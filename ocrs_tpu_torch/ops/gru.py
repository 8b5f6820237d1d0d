"""GRU sequence: the hand-written CUDA kernel, its plain versions, and the layer.

Port of ``ocrs_tpu.ops.gru_pallas``. :func:`gru_sequence` runs one GRU
layer-direction over precomputed input projections; :func:`bigru_sequence`
runs both directions of a bidirectional GRU in one launch, reading the
projections through their strides and writing the two halves of one output
tensor. On CUDA tensors both launch ``csrc/gru_seq.cu`` (built with ``nvcc``
at first use, see :mod:`ocrs_tpu_torch.cuda_build`) and count the launch in
``gru_sequence.launches`` / ``bigru_sequence.launches``, and by the name of
the launching thread in ``.launches_by_thread`` (a server launches from its
handler threads and its batching worker); on CPU tensors they
run :func:`gru_sequence_reference` / :func:`bigru_sequence_reference`, the
plain PyTorch loops with the same math. There is no fallback from CUDA to a
plain version: the kernel runs or the call raises.

The kernel runs as thread-block clusters: :func:`launch_plan` splits the
hidden units over the blocks of a cluster and the batch rows over row tiles,
and refuses hidden sizes above :data:`MAX_HIDDEN`.

:class:`GRUSequence` and :class:`BiGRUSequence` make the kernel
differentiable, as ``jax.custom_vjp`` makes the Pallas kernel
(``gru_pallas.py::_gru_pallas_vjp``): the forward launches it (the plain loop
on the CPU), and the backward recomputes the recurrence through the plain
loop under autograd, as ``_gru_bwd`` recomputes through ``lax.scan``. There
is no backward kernel; the JAX package has none either.

:func:`gru_apply` is the one-direction layer (``_gru_pallas_impl``): the input
projection for all timesteps as one matrix product outside the kernel, then
the recurrence in the kernel. The bidirectional layer is
:func:`ocrs_tpu_torch.models.nn.bigru_apply`.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch

from .. import cuda_build

_LIB_NAME = "gru_seq"
_count_lock = threading.Lock()

#: Blocks per cluster: 8 is the largest size every Hopper launch may ask for.
MAX_CLUSTER = 8
#: Blocks per cluster above hidden size MAX_UNITS * MAX_CLUSTER: a
#: non-portable cluster, which Hopper schedules on one GPC.
MAX_CLUSTER_LARGE = 16
#: Batch rows per cluster (the M = 16 of the kernel's tensor-core tile); more
#: rows go to further clusters (row tiles).
MAX_ROWS = 16
#: Hidden units per block the kernel is compiled for (four tiles of 8).
MAX_UNITS = 32
#: The largest hidden size the kernel serves: 16 blocks of 32 units.
MAX_HIDDEN = MAX_UNITS * MAX_CLUSTER_LARGE
#: Warps per block: the parts of k whose partial sums a block keeps.
WARPS = 8
#: Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448


def launch_plan(n: int, hidden: int) -> dict[str, int]:
    """How the kernel is laid out for `n` batch rows and `hidden` units.

    A cluster of ``cluster`` blocks serves one direction and one tile of
    ``rows`` batch rows; each block owns ``units`` hidden units (the last
    block fewer when `hidden` does not divide) and keeps their
    ``[hidden, 3 * units]`` slice of ``wh``, two copies of the tile's ``h``
    and the partial sums of its 8 parts of k in shared memory (``smem``
    bytes). Up to hidden 256 a cluster has at most 8 blocks; above, up to
    16 (non-portable). Where the slice of ``wh`` does not fit beside the
    rest (hidden above 384), ``wh_global`` is 1: the kernel reads ``wh``
    from global memory (L2) every step and ``smem`` leaves the slice out.
    Raises ``ValueError`` above hidden :data:`MAX_HIDDEN`."""
    if n < 1 or hidden < 1:
        raise ValueError(f"launch_plan needs n >= 1 and hidden >= 1, got {n}, {hidden}")
    if hidden > MAX_HIDDEN:
        raise ValueError(
            f"hidden size {hidden} is too large for the GRU kernel: it serves hidden sizes up to "
            f"{MAX_HIDDEN} (clusters of at most {MAX_CLUSTER_LARGE} blocks of at most {MAX_UNITS} "
            f"units; a Hopper block has at most {SMEM_LIMIT} bytes, 227 KB, of shared memory)"
        )
    max_cluster = MAX_CLUSTER if hidden <= MAX_UNITS * MAX_CLUSTER else MAX_CLUSTER_LARGE
    units = -(-hidden // max_cluster)
    cluster = -(-hidden // units)
    tiles = -(-n // MAX_ROWS)
    rows = -(-n // tiles)
    # The shared-memory layout of csrc/gru_seq.cu, name by name.
    uh = -(-units // 8) * 8
    k8 = cluster * uh // 8
    ws = 8 * k8 * 3 * (uh // 8) * 32
    hs = 4 * 2 * cluster * MAX_ROWS * (uh + 4)
    part = 4 * WARPS * 3 * MAX_ROWS * uh
    rest = 16 + hs + part + 4 * 3 * units
    wh_global = rest + ws > SMEM_LIMIT
    smem = rest if wh_global else rest + ws
    return {
        "cluster": cluster, "units": units, "tiles": tiles, "rows": rows, "smem": smem,
        "wh_global": int(wh_global),
    }


def _kernel():
    lib = cuda_build.load(_LIB_NAME)
    fn = lib.ocrs_gru_seq_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(dirs, t_len: int, n: int, hidden: int, mode: int = 0) -> None:
    """Launch the kernel once for one or two directions. Each of `dirs` is
    ``(xr, xz, xn, wh, bh, out, reverse)`` with xr/xz/xn/out ``[T, N, H]``
    f32 CUDA views of unit inner stride (xr/xz/xn sharing their strides)."""
    plan = launch_plan(n, hidden)
    flat = []
    for xr, xz, xn, wh, bh, out, reverse in dirs:
        flat += [x.data_ptr() for x in (xr, xz, xn, wh, bh, out)]
        flat += [xr.stride(0), xr.stride(1), out.stride(0), out.stride(1), int(bool(reverse))]
    packed = (ctypes.c_longlong * len(flat))(*flat)
    device = dirs[0][0].device
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(
            packed, len(dirs), t_len, n, hidden,
            plan["cluster"], plan["units"], plan["rows"], plan["smem"], plan["wh_global"], mode,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_seq kernel launch failed: CUDA error {err} (plan {plan})")


def _count(wrapper) -> None:
    """One launch of `wrapper`'s kernel, in its total and under the name of
    the calling thread."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.launches_by_thread[threading.current_thread().name] += 1


def _check_dtype(tensors, name: str) -> None:
    """float32 everywhere; float64 too on the CPU, where the plain version
    runs (the double-precision gradient checks)."""
    dtype, device = tensors[0].dtype, tensors[0].device
    ok = dtype == torch.float32 or (dtype == torch.float64 and device.type == "cpu")
    if not ok or any(x.dtype != dtype for x in tensors):
        raise TypeError(f"{name} takes float32 tensors (float64 on the CPU), all of one dtype")


def _check(xr, xz, xn, wh, bh) -> None:
    """Validate the operands of :func:`gru_sequence`."""
    if xr.dim() != 3:
        raise ValueError(f"expected [T, N, H] inputs, got {tuple(xr.shape)}")
    t, n, h = xr.shape
    for name, x in (("xz", xz), ("xn", xn)):
        if x.shape != xr.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, xr has {tuple(xr.shape)}")
    if wh.shape != (h, 3 * h) or bh.shape != (3 * h,):
        raise ValueError(
            f"expected wh [{h}, {3 * h}] and bh [{3 * h}], got {tuple(wh.shape)}, {tuple(bh.shape)}"
        )
    tensors = (xr, xz, xn, wh, bh)
    if any(x.device != xr.device for x in tensors):
        raise ValueError("gru_sequence operands must share one device")
    ld = xr.stride(1)
    for x in (xr, xz, xn):
        # Rows of H contiguous floats, (t, n) rows `ld` apart: contiguous
        # tensors and the r/z/n column slices of one [T, N, 3H] tensor.
        if x.stride() != (n * ld, ld, 1) or ld < h:
            raise ValueError("xr/xz/xn must share a row-major layout with unit inner stride")
    if not (wh.is_contiguous() and bh.is_contiguous()):
        raise ValueError("wh and bh must be contiguous")
    _check_dtype(tensors, "gru_sequence")
    if xr.numel():
        launch_plan(n, h)


def gru_sequence_reference(
    xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
    wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a loop over t with the same math.
    [T, N, H] x3, wh [H, 3H], bh [3H] -> [T, N, H]."""
    t_len, n, hidden = xr.shape
    br, bz, bn = bh.reshape(3, hidden)
    h = xr.new_zeros((n, hidden))
    hs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        hr, hz, hn = (h @ wh).split(hidden, dim=-1)
        r = torch.sigmoid(xr[t] + hr + br)
        z = torch.sigmoid(xz[t] + hz + bz)
        nval = torch.tanh(xn[t] + r * (hn + bn))
        h = (1.0 - z) * nval + z * h
        hs[t] = h
    if not t_len:
        return xr.new_empty((0, n, hidden))
    return torch.stack(hs)


def gru_sequence(
    xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
    wh: torch.Tensor, bh: torch.Tensor, reverse: bool = False,
) -> torch.Tensor:
    """Run a full GRU over precomputed input projections -> [T, N, H] f32.

    xr/xz/xn: [T, N, H] f32 (``x @ wx + bx`` split by gate); wh: [H, 3H]
    (gates r, z, n); bh: [3H]. `reverse` runs the recurrence backwards in
    time; outputs land in original time order."""
    _check(xr, xz, xn, wh, bh)
    if xr.device.type == "cpu":
        return gru_sequence_reference(xr, xz, xn, wh, bh, reverse)
    if xr.device.type != "cuda":
        raise ValueError(f"gru_sequence runs on cuda or cpu, not {xr.device.type}")
    t_len, n, hidden = xr.shape
    out = torch.empty((t_len, n, hidden), dtype=xr.dtype, device=xr.device)
    if out.numel() == 0:
        return out
    _launch([(xr, xz, xn, wh, bh, out, reverse)], t_len, n, hidden)
    _count(gru_sequence)
    return out


#: Number of kernel launches (CUDA calls only; CPU calls run the plain version).
gru_sequence.launches = 0
gru_sequence.launches_by_thread = Counter()


def _check_bigru(xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd, out) -> None:
    """Validate the operands of :func:`bigru_sequence`."""
    if xp_fwd.dim() != 3 or xp_fwd.shape[-1] % 3:
        raise ValueError(f"expected [T, N, 3H] projections, got {tuple(xp_fwd.shape)}")
    t, n, h3 = xp_fwd.shape
    h = h3 // 3
    if xp_bwd.shape != xp_fwd.shape:
        raise ValueError(f"xp_bwd has shape {tuple(xp_bwd.shape)}, xp_fwd has {tuple(xp_fwd.shape)}")
    for name, wh, bh in (("fwd", wh_fwd, bh_fwd), ("bwd", wh_bwd, bh_bwd)):
        if wh.shape != (h, h3) or bh.shape != (h3,):
            raise ValueError(
                f"expected wh_{name} [{h}, {h3}] and bh_{name} [{h3}], "
                f"got {tuple(wh.shape)}, {tuple(bh.shape)}"
            )
        if not (wh.is_contiguous() and bh.is_contiguous()):
            raise ValueError(f"wh_{name} and bh_{name} must be contiguous")
    tensors = [xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd]
    if out is not None:
        if out.shape != (t, n, 2 * h):
            raise ValueError(f"expected out [{t}, {n}, {2 * h}], got {tuple(out.shape)}")
        tensors.append(out)
    if any(x.device != xp_fwd.device for x in tensors):
        raise ValueError("bigru_sequence operands must share one device")
    # Any strides for t and n, so that the [N, T, 3H] product and the
    # [N, T, 2H] result are used where they lie; rows of floats side by side.
    if any(x.stride(2) != 1 for x in tensors if x.dim() == 3 and x.numel()):
        raise ValueError("xp_fwd, xp_bwd and out must have unit inner stride")
    _check_dtype(tensors, "bigru_sequence")
    if xp_fwd.numel():
        launch_plan(n, h)


def bigru_sequence_reference(
    xp_fwd: torch.Tensor, xp_bwd: torch.Tensor,
    wh_fwd: torch.Tensor, bh_fwd: torch.Tensor,
    wh_bwd: torch.Tensor, bh_bwd: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bigru_sequence`: the forward and the
    reverse loop, one after the other, side by side in [T, N, 2H]."""
    hidden = wh_fwd.shape[0]
    fwd = gru_sequence_reference(*xp_fwd.split(hidden, dim=-1), wh_fwd, bh_fwd, reverse=False)
    bwd = gru_sequence_reference(*xp_bwd.split(hidden, dim=-1), wh_bwd, bh_bwd, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)


def bigru_sequence(
    xp_fwd: torch.Tensor, xp_bwd: torch.Tensor,
    wh_fwd: torch.Tensor, bh_fwd: torch.Tensor,
    wh_bwd: torch.Tensor, bh_bwd: torch.Tensor,
    out: torch.Tensor | None = None, timing_mode: int = 0,
) -> torch.Tensor:
    """Both directions of a bidirectional GRU in one launch -> [T, N, 2H] f32.

    xp_fwd / xp_bwd: [T, N, 3H] f32 input projections of the two directions
    (``x @ wx + bx``, gates r | z | n side by side), with any strides for t
    and n and unit inner stride: the transposed view of an [N, T, 3H] product
    is read where it lies. wh_*: [H, 3H]; bh_*: [3H]. The forward states land
    in ``out[..., :H]``, those of the reverse direction in ``out[..., H:]``,
    both in original time order. `out`, if given, is a [T, N, 2H] f32 view
    with unit inner stride (e.g. the transposed view of an [N, T, 2H]
    tensor) and is returned.

    `timing_mode` 1 and 2 launch the kernel's timing-only variants (1: no
    recurrent product; 2: only the exchange of ``h`` and the step barrier);
    their output is not the GRU's."""
    _check_bigru(xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd, out)
    device = xp_fwd.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"bigru_sequence runs on cuda or cpu, not {device.type}")
    t_len, n, h3 = xp_fwd.shape
    hidden = h3 // 3
    if out is None:
        out = torch.empty((t_len, n, 2 * hidden), dtype=xp_fwd.dtype, device=device)
    if out.numel() == 0:
        return out
    if device.type == "cpu":
        if timing_mode:
            raise ValueError("the timing-only variants exist on the card only")
        out.copy_(bigru_sequence_reference(xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd))
        return out
    dirs = [
        (*xp.split(hidden, dim=-1), wh, bh, half, reverse)
        for xp, wh, bh, half, reverse in (
            (xp_fwd, wh_fwd, bh_fwd, out[..., :hidden], False),
            (xp_bwd, wh_bwd, bh_bwd, out[..., hidden:], True),
        )
    ]
    _launch(dirs, t_len, n, hidden, mode=timing_mode)
    _count(bigru_sequence)
    return out


#: Number of kernel launches (CUDA calls only; CPU calls run the plain version).
bigru_sequence.launches = 0
bigru_sequence.launches_by_thread = Counter()


def _recompute_grads(ctx, reference, grad, *args):
    """Gradients of a sequence Function's tensor inputs: the recurrence run
    again through `reference` under autograd, from detached copies of the
    saved inputs, and differentiated against `grad`."""
    needs = ctx.needs_input_grad[: len(ctx.saved_tensors)]
    inputs = [x.detach().requires_grad_(need) for x, need in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        out = reference(*inputs, *args)
    grads = iter(torch.autograd.grad(out, [x for x, need in zip(inputs, needs) if need], grad))
    return [next(grads) if need else None for need in needs]


class GRUSequence(torch.autograd.Function):
    """Differentiable :func:`gru_sequence`: ``GRUSequence.apply(xr, xz, xn,
    wh, bh, reverse) -> [T, N, H]``. The forward launches the kernel (the
    plain loop on the CPU); the backward recomputes through
    :func:`gru_sequence_reference` and returns the gradients of xr, xz, xn,
    wh and bh."""

    @staticmethod
    def forward(ctx, xr, xz, xn, wh, bh, reverse):
        ctx.save_for_backward(xr, xz, xn, wh, bh)
        ctx.reverse = bool(reverse)
        return gru_sequence(xr, xz, xn, wh, bh, reverse=reverse)

    @staticmethod
    def backward(ctx, grad):
        return (*_recompute_grads(ctx, gru_sequence_reference, grad, ctx.reverse), None)


class BiGRUSequence(torch.autograd.Function):
    """Differentiable :func:`bigru_sequence`, batch-first: ``BiGRUSequence.apply(
    xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd) -> [N, T, 2H]`` from the
    [T, N, 3H] projections (any strides for t and n, as
    :func:`bigru_sequence` takes them). The forward is one launch into an
    [N, T, 2H] tensor (the plain loops on the CPU); the backward recomputes
    through :func:`bigru_sequence_reference` and returns the gradients of
    all six operands."""

    @staticmethod
    def forward(ctx, xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd):
        ctx.save_for_backward(xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd)
        t_len, n, h3 = xp_fwd.shape
        out = torch.empty((n, t_len, 2 * (h3 // 3)), dtype=xp_fwd.dtype, device=xp_fwd.device)
        bigru_sequence(xp_fwd, xp_bwd, wh_fwd, bh_fwd, wh_bwd, bh_bwd, out=out.transpose(0, 1))
        return out

    @staticmethod
    def backward(ctx, grad):
        return tuple(_recompute_grads(ctx, bigru_sequence_reference, grad.transpose(0, 1)))


def gru_apply(params: dict, x: torch.Tensor, reverse: bool = False, plain: bool = False) -> torch.Tensor:
    """One GRU direction over [N, T, C] -> [N, T, H] in ``x.dtype``.

    The input projection runs in ``x.dtype`` (bf16 on the inference path),
    then in float32 with ``bx`` added; the recurrence runs in float32 in
    :class:`GRUSequence` (the kernel), or in :func:`gru_sequence_reference`
    when `plain`. Both are differentiable. A float64 `x` keeps float64 in
    the recurrence (CPU only), as the JAX package's ``gru_apply`` does."""
    hidden = params["wh"].shape[0]
    f32 = torch.promote_types(torch.float32, x.dtype)
    xp = (x @ params["wx"].to(x.dtype)).to(f32) + params["bx"].to(f32)
    xp = xp.transpose(0, 1).contiguous()  # [T, N, 3H]
    xr, xz, xn = xp.split(hidden, dim=-1)
    wh = params["wh"].to(f32).contiguous()
    bh = params["bh"].to(f32).contiguous()
    if plain:
        hs = gru_sequence_reference(xr, xz, xn, wh, bh, reverse=reverse)
    else:
        hs = GRUSequence.apply(xr, xz, xn, wh, bh, reverse)
    return hs.transpose(0, 1).to(x.dtype)
