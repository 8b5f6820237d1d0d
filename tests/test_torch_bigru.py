"""The port's bidirectional GRU sequence (ocrs_tpu_torch.ops.gru.bigru_sequence,
ocrs_tpu_torch.models.nn.bigru_apply) against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks. On the
CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel itself
is compared with that plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py). The JAX Pallas kernel runs in interpret mode, once per
direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.models import nn as jnn
from ocrs_tpu.ops.gru_pallas import gru_sequence as jax_gru_sequence
from ocrs_tpu_torch.models import nn as tnn
from ocrs_tpu_torch.ops import gru

T, H, C = 13, 32, 24
BATCHES = [1, 3, 20, 33]

# float32 on both sides, same math, different summation order in the
# [N, H] x [H, 3H] products: a few ulps per step over 13 steps.
F32_ATOL = 1e-5
# bf16 layer: the input projection runs in bf16 and the [N, T, 2H] result is
# rounded to bf16 (8 bits of mantissa, |h| < 1), so one bf16 ulp near 1 is
# 2**-8 = 3.9e-3; a different rounding of the f32 sum flips at most one ulp.
BF16_ATOL = 2**-8


def _seq_inputs(n, seed=0):
    """Projections [T, N, 3H] of both directions, and wh, bh of both."""
    rng = np.random.default_rng(seed)
    xps = [rng.standard_normal((T, n, 3 * H)).astype(np.float32) for _ in range(2)]
    rec = []
    for _ in range(2):
        rec.append((rng.standard_normal((H, 3 * H)) * np.sqrt(2.0 / H)).astype(np.float32))
        rec.append((rng.standard_normal(3 * H) * 0.1).astype(np.float32))
    return xps, rec


def _layer_params(seed=1):
    rng = np.random.default_rng(seed)

    def direction():
        return {
            "wx": (rng.standard_normal((C, 3 * H)) * np.sqrt(2.0 / C)).astype(np.float32),
            "wh": (rng.standard_normal((H, 3 * H)) * np.sqrt(2.0 / H)).astype(np.float32),
            "bx": (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
            "bh": (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
        }

    return {"fwd": direction(), "bwd": direction()}


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("n", BATCHES)
def test_plain_bigru_sequence_matches_pallas_interpret(n):
    xps, rec = _seq_inputs(n)
    want = []
    for xp, wh, bh, reverse in ((xps[0], rec[0], rec[1], False), (xps[1], rec[2], rec[3], True)):
        xr, xz, xn = (jnp.asarray(a) for a in np.split(xp, 3, axis=-1))
        want.append(np.asarray(
            jax_gru_sequence(xr, xz, xn, jnp.asarray(wh), jnp.asarray(bh), interpret=True, reverse=reverse)
        ))
    got = gru.bigru_sequence_reference(*_torch(xps), *_torch(rec))
    assert got.shape == (T, n, 2 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.concatenate(want, axis=-1), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("n", BATCHES)
def test_bigru_apply_matches_jax_f32(n):
    params = _layer_params()
    x = np.random.default_rng(3).standard_normal((n, T, C)).astype(np.float32)
    want = np.asarray(jnn.bigru_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = tnn.bigru_apply(_torch(params), torch.from_numpy(x))
    assert got.shape == (n, T, 2 * H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("n", [3, 20])
def test_bigru_apply_matches_jax_bf16(n):
    params = _layer_params(4)
    x = np.random.default_rng(5).standard_normal((n, T, C)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jnn.bigru_apply(jax.tree.map(jnp.asarray, params), xb).astype(jnp.float32))
    got = tnn.bigru_apply(_torch(params), torch.from_numpy(x).to(torch.bfloat16))
    assert got.shape == (n, T, 2 * H) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


def test_bigru_apply_plain_switch_matches_wrapper():
    params = _torch(_layer_params(7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, T, C)).astype(np.float32))
    torch.testing.assert_close(
        tnn.bigru_apply(params, x, plain=True), tnn.bigru_apply(params, x), rtol=0, atol=0
    )


def test_bigru_module_matches_function():
    g = torch.Generator().manual_seed(0)
    layer = tnn.BiGRU(C, H, generator=g)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((3, T, C)).astype(np.float32))
    want = tnn.bigru_apply({"fwd": layer.fwd.params(), "bwd": layer.bwd.params()}, x)
    torch.testing.assert_close(layer(x), want, rtol=0, atol=0)


@pytest.mark.parametrize("n", BATCHES)
def test_strided_operands_give_what_contiguous_ones_give(n):
    # The layer hands the wrapper the transposed views of [N, T, 3H] products
    # and of an [N, T, 2H] result; the wrapper reads and writes them in place.
    xps, rec = _seq_inputs(n, seed=10)
    xps, rec = _torch(xps), _torch(rec)
    want = gru.bigru_sequence(*xps, *rec)
    assert want.is_contiguous()
    strided = [xp.transpose(0, 1).contiguous().transpose(0, 1) for xp in xps]
    assert all(not xp.is_contiguous() or n == 1 for xp in strided)
    out = torch.full((n, T, 2 * H), float("nan"))
    got = gru.bigru_sequence(*strided, *rec, out=out.transpose(0, 1))
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out.transpose(0, 1), want, rtol=0, atol=0)
    # The halves are the two directions, each what gru_sequence gives.
    fwd = gru.gru_sequence(*(a.contiguous() for a in xps[0].split(H, dim=-1)), rec[0], rec[1])
    bwd = gru.gru_sequence(*(a.contiguous() for a in xps[1].split(H, dim=-1)), rec[2], rec[3], reverse=True)
    torch.testing.assert_close(want[..., :H], fwd, rtol=0, atol=0)
    torch.testing.assert_close(want[..., H:], bwd, rtol=0, atol=0)


def test_cpu_tensors_take_plain_version_without_launching():
    xps, rec = _seq_inputs(3, seed=11)
    xps, rec = _torch(xps), _torch(rec)
    before = gru.bigru_sequence.launches
    out = gru.bigru_sequence(*xps, *rec)
    assert gru.bigru_sequence.launches == before
    torch.testing.assert_close(out, gru.bigru_sequence_reference(*xps, *rec), rtol=0, atol=0)
    with pytest.raises(ValueError, match="on the card only"):
        gru.bigru_sequence(*xps, *rec, timing_mode=2)


def test_empty_sequence_returns_empty():
    xps, rec = _seq_inputs(3, seed=12)
    xps, rec = _torch(xps), _torch(rec)
    out = gru.bigru_sequence(xps[0][:0], xps[1][:0], *rec)
    assert out.shape == (0, 3, 2 * H)


def _bad_operand_cases():
    def shape_of_bwd(xps, rec):
        return (xps[0], xps[1][:, :2], *rec), ValueError

    def recurrent_weight_shape(xps, rec):
        return (*xps, rec[0][:, :H], *rec[1:]), ValueError

    def bias_shape(xps, rec):
        return (*xps, rec[0], rec[1][:H], *rec[2:]), ValueError

    def dtype(xps, rec):
        return (xps[0].double(), xps[1], *rec), TypeError

    def inner_stride(xps, rec):
        wide = torch.zeros(T, 3, 6 * H)
        return (wide[..., ::2], xps[1], *rec), ValueError

    def not_three_gates(xps, rec):
        return (xps[0][..., : 3 * H - 1], xps[1][..., : 3 * H - 1], *rec), ValueError

    def weights_not_contiguous(xps, rec):
        return (*xps, rec[0].t().contiguous().t(), *rec[1:]), ValueError

    return [shape_of_bwd, recurrent_weight_shape, bias_shape, dtype, inner_stride, not_three_gates,
            weights_not_contiguous]


@pytest.mark.parametrize("case", _bad_operand_cases(), ids=lambda f: f.__name__)
def test_wrapper_rejects_bad_operands(case):
    xps, rec = _seq_inputs(3)
    args, error = case(_torch(xps), _torch(rec))
    with pytest.raises(error):
        gru.bigru_sequence(*args)


def test_wrapper_rejects_bad_out():
    xps, rec = _seq_inputs(3)
    xps, rec = _torch(xps), _torch(rec)
    with pytest.raises(ValueError, match="expected out"):
        gru.bigru_sequence(*xps, *rec, out=torch.empty(T, 3, H))
    with pytest.raises(ValueError, match="unit inner stride"):
        gru.bigru_sequence(*xps, *rec, out=torch.empty(T, 3, 4 * H)[..., ::2])


@pytest.mark.parametrize("hidden", [513, 640])
def test_hidden_size_beyond_the_kernel_raises_with_the_limit(hidden):
    # The same call raises on the CPU as on the card: the wrapper never swaps a
    # hidden size the kernel cannot take for the plain version.
    with pytest.raises(ValueError, match=r"serves hidden sizes up to 512 .*at most 16 blocks .*227 KB"):
        gru.launch_plan(3, hidden)
    x = torch.zeros(1, 1, 3 * hidden)
    wh, bh = torch.zeros(hidden, 3 * hidden), torch.zeros(3 * hidden)
    with pytest.raises(ValueError, match="too large for the GRU kernel"):
        gru.bigru_sequence(x, x, wh, bh, wh, bh)
    with pytest.raises(ValueError, match="too large for the GRU kernel"):
        gru.gru_sequence(*x.split(hidden, dim=-1), wh, bh)


@pytest.mark.parametrize(
    "n, hidden, want",
    [
        # The recognizer's largest batch: 24 units per block, two row tiles of 10.
        (20, 192, {"cluster": 8, "units": 24, "tiles": 2, "rows": 10}),
        (16, 192, {"cluster": 8, "units": 24, "tiles": 1, "rows": 16}),
        (33, 32, {"cluster": 8, "units": 4, "tiles": 3, "rows": 11}),
        (1, 32, {"cluster": 8, "units": 4, "tiles": 1, "rows": 1}),
        # Hidden sizes that do not divide: a smaller cluster, a ragged last block.
        (4, 20, {"cluster": 7, "units": 3, "tiles": 1, "rows": 4}),
        (4, 100, {"cluster": 8, "units": 13, "tiles": 1, "rows": 4}),
        (2, 1, {"cluster": 1, "units": 1, "tiles": 1, "rows": 2}),
        (5, 256, {"cluster": 8, "units": 32, "tiles": 1, "rows": 5}),
    ],
)
def test_launch_plan(n, hidden, want):
    plan = gru.launch_plan(n, hidden)
    assert {k: plan[k] for k in want} == want
    assert plan["cluster"] * plan["units"] >= hidden > (plan["cluster"] - 1) * plan["units"]
    assert plan["tiles"] * plan["rows"] >= n and plan["rows"] <= gru.MAX_ROWS
    assert 0 < plan["smem"] <= gru.SMEM_LIMIT
