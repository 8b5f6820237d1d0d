"""Layers of the port's models (port of ``ocrs_tpu.models.nn``).

Each layer is an ``nn.Module`` whose parameter names match the JAX pytree's
leaf names (``w``, ``b``; ``wx``, ``wh``, ``bx``, ``bh``), so a JAX
checkpoint loads through :func:`..weights.params_from_jax` with no renaming.

Compute convention, as in the JAX package: activations in the caller's dtype
(bf16 on the inference path and in training), parameters stored in float32
and cast to the activation dtype at use, and the bias added after the product
in that dtype. Parameters are made without grad, so an inference forward
builds no graph; ``requires_grad_()`` makes a model trainable (the training
states of :mod:`ocrs_tpu_torch.train` do so), and every layer, the GRU
kernel's included, is then differentiable.

The column split of training over a ``"model"`` group
(:mod:`ocrs_tpu_torch.parallel.distributed`): :meth:`Dense.split_columns_`
and :meth:`GRU.split_columns_` keep this rank's slice of the output columns
of ``w`` (of ``wx``); the layer then copies its input to the group,
multiplies by its slice, gathers the whole output and adds the bias, which
stays whole, as the JAX package's rule shards only 2-D leaves. The GRU's
recurrence then reads the whole ``[N, T, 3H]`` projection, so its kernel runs
as it does on one device. Without a group nothing changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gru import BiGRUSequence, bigru_sequence_reference
from ..parallel.distributed import column_slice, copy_to_model, gather_from_model


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) zero padding of XLA's ``"SAME"``: the output has
    ``ceil(size / stride)`` positions and the odd pixel goes to the high
    side. At stride 2 and k=3 on an even size that is (0, 1), which
    PyTorch's ``padding="same"`` cannot express (it refuses stride > 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def project(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``x @ w``; with a model `group`, `w` is this rank's slice of the
    columns and the product is gathered whole (differentiably)."""
    if group is None:
        return x @ w
    return gather_from_model(copy_to_model(x, group) @ w, group)


def _split_columns_(module: nn.Module, name: str, group) -> None:
    """Replace parameter `name` of `module` by this model rank's slice of
    its last dimension (its columns)."""
    full = getattr(module, name)
    part = full.detach()[..., column_slice(full.shape[-1], group)].clone()
    setattr(module, name, nn.Parameter(part, requires_grad=full.requires_grad))
    module.model_group = group


def _he_normal(shape: tuple[int, ...], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


class Conv2d(nn.Module):
    """NCHW convolution with XLA ``"SAME"`` padding; weight ``w`` is OIHW."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride=(1, 1), generator=None):
        super().__init__()
        self.stride = tuple(stride)
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(cout), requires_grad=False)
        if generator is not None:
            # He init over the HWIO kernel, laid out as OIHW.
            hwio = _he_normal((k, k, cin, cout), k * k * cin, generator)
            self.w.copy_(hwio.permute(3, 2, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.w.shape[-2:]
        ph = same_pads(x.shape[-2], kh, self.stride[0])
        pw = same_pads(x.shape[-1], kw, self.stride[1])
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(x, self.w.to(x.dtype), stride=self.stride)
        return out + self.b.to(x.dtype)[:, None, None]


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[in, out]`` as in the JAX package."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(cout), requires_grad=False)
        if generator is not None:
            self.w.copy_(_he_normal((cin, cout), cin, generator))
        self.model_group = None

    def split_columns_(self, group) -> None:
        """Keep this model rank's slice of ``w``'s columns (see the module
        docstring)."""
        _split_columns_(self, "w", group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return project(x, self.w.to(x.dtype), self.model_group) + self.b.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis as the JAX package's ``_ln_apply`` does
    it: in float32 with the biased variance and eps inside the root, scaled
    and shifted in float32, then cast back to the activation dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(dim), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + self.eps) * self.g + self.b
        return out.to(x.dtype)


class DepthwiseConv1d(nn.Module):
    """Depthwise 1-D convolution along the sequence axis of [N, T, C] with
    XLA ``"SAME"`` padding (odd k: ``(k - 1) / 2 * dilation`` on each side);
    weight ``w`` is ``[C, 1, k]``, no kernel flip."""

    def __init__(self, dim: int, k: int, generator=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(dim, 1, k), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(dim), requires_grad=False)
        if generator is not None:
            # He-style init over the k taps of each channel, drawn as WIO.
            wio = torch.randn((k, 1, dim), generator=generator) * math.sqrt(2.0 / k)
            self.w.copy_(wio.permute(2, 1, 0))

    def forward(self, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        dim, _, k = self.w.shape
        out = F.conv1d(
            x.transpose(1, 2),
            self.w.to(x.dtype),
            padding=(k - 1) // 2 * dilation,
            dilation=dilation,
            groups=dim,
        )
        return out.transpose(1, 2) + self.b.to(x.dtype)


class GRU(nn.Module):
    """One GRU direction; fused gate matrices in order r, z, n."""

    def __init__(self, cin: int, hidden: int, generator=None):
        super().__init__()
        self.wx = nn.Parameter(torch.zeros(cin, 3 * hidden), requires_grad=False)
        self.wh = nn.Parameter(torch.zeros(hidden, 3 * hidden), requires_grad=False)
        self.bx = nn.Parameter(torch.zeros(3 * hidden), requires_grad=False)
        self.bh = nn.Parameter(torch.zeros(3 * hidden), requires_grad=False)
        if generator is not None:
            self.wx.copy_(_he_normal((cin, 3 * hidden), cin, generator))
            self.wh.copy_(_he_normal((hidden, 3 * hidden), hidden, generator))
        self.model_group = None

    def split_columns_(self, group) -> None:
        """Keep this model rank's slice of the input projection ``wx``'s
        columns (see the module docstring)."""
        _split_columns_(self, "wx", group)

    def params(self) -> dict:
        return {"wx": self.wx, "wh": self.wh, "bx": self.bx, "bh": self.bh, "model_group": self.model_group}


def bigru_apply(params: dict, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Bidirectional GRU over [N, T, C] -> [N, T, 2H] in ``x.dtype``: forward
    and backward states side by side.

    Each direction's input projection runs in ``x.dtype`` (bf16 on the
    inference path), then in float32 with ``bx`` added; both recurrences run
    in float32 in one launch of :func:`..ops.gru.bigru_sequence`, which reads
    the [N, T, 3H] projections in place and writes the halves of the
    [N, T, 2H] result, through :class:`..ops.gru.BiGRUSequence`, whose
    backward recomputes through the plain loops. `plain` swaps the CUDA
    sequence kernel for its plain PyTorch version, differentiated by autograd
    (a test switch; on the CPU both run the plain loops). A float64 `x`
    keeps float64 in the recurrence (the CPU's double-precision checks), as
    the JAX package's ``gru_apply`` does. A direction whose ``model_group``
    is set holds a column slice of ``wx``: its projection is gathered whole
    (:func:`project`)."""
    f32 = torch.promote_types(torch.float32, x.dtype)
    dirs = (params["fwd"], params["bwd"])
    xps = [
        (project(x, p["wx"].to(x.dtype), p.get("model_group")).to(f32) + p["bx"].to(f32)).transpose(0, 1)
        for p in dirs
    ]
    rec = [t for p in dirs for t in (p["wh"].to(f32).contiguous(), p["bh"].to(f32).contiguous())]
    if plain:
        return bigru_sequence_reference(*xps, *rec).transpose(0, 1).to(x.dtype)
    return BiGRUSequence.apply(*xps, *rec).to(x.dtype)


class BiGRU(nn.Module):
    def __init__(self, cin: int, hidden: int, generator=None):
        super().__init__()
        self.fwd = GRU(cin, hidden, generator)
        self.bwd = GRU(cin, hidden, generator)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return bigru_apply({"fwd": self.fwd.params(), "bwd": self.bwd.params()}, x, plain)
