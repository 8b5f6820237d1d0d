"""Text-recognition models: sequence-over-width CTC recognizers.

Port of ``ocrs_tpu.models.recognition_net``. Both architectures share one
contract: fixed input height 64, width downsampled 4x so the CTC sequence
length is W/4, output ``[seq, batch, classes]`` log-probabilities with class
0 = CTC blank.

  * ``crnn``: conv stack + two bidirectional GRUs. The recurrences run in the
    hand-written CUDA sequence kernel of :mod:`ocrs_tpu_torch.ops.gru`.
  * ``convctc``: conv stem + dilated depthwise ConvNeXt-style blocks, no
    recurrence; the architecture of the shipped
    ``weights/text-recognition.npz`` and the default. Every op is a library
    convolution or matrix product.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .nn import BiGRU, Conv2d, Dense, DepthwiseConv1d, LayerNorm
from .weights import params_from_jax

#: Fixed input height (upstream ocrs recognition.rs:332-337).
INPUT_HEIGHT = 64
#: Width downsampling factor of the conv stack.
DOWNSAMPLE_W = 4

DEFAULT_HIDDEN = 192

CONV_DIM = 384
#: Per-block dilation of the depthwise kernel along the sequence axis.
CONV_BLOCKS: tuple[int, ...] = (1, 1, 2, 2, 4)
CONV_KERNEL = 9


class CRNN(nn.Module):
    """``recognition_net.apply``; submodule names follow the JAX pytree."""

    def __init__(self, n_classes: int, hidden: int = DEFAULT_HIDDEN, generator=None):
        super().__init__()
        g = generator
        # H 64 -> 32 -> 16 -> 8 -> 4; W -> W/2 -> W/4
        self.conv1 = Conv2d(1, 32, stride=(2, 2), generator=g)
        self.conv2 = Conv2d(32, 64, stride=(2, 1), generator=g)
        self.conv3 = Conv2d(64, 96, stride=(2, 2), generator=g)
        self.conv4 = Conv2d(96, 128, stride=(2, 1), generator=g)
        self.proj = Dense(4 * 128, hidden, generator=g)
        self.gru1 = BiGRU(hidden, hidden, generator=g)
        self.gru2 = BiGRU(2 * hidden, hidden, generator=g)
        self.head = Dense(2 * hidden, n_classes, generator=g)
        #: Test switch: run the GRUs through the plain PyTorch sequence loop
        #: instead of the CUDA kernel.
        self.plain_gru = False

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """[N, 1, 64, W] -> [W//4, N, classes] log-probs (at least float32).
        `dtype` is the activation dtype: bf16 for inference, float32 for
        numeric-equivalence checks."""
        h = x.to(dtype)
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        h = F.relu(self.conv4(h))
        n, c, hh, t = h.shape  # [N, 128, 4, W/4]
        h = h.permute(0, 3, 2, 1).reshape(n, t, hh * c)  # [N, W/4, 4*128]
        h = F.relu(self.proj(h))
        h = self.gru1(h, plain=self.plain_gru)
        h = self.gru2(h, plain=self.plain_gru)
        out_dtype = torch.promote_types(torch.float32, dtype)
        logits = self.head(h).to(out_dtype)  # [N, T, C]
        return F.log_softmax(logits, dim=-1).permute(1, 0, 2)  # [T, N, C]


class ConvBlock(nn.Module):
    """Depthwise conv -> LayerNorm -> dense, tanh-GELU, dense; the caller adds
    the residual."""

    def __init__(self, dim: int, generator=None):
        super().__init__()
        self.dw = DepthwiseConv1d(dim, CONV_KERNEL, generator)
        self.ln = LayerNorm(dim)
        self.ff1 = Dense(dim, 2 * dim, generator)
        self.ff2 = Dense(2 * dim, dim, generator)

    def forward(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        y = self.ln(self.dw(x, dilation))
        # jax.nn.gelu's default is the tanh approximation.
        return self.ff2(F.gelu(self.ff1(y), approximate="tanh"))


class ConvCTC(nn.Module):
    """``recognition_net.conv_apply``; submodule names follow the JAX pytree."""

    def __init__(self, n_classes: int, dim: int = CONV_DIM, generator=None):
        super().__init__()
        g = generator
        # H 64 -> 32 -> 16 -> 8 -> 4; W -> W/2 -> W/4
        self.conv1 = Conv2d(1, 48, stride=(2, 2), generator=g)
        self.conv2 = Conv2d(48, 96, stride=(2, 1), generator=g)
        self.conv3 = Conv2d(96, 128, stride=(2, 2), generator=g)
        self.conv4 = Conv2d(128, 192, stride=(2, 1), generator=g)
        self.proj = Dense(4 * 192, dim, generator=g)
        self.blocks = nn.ModuleList(ConvBlock(dim, g) for _ in CONV_BLOCKS)
        self.ln_out = LayerNorm(dim)
        self.head = Dense(dim, n_classes, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """[N, 1, 64, W] -> [W//4, N, classes] log-probs (at least float32).
        The JAX function computes in bf16 only; float32 is for
        numeric-equivalence checks."""
        h = x.to(dtype)
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        h = F.relu(self.conv4(h))
        n, c, hh, t = h.shape  # [N, 192, 4, W/4]
        h = h.permute(0, 3, 2, 1).reshape(n, t, hh * c)  # [N, W/4, 4*192]
        h = self.proj(h)
        for block, dilation in zip(self.blocks, CONV_BLOCKS):
            h = h + block(h, dilation)
        h = self.ln_out(h)
        out_dtype = torch.promote_types(torch.float32, dtype)
        logits = self.head(h).to(out_dtype)  # [N, T, C]
        return F.log_softmax(logits, dim=-1).permute(1, 0, 2)  # [T, N, C]


#: Architecture name -> network class; the second constructor argument is the
#: width that ``proj`` maps to (GRU hidden size, or ConvCTC's dim).
ARCHS = {"crnn": CRNN, "convctc": ConvCTC}
_DEFAULT_WIDTH = {"crnn": DEFAULT_HIDDEN, "convctc": CONV_DIM}

DEFAULT_ARCH = "convctc"


class RecognitionModel(nn.Module):
    """Model-protocol wrapper (see :mod:`.protocol`). ``arch`` selects the
    parameter family; weight files record it in their meta dict."""

    def __init__(self, params: Any = None, arch: str = "crnn", *,
                 n_classes: int = 97, hidden: int | None = None, generator=None):
        """`params`: JAX-layout parameter tree (numpy leaves); None builds a
        network initialized from `generator`. `hidden` is the CRNN's GRU size
        or ConvCTC's dim; with `params` it is read from ``proj.w``."""
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown recognition arch {arch!r}")
        width = hidden or _DEFAULT_WIDTH[arch]
        if params is not None:
            n_classes = int(params["head"]["w"].shape[-1])
            width = int(params["proj"]["w"].shape[-1])
        self.net = ARCHS[arch](n_classes, width, generator)
        if params is not None:
            self.net.load_state_dict(params_from_jax(params))
        self.arch = arch
        #: Activation dtype of :meth:`run`: bf16 for inference, float32 for
        #: numeric-equivalence checks.
        self.dtype = torch.bfloat16

    @staticmethod
    def create(seed: int = 0, n_classes: int = 97, hidden: int = DEFAULT_HIDDEN,
               arch: str = "crnn") -> "RecognitionModel":
        """Random weights from a seeded ``torch.Generator`` (He-normal kernels,
        zero biases, as the JAX package's init functions draw them; the
        numbers differ from ``jax.random``'s). As there, `hidden` sizes the
        CRNN only; ConvCTC is built at ``CONV_DIM``."""
        g = torch.Generator().manual_seed(seed)
        width = hidden if arch == "crnn" else None
        return RecognitionModel(None, arch, n_classes=n_classes, hidden=width, generator=g)

    def input_shape(self):
        return ["batch", 1, INPUT_HEIGHT, "seq"]

    @torch.inference_mode()
    def run(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        return self.net(x, dtype or self.dtype)
