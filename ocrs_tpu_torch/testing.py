"""Test fixtures: the port of ``ocrs_tpu.testing`` (upstream
ocrs/src/test_util.rs:7-35), and a PyTorch twin of the CRNN recognizer
built from library layers, a yardstick for weight conversion."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import Rect


def gen_rect_grid(
    top_left: tuple[float, float],
    grid_shape: tuple[int, int],
    rect_size: tuple[float, float],
    gap_size: tuple[float, float],
) -> list[Rect]:
    """Generate a (rows, cols) grid of rects of (h, w) separated by gaps
    (test_util.rs:7-27). `top_left` is (y, x) to match the upstream
    Point::from_yx call sites."""
    rows, cols = grid_shape
    rect_h, rect_w = rect_size
    gap_y, gap_x = gap_size
    y0, x0 = top_left
    out = []
    for r in range(rows):
        for c in range(cols):
            top = y0 + r * (rect_h + gap_y)
            left = x0 + c * (rect_w + gap_x)
            out.append(Rect.from_tlhw(top, left, rect_h, rect_w))
    return out


def union_rects(rects: Sequence[Rect]) -> Optional[Rect]:
    """Union of all rects (test_util.rs:29-35)."""
    out: Optional[Rect] = None
    for r in rects:
        out = r if out is None else out.union(r)
    return out


def fill_rect(image: np.ndarray, rect: Rect, value: float) -> None:
    """Fill rows [top, bottom) x cols [left, right) of a 2-D array."""
    image[int(rect.top) : int(rect.bottom), int(rect.left) : int(rect.right)] = value


class TorchCRNN(torch.nn.Module):
    """The CRNN recognizer written with ``torch.nn`` layers (``Conv2d``,
    ``Linear``, ``GRU``), as an upstream PyTorch checkpoint would hold it:
    the same graph as ``models.recognition_net.CRNN`` with ONNX-style
    asymmetric stride-2 pads, torch's GRU gate order and bias placement.
    Its ``state_dict()`` and ONNX export are what the converters of
    :mod:`.models.convert` take; its output (log-probs [T, N, C]) is what
    the converted model must give. The port itself never calls it."""

    def __init__(self, hidden: int, n_classes: int):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 32, 3, stride=(2, 2))
        self.conv2 = torch.nn.Conv2d(32, 64, 3, stride=(2, 1))
        self.conv3 = torch.nn.Conv2d(64, 96, 3, stride=(2, 2))
        self.conv4 = torch.nn.Conv2d(96, 128, 3, stride=(2, 1))
        self.proj = torch.nn.Linear(4 * 128, hidden)
        self.gru1 = torch.nn.GRU(hidden, hidden, bidirectional=True, batch_first=True)
        self.gru2 = torch.nn.GRU(2 * hidden, hidden, bidirectional=True, batch_first=True)
        self.head = torch.nn.Linear(2 * hidden, n_classes)

    def forward(self, x):
        # XLA SAME padding for k=3: (1,1) at stride 1, (0,1) at stride 2.
        def pad(x, sh, sw):
            return F.pad(x, (0 if sw == 2 else 1, 1, 0 if sh == 2 else 1, 1))

        h = F.relu(self.conv1(pad(x, 2, 2)))
        h = F.relu(self.conv2(pad(h, 2, 1)))
        h = F.relu(self.conv3(pad(h, 2, 2)))
        h = F.relu(self.conv4(pad(h, 2, 1)))
        n, c, hh, t = h.shape  # [N, 128, 4, T]
        h = h.permute(0, 3, 2, 1).reshape(n, t, hh * c)
        h = F.relu(self.proj(h))
        h, _ = self.gru1(h)
        h, _ = self.gru2(h)
        logits = self.head(h)
        return F.log_softmax(logits, dim=-1).permute(1, 0, 2)  # [T, N, C]


def torch_crnn_twin(hidden: int, n_classes: int, seed: int) -> TorchCRNN:
    """A :class:`TorchCRNN` on the CPU with torch's default init under
    ``torch.manual_seed(seed)`` (the global generator is left as it was),
    in evaluation mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return TorchCRNN(hidden, n_classes).eval()
