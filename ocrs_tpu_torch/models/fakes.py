"""Fake models for pipeline-level tests without trained weights.

Port of ``ocrs_tpu.models.fakes``, mirroring upstream's test strategy
(ocrs/src/lib.rs:339-422): the whole pipeline is testable with tiny
deterministic models injected through the
:class:`~ocrs_tpu_torch.models.protocol.Model` seam. They have no parameters.
"""

from __future__ import annotations

import torch
from torch import nn


class FakeDetectionModel(nn.Module):
    """Identity + 0.5 bias "probability map" (lib.rs:344-362).

    Declares a small fixed input so tests are fast; the pipeline pads and
    resizes to this size exactly as it would for a real model."""

    def __init__(self, height: int = 200, width: int = 100):
        super().__init__()
        self._h = height
        self._w = width

    def input_shape(self):
        return ["batch", 1, self._h, self._w]

    def run(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.5


class FakeRecognitionModel(nn.Module):
    """Interprets image rows as class probabilities (lib.rs:372-422).

    Takes ``[N, 1, 64, W]`` and returns ``[W // 4, N, 64]``: max-pools the
    width by 4 (the real model's downsample factor) and permutes so each
    output step's class vector is the corresponding input column."""

    W_SCALE = 4

    def input_shape(self):
        return ["batch", 1, 64, "seq"]

    def run(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        assert c == 1 and h == 64
        w4 = w // self.W_SCALE
        pooled = x[:, 0, :, : w4 * self.W_SCALE].reshape(n, h, w4, self.W_SCALE).amax(dim=-1)
        # [N, H(=classes), W/4] -> [W/4, N, classes]
        return pooled.permute(2, 0, 1)
