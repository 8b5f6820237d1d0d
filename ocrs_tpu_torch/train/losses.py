"""Training losses (port of ``ocrs_tpu.train.losses``).

  * detection: binary cross-entropy + soft Dice over the probability map.
  * recognition: CTC over [T, N, C] log-probabilities with label 0 = blank,
    the mean over the batch of each sequence's loss, as
    ``optax.ctc_loss(...).mean()`` gives it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def detection_loss(probs: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """BCE + soft-Dice loss. `probs` and `target` are [N, 1, H, W] in [0, 1];
    `probs` is clipped to [eps, 1 - eps] first. Float32 scalar."""
    p = probs.to(torch.float32).clamp(eps, 1.0 - eps)
    t = target.to(torch.float32)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()
    inter = (p * t).sum(dim=(1, 2, 3))
    denom = p.sum(dim=(1, 2, 3)) + t.sum(dim=(1, 2, 3))
    dice = 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()
    return bce + dice


def ctc_loss(
    logprobs_tnc: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    logit_lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean CTC loss.

    `logprobs_tnc`: [T, N, C] log-probabilities (the recognizers' output).
    `labels`: [N, L] integers, class 0 = blank used as padding.
    `label_lengths`: [N]. `logit_lengths`: [N] or None (= all T).

    Each sequence's negative log-likelihood (``F.ctc_loss`` with
    ``reduction="none"``; PyTorch's ``"mean"`` would divide each by its label
    length), then the mean over the batch. A label that needs more frames
    than it has (``2 * L + 1`` with repeats) has no alignment: its loss is
    ``inf`` here, where optax returns a large finite value; the batches this
    package makes keep ``T = W / 4 >= 2 * L + 1``. The loss is float32
    (float64 for float64 log-probs).

    The gradient PyTorch gives the log-probs is that of the logits before a
    ``log_softmax`` (``softmax - posterior``); through the recognizers' own
    ``log_softmax`` the parameters' gradients are the true ones."""
    t, n, c = logprobs_tnc.shape
    device = logprobs_tnc.device
    if not (isinstance(labels, torch.Tensor) and labels.is_cuda):
        # F.ctc_loss does not check its targets on the CPU, and a class past
        # the last writes out of bounds there: refuse it (host labels only;
        # a check of labels on the card would wait for it).
        host = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels)
        if host.size and (host.min() < 0 or host.max() >= c):
            raise ValueError(f"CTC labels must lie in [0, {c}): got {host.min()} to {host.max()}")
    if logit_lengths is None:
        logit_lengths = torch.full((n,), t, dtype=torch.long)
    per_seq = F.ctc_loss(
        logprobs_tnc.to(torch.promote_types(torch.float32, logprobs_tnc.dtype)),
        torch.as_tensor(labels, device=device).long(),
        torch.as_tensor(logit_lengths, device=device).long(),
        torch.as_tensor(label_lengths, device=device).long(),
        blank=0,
        reduction="none",
    )
    return per_seq.mean()
