"""The port's training losses (ocrs_tpu_torch.train.losses) against the JAX
package's (ocrs_tpu.train.losses): values, and gradients with respect to
the probability map (detection) and to pre-softmax logits (CTC).

PyTorch's CTC gradient with respect to its log-prob input is that of the
logits before a log_softmax (softmax minus the posterior), not the true
partial derivative, so the CTC gradients are taken through a log_softmax of
logits on both sides, as the recognizers compute them. Float32 on both
sides; the sums run in other orders: 1e-5 relative (CTC's forward-backward
over 16 frames: 1e-4 for its gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.train import losses as jlosses
from ocrs_tpu_torch.train import losses as tlosses


def _det_inputs(seed):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.0, 1.0, size=(3, 1, 12, 10)).astype(np.float32)
    probs[0, 0, 0, :3] = [0.0, 1.0, 1e-9]  # clipped to [eps, 1 - eps]
    target = (rng.uniform(size=probs.shape) < 0.3).astype(np.float32)
    return probs, target


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_gradient_match_jax(seed):
    probs, target = _det_inputs(seed)
    want, want_grad = jax.value_and_grad(jlosses.detection_loss)(jnp.asarray(probs), jnp.asarray(target))
    p = torch.from_numpy(probs).requires_grad_()
    got = tlosses.detection_loss(p, torch.from_numpy(target))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-9)


def _ctc_inputs(seed, t=16, n=4, c=9, l=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(t, n, c)).astype(np.float32) * 2.0
    lengths = rng.integers(1, l + 1, size=n).astype(np.int32)
    lengths[0] = l
    labels = np.zeros((n, l), np.int32)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.integers(1, c, size=k)
    labels[0, 1] = labels[0, 0]  # a repeat needs a blank between
    return logits, labels, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frames", [None, "ragged"])
def test_ctc_loss_and_logit_gradient_match_jax(seed, frames):
    logits, labels, lengths = _ctc_inputs(seed)
    logit_lengths = None if frames is None else np.array([16, 13, 11, 16], np.int32)

    def jloss(lg):
        ll = None if logit_lengths is None else jnp.asarray(logit_lengths)
        return jlosses.ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(labels), jnp.asarray(lengths), ll)

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    ll = None if logit_lengths is None else torch.from_numpy(logit_lengths)
    got = tlosses.ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(labels), torch.from_numpy(lengths), ll)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)


def test_ctc_loss_is_the_batch_mean_of_per_sequence_losses():
    # Not PyTorch's "mean", which divides each sequence's loss by its label length.
    logits, labels, lengths = _ctc_inputs(3)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    per_seq = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels).long(), torch.full((4,), 16), torch.from_numpy(lengths).long(), reduction="none"
    )
    got = tlosses.ctc_loss(lp, torch.from_numpy(labels), torch.from_numpy(lengths))
    assert float(got) == pytest.approx(float(per_seq.mean()), rel=1e-6)
    assert float(got) != pytest.approx(float((per_seq / torch.from_numpy(lengths)).mean()), rel=1e-3)


def test_ctc_loss_without_an_alignment_is_infinite():
    # Two frames cannot hold three labels: optax gives a large finite value,
    # PyTorch inf (documented in ctc_loss).
    lp = torch.log_softmax(torch.zeros(2, 1, 4), -1)
    assert torch.isinf(tlosses.ctc_loss(lp, torch.tensor([[1, 2, 3]]), torch.tensor([3])))


@pytest.mark.parametrize("bad", [4, 97, -1])
def test_ctc_loss_refuses_labels_outside_the_classes(bad):
    # F.ctc_loss does not check its targets on the CPU and writes out of
    # bounds for a class past the last (a 97-class batch on a 24-class head
    # corrupted the heap): the port refuses host labels outside [0, C).
    lp = torch.log_softmax(torch.zeros(8, 2, 4), -1)
    labels = np.array([[1, 2, 0], [3, bad, 1]], np.int32)
    with pytest.raises(ValueError, match="labels must lie in"):
        tlosses.ctc_loss(lp, labels, np.array([2, 3]))
    with pytest.raises(ValueError, match="labels must lie in"):
        tlosses.ctc_loss(lp, torch.from_numpy(labels), torch.tensor([2, 3]))
    assert torch.isfinite(tlosses.ctc_loss(lp, np.array([[1, 2, 0], [3, 3, 1]]), np.array([2, 3])))
