"""The port's detection train step and optimizer recipes against the JAX
package's (ocrs_tpu.train, optax).

A narrow U-Net (channels 4-8, the default's five levels) on 64 x 64 uint8
pages made with numpy from a seed, from the same parameters in both
packages (drawn by the port's init, written out with params_to_jax, carried
back by params_from_jax), two updates under ``adam(1e-3)`` and under
``tools/train_models.py``'s chain; the JAX side is its jitted
``make_detection_train_step``, on the CPU. Both U-Nets compute in bf16
only, so the bounds are bf16's (see tests/test_torch_train_step.py): loss
1e-2 relative, gradients 0.1 by relative norm, parameters within
2 * lr + 1e-6 per update, and each update's direction where the JAX
gradient is clear of bf16 noise. A bias's gradient is a sum over every
position of its level: XLA on the CPU takes that sum in bf16 and PyTorch
accumulates it in float32. At the two decoder levels of 32 x 32 and
64 x 64 and at the head (2,048 to 8,192 positions) the two differ by 0.92,
2.00 and 2.15 of their norm (the weights' by at most 2.4e-3, the other
biases' by at most 5.7e-2), so those three biases are held by the
parameter bound alone (NOISY_BIAS_SUMS).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocrs_tpu.models import detection_net as jdet
from ocrs_tpu.train import losses as jlosses
from ocrs_tpu.train import train as jtrain
from ocrs_tpu_torch.models.detection_net import DetectionModel
from ocrs_tpu_torch.train import optim as toptim
from ocrs_tpu_torch.train import train as ttrain
from tests.test_torch_train_step import (
    BF16_GRAD_RTOL,
    BF16_LOSS_RTOL,
    BF16_PARAM_ATOL,
    LR,
    _jax_state,
    _leaves,
    _port_grads,
    _port_params,
    _recipes,
    _relnorm,
    _schedule,
    assert_updates_follow_jax,
)
from ocrs_tpu_torch.models.weights import params_to_jax

NARROW_UNET = (4, 8, 8, 8, 8)
# Biases whose gradient XLA sums in bf16 over 2,048 (decoder[2]) or 8,192
# positions (decoder[3], head): not comparable with a float32 sum.
NOISY_BIAS_SUMS = ("['decoder'][2]['conv']['b']", "['decoder'][3]['conv']['b']", "['head']['b']")


def _unet_params(seed):
    model = DetectionModel(None, channels=NARROW_UNET, generator=torch.Generator().manual_seed(seed))
    tree = params_to_jax(model.net.state_dict())
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + (0.05 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim == 1 else a, tree)


def _det_batch(seed=3, n=2, hw=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, 1, hw, hw), dtype=np.uint8)
    targets = np.zeros((n, 1, hw, hw), np.uint8)
    targets[:, :, 20:30, 8:50] = 1
    targets[1, :, 40:48, 16:40] = 1
    return images, targets


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """The JAX package's bf16 gradients at the test's parameters and batch
    (the same for every recipe)."""
    images, targets = _det_batch()

    def jloss_fn(p):
        x = jnp.asarray(images).astype(jnp.float32) / 255.0 - 0.5
        return jlosses.detection_loss(jdet.apply(p, x), jnp.asarray(targets).astype(jnp.float32))

    return _leaves(jax.jit(jax.grad(jloss_fn))(jax.tree.map(jnp.asarray, _unet_params(4))))


@pytest.mark.parametrize("recipe", ["adam", "chain"])
def test_detection_bf16_steps_match_jax_train_step(recipe):
    images, targets = _det_batch()
    jopt, topt = _recipes(recipe)
    params = _unet_params(4)
    mesh = jtrain.make_mesh(1)
    jgrads = _jax_grads()
    with mesh:
        jstate = _jax_state(params, jopt)
        jstep = jtrain.make_detection_train_step(mesh, jopt)
        jlosses_ = []
        for _ in range(2):
            jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(targets))
            jlosses_.append(float(jloss))
        jp = _leaves(jstate.params)
    state = ttrain.init_detection_state(topt, init_params=params, device="cpu")
    tgrads = _port_grads(state, ttrain.detection_loss_of(state.model, images, targets))
    step = ttrain.make_detection_train_step(topt)
    tlosses = []
    for _ in range(2):
        state, loss = step(state, images, targets)
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses_, rtol=BF16_LOSS_RTOL)
    tp = _port_params(state)
    assert set(tp) == set(jp) == set(jgrads)
    held = [k for k in jgrads if k not in NOISY_BIAS_SUMS]
    for k in jgrads:
        if k in held:
            assert _relnorm(tgrads[k], jgrads[k]) <= BF16_GRAD_RTOL, k
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2 * BF16_PARAM_ATOL, err_msg=k)
    # The learning rates of the two updates: adam's, or the schedule's at
    # counts 0 and 1.
    lr_total = 2 * LR if recipe == "adam" else _schedule(toptim)(0) + _schedule(toptim)(1)
    assert_updates_follow_jax(_leaves(params), tp, jp, jgrads, tgrads, lr_total, held)


def test_detection_two_steps_lower_the_loss_on_a_fixed_batch():
    opt = toptim.adam(1e-3)
    images, targets = _det_batch(5)
    state = ttrain.init_detection_state(opt, init_params=_unet_params(5), device="cpu")
    step = ttrain.make_detection_train_step(opt)
    state, loss1 = step(state, images, targets)
    state, loss2 = step(state, images, targets)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)


def test_detection_init_refuses_another_tree():
    params = _unet_params(6)
    del params["decoder"][0]
    with pytest.raises(ValueError, match="init_params tree mismatch"):
        ttrain.init_detection_state(toptim.adam(LR), init_params=params, device="cpu")


def test_schedule_and_clip_match_optax():
    jsched, tsched = _schedule(optax), _schedule(toptim)
    counts = [0, 1, 2, 3, 5, 10, 11, 20]
    np.testing.assert_allclose([tsched(c) for c in counts], [float(jsched(c)) for c in counts], rtol=1e-6, atol=1e-12)
    assert tsched(0) == 0.0
    rng = np.random.default_rng(6)
    for scale in (0.1, 10.0):
        grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        toptim.clip_grads_by_global_norm_(got, 1.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert toptim.adamw(LR).weight_decay == 1e-4
    with pytest.raises(ValueError, match="chain takes"):
        toptim.chain(toptim.adam(LR), toptim.clip_by_global_norm(1.0))


