"""The port's training checkpoints against the JAX package's.

A checkpoint is ``step-N.npz`` in the JAX package's flat layout, so it
crosses both ways: one written by ``ocrs_tpu.train.checkpoint`` restores in
the port, one written by the port restores in ``ocrs_tpu``, and one more
step on each side gives equal parameters. The JAX package cannot read back a
chain's state (its ``_unflatten`` turns ``opt_state/1/...`` without an
``opt_state/0`` into a list and fails), so the chain crosses from JAX to the
port, and the port's chain file is held to the JAX file's keys and shapes.
Small CRNNs (hidden 16) on the CPU, in float32; equal means within float32
rounding of the two frameworks' sums (1e-5 in the parameters after a step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.models.weights import load_params as jax_load_params
from ocrs_tpu.train import checkpoint as jckpt
from ocrs_tpu.train import train as jtrain
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import load_flat, load_params, params_from_jax, params_to_jax, save_params
from ocrs_tpu_torch.train import checkpoint as tckpt
from ocrs_tpu_torch.train import optim as toptim
from ocrs_tpu_torch.train import train as ttrain
from tests.test_torch_train_step import N_CLASSES, _jax_state, _leaves, _params, _port_params, _rec_batch, _recipes

PARAM_ATOL = 1e-5


BATCH = _rec_batch(20)


@functools.lru_cache(maxsize=None)
def _jax_f32_step(recipe):
    """A jitted float32 CRNN step of the JAX package on BATCH under `recipe`
    (its own step runs in bf16; float32 keeps the comparison tight), and
    its optax transformation."""
    import optax

    from ocrs_tpu.models import recognition_net as jrec
    from ocrs_tpu.train import losses as jlosses

    jopt = _recipes(recipe)[0]
    images, labels, lengths = map(jnp.asarray, BATCH)

    @jax.jit
    def step(state):
        def loss_fn(p):
            return jlosses.ctc_loss(jrec.apply(p, images, dtype=jnp.float32), labels, lengths)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = jopt.update(grads, state.opt_state, state.params)
        return jtrain.TrainState(optax.apply_updates(state.params, updates), opt_state, state.step + 1), loss

    return step, jopt


def _port_f32_step(state, batch):
    """The port's recognition step with float32 activations."""
    loss = ttrain.recognition_loss(state.model, *batch, dtype=torch.float32)
    return ttrain.apply_gradients(state, loss), loss.detach()


def _port_state(recipe, params):
    return ttrain.init_recognition_state(recipe, n_classes=N_CLASSES, arch="crnn", init_params=params, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    # As tests/test_serve_train.py::test_checkpoint_roundtrip for the JAX package.
    opt = toptim.adam(1e-3)
    state = ttrain.init_recognition_state(opt, n_classes=8, hidden=16, device="cpu")
    step = ttrain.make_recognition_train_step(opt)
    images = np.zeros((2, 1, 64, 32), np.float32)
    labels = np.ones((2, 2), np.int32)
    lengths = np.full((2,), 2, np.int32)
    state, _ = step(state, images, labels, lengths)
    path = tckpt.save_checkpoint(tmp_path, state)
    assert path.name == "step-00000001.npz" and tckpt.latest_checkpoint(tmp_path) == path
    fresh = ttrain.init_recognition_state(opt, n_classes=8, hidden=16, seed=1, device="cpu")
    restored = tckpt.restore_checkpoint(path, fresh)
    assert restored.step == state.step == 1 and restored.optimizer.count == 1
    for k, v in state.model.net.state_dict().items():
        torch.testing.assert_close(restored.model.net.state_dict()[k], v, rtol=0, atol=0)
    state2, loss = step(restored, images, labels, lengths)
    assert np.isfinite(float(loss)) and state2.step == 2


def test_save_keeps_the_newest(tmp_path):
    opt = toptim.adam(1e-3)
    state = ttrain.init_recognition_state(opt, n_classes=8, hidden=16, device="cpu")
    for s in range(5):
        state.optimizer.count = s
        tckpt.save_checkpoint(tmp_path, state, keep=3)
    assert [p.name for p in sorted(tmp_path.glob("step-*.npz"))] == [f"step-{s:08d}.npz" for s in (2, 3, 4)]


def test_restore_refuses_a_step_that_is_not_the_optimizer_count(tmp_path):
    opt = toptim.adam(1e-3)
    state = ttrain.init_recognition_state(opt, n_classes=8, hidden=16, device="cpu")
    state.optimizer.count = 2
    tree = {"params": params_to_jax(state.model.net.state_dict()), "opt_state": state.optimizer.state_tree()}
    save_params(tmp_path / "step-00000003.npz", tree, meta={"step": 3})
    with pytest.raises(ValueError, match="not its optimizer count"):
        tckpt.restore_checkpoint(tmp_path / "step-00000003.npz", state)


@pytest.mark.parametrize("recipe", ["adam", "chain"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, recipe):
    topt = _recipes(recipe)[1]
    step, jopt = _jax_f32_step(recipe)
    jstate, _ = step(_jax_state(_params("crnn", seed=20), jopt))
    path = jckpt.save_checkpoint(tmp_path, jstate)
    state = tckpt.restore_checkpoint(path, _port_state(topt, _params("crnn", seed=21)))
    assert state.step == 1 and state.optimizer.count == 1
    jstate, _ = step(jstate)
    state, _ = _port_f32_step(state, BATCH)
    jp, tp = _leaves(jstate.params), _port_params(state)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_port_checkpoint_restores_in_jax(tmp_path):
    topt = _recipes("adam")[1]
    step, jopt = _jax_f32_step("adam")
    state = _port_state(topt, _params("crnn", seed=22))
    state, _ = _port_f32_step(state, BATCH)
    path = tckpt.save_checkpoint(tmp_path, state)
    like = _jax_state(_params("crnn", seed=23), jopt)
    jstate = jckpt.restore_checkpoint(path, like)
    assert int(jstate.step) == 1
    jstate, _ = step(jstate)
    state, _ = _port_f32_step(state, BATCH)
    jp, tp = _leaves(jstate.params), _port_params(state)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_port_chain_checkpoint_has_the_jax_layout(tmp_path):
    jopt, topt = _recipes("chain")
    params = _params("crnn", seed=24)
    jpath = jckpt.save_checkpoint(tmp_path / "jax", _jax_state(params, jopt))
    tpath = tckpt.save_checkpoint(tmp_path / "port", _port_state(topt, params))
    (jflat, jmeta), (tflat, tmeta) = load_flat(jpath), load_flat(tpath)
    assert jmeta == tmeta == {"step": 0}
    assert sorted(jflat) == sorted(tflat)
    assert {"opt_state/1/0/0", "opt_state/1/2/0"} <= set(tflat)
    for k in jflat:
        assert tflat[k].shape == jflat[k].shape and tflat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


@pytest.mark.parametrize("arch", ["crnn", "convctc"])
def test_params_to_jax_inverts_params_from_jax(arch):
    params = _params(arch, seed=25)
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_exported_model_loads_in_both_packages(tmp_path):
    # The shipped detector (HWIO kernels) and a ConvCTC (depthwise kernels)
    # written by the port load in the JAX package's loader and back here.
    from ocrs_tpu_torch.models.weights import load_detection_model

    det = load_detection_model("weights/text-detection.npz")
    conv = RecognitionModel.create(seed=3, arch="convctc")
    for name, model, meta in (("det", det, {"input_hw": [800, 608]}), ("rec", conv, {"arch": "convctc"})):
        path = tmp_path / f"{name}.npz"
        save_params(path, params_to_jax(model.net.state_dict()), meta=meta)
        jtree, jmeta = jax_load_params(path)
        assert jmeta == meta
        ttree, _ = load_params(path)
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(params_to_jax(model.net.state_dict()))):
            np.testing.assert_array_equal(a, b)
        state = params_from_jax(ttree)
        for k, v in model.net.state_dict().items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=0)
