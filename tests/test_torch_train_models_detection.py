"""The port's trainer against tools/train_models.py for the detector: a
narrow U-Net (channels 4-8, the default's five levels) warm-started from one
``--init-from`` file, both scripts reading one cache of 8 pages at batch 8.
Both scripts train at the detector's input size (800 x 608); here it is set
to 160 x 128 in both (the module constant each reads), which keeps the JAX
side's CPU step to seconds. Exactly:
the batches and the exported file's keys, shapes, dtypes and meta; by the
bf16 criteria of tests/test_torch_train_step.py: the step-1 loss and the
parameters after 2 steps. The update directions are held on the kernels;
a bias's gradient is a sum over every position of its level, which XLA on
the CPU takes in bf16 and PyTorch in float32 (tests/test_torch_train_detection.py),
so the biases are held by the parameter bound alone."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ocrs_tpu.models import detection_net as jdet
from ocrs_tpu.train import losses as jlosses
from ocrs_tpu_torch.models.detection_net import DetectionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_params, params_to_jax
from ocrs_tpu_torch.train import optim
from ocrs_tpu_torch.train import train as ttrain
from ocrs_tpu_torch.train import train_models
from ocrs_tpu_torch.train.data import DetectionDataset
from tests.test_torch_train_models import (  # noqa: F401
    LR,
    cheap_jax_init,
    check_batches,
    check_export,
    check_two_steps,
    run_both,
)
from tests.test_torch_train_step import _leaves, _port_grads

NARROW_UNET = (4, 8, 8, 8, 8)
HW = (160, 128)


def test_detection_scripts_agree(tmp_path, capsys, cheap_jax_init, monkeypatch):
    monkeypatch.setattr(jdet, "DEFAULT_INPUT_HW", HW)
    monkeypatch.setattr(train_models, "DEFAULT_INPUT_HW", HW)
    cache = tmp_path / "det.npz"
    DetectionDataset(8, page_hw=HW, seed=0, cache_path=cache)
    model = DetectionModel(None, channels=NARROW_UNET, generator=torch.Generator().manual_seed(5))
    out, record = run_both(tmp_path, capsys, ["detection"], params_to_jax(model.net.state_dict()), {}, cache)
    check_export(out, "detection")
    assert out["port"][1]["input_hw"] == list(HW)
    assert len(record["losses"]) == 2 and np.all(np.isfinite(record["losses"]))
    batches = check_batches(cache, "detection", page_hw=HW)
    params = load_params(tmp_path / "init.npz")[0]

    def jloss(p, images, targets):
        x = images.astype(jnp.float32) / 255.0 - 0.5
        return jlosses.detection_loss(jdet.apply(p, x), targets.astype(jnp.float32))

    grad = jax.jit(jax.grad(jloss))
    p = jax.tree.map(jnp.asarray, params)
    jgrads = [_leaves(grad(p, jnp.asarray(i), jnp.asarray(t))) for i, t in batches]
    state = ttrain.init_detection_state(optim.adam(LR), init_params=params, device="cpu")
    tgrads = [_port_grads(state, ttrain.detection_loss_of(state.model, i, t)) for i, t in batches]
    p0 = _leaves(params)
    check_two_steps(out, p0, jgrads, tgrads, [k for k in p0 if k.endswith("['w']")])
    assert load_detection_model(tmp_path / "port.npz").net.stem.w.shape[0] == NARROW_UNET[0]
