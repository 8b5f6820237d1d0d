"""The port's models (ocrs_tpu_torch.models) against the JAX package's, with
the same weights carried across by params_from_jax."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ocrs_tpu.detection import _pre as jax_pre
from ocrs_tpu.models import nn as jnn
from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_params as jax_load_params
from ocrs_tpu.preprocess import DimOrder, ImageSource, prepare_image
from ocrs_tpu_torch.models import nn as tnn
from ocrs_tpu_torch.models import protocol
from ocrs_tpu_torch.models.recognition_net import CRNN, RecognitionModel
from ocrs_tpu_torch.models.weights import (
    load_detection_model,
    load_params,
    load_recognition_model,
    params_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
DET_WEIGHTS = REPO / "weights" / "text-detection.npz"

# U-Net in bf16: every conv rounds its output to bf16 (2**-8 relative), and
# the two frameworks sum in different orders, so single-ulp flips in the
# activations reach the sigmoid. Measured max |diff| ~1.3e-3 on this page;
# the bound leaves room for other BLAS builds.
UNET_ATOL = 2e-2
# CRNN in float32: same math, different summation order in convs, matmuls and
# the 2 x 2 GRU recurrences.
CRNN_F32_ATOL = 1e-4
# CRNN in bf16: activations are rounded to bf16 after every layer (8 bits of
# mantissa), so one-ulp flips early move the log-probs. Measured max |diff|
# 8.1e-3 at hidden 16 and 8.7e-3 at hidden 192 on these inputs.
CRNN_BF16_ATOL = 5e-2


def _jax_crnn_params(hidden, seed=0):
    return jax.device_get(jrec.init_params(jax.random.key(seed), 97, hidden))


def test_unet_probabilities_match_jax_on_shipped_weights():
    img = np.asarray(Image.open(REPO / "test-data" / "two-lines.png").convert("L"))[..., None]
    page = prepare_image(ImageSource.from_tensor(img, DimOrder.HWC))
    x = np.array(jax_pre(page, input_hw=(800, 608), pads=(800 - 240, 608 - 320)))
    want = np.asarray(jax_load_detection_model(DET_WEIGHTS).run(jnp.asarray(x)))

    model = load_detection_model(DET_WEIGHTS)
    assert model.input_shape() == ["batch", 1, 800, 608]
    got = model.run(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1, 800, 608)
    np.testing.assert_allclose(got.numpy(), want, atol=UNET_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crnn_logprobs_match_jax(dtype):
    params = _jax_crnn_params(hidden=16)
    x = np.random.default_rng(0).random((2, 1, 64, 96), dtype=np.float32) - 0.5
    want = np.asarray(jrec.apply(params, jnp.asarray(x), dtype=getattr(jnp, dtype)))

    model = RecognitionModel(params, "crnn")
    got = model.run(torch.from_numpy(x), dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 2, 97)
    atol = CRNN_F32_ATOL if dtype == "float32" else CRNN_BF16_ATOL
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("size,stride", [(8, 2), (9, 2), (7, 1), (10, 1)])
def test_conv_same_padding_matches_xla(size, stride):
    # XLA "SAME" at stride 2 pads (0, 1) on even sizes; PyTorch's
    # padding="same" cannot express it, so the port pads explicitly.
    rng = np.random.default_rng(size)
    w = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((1, size, size + 1, 2)).astype(np.float32)
    want = np.asarray(jnn.conv_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=(stride, 2)))
    conv = tnn.Conv2d(2, 4, stride=(stride, 2))
    conv.load_state_dict(params_from_jax({"w": w, "b": b}))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def test_same_pads_stride_two_is_asymmetric():
    assert tnn.same_pads(8, 3, 2) == (0, 1)
    assert tnn.same_pads(9, 3, 2) == (1, 1)
    assert tnn.same_pads(8, 3, 1) == (1, 1)
    assert tnn.same_pads(8, 1, 1) == (0, 0)


def test_params_from_jax_layouts_and_round_trip(tmp_path):
    params = _jax_crnn_params(hidden=16, seed=3)
    state = params_from_jax(params)
    # HWIO -> OIHW; dense [in, out] and GRU [C, 3H] / [H, 3H] kept as they are.
    np.testing.assert_array_equal(state["conv2.w"].numpy(), np.transpose(params["conv2"]["w"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(state["proj.w"].numpy(), params["proj"]["w"])
    np.testing.assert_array_equal(state["gru1.bwd.wh"].numpy(), params["gru1"]["bwd"]["wh"])
    np.testing.assert_array_equal(state["gru2.fwd.wx"].numpy(), params["gru2"]["fwd"]["wx"])
    # The module's own state dict has the same keys and shapes.
    net = CRNN(97, 16)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state.items()
    }
    # A flat "/"-keyed mapping (the .npz layout) gives the same state.
    from ocrs_tpu.models.weights import _flatten, save_params

    flat_state = params_from_jax(_flatten(params))
    assert flat_state.keys() == state.keys()
    assert all(torch.equal(flat_state[k], state[k]) for k in state)
    # And a weight file written by the JAX package loads with its meta.
    path = tmp_path / "crnn.npz"
    save_params(path, params, {"arch": "crnn"})
    loaded, meta = load_params(path)
    assert meta == {"arch": "crnn"}
    assert all(torch.equal(params_from_jax(loaded)[k], state[k]) for k in state)
    model = load_recognition_model(path)
    assert all(torch.equal(model.net.state_dict()[k], state[k]) for k in state)


def test_detection_weight_file_loads_like_jax():
    tree, meta = load_params(DET_WEIGHTS)
    jtree, jmeta = jax_load_params(DET_WEIGHTS)
    assert meta == jmeta
    assert len(jax.tree.leaves(tree)) == len(jax.tree.leaves(jtree))
    model = load_detection_model(DET_WEIGHTS)
    assert protocol.fixed_hw(model.input_shape()) == tuple(meta.get("input_hw", (800, 608)))


def test_recognition_model_create_is_seeded_and_convctc_is_refused():
    a, b = RecognitionModel.create(5, hidden=16), RecognitionModel.create(5, hidden=16)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.input_shape() == ["batch", 1, 64, "seq"]
    # ConvCTC is no longer refused: it builds, at its own width.
    assert RecognitionModel.create(0, arch="convctc").arch == "convctc"
    with pytest.raises(ValueError):
        RecognitionModel.create(0, arch="lstm")


def test_protocol_helpers():
    assert protocol.fixed_hw(["batch", 1, 800, 608]) == (800, 608)
    with pytest.raises(ValueError):
        protocol.fixed_hw(["batch", 1, "h", 608])
    assert protocol.fixed_height_or(["batch", 1, 64, "seq"]) == 64
    assert protocol.fixed_height_or(["batch", 1, "h", "seq"], default=50) == 50
