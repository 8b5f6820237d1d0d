"""The port's ConvCTC recognizer against the JAX package's, layer by layer and
as a whole, with the same weights carried across by params_from_jax.

``recognition_net.conv_apply`` has no float32 mode, so the float32 reference
of the whole network is composed here from the JAX pieces, which all follow
the dtype of their input.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.models import nn as jnn
from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.train.pixelfont import render_pixel_line
from ocrs_tpu_torch.models import nn as tnn
from ocrs_tpu_torch.models import recognition_net as trec
from ocrs_tpu_torch.models.weights import load_recognition_model, params_from_jax

REPO = Path(__file__).resolve().parent.parent
REC_WEIGHTS = REPO / "weights" / "text-recognition.npz"

# Float32 on both sides: the same math, sums taken in another order.
F32_ATOL = 1e-4
# bf16 end to end: every layer rounds its output to 8 bits of mantissa, the two
# frameworks sum in different orders, and a flipped rounding early moves
# everything after it. The bound is on the winning class's log-prob, which is
# what decoding reads; log-probs of unlikely classes are tens of nats below
# zero, where one bf16 ulp of a logit is 0.125-0.25. Measured on the CPU:
# 0.029 (created weights) and 0.019 (shipped weights) for the winner, 0.051
# and 0.47 over all classes.
BF16_TOP_ATOL = 0.15
BF16_ALL_ATOL = 1.0


def _jax_params(dim, seed=0):
    return jax.device_get(jrec.conv_init_params(jax.random.key(seed), 97, dim=dim))


def _jax_forward(params, x, dtype=jnp.float32):
    """conv_apply composed from its pieces at `dtype`."""
    h = jnp.transpose(x, (0, 2, 3, 1)).astype(dtype)
    for name, stride in (("conv1", (2, 2)), ("conv2", (2, 1)), ("conv3", (2, 2)), ("conv4", (2, 1))):
        h = jax.nn.relu(jnn.conv_apply(params[name], h, stride=stride))
    n, hh, t, c = h.shape
    h = jnp.transpose(h, (0, 2, 1, 3)).reshape(n, t, hh * c)
    h = jnn.dense_apply(params["proj"], h)
    for block, dilation in zip(params["blocks"], jrec.CONV_BLOCKS):
        h = h + _jax_block(block, h, dilation)
    h = jrec._ln_apply(params["ln_out"], h)
    logits = jnn.dense_apply(params["head"], h).astype(jnp.float32)
    return jnp.transpose(jax.nn.log_softmax(logits, axis=-1), (1, 0, 2))


def _jax_block(block, h, dilation):
    y = jrec._ln_apply(block["ln"], jrec._dwconv_apply(block["dw"], h, dilation))
    return jnn.dense_apply(block["ff2"], jax.nn.gelu(jnn.dense_apply(block["ff1"], y)))


def _text_line_crop(text="Hello World 42", width=512):
    """A rendered text line as the recognizer sees it: [1, 1, 64, width] in
    [-0.5, 0.5], dark ink on a light page, BLACK padding on the right."""
    ink, _ = render_pixel_line(text, 5.6, weight=1)
    rows = np.flatnonzero(ink.any(axis=1))
    ink = ink[rows[0] : rows[-1] + 1]  # tight to the ink, as a detected line is
    h, w = ink.shape
    top = (64 - h) // 2
    crop = np.full((64, width), -0.5, dtype=np.float32)
    crop[:, :w] = 0.5
    crop[top : top + h, :w] -= ink
    return crop[None, None]


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_depthwise_conv_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    p = {"w": rng.standard_normal((9, 1, 12)).astype(np.float32), "b": rng.standard_normal(12).astype(np.float32)}
    x = rng.standard_normal((2, 23, 12)).astype(np.float32)
    want = np.asarray(jrec._dwconv_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), dilation))
    layer = tnn.DepthwiseConv1d(12, 9)
    state = params_from_jax({"dw": p})
    layer.load_state_dict({"w": state["dw.w"], "b": state["dw.b"]})
    got = layer(torch.from_numpy(x), dilation)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(7)
    p = {"g": rng.standard_normal(16).astype(np.float32), "b": rng.standard_normal(16).astype(np.float32)}
    x = (3.0 * rng.standard_normal((2, 5, 16)) + 1.0).astype(np.float32)
    want = jrec._ln_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(getattr(jnp, dtype)))
    layer = tnn.LayerNorm(16)
    layer.load_state_dict(params_from_jax(p))
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # Float32 inside on both sides, then one rounding to the activation dtype:
    # at most one bf16 ulp apart (2**-8 relative) where a float32 sum differs.
    atol = F32_ATOL if dtype == "float32" else 2.0**-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=atol, rtol=0)


@pytest.mark.parametrize("dilation", [1, 4])
def test_block_matches_jax_in_float32(dilation):
    params = _jax_params(dim=24, seed=2)
    block = params["blocks"][1]
    # Biases and the LayerNorm shift are zero at init: make them count.
    rng = np.random.default_rng(3)
    block = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), block)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    want = np.asarray(_jax_block(jax.tree.map(jnp.asarray, block), jnp.asarray(x), dilation))
    layer = trec.ConvBlock(24)
    layer.load_state_dict(params_from_jax(block))
    np.testing.assert_allclose(layer(torch.from_numpy(x), dilation).numpy(), want, atol=F32_ATOL, rtol=0)


def test_network_matches_jax_in_float32():
    params = _jax_params(dim=32)
    x = np.random.default_rng(0).random((2, 1, 64, 96), dtype=np.float32) - 0.5
    want = np.asarray(_jax_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    model = trec.RecognitionModel(params, "convctc")
    got = model.run(torch.from_numpy(x), dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 2, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def _check_bf16(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.max(-1), want.max(-1), atol=BF16_TOP_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=BF16_ALL_ATOL, rtol=0)
    # The labels agree wherever the reference's winner leads by more than the
    # two runs can differ.
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_TOP_ATOL
    assert clear.any()
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()
    return int((got.argmax(-1) != want.argmax(-1)).sum())


def test_network_matches_jax_in_bf16_with_created_weights():
    jax_model = jrec.RecognitionModel.create(0, arch="convctc")
    model = trec.RecognitionModel(jax.device_get(jax_model.params), "convctc")
    assert model.net.proj.w.shape == (4 * 192, trec.CONV_DIM) and len(model.net.blocks) == 5
    x = _text_line_crop()
    want = np.asarray(jax_model.run(jnp.asarray(x)))
    got = model.run(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (128, 1, 97)
    _check_bf16(got.numpy(), want)


def test_shipped_recognizer_loads_and_matches_jax():
    jax_model = jax_load_recognition_model(REC_WEIGHTS)
    model = load_recognition_model(REC_WEIGHTS)
    assert model.arch == jax_model.arch == "convctc"
    assert model.net.head.w.shape == (384, 97) and len(model.net.blocks) == 5
    assert model.input_shape() == ["batch", 1, 64, "seq"]
    x = _text_line_crop("Hello World 42")
    want = np.asarray(jax_model.run(jnp.asarray(x)))
    got = model.run(torch.from_numpy(x)).numpy()
    # Real weights on a real line: every frame decodes to the same label.
    assert _check_bf16(got, want) == 0
    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.ops.ctc import collapse_greedy

    text = "".join(DEFAULT_ALPHABET[s.label - 1] for s in collapse_greedy(got.argmax(-1)[:, 0]))
    assert text.startswith("Hello") and text.endswith("42")


def test_params_from_jax_maps_every_convctc_leaf():
    params = _jax_params(dim=16, seed=4)
    state = params_from_jax(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(state) == 12 + 8 * 5 + 2
    for path, leaf in leaves:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        got = state[key].numpy()
        if key.endswith("dw.w"):  # [k, 1, dim] -> [dim, 1, k]
            want = np.transpose(leaf, (2, 1, 0))
        elif leaf.ndim == 4:  # HWIO -> OIHW
            want = np.transpose(leaf, (3, 2, 0, 1))
        else:  # dense [in, out], biases, LayerNorm g/b
            want = leaf
        np.testing.assert_array_equal(got, want, err_msg=key)
    net = trec.ConvCTC(97, 16)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state.items()
    }
    # A tree that went through a weight file (list level "blocks/0..4") maps alike.
    from ocrs_tpu.models.weights import _flatten

    flat_state = params_from_jax(_flatten(params))
    assert flat_state.keys() == state.keys()
    assert all(torch.equal(flat_state[k], state[k]) for k in state)


def test_create_convctc_is_seeded_and_the_default_arch():
    assert trec.DEFAULT_ARCH == jrec.DEFAULT_ARCH == "convctc"
    assert set(trec.ARCHS) == set(jrec.ARCHS)
    a, b = (trec.RecognitionModel.create(5, arch="convctc") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.net.proj.w.shape[1] == trec.CONV_DIM == jrec.CONV_DIM
    assert trec.CONV_BLOCKS == jrec.CONV_BLOCKS and trec.CONV_KERNEL == jrec.CONV_KERNEL
    # He-style init as in the JAX package: std sqrt(2 / k) over the taps.
    assert abs(float(a.net.blocks[0].dw.w.std()) - (2.0 / 9) ** 0.5) < 0.02
    assert float(a.net.blocks[0].ln.g.min()) == 1.0 and float(a.net.head.b.abs().max()) == 0.0
