"""The port's engine end to end against the JAX engine, at full width.

Both engines use the shipped detector (weights/text-detection.npz). Two
recognizers are driven:

  * the shipped ConvCTC (weights/text-recognition.npz) with DEFAULT engine
    parameters on both sides (multigrid post-processing on the device);
  * the CRNN at hidden 192, the JAX package's
    ``RecognitionModel.create(0, arch="crnn")`` carried across with
    ``params_from_jax``, with ``detection_postprocess="host"`` stated on both
    sides. Its weights are random, so the decoded text is nonsense, but it
    is deterministic, and the port must reproduce it exactly.
"""

import dataclasses

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ocrs_tpu.engine import OcrEngine as JaxEngine
from ocrs_tpu.engine import OcrEngineParams as JaxParams
from ocrs_tpu.models.recognition_net import RecognitionModel as JaxRecognitionModel
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.preprocess import DimOrder as JaxDimOrder
from ocrs_tpu.preprocess import ImageSource as JaxImageSource
import ocrs_tpu_torch as ot
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.ops import gru
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parent.parent
DET_WEIGHTS = REPO / "weights" / "text-detection.npz"
REC_WEIGHTS = REPO / "weights" / "text-recognition.npz"
EXPECTED_TEXT = {
    "two-lines.png": "@A]F\ng]F",
    "strip-line.png": "A]A]F]F\n]FAw]\n]F]F",
}


@pytest.fixture(scope="module")
def engines():
    jax_rec = JaxRecognitionModel.create(0, arch="crnn")
    jax_engine = JaxEngine(
        JaxParams(
            detection_model=jax_load_detection_model(DET_WEIGHTS),
            recognition_model=jax_rec,
            detection_postprocess="host",
        )
    )
    port_engine = ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=load_detection_model(DET_WEIGHTS),
            recognition_model=RecognitionModel(jax.device_get(jax_rec.params), "crnn"),
            detection_postprocess="host",
        ),
        device="cpu",
    )
    return jax_engine, port_engine


def _image(name):
    return np.asarray(Image.open(REPO / "test-data" / name).convert("L"))[..., None]


def _corners(rect):
    return np.stack(rect.corners())


def _corner_distance(a, b):
    """Largest coordinate difference between two rects' corners, whichever
    corner each starts from: a rect fitted to four points is the same rect
    with its axes turned by 90 degrees and width and height swapped, and
    which one the calipers return hangs on the last bit of a tie."""
    ca, cb = _corners(a), _corners(b)
    return min(float(np.abs(ca - np.roll(cb, k, axis=0)).max()) for k in range(4))


@pytest.fixture(scope="module")
def default_engines():
    jax_engine = JaxEngine(
        JaxParams(
            detection_model=jax_load_detection_model(DET_WEIGHTS),
            recognition_model=jax_load_recognition_model(REC_WEIGHTS),
        )
    )
    port_engine = ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=load_detection_model(DET_WEIGHTS),
            recognition_model=load_recognition_model(REC_WEIGHTS),
        ),
        device="cpu",
    )
    return jax_engine, port_engine


def test_engine_params_defaults_equal_the_jax_engines():
    def defaults(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            else:
                out[f.name] = type(f.default_factory()).__name__
        return out

    assert defaults(ot.OcrEngineParams) == defaults(JaxParams)
    assert ot.OcrEngineParams().detection_postprocess == "multigrid"
    assert ot.OcrEngineParams().detection_tile_overlap == 64


@pytest.mark.parametrize("name", sorted(EXPECTED_TEXT))
def test_shipped_convctc_with_default_params_matches_jax_engine(default_engines, name):
    jax_engine, port_engine = default_engines
    img = _image(name)
    jin = jax_engine.prepare_input(JaxImageSource.from_tensor(img, JaxDimOrder.HWC))
    pin = port_engine.prepare_input(ot.ImageSource.from_tensor(img, ot.DimOrder.HWC))

    jwords = jax_engine.detect_words(jin)
    pwords = port_engine.detect_words(pin)
    assert len(pwords) == len(jwords) > 0
    for pw, jw in zip(pwords, jwords):
        assert _corner_distance(pw, jw) <= 1.0

    jlines = jax_engine.find_text_lines(jin, jwords)
    plines = port_engine.find_text_lines(pin, pwords)
    jpos = {id(w): i for i, w in enumerate(jwords)}
    ppos = {id(w): i for i, w in enumerate(pwords)}
    assert [[ppos[id(w)] for w in line] for line in plines] == [
        [jpos[id(w)] for w in line] for line in jlines
    ]

    launches = gru.gru_sequence.launches + gru.bigru_sequence.launches
    text = port_engine.get_text(pin)
    assert gru.gru_sequence.launches + gru.bigru_sequence.launches == launches  # no recurrence here
    assert text == jax_engine.get_text(jin) and text.strip()

    as_chars = lambda tl: tl and [(c.char, c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in tl.chars()]
    jrec = jax_engine.recognize_text(jin, jlines)
    prec = port_engine.recognize_text(pin, plines)
    assert len(prec) == len(jrec)
    for p, j in zip(prec, jrec):
        assert (p is None) == (j is None)
        assert as_chars(p) == as_chars(j)  # characters and their rects, exactly


@pytest.mark.parametrize("name", sorted(EXPECTED_TEXT))
def test_get_text_matches_jax_engine(engines, name):
    jax_engine, port_engine = engines
    img = _image(name)
    jin = jax_engine.prepare_input(JaxImageSource.from_tensor(img, JaxDimOrder.HWC))
    pin = port_engine.prepare_input(ot.ImageSource.from_tensor(img, ot.DimOrder.HWC))
    assert pin.image.device.type == "cpu" and tuple(pin.image.shape) == (1,) + img.shape[:2]

    jwords = jax_engine.detect_words(jin)
    pwords = port_engine.detect_words(pin)
    assert len(pwords) == len(jwords) > 0
    for pw, jw in zip(pwords, jwords):
        np.testing.assert_allclose(_corners(pw), _corners(jw), atol=1.0, rtol=0)

    jlines = jax_engine.find_text_lines(jin, jwords)
    plines = port_engine.find_text_lines(pin, pwords)
    jpos = {id(w): i for i, w in enumerate(jwords)}
    ppos = {id(w): i for i, w in enumerate(pwords)}
    assert [[ppos[id(w)] for w in line] for line in plines] == [
        [jpos[id(w)] for w in line] for line in jlines
    ]

    before = gru.gru_sequence.launches
    text = port_engine.get_text(pin)
    assert gru.gru_sequence.launches == before  # the CPU runs the plain version
    assert text == jax_engine.get_text(jin) == EXPECTED_TEXT[name]


def test_char_rects_and_recognition_input_match_jax(engines):
    jax_engine, port_engine = engines
    img = _image("two-lines.png")
    jin = jax_engine.prepare_input(JaxImageSource.from_tensor(img, JaxDimOrder.HWC))
    pin = port_engine.prepare_input(ot.ImageSource.from_tensor(img, ot.DimOrder.HWC))
    jlines = jax_engine.find_text_lines(jin, jax_engine.detect_words(jin))
    plines = port_engine.find_text_lines(pin, port_engine.detect_words(pin))
    jrec = jax_engine.recognize_text(jin, jlines)
    prec = port_engine.recognize_text(pin, plines)
    as_chars = lambda tl: [(c.char, c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in tl.chars()]
    assert [as_chars(t) for t in prec] == [as_chars(t) for t in jrec]
    np.testing.assert_allclose(
        port_engine.prepare_recognition_input(pin, plines[0]),
        jax_engine.prepare_recognition_input(jin, jlines[0]),
        atol=1e-6,
        rtol=0,
    )


def test_detect_text_pixels_and_page_resolution_path_match_jax():
    img = _image("strip-line.png")
    jax_engine = JaxEngine(
        JaxParams(
            detection_model=jax_load_detection_model(DET_WEIGHTS),
            detection_postprocess="host",
            detection_postprocess_resolution="page",
        )
    )
    port_engine = ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=load_detection_model(DET_WEIGHTS),
            detection_postprocess="host",
            detection_postprocess_resolution="page",
        ),
        device="cpu",
    )
    jin = jax_engine.prepare_input(JaxImageSource.from_tensor(img, JaxDimOrder.HWC))
    pin = port_engine.prepare_input(ot.ImageSource.from_tensor(img, ot.DimOrder.HWC))
    probs = port_engine.detect_text_pixels(pin)
    assert tuple(probs.shape) == img.shape[:2]
    # bf16 U-Net, as in test_torch_models.py.
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax_engine.detect_text_pixels(jin)), atol=2e-2, rtol=0)
    jwords = jax_engine.detect_words(jin)
    pwords = port_engine.detect_words(pin)
    assert len(pwords) == len(jwords) > 0
    for pw, jw in zip(pwords, jwords):
        np.testing.assert_allclose(_corners(pw), _corners(jw), atol=1.0, rtol=0)
    assert port_engine.detection_threshold() == jax_engine.detection_threshold() == 0.2


def test_missing_models_raise():
    engine = ot.OcrEngine(device="cpu")
    inp = engine.prepare_input(ot.ImageSource.from_tensor(_image("two-lines.png"), ot.DimOrder.HWC))
    with pytest.raises(ot.ModelNotLoadedError):
        engine.detect_words(inp)
    with pytest.raises(ot.ModelNotLoadedError):
        engine.recognize_text(inp, [])
    assert engine.detection_threshold() == 0.2
