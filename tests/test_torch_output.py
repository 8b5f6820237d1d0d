"""The port's output formatters (ocrs_tpu_torch/output.py) against the JAX
package's (ocrs_tpu/output.py) on the same lines.

Strings must be equal. The annotated image is drawn with numpy in the port
and with Pillow in the JAX package; the tolerance is stated at
:func:`_drawn_within`.
"""

import json

import numpy as np
import pytest
from scipy import ndimage

from ocrs_tpu import output as jout
from ocrs_tpu.engine import OcrEngine as JaxEngine
from ocrs_tpu.engine import OcrEngineParams as JaxParams
from ocrs_tpu.geometry import Rect as JaxRect
from ocrs_tpu.geometry import RotatedRect as JaxRotatedRect
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.preprocess import DimOrder as JaxDimOrder
from ocrs_tpu.preprocess import ImageSource as JaxImageSource
from ocrs_tpu.text_items import TextChar as JaxTextChar
from ocrs_tpu.text_items import TextLine as JaxTextLine
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import output as tout
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from test_torch_support import (
    DET_WEIGHTS,
    REC_WEIGHTS,
    assert_same_ocr_json,
    jax_native,  # noqa: F401 - a fixture, used by pytestmark
    text_page_rgb,
    to_port_rrects,
    to_port_text_lines,
)

# The JAX engine's layout and CTC collapse take its native library.
pytestmark = pytest.mark.usefixtures("jax_native")


def _jax_lines(texts, char_w=10):
    """JAX text lines of `char_w` px wide chars, 30 px apart, as in the
    reference's format-json fixture (output.rs:216-234); None stays None."""
    out = []
    for i, text in enumerate(texts):
        if text is None:
            out.append(None)
            continue
        chars = [JaxTextChar(c, JaxRect.from_tlhw(30 * i, k * char_w, 25, char_w)) for k, c in enumerate(text)]
        out.append(JaxTextLine(chars))
    return out


@pytest.fixture(scope="module")
def engines_on_text_page():
    """Both engines' words by line and text lines on the text page."""
    page = text_page_rgb()
    jeng = JaxEngine(
        JaxParams(
            detection_model=jax_load_detection_model(DET_WEIGHTS),
            recognition_model=jax_load_recognition_model(REC_WEIGHTS),
        )
    )
    jin = jeng.prepare_input(JaxImageSource.from_tensor(page, JaxDimOrder.HWC))
    jlines = jeng.find_text_lines(jin, jeng.detect_words(jin))
    teng = ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=load_detection_model(DET_WEIGHTS), recognition_model=load_recognition_model(REC_WEIGHTS)
        ),
        device="cpu",
    )
    tin = teng.prepare_input(ot.ImageSource.from_tensor(page, ot.DimOrder.HWC))
    tlines = teng.find_text_lines(tin, teng.detect_words(tin))
    return page, (jlines, jeng.recognize_text(jin, jlines)), (tlines, teng.recognize_text(tin, tlines))


def test_format_text_and_json_equal_jax_on_the_same_lines():
    jlines = _jax_lines(["line one", None, "line two", "a  b"])
    tlines = to_port_text_lines(jlines)
    assert tout.format_text_output(tlines) == jout.format_text_output(jlines) == "line one\nline two\na  b"
    for path, hw in (("image.jpeg", (256, 256)), (None, (30, 500))):
        want = jout.format_json_output(jout.FormatJsonArgs(input_path=path, input_hw=hw, text_lines=jlines))
        got = tout.format_json_output(tout.FormatJsonArgs(input_path=path, input_hw=hw, text_lines=tlines))
        assert got == want
    doc = json.loads(got)
    assert [l["text"] for l in doc["paragraphs"][0]["lines"]] == ["line one", "line two", "a  b"]
    assert doc["paragraphs"][0]["lines"][1]["vertices"] == [[80, 85], [0, 85], [0, 60], [80, 60]]
    assert tout.format_text_output([]) == "" and json.loads(
        tout.format_json_output(tout.FormatJsonArgs("x", (1, 2), []))
    )["paragraphs"] == [{"lines": []}]


def test_format_json_of_both_engines_on_the_text_page(engines_on_text_page):
    page, (_, jtext), (_, ttext) = engines_on_text_page
    args = dict(input_path="page.png", input_hw=page.shape[:2])
    want = jout.format_json_output(jout.FormatJsonArgs(text_lines=jtext, **args))
    # The JAX engine's lines through the port's formatter: the same string.
    assert tout.format_json_output(tout.FormatJsonArgs(text_lines=to_port_text_lines(jtext), **args)) == want
    # The port engine's own lines: the same text, vertices within 1 px.
    got = tout.format_json_output(tout.FormatJsonArgs(text_lines=ttext, **args))
    assert_same_ocr_json(json.loads(got), json.loads(want))
    assert tout.format_text_output(ttext).splitlines() == ["Section 12 notes", "This line is longer"]


def _drawn_within(got, want, base):
    """Pixels the two drew (those that differ from `base`): each within 1 px
    (the 8 neighbours) of a pixel the other drew, with this exception: Pillow
    rasterizes an outline from scanline crossings inside the polygon, the
    port from its rounded vertices, and at a corner the two can be 2 px
    apart. So at most 1% of the drawn pixels may be 2 px away, none further.
    The colours drawn come from the same palette."""
    gm, wm = (got != base).any(-1), (want != base).any(-1)
    assert gm.any() and wm.any()
    eight = np.ones((3, 3), bool)
    for a, b in ((gm, wm), (wm, gm)):
        assert not (a & ~ndimage.binary_dilation(b, eight, iterations=2)).any()
        assert (a & ~ndimage.binary_dilation(b, eight)).sum() <= 0.01 * a.sum()
    assert {tuple(c) for c in got[gm]} <= {tuple(c) for c in want[wm]}
    return gm, wm


def test_generate_annotated_png_draws_what_pillow_draws_on_engine_output(engines_on_text_page):
    page, (jlines, jtext), (tlines, ttext) = engines_on_text_page
    want = jout.generate_annotated_png(page, jlines, jtext)
    got = tout.generate_annotated_png(page, [to_port_rrects(l) for l in jlines], to_port_text_lines(jtext))
    assert got.shape == want.shape == page.shape and got.dtype == np.uint8
    gm, wm = _drawn_within(got, want, page)
    # On word-sized rects of real output the two agree within 1 px everywhere.
    eight = np.ones((3, 3), bool)
    assert not (gm & ~ndimage.binary_dilation(wm, eight)).any() and not (wm & ~ndimage.binary_dilation(gm, eight)).any()
    # The port's own lines: the same layers.
    _drawn_within(tout.generate_annotated_png(page, tlines, ttext), want, page)


def test_generate_annotated_png_on_rotated_rects_and_palettes():
    rng = np.random.default_rng(0)
    base = np.full((160, 240, 3), 90, np.uint8)
    jwords, twords = [], []
    for _ in range(6):  # lines of 3 rotated word rects each
        line = []
        for _ in range(3):
            ang = rng.uniform(-0.6, 0.6)
            line.append(((rng.uniform(30, 210), rng.uniform(30, 130)), (np.sin(ang), -np.cos(ang)), rng.uniform(8, 50), rng.uniform(6, 24)))
        jwords.append([JaxRotatedRect(*r) for r in line])
        twords.append([ot.RotatedRect(*r) for r in line])
    jtext = _jax_lines(["ab cd", None, "efg h", "ij"], char_w=12)
    want = jout.generate_annotated_png(base, jwords, jtext)
    got = tout.generate_annotated_png(base, twords, to_port_text_lines(jtext))
    _drawn_within(got, want, base)
    # Every palette appears: light grey lines, the three detection colours,
    # and the recognition colours of the lines that were read.
    drawn = {tuple(c) for c in got[(got != base).any(-1)]}
    assert tout.LINE_COLOR in drawn and set(tout.DETECTION_COLORS) <= drawn
    assert {tout.RECOGNITION_COLORS[0], tout.RECOGNITION_COLORS[2]} <= drawn and tout.RECOGNITION_COLORS[1] not in drawn
    # Recognized words are outlined 2 px wide, inside their rect.
    one = tout.generate_annotated_png(base, [], to_port_text_lines(_jax_lines(["x"], char_w=20)))
    ys, xs = np.nonzero((one != base).any(-1))
    assert (ys.min(), ys.max(), xs.min(), xs.max()) == (0, 25, 0, 20)
    assert (one[1, 1:19] != base[1, 1:19]).all() and (one[2, 2:18] == base[2, 2:18]).all()
    # The input is not drawn on, and other shapes are refused.
    assert (base == 90).all()
    with pytest.raises(ValueError):
        tout.generate_annotated_png(base[..., 0], [], [])
