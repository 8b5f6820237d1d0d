"""Every option of the port's OcrEngineParams against the JAX engine built
with the same option, on the CPU, with the shipped detector and the shipped
ConvCTC recognizer, plus the functions each option adds.

The pages are drawn here with the JAX package's pixel font, which the shipped
models read: a page of three lines, the same page turned by 7 degrees
(deskew), a strip turned by 90 degrees (vertical text), a page with a ruled
heading (rule glyph) and a page larger than the detector's 800 x 608 input
(tiled detection).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from ocrs_tpu import recognition as jrecog
from ocrs_tpu.engine import OcrEngine as JaxEngine
from ocrs_tpu.engine import OcrEngineParams as JaxParams
from ocrs_tpu.layout import merge_vertical_chains as jax_merge_vertical_chains
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.ops import ctc as jctc
from ocrs_tpu.ops.warp import extract_line_batch_rotated as jax_extract_rotated
from ocrs_tpu.preprocess import DimOrder as JaxDimOrder
from ocrs_tpu.preprocess import ImageSource as JaxImageSource
from ocrs_tpu.train.pixelfont import render_pixel_line
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import recognition as trecog
from ocrs_tpu_torch.detection import RuleRect, _tile_offsets
from ocrs_tpu_torch.layout import is_vertical_line, merge_vertical_chains
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.ops import ctc as tctc
from ocrs_tpu_torch.ops.warp import extract_line_batch_rotated

REPO = Path(__file__).resolve().parent.parent
DET_WEIGHTS = REPO / "weights" / "text-detection.npz"
REC_WEIGHTS = REPO / "weights" / "text-recognition.npz"


def _page(lines, hw=(240, 420), scale=3.0, left=30, top=24, gap=22):
    """Dark pixel-font text on a light page -> (H, W, 1) uint8."""
    ink = np.zeros(hw, np.float32)
    y = top
    for text in lines:
        m, _ = render_pixel_line(text, scale, weight=1)
        h, w = m.shape
        ink[y : y + h, left : left + w] = m
        y += h + gap
    return ((1.0 - ink) * 255).astype(np.uint8)[..., None]


# Lines the shipped recognizer reads letter for letter with wide top-2 margins,
# so that bf16 near-ties (which the two frameworks can break differently, see
# test_torch_convctc.py) do not decide a character.
LINES = ["Section 12 notes", "This line is longer", "notes Section 12"]


def _rotate(img, degrees):
    return ndimage.rotate(img[..., 0], degrees, reshape=True, order=1, cval=255)[..., None].astype(np.uint8)


def _pages():
    plain = _page(LINES)
    ruled = plain.copy()
    ruled[66:69, 30:330] = 0  # a rule under the first line
    big = np.full((700, 1000, 1), 255, np.uint8)
    big[40:280, 60:480] = plain
    big[400:640, 520:940] = plain
    return {
        "plain": plain,
        "rotated": _rotate(plain, 7.0),
        "vertical": _rotate(_page(["Section 12 notes"], hw=(78, 376), top=15), 90.0),
        "ruled": ruled,
        "big": big,
    }


PAGES = _pages()


@pytest.fixture(scope="module")
def models():
    return (
        jax_load_detection_model(DET_WEIGHTS),
        jax_load_recognition_model(REC_WEIGHTS),
        load_detection_model(DET_WEIGHTS),
        load_recognition_model(REC_WEIGHTS),
    )


def _engines(models, jax_options, port_options=None):
    jdet, jrec, pdet, prec = models
    jax_engine = JaxEngine(JaxParams(detection_model=jdet, recognition_model=jrec, **jax_options))
    port_engine = ot.OcrEngine(
        ot.OcrEngineParams(detection_model=pdet, recognition_model=prec, **(port_options or jax_options)),
        device="cpu",
    )
    return jax_engine, port_engine


def _inputs(jax_engine, port_engine, img):
    return (
        jax_engine.prepare_input(JaxImageSource.from_tensor(img, JaxDimOrder.HWC)),
        port_engine.prepare_input(ot.ImageSource.from_tensor(img, ot.DimOrder.HWC)),
    )


def _chars(lines):
    return [
        tl and [(c.char, c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in tl.chars()]
        for tl in lines
    ]


def _same_text(models, page, jax_options, port_options=None):
    """Both engines on one page: the same text, returned with the port's
    engine, its input and the text for further checks."""
    jax_engine, port_engine = _engines(models, jax_options, port_options)
    jin, pin = _inputs(jax_engine, port_engine, PAGES[page])
    want = jax_engine.get_text(jin)
    got = port_engine.get_text(pin)
    assert got == want
    return port_engine, pin, got


OPTIONS = {
    "defaults": ("plain", {}),
    "postprocess_host": ("plain", {"detection_postprocess": "host"}),
    "postprocess_device": ("plain", {"detection_postprocess": "device"}),
    "postprocess_page_multigrid": ("plain", {"detection_postprocess_resolution": "page"}),
    "postprocess_page_device": (
        "plain",
        {"detection_postprocess_resolution": "page", "detection_postprocess": "device"},
    ),
    "min_line_confidence": ("plain", {"min_line_confidence": 0.97}),
    "detection_word_spaces": ("plain", {"detection_word_spaces": True}),
    "allowed_chars": ("plain", {"allowed_chars": "abcdefghijklmnopqrstuvwxyz "}),
    "max_lines_per_batch": ("plain", {"max_lines_per_batch": 2}),
    "deskew_on_upright_page": ("plain", {"deskew": True}),
    "vertical_text_on_upright_page": ("plain", {"vertical_text": True}),
    "rule_glyph_without_rules": ("plain", {"rule_glyph": "["}),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_decodes_the_jax_engines_text(models, case):
    page, options = OPTIONS[case]
    _, _, text = _same_text(models, page, options)
    if case == "defaults":
        assert text.splitlines() == LINES
    if case == "allowed_chars":
        assert not any(ch.isdigit() or ch.isupper() for ch in text)


@pytest.mark.parametrize("width", [3, 100])
def test_beam_search_decodes_the_jax_engines_text(models, width):
    port_engine, pin, text = _same_text(
        models,
        "plain",
        {"decode_method": jrecog.BeamSearch(width)},
        {"decode_method": trecog.BeamSearch(width)},
    )
    # The recognizer is peaked: beam and greedy read the same on this page.
    greedy_engine = ot.OcrEngine(ot.OcrEngineParams(detection_model=models[2], recognition_model=models[3]), device="cpu")
    assert text == greedy_engine.get_text(pin)


@pytest.mark.parametrize("bucket", ["reference", "ladder"])
def test_width_buckets_decode_the_jax_engines_text(models, bucket):
    assert trecog.WIDTH_LADDER == jrecog.TPU_WIDTH_LADDER and trecog.COARSE_WIDTH_LADDER == jrecog.COARSE_WIDTH_LADDER
    jb = jrecog.reference_bucket if bucket == "reference" else jrecog.ladder_bucket(jrecog.TPU_WIDTH_LADDER)
    pb = trecog.reference_bucket if bucket == "reference" else trecog.ladder_bucket(trecog.WIDTH_LADDER)
    for w in (1, 49, 50, 51, 128, 129, 1000, 2400, 5000):
        assert pb(w) == jb(w)
    _same_text(models, "plain", {"recognition_width_bucket": jb}, {"recognition_width_bucket": pb})


def test_deskew_reads_a_rotated_page_like_the_jax_engine(models):
    jax_engine, port_engine = _engines(models, {"deskew": True})
    jin, pin = _inputs(jax_engine, port_engine, PAGES["rotated"])
    jlines = jax_engine.find_text_lines(jin, jax_engine.detect_words(jin))
    plines = port_engine.find_text_lines(pin, port_engine.detect_words(pin))
    assert len(plines) == len(jlines) == 3
    # The line's rotated rect follows the text angle (7 degrees) on both sides.
    for pl, jl in zip(plines, jlines):
        pr, jr_ = trecog.line_rotated_rect(pl), jrecog.line_rotated_rect(jl)
        np.testing.assert_allclose(pr.up, jr_.up, atol=1e-3)
        assert 3.0 < np.degrees(np.arctan2(-pr.up[0], -pr.up[1])) < 11.0 or len(pl) == 1
    want, got = jax_engine.recognize_text(jin, jlines), port_engine.recognize_text(pin, plines)
    assert [str(t) for t in got] == [str(t) for t in want]
    # Char rects are bounding boxes of slanted slices of rects that agree to 1 px.
    for p, j in zip(_chars(got), _chars(want)):
        np.testing.assert_allclose(np.array([c[1:] for c in p]), np.array([c[1:] for c in j]), atol=1.5)
    text = port_engine.get_text(pin)
    assert text == jax_engine.get_text(jin)
    # Deskew is what reads this page: upright crops of slanted lines do worse.
    plain = ot.OcrEngine(ot.OcrEngineParams(detection_model=models[2], recognition_model=models[3]), device="cpu")
    assert LINES[0] in text and LINES[0] not in plain.get_text(pin)


def test_vertical_text_reads_a_turned_strip_like_the_jax_engine(models):
    jax_engine, port_engine = _engines(models, {"vertical_text": True})
    jin, pin = _inputs(jax_engine, port_engine, PAGES["vertical"])
    jlines = jax_engine.find_text_lines(jin, jax_engine.detect_words(jin))
    plines = port_engine.find_text_lines(pin, port_engine.detect_words(pin))
    assert [len(l) for l in plines] == [len(l) for l in jlines]
    assert any(is_vertical_line(l) for l in plines)
    text = port_engine.get_text(pin)
    assert text == jax_engine.get_text(jin)
    assert text == "Section 12 notes"
    assert _chars(port_engine.recognize_text(pin, plines))[0][0][0] == _chars(jax_engine.recognize_text(jin, jlines))[0][0][0]


def test_rule_glyph_on_a_ruled_page_matches_the_jax_engine(models):
    jax_engine, port_engine = _engines(models, {"rule_glyph": "["})
    jin, pin = _inputs(jax_engine, port_engine, PAGES["ruled"])
    jwords, pwords = jax_engine.detect_words(jin), port_engine.detect_words(pin)
    rules = [w for w in pwords if isinstance(w, RuleRect)]
    assert len(rules) == 1 == sum(type(w).__name__ == "RuleRect" for w in jwords)
    np.testing.assert_allclose(np.stack(rules[0].corners()), [[330, 69], [30, 69], [30, 66], [330, 66]], atol=1.0)
    text = port_engine.get_text(pin)
    assert text == jax_engine.get_text(jin)
    assert text.splitlines()[1] == "[" and len(text.splitlines()) == 4
    # Without the option the rule is skipped, on both sides.
    _, _, skipped = _same_text(models, "ruled", {})
    assert "[" not in skipped


def test_tiled_detection_on_a_page_larger_than_the_model_input_matches_jax(models):
    img = PAGES["big"]
    assert img.shape[0] < 800 and img.shape[1] > 608  # wider than the 800 x 608 input
    jax_engine, port_engine = _engines(models, {"detection_tiled": True})
    jin, pin = _inputs(jax_engine, port_engine, img)
    offsets = _tile_offsets(img.shape[:2], (800, 608), 64)
    assert offsets == ((0, 0), (0, 392))
    probs = port_engine.detect_text_pixels(pin)
    assert tuple(probs.shape) == img.shape[:2]
    # bf16 U-Net on two tiles, max-blended (bound as in test_torch_models.py).
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax_engine.detect_text_pixels(jin)), atol=2e-2, rtol=0)
    text = port_engine.get_text(pin)
    assert text == jax_engine.get_text(jin)
    assert text.count("Section 12 notes") >= 2


def test_tile_offsets_equal_jax():
    from ocrs_tpu.detection import _tile_offsets as jax_tile_offsets

    for page_hw in ((700, 1000), (800, 608), (801, 609), (2000, 3000), (300, 200), (1536, 1152)):
        for overlap in (0, 64, 700):
            assert _tile_offsets(page_hw, (800, 608), overlap) == jax_tile_offsets(page_hw, (800, 608), overlap)


def test_rotated_extraction_matches_jax():
    rng = np.random.default_rng(0)
    page = rng.random((3, 90, 140), dtype=np.float32) - 0.5
    n = 5
    theta = rng.uniform(-0.5, 0.5, n)
    geom = np.zeros((10, n), np.float32)
    geom[0], geom[1] = rng.uniform(-5, 60, n), rng.uniform(-5, 50, n)
    geom[2], geom[3] = np.cos(theta), np.sin(theta)
    geom[4], geom[5] = -np.sin(theta), np.cos(theta)
    geom[6], geom[7] = rng.uniform(30, 90, n), rng.uniform(8, 30, n)
    geom[8] = rng.integers(40, 128, n)
    geom[9] = rng.integers(0, 3, n)
    for pg in (page, page[1]):
        want = np.asarray(jax_extract_rotated(jnp.asarray(pg), jnp.asarray(geom), out_h=16, out_w=128))
        got = extract_line_batch_rotated(torch.from_numpy(pg), torch.from_numpy(geom), out_h=16, out_w=128)
        assert tuple(got.shape) == (n, 1, 16, 128)
        # float32 sample positions and four-tap sums on both sides.
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert (got.numpy() == -0.5).any() and (got.numpy() != -0.5).any()


@pytest.mark.parametrize("width", [1, 4, 25])
def test_beam_decode_matches_jax_on_random_logprobs(width):
    rng = np.random.default_rng(width)
    logits = rng.standard_normal((3, 30, 12)) * 3.0
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    for i in range(3):
        assert tctc.beam_decode(lp[i], width) == [tctc.CtcStep(s.pos, s.label) for s in jctc.beam_decode(lp[i], width)]
    assert tctc.beam_decode(lp[0], width, excluded=[1, 2]) == [
        tctc.CtcStep(s.pos, s.label) for s in jctc.beam_decode(lp[0], width, excluded=[1, 2])
    ]
    assert all(s.label not in (1, 2) for s in tctc.beam_decode(lp[0], width, excluded=[1, 2]))
    batch = tctc.beam_decode_batch(lp, width)
    assert batch == [tctc.beam_decode(lp[i], width) for i in range(3)]
    if width == 1:
        # A beam of one keeps the best prefix per frame; on peaked frames that is greedy.
        peaked = lp * 8.0
        peaked = peaked - np.log(np.exp(peaked).sum(-1, keepdims=True))
        assert tctc.beam_decode(peaked[0], 1) == tctc.collapse_greedy(peaked[0].argmax(-1))


def test_beam_topk_reduction_matches_jax():
    rng = np.random.default_rng(5)
    lp = np.log(rng.dirichlet(np.full(97, 0.05), size=(2, 40)).clip(1e-30)).astype(np.float32)
    assert tctc.BEAM_CANDIDATE_CAP == jctc.BEAM_CANDIDATE_CAP and tctc.BEAM_EMISSION_GAP == jctc.BEAM_EMISSION_GAP
    for width, classes in ((1, 97), (100, 97), (100, 5)):
        assert tctc.beam_candidate_k(width, classes) == jctc.beam_candidate_k(width, classes)
    k = tctc.beam_candidate_k(100, 97)
    for gap in (None, tctc.BEAM_EMISSION_GAP):
        want = np.asarray(jctc.beam_topk_packed(jnp.asarray(lp), k=k, gap=gap))
        got = tctc.beam_topk_packed(torch.from_numpy(lp), k=k, gap=gap)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 40, 5 * k)
        np.testing.assert_array_equal(got.numpy(), want)
    vals, idx = tctc.unpack_topk(got.numpy(), k)
    jvals, jidx = jctc.unpack_topk(want, k)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(idx, jidx)
    tv, ti = tctc.beam_topk(torch.from_numpy(lp), k)
    assert ti.dtype == torch.uint8 and torch.equal(tv, torch.from_numpy(lp).topk(k).values)
    np.testing.assert_array_equal(tctc._topk_to_full(vals[0], idx[0], 97), jctc._topk_to_full(jvals[0], jidx[0], 97))
    # The beam on the candidates equals the beam on the full matrix.
    assert tctc.beam_decode_topk(vals, idx, 10, 97) == tctc.beam_decode_batch(lp, 10)


def test_greedy_labels_and_text_confidence_match_jax():
    rng = np.random.default_rng(6)
    lp = np.log(rng.dirichlet(np.full(20, 0.3), size=(4, 25))).astype(np.float32)
    lp[3, :, 0] = 0.0  # a line of blanks only: confidence 1
    t = torch.from_numpy(lp)
    np.testing.assert_array_equal(tctc.greedy_labels(t).numpy(), np.asarray(jctc.greedy_labels(jnp.asarray(lp))))
    assert tctc.greedy_labels(t).dtype == torch.int32
    got = tctc.text_confidence(t)
    assert got.dtype == torch.float32 and float(got[3]) == 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(jctc.text_confidence(jnp.asarray(lp))), atol=1e-6, rtol=0)


def test_vertical_chains_and_word_gaps_match_jax():
    from ocrs_tpu.geometry import RotatedRect as JaxRotatedRect
    from ocrs_tpu.geometry import Rect as JaxRect
    from ocrs_tpu.text_items import TextChar as JaxTextChar
    from ocrs_tpu.text_items import TextLine as JaxTextLine
    from ocrs_tpu_torch.geometry import Rect, RotatedRect
    from ocrs_tpu_torch.text_items import TextChar, TextLine

    # A stack of five glyph blobs, a lone tall word, two ordinary lines.
    boxes = [[(10 + 14 * i, 40, 22 + 14 * i, 52)] for i in range(5)]
    boxes += [[(20, 100, 90, 112)], [(30, 150, 42, 200), (30, 206, 42, 260)], [(60, 150, 72, 220)]]
    make = lambda rr, r: [[rr.from_rect(r.from_tlbr(*b)) for b in line] for line in boxes]
    want_lines, want_flags = jax_merge_vertical_chains(make(JaxRotatedRect, JaxRect))
    got_lines, got_flags = merge_vertical_chains(make(RotatedRect, Rect))
    assert got_flags == want_flags == [True, True, False, False]
    assert [[tuple(w.center) for w in l] for l in got_lines] == [[tuple(w.center) for w in l] for l in want_lines]
    assert merge_vertical_chains([]) == ([], [])

    # "ab cd" decoded as "abcd" over two detected words: a space goes in.
    def line(tc, tl, r):
        return tl([tc(ch, r.from_tlbr(0, 10 * i + (6 if i > 1 else 0), 10, 10 * i + 8 + (6 if i > 1 else 0))) for i, ch in enumerate("abcd")])

    words = lambda rr, r: [rr.from_rect(r.from_tlbr(0, 0, 10, 18)), rr.from_rect(r.from_tlbr(0, 26, 10, 44))]
    want = jrecog.arbitrate_word_gaps(words(JaxRotatedRect, JaxRect), line(JaxTextChar, JaxTextLine, JaxRect))
    got = trecog.arbitrate_word_gaps(words(RotatedRect, Rect), line(TextChar, TextLine, Rect))
    assert str(got) == str(want) == "ab cd"
    assert _chars([got]) == _chars([want])
    assert trecog.arbitrate_word_gaps(words(RotatedRect, Rect), None) is None


def test_pick_direction_variants_matches_jax():
    def results(mod, rect_cls):
        rl = lambda index, variant: mod._RecLine(index=index, poly=np.zeros((4, 2)), rect=rect_cls.from_tlbr(0, 0, 1, 1), resized_width=10, variant=variant)
        steps = lambda n: [object()] * n
        return [
            mod._LineResult(rl(0, -1), 128, 32, steps(3)),
            mod._LineResult(rl(1, 0), 128, 32, steps(5), conf=-0.5),
            mod._LineResult(rl(1, 1), 128, 32, steps(4), conf=-0.2),
            mod._LineResult(rl(2, 0), 128, 32, steps(3), conf=-0.9),
            mod._LineResult(rl(2, 1), 128, 32, steps(1), conf=-0.1),
        ]

    from ocrs_tpu.geometry import Rect as JaxRect
    from ocrs_tpu_torch.geometry import Rect

    pick = lambda mod, rect_cls: [(r.line.index, r.line.variant) for r in mod._pick_direction_variants(results(mod, rect_cls))]
    assert pick(trecog, Rect) == pick(jrecog, JaxRect) == [(0, -1), (1, 1), (2, 0)]


def test_chip_smoke_text_page_is_the_pixel_fonts_rendering():
    # chip_smoke.py keeps its own copy of the few glyphs it draws its page of
    # real text with; this holds the copy against the JAX package's font.
    import sys

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    np.testing.assert_array_equal(chip_smoke.text_page(), _page(list(chip_smoke.TEXT_LINES), hw=(160, 420)))
    pages = chip_smoke.option_pages(chip_smoke.text_page(), np.zeros((800, 2560, 1), np.uint8))
    assert set(pages) == {"text", "rotated", "vertical", "ruled", "wide"}
    assert pages["vertical"].shape[0] > 4 * pages["vertical"].shape[1]
