"""The port's PagePipeline on the CPU: the counterparts of the JAX package's
pipeline tests on the fake models (tests/test_parallel.py), each also held
against the JAX pipeline's own output, and the slice as a whole against the
JAX pipeline with the shipped detector and recognizer on small pages of real
glyphs, under both transports, greedy and beam.

Pages are made with numpy. Words compare by their corner sets within 1 px
(the two U-Nets compute in bf16 and a mask pixel may differ); lines and text
must be equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ocrs_tpu import recognition as jrecog
from ocrs_tpu.models.fakes import FakeDetectionModel as JaxFakeDetectionModel
from ocrs_tpu.models.fakes import FakeRecognitionModel as JaxFakeRecognitionModel
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.parallel.pipeline import PagePipeline as JaxPagePipeline
from ocrs_tpu.train.pixelfont import render_pixel_line
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import native
from ocrs_tpu_torch import recognition as trecog
from ocrs_tpu_torch.errors import WrongOutputError
from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.parallel import pipeline as tpipe
from ocrs_tpu_torch.utils.tracing import StageTimer
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parent.parent
ALPHABET = ot.DEFAULT_ALPHABET[:63]


def _needs_native():
    if not native.available():
        pytest.skip(f"the native library cannot be built here: {native.build_error()}")


def _fake_pipe(**kw):
    return ot.PagePipeline(
        FakeDetectionModel(), FakeRecognitionModel(), ALPHABET, max_lines_per_batch=8, device="cpu", **kw
    )


def _jax_fake_pipe(**kw):
    return JaxPagePipeline(
        JaxFakeDetectionModel(), JaxFakeRecognitionModel(), ALPHABET, max_lines_per_batch=8, **kw
    )


def _fake_engine(**kw):
    return ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=FakeDetectionModel(), recognition_model=FakeRecognitionModel(), alphabet=ALPHABET, **kw
        ),
        device="cpu",
    )


def _engine_text(engine, page):
    return engine.get_text(engine.prepare_input(ot.ImageSource.from_tensor(page[..., None], ot.DimOrder.HWC)))


def _texts(results):
    return [r.text for r in results]


def _corner_sets(words):
    return sorted(tuple(sorted((round(float(x), 3), round(float(y), 3)) for x, y in w.corners())) for w in words)


def _assert_same_results(got, want, atol=1e-6):
    """Port results against JAX results: same text, same lines, and words
    whose corner sets agree within `atol` pixels."""
    assert _texts(got) == _texts(want)
    for a, b in zip(got, want):
        assert [len(l) for l in a.lines] == [len(l) for l in b.lines]
        assert len(a.words) == len(b.words)
        if a.words:
            np.testing.assert_allclose(np.array(_corner_sets(a.words)), np.array(_corner_sets(b.words)), atol=atol)


def test_pipeline_constructor_mirrors_jax_without_mesh():
    import inspect

    jparams = inspect.signature(JaxPagePipeline.__init__).parameters
    pparams = inspect.signature(ot.PagePipeline.__init__).parameters
    # The port also takes `mesh`, in the JAX pipeline's place (its sharded
    # runs are tests/test_torch_parallel_pipeline.py's).
    assert list(jparams) == [n for n in pparams if n != "device"]
    for name, p in pparams.items():
        if name not in ("self", "device", "detector_params"):
            assert p.default == jparams[name].default, name
    assert pparams["mesh"].default is None and pparams["device"].default is None
    assert _fake_pipe(mesh=None)._shards is None
    with pytest.raises(ValueError, match="transport"):
        _fake_pipe(transport="pcie")
    assert ot.PagePipeline is tpipe.PagePipeline and ot.PageResult is tpipe.PageResult


def test_process_stream_matches_per_group_process():
    """The software-pipelined stream (stage N+2 / detect N+1 / finish N in
    flight together) must give exactly the per-group results of serial
    process() calls, in order."""
    groups = []
    for g in range(3):
        pages = np.zeros((4, 100, 200), dtype=np.float32)
        for i in range(4):
            pages[i, 30:50, 20 + 5 * (g + i) : 90 + 5 * (g + i)] = 1.0
        groups.append(pages)

    pipe = _fake_pipe()
    serial = [pipe.process(g) for g in groups]
    streamed = pipe.process_stream(groups)
    assert len(streamed) == len(serial) == 3
    for sg, tg in zip(serial, streamed):
        assert len(sg) == len(tg)
        for a, b in zip(sg, tg):
            assert a.text == b.text
            assert _corner_sets(a.words) == _corner_sets(b.words)
    # The groups' words lie elsewhere, so the order of the results is checked.
    assert len({str(_corner_sets(g[0].words)) for g in serial}) == 3
    assert pipe.process_stream([]) == [] and pipe.process_stream(iter(groups[:1]))[0][0].text == serial[0][0].text
    jax_streamed = _jax_fake_pipe().process_stream(groups)
    for got, want in zip(streamed, jax_streamed):
        _assert_same_results(got, want)


@pytest.mark.parametrize(
    "decode,allowed",
    [("greedy", None), ("beam", None), ("greedy", ALPHABET[:40])],
    ids=["greedy", "beam8", "allowed_chars"],
)
def test_pipeline_matches_engine_all_decode_configs(decode, allowed):
    """The pooled multi-page pipeline must give the same text as the
    single-image engine on the same pages for every decode configuration."""
    pages = np.zeros((2, 100, 200), dtype=np.float32)
    pages[0, 30:50, 20:90] = 1.0
    pages[1, 40:60, 30:110] = 1.0
    method = trecog.Greedy() if decode == "greedy" else trecog.BeamSearch(width=8)
    jmethod = jrecog.Greedy() if decode == "greedy" else jrecog.BeamSearch(width=8)
    results = _fake_pipe(decode_method=method, allowed_chars=allowed).process(pages)
    engine = _fake_engine(decode_method=method, allowed_chars=allowed)
    for i in range(2):
        assert results[i].text == _engine_text(engine, pages[i])
    assert any(r.text for r in results)
    _assert_same_results(results, _jax_fake_pipe(decode_method=jmethod, allowed_chars=allowed).process(pages))


@pytest.mark.parametrize(
    "flags", [dict(deskew=True), dict(vertical_text=True), dict(deskew=True, vertical_text=True)],
    ids=["deskew", "vertical_text", "both"],
)
def test_pipeline_matches_engine_deskew_and_vertical(flags):
    pages = np.zeros((2, 100, 200), dtype=np.float32)
    # Page 0: a horizontal line plus a vertical stack of three word blocks
    # (merge_vertical_chains material).
    pages[0, 20:36, 30:120] = 1.0
    pages[0, 45:58, 150:165] = 1.0
    pages[0, 62:75, 150:165] = 1.0
    pages[0, 79:92, 150:165] = 1.0
    # Page 1: two horizontal lines.
    pages[1, 10:26, 20:110] = 1.0
    pages[1, 50:66, 30:140] = 1.0
    # The full-page transport is pinned: the low-bandwidth one quantizes
    # crops to u8, which can flip argmax ties on the fake model's content.
    results = _fake_pipe(transport="hbm", **flags).process(pages)
    engine = _fake_engine(**flags)
    for i in range(2):
        assert results[i].text == _engine_text(engine, pages[i]), flags
    assert sum(len(l) for l in results[0].lines) == len(results[0].words) >= 2
    _assert_same_results(results, _jax_fake_pipe(transport="hbm", **flags).process(pages))


def test_pipeline_lowbw_transport_matches_hbm():
    """The low-bandwidth transport (detector input resized on the host, u8
    line crops extracted on the host) must give the same text as the
    full-page path: identical masks by construction, crop pixels within u8
    rounding."""
    _needs_native()
    pages = np.zeros((3, 100, 200), dtype=np.uint8)
    pages[0, 30:50, 20:90] = 255
    pages[0, 60:80, 30:140] = 255
    pages[1, 40:60, 30:110] = 255
    pages[2, 10:28, 5:120] = 255

    ref = _fake_pipe(transport="hbm").process(pages)
    low = _fake_pipe(transport="lowbw", transport_pack4=False).process(pages)
    low4 = _fake_pipe(transport="lowbw", transport_pack4=True).process(pages)
    assert _texts(low) == _texts(ref)
    for a, b, c in zip(ref, low, low4):
        assert len(a.words) == len(b.words) == len(c.words)
        assert len(a.lines) == len(b.lines) == len(c.lines)
    # The stream path accepts host-staged groups too.
    streamed = _fake_pipe(transport="lowbw", transport_pack4=False).process_stream([pages, pages])
    assert _texts(streamed[0]) == _texts(ref) and _texts(streamed[1]) == _texts(ref)
    # Deskewed crops come from the host as well under this transport.
    rot = _fake_pipe(transport="lowbw", transport_pack4=False, deskew=True).process(pages)
    assert _texts(rot) == _texts(_fake_pipe(transport="hbm", deskew=True).process(pages))
    _assert_same_results(low, _jax_fake_pipe(transport="lowbw", transport_pack4=False).process(pages))
    _assert_same_results(low4, _jax_fake_pipe(transport="lowbw", transport_pack4=True).process(pages))


def test_pipeline_tiled_detection_matches_plain_on_large_page():
    """Tiled pipeline detection on a page larger than the fake detector's
    input must find the same words (page-resolution post-processing)."""
    # The fake detector's input is 200 x 100 (H x W); pages are wider, so the
    # width tiles while the height pads.
    pages = np.zeros((2, 150, 300), dtype=np.float32)
    pages[0, 30:50, 20:90] = 1.0
    pages[0, 100:120, 150:260] = 1.0
    pages[1, 60:80, 40:140] = 1.0
    results = _fake_pipe(tiled_detection=True, tile_overlap=32).process(pages)
    assert len(results[0].words) == 2
    assert len(results[1].words) == 1
    # Word rects are in page coordinates (inside their drawn regions).
    for rect in results[0].words:
        cx, cy = rect.center
        assert 0 <= cx <= 300 and 0 <= cy <= 150
    # Rects fitted by the angle scan in float32 on both sides.
    _assert_same_results(results, _jax_fake_pipe(tiled_detection=True, tile_overlap=32).process(pages), atol=1e-2)


class LowConfRec(FakeRecognitionModel):
    def run(self, x: torch.Tensor) -> torch.Tensor:
        return super().run(x) - 5.0


def test_pipeline_min_line_confidence_matches_engine_filter():
    """PagePipeline(min_line_confidence=...) drops the same low-confidence
    lines as the engine's filter."""
    pages = np.zeros((2, 100, 200), dtype=np.uint8)
    pages[0, 30:50, 20:90] = 255
    pages[1, 40:60, 30:110] = 255

    def texts(rec, min_conf):
        pipe = ot.PagePipeline(
            FakeDetectionModel(), rec, ALPHABET, max_lines_per_batch=8, min_line_confidence=min_conf, device="cpu"
        )
        return _texts(pipe.process(pages))

    base = texts(FakeRecognitionModel(), None)
    assert any(t.strip() for t in base)
    assert texts(FakeRecognitionModel(), 0.5) == base
    assert texts(LowConfRec(), 0.5) == ["", ""]
    assert texts(LowConfRec(), None) == base
    engine = _fake_engine(min_line_confidence=0.5)
    assert [_engine_text(engine, p) for p in pages] == base


@pytest.mark.parametrize("multigrid,solidify", [(True, True), (False, False)])
def test_pipeline_run_table_geometry_matches_device_path(multigrid, solidify):
    """Text with run_table_geometry on and off must agree on the fake models
    (same connectivity; the rect fit differs only by the angle scan's
    resolution), and each route equals the JAX pipeline's."""
    pages = np.zeros((4, 100, 200), dtype=np.float32)
    for i in range(4):
        pages[i, 30:50, 20 + 5 * i : 90 + 5 * i] = 1.0
        pages[i, 60:75, 40 : 160 - 5 * i] = 1.0
    kw = dict(multigrid=multigrid, solidify=solidify)
    a = _fake_pipe(run_table_geometry=False, **kw).process(pages)
    b = _fake_pipe(run_table_geometry=True, **kw).process(pages)
    assert _texts(a) == _texts(b)
    for ra, rb in zip(a, b):
        assert len(ra.words) == len(rb.words) == 2
    _assert_same_results(a, _jax_fake_pipe(run_table_geometry=False, **kw).process(pages), atol=1e-2)
    _assert_same_results(b, _jax_fake_pipe(run_table_geometry=True, **kw).process(pages))
    with native.disabled():
        _assert_same_results(_fake_pipe(**kw).process(pages), b, atol=1e-9)


def test_pipeline_inputs_stages_and_errors(capsys):
    rng = np.random.default_rng(0)
    grey = np.zeros((2, 100, 200), np.uint8)
    grey[0, 30:50, 20:90] = 255
    grey[1, 40:60, 30:110] = 200
    pipe = _fake_pipe(transport="hbm", debug=True)
    ref = pipe.process(grey)
    assert "detect" in capsys.readouterr().out
    # Grey with a channel axis, RGB and RGBA, float pages, normalized tensors.
    rgb = np.repeat(grey[..., None], 3, axis=-1)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (2, 100, 200, 1), dtype=np.uint8)], axis=-1)
    quiet = _fake_pipe(transport="hbm")
    for pages in (grey[..., None], rgb, rgba, grey.astype(np.float32) / 255.0):
        assert _texts(quiet.process(pages)) == _texts(ref)
    normalized = torch.from_numpy(grey.astype(np.float32) / 255.0 - 0.5)
    timer = StageTimer(fence_device="cpu")
    assert _texts(quiet.process_normalized(normalized, timer=timer)) == _texts(ref)
    assert list(timer.timings) == ["detect", "rects_to_host", "layout", "recognize"]
    np.testing.assert_array_equal(tpipe._to_grey_u8(rgb), grey)
    np.testing.assert_array_equal(tpipe._to_grey_u8(grey.astype(np.float32) / 255.0), grey)
    # auto resolves to the full-page transport on the CPU, where there is no link.
    auto = _fake_pipe()
    auto.process(grey)
    assert auto._transport == "hbm"
    assert tpipe.probe_h2d_mbps("cpu") > 0
    # An alphabet that does not match the recognizer's classes raises on the first batch.
    bad = ot.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), ALPHABET[:10], device="cpu")
    with pytest.raises(WrongOutputError, match="alphabet size"):
        bad.process(grey)
    # A page without words gives empty results, alone and in a group.
    blank = np.zeros((1, 100, 200), np.uint8)
    assert quiet.process(blank)[0].text == "" and quiet.process(blank)[0].words == []


def test_scale_rotated_rect_matches_jax():
    from ocrs_tpu.geometry import RotatedRect as JaxRotatedRect
    from ocrs_tpu.parallel.pipeline import _scale_rotated_rect as jax_scale

    for up in ((0.0, -1.0), (1.0, 0.0), (0.3, -0.954)):
        for sx, sy in ((2.0, 2.0), (1.5, 3.0)):
            got = tpipe._scale_rotated_rect(ot.RotatedRect((10.0, 20.0), up, 30.0, 8.0), sx, sy)
            want = jax_scale(JaxRotatedRect((10.0, 20.0), up, 30.0, 8.0), sx, sy)
            np.testing.assert_allclose(np.stack(got.corners()), np.stack(want.corners()), atol=1e-9)


# ---------------------------------------------------------------------------
# The slice as a whole: shipped weights, real glyphs, both transports.
# ---------------------------------------------------------------------------

# Lines the shipped recognizer reads with wide top-2 margins, so that bf16
# near-ties, which the two frameworks may break differently, decide no character.
LINES = ["Section 12 notes", "This line is longer", "notes Section 12"]


def _page(lines, hw=(240, 420), scale=3.0, left=30, top=24, gap=22):
    """Dark pixel-font text on a light page -> (H, W) uint8."""
    ink = np.zeros(hw, np.float32)
    y = top
    for text in lines:
        m, _ = render_pixel_line(text, scale, weight=1)
        h, w = m.shape
        ink[y : y + h, left : left + w] = m
        y += h + gap
    return ((1.0 - ink) * 255).astype(np.uint8)


PAGES = np.stack([_page(LINES), _page(LINES[::-1], left=44), _page(LINES[:2], top=60)])


@pytest.fixture(scope="module")
def models():
    det, rec = REPO / "weights" / "text-detection.npz", REPO / "weights" / "text-recognition.npz"
    return (
        jax_load_detection_model(det), jax_load_recognition_model(rec),
        load_detection_model(det), load_recognition_model(rec),
    )


@pytest.mark.parametrize("decode", ["greedy", "beam"])
@pytest.mark.parametrize("transport", ["hbm", "lowbw"])
def test_pipeline_with_shipped_weights_matches_jax_pipeline(models, transport, decode):
    if transport == "lowbw":
        _needs_native()
    jdet, jrec, pdet, prec = models
    jmethod = jrecog.BeamSearch(100) if decode == "beam" else None
    pmethod = trecog.BeamSearch(100) if decode == "beam" else None
    want = JaxPagePipeline(jdet, jrec, ot.DEFAULT_ALPHABET, transport=transport, decode_method=jmethod).process(PAGES)
    pipe = ot.PagePipeline(pdet, prec, ot.DEFAULT_ALPHABET, transport=transport, decode_method=pmethod, device="cpu")
    got = pipe.process(PAGES)
    _assert_same_results(got, want, atol=1.0)
    assert got[0].text.splitlines() == LINES and got[1].text.splitlines() == LINES[::-1]
    assert got[2].text.splitlines() == LINES[:2]
    # Char rects come back through the same polygons.
    for a, b in zip(got, want):
        for ta, tb in zip(a.text_lines, b.text_lines):
            ra = np.array([(c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in ta.chars()])
            rb = np.array([(c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in tb.chars()])
            np.testing.assert_allclose(ra, rb, atol=1.5)
    if transport == "hbm" and decode == "greedy":
        # The stream gives what process gives, and the engine reads the same text.
        streamed = pipe.process_stream([PAGES[:2], PAGES[2:], PAGES[1:]])
        assert [_texts(g) for g in streamed] == [_texts(got[:2]), _texts(got[2:]), _texts(got[1:])]
        engine = ot.OcrEngine(ot.OcrEngineParams(detection_model=pdet, recognition_model=prec), device="cpu")
        assert got[0].text == engine.get_text(
            engine.prepare_input(ot.ImageSource.from_tensor(PAGES[0][..., None], ot.DimOrder.HWC))
        )
