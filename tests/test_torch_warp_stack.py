"""The functions the page pipeline adds to modules the port already had,
each against its JAX counterpart on numpy inputs made from a seed, on the
CPU: page stacks in the line extraction, the finishing of crops extracted on
the host, run tables of a stack of masks, the vectorised line polygons, the
array form of the layout and of the CTC decoders, the fake models and the
stage timer.

Integers and masks must be equal; float32 images agree within 1e-5 (the same
float32 sample positions and two-tap sums on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu import layout as jlayout
from ocrs_tpu import recognition as jrecog
from ocrs_tpu.geometry import Rect as JaxRect
from ocrs_tpu.geometry import RotatedRect as JaxRotatedRect
from ocrs_tpu.models import fakes as jfakes
from ocrs_tpu.ops import ctc as jctc
from ocrs_tpu.ops import rects as jrects
from ocrs_tpu.ops import warp as jwarp
from ocrs_tpu_torch import layout, native
from ocrs_tpu_torch import recognition as trecog
from ocrs_tpu_torch.geometry import Rect, RotatedRect
from ocrs_tpu_torch.models import fakes
from ocrs_tpu_torch.models.protocol import Model
from ocrs_tpu_torch.ops import ctc, rects, warp
from ocrs_tpu_torch.utils.tracing import StageTimer, fence, trace
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

F32_ATOL = 1e-5
OUT_H, OUT_W = 16, 96


def _lines(seed, n=6, pages=3, hw=(90, 140)):
    """Geometry [6, n] and chains [n, 2, 8, 2] of n slightly slanted line
    ribbons spread over a stack of pages; some reach past the page edge."""
    rng = np.random.default_rng(seed)
    geom = np.zeros((6, n), np.float32)
    geom[0] = rng.integers(-4, hw[0] - 20, n)  # top
    geom[1] = rng.integers(-6, hw[1] - 60, n)  # left
    geom[2] = rng.integers(10, 24, n)  # height
    geom[3] = rng.integers(40, 90, n)  # width
    geom[4] = rng.integers(30, OUT_W + 1, n)  # resized width
    geom[5] = rng.integers(0, pages, n)  # page
    chains = np.zeros((n, 2, 8, 2), np.float32)
    for i in range(n):
        xs = np.sort(rng.uniform(geom[1, i], geom[1, i] + geom[3, i], 8))
        slope = rng.uniform(-0.1, 0.1)
        chains[i, 0, :, 0] = chains[i, 1, :, 0] = xs
        chains[i, 0, :, 1] = geom[0, i] + 2 + slope * (xs - xs[0])
        chains[i, 1, :, 1] = geom[0, i] + geom[2, i] - 2 + slope * (xs - xs[0])
    return geom, chains


@pytest.mark.parametrize("seed", [0, 1])
def test_page_stack_extraction_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pages = rng.random((3, 90, 140), dtype=np.float32) - 0.5
    geom, chains = _lines(seed)
    want = np.asarray(
        jwarp.extract_line_batch_packed(jnp.asarray(pages), jnp.asarray(geom), jnp.asarray(chains), out_h=OUT_H, out_w=OUT_W)
    )
    got = warp.extract_line_batch_packed(
        torch.from_numpy(pages), torch.from_numpy(geom), torch.from_numpy(chains), out_h=OUT_H, out_w=OUT_W
    )
    assert tuple(got.shape) == (geom.shape[1], 1, OUT_H, OUT_W)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    # The masks are equal exactly, and the lines read from different pages.
    np.testing.assert_array_equal(got.numpy() == -0.5, want == -0.5)
    assert len(set(geom[5].tolist())) > 1 and (got.numpy() != -0.5).any()
    # The unpacked form, and one page of the stack as a single page.
    t = [torch.from_numpy(geom[i]) for i in range(5)]
    unpacked = warp.extract_line_batch(
        torch.from_numpy(pages), *t, torch.from_numpy(chains[:, 0]), torch.from_numpy(chains[:, 1]),
        torch.from_numpy(geom[5].astype(np.int32)), out_h=OUT_H, out_w=OUT_W,
    )
    assert torch.equal(unpacked, got)
    on_page_1 = geom[5] == 1
    single = warp.extract_line_batch_packed(
        torch.from_numpy(pages[1]), torch.from_numpy(geom), torch.from_numpy(chains), out_h=OUT_H, out_w=OUT_W
    )
    assert torch.equal(single[on_page_1], got[on_page_1])
    with pytest.raises(ValueError, match="page_idx"):
        warp.extract_line_batch(torch.from_numpy(pages), *t, torch.from_numpy(chains[:, 0]), torch.from_numpy(chains[:, 1]), out_h=OUT_H, out_w=OUT_W)


@pytest.mark.parametrize("pack4", [False, True])
def test_mask_normalize_crops_match_jax(pack4):
    rng = np.random.default_rng(2)
    geom, chains = _lines(2)
    n = geom.shape[1]
    crops = rng.integers(0, 256, (n, OUT_H, OUT_W // 2 if pack4 else OUT_W)).astype(np.uint8)
    want = np.asarray(
        jwarp.mask_normalize_crops(jnp.asarray(crops), jnp.asarray(geom), jnp.asarray(chains), page_hw=(90, 140), pack4=pack4)
    )
    got = warp.mask_normalize_crops(
        torch.from_numpy(crops), torch.from_numpy(geom), torch.from_numpy(chains), page_hw=(90, 140), pack4=pack4
    )
    assert tuple(got.shape) == (n, 1, OUT_H, OUT_W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    np.testing.assert_array_equal(got.numpy() == -0.5, want == -0.5)


@pytest.mark.parametrize("pack4", [False, True])
def test_strip_mask_normalize_crops_match_jax(pack4):
    rng = np.random.default_rng(3)
    geom, chains = _lines(3)
    n = geom.shape[1]
    segs = ((geom[4].astype(np.int64) + 1) // 2) * 2
    offs = np.concatenate([[0], np.cumsum(segs[:-1])]).astype(np.int32)
    total_w = 1024
    strip = rng.integers(0, 256, (OUT_H, total_w // 2 if pack4 else total_w)).astype(np.uint8)
    want = np.asarray(
        jwarp.strip_mask_normalize_crops(
            jnp.asarray(strip), jnp.asarray(offs), jnp.asarray(geom), jnp.asarray(chains),
            page_hw=(90, 140), pack4=pack4, out_w=OUT_W,
        )
    )
    got = warp.strip_mask_normalize_crops(
        torch.from_numpy(strip), torch.from_numpy(offs), torch.from_numpy(geom), torch.from_numpy(chains),
        page_hw=(90, 140), pack4=pack4, out_w=OUT_W,
    )
    assert tuple(got.shape) == (n, 1, OUT_H, OUT_W)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    # The window gather agrees with mask_normalize_crops on the same bytes.
    unpacked = warp._unpack4(torch.from_numpy(strip)) if pack4 else torch.from_numpy(strip)
    windows = torch.stack([unpacked[:, o : o + OUT_W] for o in offs.tolist()])
    again = warp.mask_normalize_crops(windows, torch.from_numpy(geom), torch.from_numpy(chains), page_hw=(90, 140))
    assert torch.equal(again, got)


def _mask(seed, hw=(61, 83), n=14):
    rng = np.random.default_rng(seed)
    m = np.zeros(hw, bool)
    for _ in range(n):
        y, x = rng.integers(0, hw[0] - 6), rng.integers(0, hw[1] - 20)
        m[y : y + rng.integers(1, 6), x : x + rng.integers(2, 20)] = True
    return m


@pytest.mark.parametrize("pool,solidify,caps", [(2, True, {}), (1, False, {}), (2, True, {"max_runs": 40, "k_row": 2})])
def test_batched_runs_tables_equal_jax_page_by_page(pool, solidify, caps):
    masks = np.stack([_mask(s) for s in range(4)] + [np.zeros((61, 83), bool)])
    got = rects.runs_tables(torch.from_numpy(masks), pool=pool, solidify=solidify, **caps)
    assert got.dtype == torch.int16 and tuple(got.shape) == (5, 7, caps.get("max_runs", 4096))
    for i, m in enumerate(masks):
        want = np.asarray(jrects.runs_tables(jnp.asarray(m), pool=pool, solidify=solidify, **caps))
        np.testing.assert_array_equal(got[i].numpy(), want)
        # One page of the stack is that page alone.
        assert torch.equal(rects.runs_tables(torch.from_numpy(m), pool=pool, solidify=solidify, **caps), got[i])
    if caps:
        assert int(got[0, 6, 0]) > 0  # runs beyond the caps are dropped and counted, page by page
    assert int((got[4, 0] >= 0).sum()) == 0


def _word_lines(seed, rect_cls, rrect_cls):
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(7):
        x, words = 10.0 + rng.uniform(0, 30), []
        for _ in range(rng.integers(1, 6)):
            w, h = rng.uniform(20, 80), rng.uniform(12, 20)
            y = 30.0 * r + rng.uniform(0, 3)
            rr = rrect_cls.from_rect(rect_cls.from_tlbr(y, x, y + h, x + w))
            if r % 3 == 2:
                th = rng.uniform(-0.15, 0.15)
                rr = rrect_cls(rr.center, (np.sin(th), -np.cos(th)), rr.width, rr.height)
            words.append(rr)
            x += w + rng.uniform(4, 20)
        lines.append(words)
    return lines


@pytest.mark.parametrize("seed", [0, 1])
def test_line_polygons_batch_matches_jax_and_the_single_form(seed):
    want_polys, want_rects = jrecog.line_polygons_batch(_word_lines(seed, JaxRect, JaxRotatedRect))
    lines = _word_lines(seed, Rect, RotatedRect)
    polys, line_rects = trecog.line_polygons_batch(lines)
    assert len(polys) == len(lines) == len(want_polys)
    for words, poly, rect, wp, wr in zip(lines, polys, line_rects, want_polys, want_rects):
        np.testing.assert_array_equal(poly, wp)
        np.testing.assert_array_equal(poly, trecog.line_polygon(words))
        assert (rect.top, rect.left, rect.bottom, rect.right) == (wr.top, wr.left, wr.bottom, wr.right)
        union = trecog.TextRecognizer._line_rect(words)
        assert (rect.top, rect.left, rect.bottom, rect.right) == (union.top, union.left, union.bottom, union.right)
    assert trecog.line_polygons_batch([]) == ([], [])


def test_polygon_slice_bounding_rect_matches_jax_and_the_batch_form():
    poly = trecog.line_polygon(_word_lines(2, Rect, RotatedRect)[2])
    x0, x1 = int(poly[:, 0].min()), int(poly[:, 0].max())
    ranges = np.array([[x0, x0 + 9], [x0 + 15, x0 + 40], [x1 - 5, x1], [x1 + 10, x1 + 20]])
    batch = trecog.polygon_slice_bounding_rects(poly, ranges)
    for (mn, mx), from_batch in zip(ranges.tolist(), batch):
        got = trecog.polygon_slice_bounding_rect(poly, mn, mx)
        want = jrecog.polygon_slice_bounding_rect(poly, mn, mx)
        if want is None:
            assert got is None and from_batch is None
            continue
        assert (got.top, got.left, got.bottom, got.right) == (want.top, want.left, want.bottom, want.right)
        assert (got.top, got.left, got.bottom, got.right) == (from_batch.top, from_batch.left, from_batch.bottom, from_batch.right)
    assert batch[-1] is None and batch[0] is not None


def test_find_text_lines_idx_arrays_matches_jax():
    if not native.available():
        pytest.skip(f"the native library cannot be built here: {native.build_error()}")
    rng = np.random.default_rng(4)
    words = [w for line in _word_lines(4, Rect, RotatedRect) for w in line]
    words = [words[i] for i in rng.permutation(len(words))]
    cols = [np.array(c) for c in zip(*[(w.center[0], w.center[1], w.up[0], w.up[1], w.width, w.height) for w in words])]
    got = layout.find_text_lines_idx_arrays(*cols)
    assert got == jlayout.find_text_lines_idx_arrays(*cols)
    feat, boxes = layout._word_features_arrays(*cols)
    jfeat, jboxes = jlayout._word_features_arrays(*cols)
    np.testing.assert_array_equal(feat, jfeat)
    np.testing.assert_array_equal(boxes, jboxes)
    assert sorted(i for line in got for i in line) == list(range(len(words)))
    # The array form is the object form.
    by_objects = layout.find_text_lines(words)
    assert [[tuple(words[i].center) for i in li] for li in got] == [[tuple(w.center) for w in l] for l in by_objects]


@pytest.mark.parametrize("use_native", [True, False])
def test_ctc_array_forms_match_jax(use_native):
    if use_native and not native.available():
        pytest.skip(f"the native library cannot be built here: {native.build_error()}")
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 5, (6, 40)).astype(np.uint8)
    logits = rng.standard_normal((3, 25, 10)) * 4.0
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    vals, idx = ctc.unpack_topk(ctc.beam_topk_packed(torch.from_numpy(lp), k=8).numpy(), 8)
    want_greedy = jctc.collapse_greedy_batch_arrays(labels)
    want_beam = jctc.beam_decode_topk_arrays(vals, idx, 10, 10)
    want_full = jctc.beam_decode_batch_arrays(lp, 10, excluded=[3])
    ctx = native.disabled() if not use_native else __import__("contextlib").nullcontext()
    with ctx:
        got_greedy = ctc.collapse_greedy_batch_arrays(labels)
        got_beam = ctc.beam_decode_topk_arrays(vals, idx, 10, 10)
        got_full = ctc.beam_decode_batch_arrays(lp, 10, excluded=[3])
    for got, want in ((got_greedy, want_greedy), (got_beam, want_beam), (got_full, want_full)):
        assert len(got) == len(want)
        for (gp, gl), (wp, wl) in zip(got, want):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gl, wl)
    assert any(len(p) for p, _ in got_greedy) and any(len(p) for p, _ in got_beam)


def test_text_lines_from_array_steps_equal_those_from_step_objects():
    words = _word_lines(6, Rect, RotatedRect)[1]
    poly = trecog.line_polygon(words)
    rect = Rect.from_tlbr(float(poly[:, 1].min()), float(poly[:, 0].min()), float(poly[:, 1].max()), float(poly[:, 0].max()))
    pos, lab = np.array([0, 3, 9, 30], np.int32), np.array([5, 1, 7, 2], np.int32)
    steps = [ctc.CtcStep(int(p), int(l)) for p, l in zip(pos, lab)]
    for rrect in (None, trecog.line_rotated_rect(words)):
        line = trecog._RecLine(index=0, poly=poly, rect=rect, resized_width=100, rrect=rrect)
        a, b, empty = trecog._text_lines_from_results(
            [
                trecog._LineResult(line, 128, 32, (pos, lab)),
                trecog._LineResult(line, 128, 32, steps),
                trecog._LineResult(line, 128, 32, (pos[:0], lab[:0])),
            ],
            "abcdefgh",
        )
        assert str(a) == str(b) == "eag" and empty is None  # the step at frame 30 lies in the padding
        assert [(c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in a.chars()] == [
            (c.rect.top, c.rect.left, c.rect.bottom, c.rect.right) for c in b.chars()
        ]


def test_fake_models_match_jax():
    rng = np.random.default_rng(7)
    x = rng.random((2, 1, 64, 22), dtype=np.float32) - 0.5
    det, rec = fakes.FakeDetectionModel(), fakes.FakeRecognitionModel()
    assert isinstance(det, Model) and isinstance(rec, Model) and isinstance(det, torch.nn.Module)
    assert det.input_shape() == jfakes.FakeDetectionModel().input_shape() == ["batch", 1, 200, 100]
    assert rec.input_shape() == jfakes.FakeRecognitionModel().input_shape()
    np.testing.assert_array_equal(det.run(torch.from_numpy(x)).numpy(), np.asarray(jfakes.FakeDetectionModel().run(jnp.asarray(x))))
    got = rec.run(torch.from_numpy(x))
    assert tuple(got.shape) == (5, 2, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfakes.FakeRecognitionModel().run(jnp.asarray(x))))
    assert not list(det.parameters()) and not list(rec.parameters())


def test_stage_timer_fence_and_trace(tmp_path, capsys):
    timer = StageTimer(debug=True, fence_device="cpu")
    with timer.stage("detect"):
        torch.ones(4).sum()
    with timer.stage("detect"):
        pass
    with timer.stage("layout"):
        pass
    assert list(timer.timings) == ["detect", "layout"] and timer.timings["detect"] > 0
    assert timer.summary().startswith("total=") and "detect=" in timer.summary()
    assert capsys.readouterr().out.count("detect:") == 2
    fence("cpu")
    fence(None)  # no card: nothing to wait for
    with trace(None):
        pass
    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
