"""The port's loader for the native host library (native/ocrs_native.cpp):
every entry point against the port's own numpy or tensor route on seeded
inputs, and against the JAX package's loader, which builds the same source.

Integers and masks are exact. The u8 outputs of the resize and of the line
extraction are held within 0.75 of a grey level (u8 rounding of the same
float sample, whose position the C++ and the tensor route compute in another
order). Without a C++ compiler every test here skips with the build's
output as the reason.
"""

import numpy as np
import pytest
import torch

from ocrs_tpu import native as jnative
from ocrs_tpu_torch import layout, native
from ocrs_tpu_torch.geometry import Rect, RotatedRect
from ocrs_tpu_torch.ops import ctc, rects
from ocrs_tpu_torch.ops.resize import resize_bilinear
from ocrs_tpu_torch.ops.warp import extract_line_batch_packed, extract_line_batch_rotated
from ocrs_tpu_torch.preprocess import BLACK_VALUE
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

U8_ATOL = 0.75


@pytest.fixture(autouse=True)
def lib():
    if not native.available():
        pytest.skip(f"the native library cannot be built here: {native.build_error()}")


def _words(seed, rows=10, tilt=0.0):
    """A page of word rects in rows, two columns apart by a wide gutter,
    in random order."""
    rng = np.random.default_rng(seed)
    words = []
    for col_x in (20, 520):
        for r in range(rows):
            x = col_x + rng.integers(0, 8)
            for _ in range(rng.integers(2, 6)):
                w = int(rng.integers(20, 90))
                y = 40 * r + int(rng.integers(0, 4))
                rect = RotatedRect.from_rect(Rect.from_tlbr(y, x, y + 20, x + w))
                if tilt:
                    rect = RotatedRect(rect.center, (np.sin(tilt), -np.cos(tilt)), rect.width, rect.height)
                words.append(rect)
                x += w + int(rng.integers(6, 24))
    order = rng.permutation(len(words))
    return [words[i] for i in order]


def _arrays(words):
    cols = zip(*[(w.center[0], w.center[1], w.up[0], w.up[1], w.width, w.height) for w in words])
    return [np.array(c, dtype=np.float64) for c in cols]


def _centers(lines):
    return [[tuple(w.center) for w in line] for line in lines]


def test_loader_builds_into_its_own_directory_and_reports_no_error():
    native.require()
    assert native.build_error() is None
    built = sorted(p.name for p in (native._BUILD_DIR).glob("libocrs_native-*.so"))
    assert built and native._BUILD_DIR.parts[-2:] == ("build", "native")
    assert native._BUILD_DIR != jnative._BUILD_DIR  # not the JAX package's cache


def test_disabled_makes_every_wrapper_return_none_and_require_raise():
    with native.disabled():
        assert not native.available()
        assert native.ctc_collapse_batch(np.zeros((1, 4), np.int32)) is None
        assert native.runs_to_rects(np.zeros((1, 6, 4), np.int16), 2, 8) is None
        with pytest.raises(RuntimeError, match="disabled"):
            native.require()
    assert native.available()


@pytest.mark.parametrize("seed,tilt", [(0, 0.0), (1, 0.0), (2, 0.05)])
def test_layout_native_routes_equal_numpy_routes(seed, tilt):
    words = _words(seed, tilt=tilt)
    idx = layout._WordIndex(words)
    # find_separators (inside find_block_separators) and group_lines.
    seps = layout.find_block_separators(words, idx=idx)
    lines = layout._group_into_lines_idx(words, (), idx=idx)
    text_lines = layout.find_text_lines(words)
    from_arrays = layout.find_text_lines_idx_arrays(*_arrays(words))
    with native.disabled():
        assert layout.find_text_lines_idx_arrays(*_arrays(words)) is None
        want_seps = layout.find_block_separators(words, idx=idx)
        want_lines = layout._group_into_lines_idx(words, (), idx=idx)
        want_text_lines = layout.find_text_lines(words)
    assert [(s.top, s.left, s.bottom, s.right) for s in seps] == [
        (s.top, s.left, s.bottom, s.right) for s in want_seps
    ]
    assert len(seps) > 0
    assert lines == want_lines
    assert _centers(text_lines) == _centers(want_text_lines)
    # oc_find_text_lines: the whole layout in one call, from arrays.
    assert _centers([[words[i] for i in li] for li in from_arrays]) == _centers(want_text_lines)
    assert layout.find_text_lines_idx_arrays(*(np.zeros(0) for _ in range(6))) == []


def test_group_into_lines_and_max_empty_rects_public_forms():
    words = _words(3, rows=4)
    with native.disabled():
        want = layout.group_into_lines(words)
    assert _centers(layout.group_into_lines(words)) == _centers(want)
    obstacles = [Rect.from_tlbr(10, 10, 30, 40), Rect.from_tlbr(10, 70, 30, 100)]
    area = lambda r: r.width * r.height
    found = list(layout.max_empty_rects(obstacles, Rect.from_tlbr(0, 0, 40, 110), area, 5, 5))
    assert len(found) > 2 and area(found[0]) >= area(found[-1])
    assert not any(f.intersects(o) for f in found for o in obstacles)


def _blob_mask(seed, hw=(80, 120), n=10):
    rng = np.random.default_rng(seed)
    m = np.zeros(hw, bool)
    for _ in range(n):
        y, x = rng.integers(0, hw[0] - 8), rng.integers(0, hw[1] - 30)
        m[y : y + rng.integers(3, 8), x : x + rng.integers(6, 30)] = True
    return m


@pytest.mark.parametrize("pool", [1, 2])
def test_runs_to_rects_equals_numpy_route(pool):
    runs = rects.runs_tables(torch.from_numpy(np.stack([_blob_mask(4), _blob_mask(5)])), pool=pool).numpy()
    assert runs.shape == (2, 7, 4096)
    got = native.runs_to_rects(np.ascontiguousarray(runs[:, :6]), pool, 64)
    want = rects._runs_to_rects_numpy(runs[:, :6], pool, 64)
    # The same union-find and calipers in double precision on both sides.
    np.testing.assert_allclose(got, want, atol=1e-9)
    table = rects.runs_to_rect_table_host(runs, pool, 64)
    with native.disabled():
        table_numpy = rects.runs_to_rect_table_host(runs, pool, 64)
    for k in ("valid", "count", "dropped"):
        np.testing.assert_array_equal(table[k], table_numpy[k])
    assert table["valid"].sum() > 4
    np.testing.assert_array_equal(got, jnative.runs_to_rects(np.ascontiguousarray(runs[:, :6]), pool, 64))


def _assert_same_steps(got, want):
    """(pos, lab, counts) of the two loaders: equal counts, and equal
    entries below each line's count (the rest is not written)."""
    (pos, lab, counts), (jpos, jlab, jcounts) = got, want
    np.testing.assert_array_equal(counts, jcounts)
    for i, c in enumerate(counts):
        np.testing.assert_array_equal(pos[i, :c], jpos[i, :c])
        np.testing.assert_array_equal(lab[i, :c], jlab[i, :c])


def test_ctc_collapse_equals_numpy_route():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 4, (7, 50)).astype(np.uint8)
    got = ctc.collapse_greedy_batch_arrays(labels)
    with native.disabled():
        want = ctc.collapse_greedy_batch_arrays(labels)
        want_steps = ctc.collapse_greedy_batch(labels)
    for (gp, gl), (wp, wl) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
        assert gp.dtype == wp.dtype == np.int32 and gl.dtype == wl.dtype == np.int32
    assert ctc.collapse_greedy_batch(labels) == want_steps
    _assert_same_steps(native.ctc_collapse_batch(labels), jnative.ctc_collapse_batch(labels))


@pytest.mark.parametrize("width", [1, 5, 100])
def test_ctc_beam_equals_python_beam(width):
    rng = np.random.default_rng(width)
    logits = rng.standard_normal((4, 30, 12)) * 4.0
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    k = ctc.beam_candidate_k(width, 12)
    vals, idx = ctc.unpack_topk(ctc.beam_topk_packed(torch.from_numpy(lp), k=k).numpy(), k)
    got = ctc.beam_decode_topk(vals, idx, width, 12)
    got_full = ctc.beam_decode_batch(lp, width, excluded=[2])
    with native.disabled():
        assert ctc.beam_decode_topk(vals, idx, width, 12) == got
        assert ctc.beam_decode_batch(lp, width, excluded=[2]) == got_full
    assert any(len(steps) > 3 for steps in got)
    assert all(s.label != 2 for steps in got_full for s in steps)
    arrays = ctc.beam_decode_topk_arrays(vals, idx, width, 12)
    assert [list(zip(p.tolist(), l.tolist())) for p, l in arrays] == [[(s.pos, s.label) for s in st] for st in got]
    arrays_full = ctc.beam_decode_batch_arrays(lp, width, excluded=[2])
    assert [list(zip(p.tolist(), l.tolist())) for p, l in arrays_full] == [[(s.pos, s.label) for s in st] for st in got_full]
    _assert_same_steps(native.ctc_beam_topk(vals, idx, width), jnative.ctc_beam_topk(vals, idx, width))


def test_resize_pages_equals_tensor_route():
    rng = np.random.default_rng(7)
    pages = rng.integers(0, 256, (2, 37, 61), np.uint8)
    got = native.resize_pages(pages, (20, 24))
    want = resize_bilinear(torch.from_numpy(pages).to(torch.float32), (20, 24)).numpy()
    assert got.shape == (2, 20, 24) and got.dtype == np.uint8
    np.testing.assert_allclose(got.astype(np.float32), want, atol=U8_ATOL)
    np.testing.assert_array_equal(got, jnative.resize_pages(pages, (20, 24)))
    packed = native.resize_pages(pages, (20, 24), pack4=True)
    assert packed.shape == (2, 20, 12)
    np.testing.assert_array_equal(packed, jnative.resize_pages(pages, (20, 24), pack4=True))
    # A page smaller than the target is padded bottom and right with black.
    small = native.resize_pages(np.full((1, 10, 40), 200, np.uint8), (20, 32))
    assert (small[0, :10, :32] > 150).all() and (small[0, 12:] == 0).all()


def _line_geom():
    return np.array(
        [
            [5.0, 30.0, 10.0],  # top
            [3.0, 10.0, 1.0],  # left
            [12.0, 20.0, 9.0],  # height
            [40.0, 60.0, 33.0],  # width
            [30.0, 24.0, 17.0],  # resized width
            [0.0, 1.0, 0.0],  # page index
        ],
        np.float32,
    )


def test_extract_lines_equals_tensor_route():
    rng = np.random.default_rng(8)
    pages = rng.integers(0, 256, (2, 50, 80), np.uint8)
    geom = _line_geom()
    got = native.extract_lines(pages, geom, out_h=16, out_w=32)
    # The tensor route with chains that mask nothing: a band far above and
    # below every line. What is left of the mask is in-page and valid-column.
    chains = np.zeros((3, 2, 4, 2), np.float32)
    chains[:, :, :, 0] = np.linspace(-10, 200, 4)
    chains[:, 0, :, 1], chains[:, 1, :, 1] = -100.0, 300.0
    norm = torch.from_numpy(pages).to(torch.float32) / 255.0 + BLACK_VALUE
    want = extract_line_batch_packed(norm, torch.from_numpy(geom), torch.from_numpy(chains), out_h=16, out_w=32)
    want_u8 = (want[:, 0].numpy() - BLACK_VALUE) * 255.0
    np.testing.assert_allclose(got.astype(np.float32), want_u8, atol=U8_ATOL)
    for i, w in enumerate(geom[4].astype(int)):
        assert (got[i, :, w:] == 0).all() and got[i, :, :w].any()
    np.testing.assert_array_equal(got, jnative.extract_lines(pages, geom, out_h=16, out_w=32))


@pytest.mark.parametrize("pack4", [False, True])
def test_extract_lines_strip_equals_padded_crops(pack4):
    rng = np.random.default_rng(9)
    pages = rng.integers(0, 256, (2, 60, 90), np.uint8)
    geom = _line_geom()
    geom[4, 2] = 0.0  # a padding line
    offs = np.array([0, 30, 54], np.int32)
    strip = native.extract_lines_strip(pages, geom, offs, out_h=16, total_w=64, pack4=pack4)
    padded = native.extract_lines(pages, geom, out_h=16, out_w=32, pack4=pack4)
    assert strip.shape == (16, 32 if pack4 else 64)
    per = 2 if pack4 else 1
    for i, off in enumerate(offs):
        w = int(geom[4, i]) // per
        np.testing.assert_array_equal(strip[:, off // per : off // per + w], padded[i, :, :w])
    assert (strip[:, 54 // per :] == 0).all()
    np.testing.assert_array_equal(
        strip, jnative.extract_lines_strip(pages, geom, offs, out_h=16, total_w=64, pack4=pack4)
    )


def test_extract_lines_rotated_equals_tensor_route():
    rng = np.random.default_rng(10)
    pages = rng.integers(0, 256, (2, 60, 60), np.uint8)
    geom = np.zeros((10, 2), np.float32)
    for col, (deg, origin, page) in enumerate(((12.0, (8.0, 10.0), 1.0), (-20.0, (5.0, 40.0), 0.0))):
        theta = np.radians(deg)
        geom[0:2, col] = origin
        geom[2:4, col] = (np.cos(theta), np.sin(theta))
        geom[4:6, col] = (-np.sin(theta), np.cos(theta))
        geom[6:10, col] = (42.0, 14.0, 28.0, page)
    got = native.extract_lines_rotated(pages, geom, out_h=16, out_w=32)
    norm = torch.from_numpy(pages).to(torch.float32) / 255.0 + BLACK_VALUE
    want = extract_line_batch_rotated(norm, torch.from_numpy(geom), out_h=16, out_w=32)[:, 0].numpy()
    np.testing.assert_allclose(got.astype(np.float32), (want - BLACK_VALUE) * 255.0, atol=U8_ATOL)
    assert (got[:, :, 28:] == 0).all() and got[:, :, :28].any()
    np.testing.assert_array_equal(got, jnative.extract_lines_rotated(pages, geom, out_h=16, out_w=32))
