"""The port's host post-processing, layout, line extraction and greedy CTC
against the JAX package on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu import detection as jdet
from ocrs_tpu import geometry as jgeom
from ocrs_tpu import layout as jlayout
from ocrs_tpu.ops import ctc as jctc
from ocrs_tpu.ops import warp as jwarp
from ocrs_tpu.recognition import line_polygon as jax_line_polygon
from ocrs_tpu_torch import detection as tdet
from ocrs_tpu_torch import geometry as tgeom
from ocrs_tpu_torch import layout as tlayout
from ocrs_tpu_torch import recognition as trec
from ocrs_tpu_torch.ops import ctc as tctc
from ocrs_tpu_torch.ops import warp as twarp
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

# Same float32 formulas on both sides, but XLA fuses the sample-position
# arithmetic into FMAs, so a page coordinate can differ by one float32 ulp
# (3.05e-5 for coordinates in [256, 512) on the 260-px-wide page below).
# The bilinear weight then differs by that ulp, times a pixel step of at
# most 1, in each of the two passes (measured 1.2e-5).
EXTRACT_ATOL = 2 * float(np.spacing(np.float32(256)))


def _blob_mask(seed, hw=(120, 160), n=12):
    """Random filled ellipses, some rotated, some touching."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: hw[0], : hw[1]].astype(np.float64)
    mask = np.zeros(hw, dtype=bool)
    for _ in range(n):
        cy, cx = rng.uniform(0, hw[0]), rng.uniform(0, hw[1])
        a, b = rng.uniform(2, 18), rng.uniform(1.5, 6)
        th = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        mask |= (u / a) ** 2 + (v / b) ** 2 <= 1.0
    return mask


def _rect_tuple(r):
    return (*np.round(r.center, 9), *np.round(r.up, 9), round(r.width, 9), round(r.height, 9))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rects_from_mask_host_identical(seed):
    mask = _blob_mask(seed)
    want = jdet.rects_from_mask_host(mask, expand_dist=jdet.EXPAND_DIST, min_area=30.0)
    got = tdet.rects_from_mask_host(mask, expand_dist=tdet.EXPAND_DIST, min_area=30.0)
    assert len(want) > 3
    assert [_rect_tuple(r) for r in got] == [_rect_tuple(r) for r in want]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_area_rect_identical(seed):
    pts = np.random.default_rng(seed).standard_normal((40, 2)) * [30.0, 8.0]
    assert _rect_tuple(tgeom.min_area_rect(pts)) == _rect_tuple(jgeom.min_area_rect(pts))


def _page_words(seed):
    """Word rects of a two-column page: (center, up, width, height) tuples,
    shuffled, with small skew and jitter."""
    rng = np.random.default_rng(seed)
    words = []
    for col_left in (20.0, 420.0):
        for row in range(7):
            x = col_left + rng.uniform(0, 8)
            y = 30.0 + 26.0 * row + rng.uniform(-2, 2)
            while x < col_left + 320:
                w = rng.uniform(18, 60)
                th = rng.uniform(-0.03, 0.03)
                words.append(((x + w / 2, y), (np.sin(th), -np.cos(th)), w, rng.uniform(14, 18)))
                x += w + rng.uniform(6, 12)
    order = rng.permutation(len(words))
    return [words[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1])
def test_find_text_lines_identical_to_native_backed_jax(seed):
    spec = _page_words(seed)
    jwords = [jgeom.RotatedRect(*s) for s in spec]
    twords = [tgeom.RotatedRect(*s) for s in spec]
    want = jlayout.find_text_lines(jwords)
    got = tlayout.find_text_lines(twords)
    jid = {id(w): i for i, w in enumerate(jwords)}
    tid = {id(w): i for i, w in enumerate(twords)}
    assert [[tid[id(w)] for w in line] for line in got] == [[jid[id(w)] for w in line] for line in want]
    assert len(got) > 7


def test_find_block_separators_identical():
    spec = _page_words(3)
    want = jlayout.find_block_separators([jgeom.RotatedRect(*s) for s in spec])
    got = tlayout.find_block_separators([tgeom.RotatedRect(*s) for s in spec])
    assert [(r.top, r.left, r.bottom, r.right) for r in got] == [
        (r.top, r.left, r.bottom, r.right) for r in want
    ]
    assert got


def test_extract_line_batch_packed_matches_jax():
    rng = np.random.default_rng(0)
    page = (rng.random((140, 260)) - 0.5).astype(np.float32)
    lines = [
        [((40, 30), (0, -1), 60, 24), ((110, 32), (0.05, -1), 70, 22)],
        [((60, 80), (0, -1), 100, 30)],
        [((150, 120), (-0.04, -1), 80, 26), ((230, 121), (0, -1), 50, 28)],  # runs off the page
    ]
    out_h, out_w, v = 32, 256, 16
    geom = np.zeros((6, len(lines)), np.float32)
    chains = np.zeros((len(lines), 2, v, 2), np.float32)
    for col, spec in enumerate(lines):
        poly = trec.line_polygon([tgeom.RotatedRect(*s) for s in spec])
        np.testing.assert_array_equal(poly, jax_line_polygon([jgeom.RotatedRect(*s) for s in spec]))
        top, left = poly[:, 1].min(), poly[:, 0].min()
        height, width = poly[:, 1].max() - top, poly[:, 0].max() - left
        geom[:, col] = (top, left, height, width, trec.resized_line_width(width, height, out_h), 0)
        half = len(poly) // 2
        chains[col, 0] = twarp.pad_chain(poly[:half], v)
        chains[col, 1] = twarp.pad_chain(poly[half:][::-1], v)
        np.testing.assert_array_equal(chains[col, 0], jwarp.pad_chain(poly[:half], v))
    want = np.asarray(
        jwarp.extract_line_batch_packed(
            jnp.asarray(page), jnp.asarray(geom), jnp.asarray(chains), out_h=out_h, out_w=out_w
        )
    )
    got = twarp.extract_line_batch_packed(
        torch.from_numpy(page), torch.from_numpy(geom), torch.from_numpy(chains), out_h=out_h, out_w=out_w
    )
    assert tuple(got.shape) == (len(lines), 1, out_h, out_w)
    np.testing.assert_allclose(got.numpy(), want, atol=EXTRACT_ATOL, rtol=0)


def test_chain_eval_takes_last_vertex_of_equal_x_run():
    # A vertical step in the chain (equal x) resolves to its last vertex, as
    # the JAX comparison-count form does.
    chain = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [10.0, 5.0], [20.0, 5.0]]])
    q = torch.tensor([[5.0, 10.0, 15.0]])
    torch.testing.assert_close(twarp._chain_eval(q, chain), torch.tensor([[0.0, 5.0, 5.0]]))


def test_greedy_labels_and_collapse_match_jax_exactly():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 40, 9)).astype(np.float32)
    # Force ties: the first maximal index wins in both frameworks.
    logits[0, 5, [2, 6]] = 10.0
    logits[1, 7, [0, 3]] = 10.0
    logits[2, :10] = 0.0
    logits[2, 10:20, 4] = 5.0
    want_labels = np.asarray(jctc.greedy_labels_u8(jnp.asarray(logits)))
    got_labels = tctc.greedy_labels_u8(torch.from_numpy(logits)).numpy()
    assert got_labels.dtype == np.uint8
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got_labels[0, 5] == 2 and got_labels[1, 7] == 0
    want = jctc.collapse_greedy_batch(want_labels)
    got = tctc.collapse_greedy_batch(got_labels)
    assert [[(s.pos, s.label) for s in line] for line in got] == [
        [(s.pos, s.label) for s in line] for line in want
    ]
    assert [(s.pos, s.label) for s in tctc.collapse_greedy(np.array([0, 3, 3, 0, 3, 5, 5, 0, 0, 1]))] == [
        (1, 3), (4, 3), (5, 5), (9, 1)
    ]


def test_mask_excluded_matches_jax():
    logprobs = np.random.default_rng(1).standard_normal((2, 5, 6)).astype(np.float32)
    onehot = np.array([False, True, False, False, True, False])
    want = np.asarray(jctc.mask_excluded(jnp.asarray(logprobs), jnp.asarray(onehot)))
    got = tctc.mask_excluded(torch.from_numpy(logprobs), torch.from_numpy(onehot)).numpy()
    np.testing.assert_array_equal(got, want)


def test_polygon_slice_bounding_rects_identical():
    from ocrs_tpu.recognition import polygon_slice_bounding_rects as jax_slices

    spec = [((40, 30), (0.05, -1), 60, 24), ((110, 32), (0, -1), 70, 22)]
    poly = trec.line_polygon([tgeom.RotatedRect(*s) for s in spec])
    ranges = np.array([[5, 20], [20, 41], [60, 90], [130, 150], [-10, 2]])
    want = jax_slices(poly, ranges)
    got = trec.polygon_slice_bounding_rects(poly, ranges)
    as_tuples = lambda rs: [None if r is None else (r.top, r.left, r.bottom, r.right) for r in rs]
    assert as_tuples(got) == as_tuples(want)
