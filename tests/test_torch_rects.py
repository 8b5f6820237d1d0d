"""The port's device rect fitting and run tables (ocrs_tpu_torch.ops.rects)
against the JAX package's on the same masks and labels.

Integers (``valid``, ``count``, ``dropped``, the int16 run tables) agree
exactly. The geometry goes through float32 ``cos``/``sin`` and an ``argmin``
over candidate angles, where the two frameworks may differ in the last bit:
it agrees to a tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.ops import connected_components as jcc
from ocrs_tpu.ops import rects as jr
from ocrs_tpu_torch.geometry import RotatedRect
from ocrs_tpu_torch.ops import rects as tr
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

# Centres and extents in pixels, axes as unit vectors: float32 projections of
# coordinates below 256. Measured max |diff| 1.2e-5.
GEOM_ATOL = 1e-3


def _boxes(h, w, n, seed, rotated=False):
    """`n` separate rectangles (rotated: oriented ones) on an empty page."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx = rng.integers(12, h - 12), rng.integers(20, w - 20)
        hh, ww = rng.integers(3, 9), rng.integers(6, 30)
        a = rng.uniform(-0.6, 0.6) if rotated else 0.0
        u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
        v = (yy - cy) * np.cos(a) - (xx - cx) * np.sin(a)
        m |= (np.abs(u) <= ww / 2) & (np.abs(v) <= hh / 2)
    return m


def _grid_of_dots(rows, cols, pitch=12, hw=(100, 150)):
    """rows x cols components of 3 x 4 px, `pitch` apart: none merges."""
    m = np.zeros(hw, bool)
    for r in range(rows):
        for c in range(cols):
            m[2 + r * pitch : 5 + r * pitch, 2 + c * pitch : 6 + c * pitch] = True
    return m


# One shape for all but one mask: the JAX functions compile once per shape.
MASKS = {
    "boxes": _boxes(100, 150, 25, 1),
    "rotated": _boxes(100, 150, 20, 2, rotated=True),
    "empty": np.zeros((100, 150), bool),
    "one_blob": np.pad(np.ones((200, 150), bool), 5),  # more endpoints than one tile holds
    "dots": _grid_of_dots(6, 9),
}


def _labels(mask):
    return np.array(jcc.label_components_multigrid(jnp.asarray(mask)))


def _check_table(want, got):
    for k in ("valid", "count", "dropped"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    valid = np.asarray(want["valid"])
    for k in ("cx", "cy", "ux", "uy", "w", "h"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid], atol=GEOM_ATOL, rtol=0, err_msg=k)
    return int(valid.sum())


@pytest.mark.parametrize("name", sorted(MASKS))
def test_min_area_rects_table_matches_jax(name):
    labels = _labels(MASKS[name])
    want = jr.min_area_rects_device(jnp.asarray(labels))
    got = tr.min_area_rects_device(torch.from_numpy(labels))
    n = _check_table(want, got)
    assert (n == 0) == (name == "empty")
    if name == "dots":
        assert n == 54 and int(got["dropped"]) == 0


@pytest.mark.parametrize(
    "caps",
    [{"max_components": 8}, {"max_boundary": 100}, {"max_components": 8, "max_boundary": 130}, {"max_points": 64}],
    ids=["max_components", "max_boundary", "both", "max_points"],
)
@pytest.mark.parametrize("name", ["dots", "rotated", "one_blob"])
def test_min_area_rects_match_jax_beyond_the_caps(name, caps):
    labels = _labels(MASKS[name])
    want = jr.min_area_rects_device(jnp.asarray(labels), **caps)
    got = tr.min_area_rects_device(torch.from_numpy(labels), **caps)
    _check_table(want, got)
    if name == "dots" and "max_components" in caps and "max_boundary" not in caps:
        assert int(got["dropped"]) == 54 - 8 and int(got["valid"].sum()) == 8


@pytest.mark.parametrize(
    "name,multigrid",
    [("boxes", True), ("rotated", True), ("dots", True), ("empty", True), ("rotated", False), ("empty", False)],
)
def test_rects_from_mask_device_match_jax(name, multigrid):
    mask = MASKS[name]
    want = jr.rects_from_mask_device(jnp.asarray(mask), 3.0, 100.0, multigrid=multigrid)
    got = tr.rects_from_mask_device(torch.from_numpy(mask), 3.0, 100.0, multigrid=multigrid)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, RotatedRect)
        np.testing.assert_allclose(np.stack(g.corners()), np.stack(w.corners()), atol=GEOM_ATOL, rtol=0)
    if name == "dots":
        assert len(got) == 0  # 6 x 7 px after the expansion: below min_area


def test_overflow_beyond_max_components_warns_like_jax(caplog):
    mask = MASKS["dots"]
    with caplog.at_level("WARNING", logger="ocrs_tpu_torch"):
        got = tr.rects_from_mask_device(torch.from_numpy(mask), 0.0, 0.0, max_components=10)
    want = jr.rects_from_mask_device(jnp.asarray(mask), 0.0, 0.0, max_components=10)
    assert len(got) == len(want) == 10
    assert "44 more components" in caplog.text


@pytest.mark.parametrize("solidify", [False, True])
@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_runs_tables_equal_jax(name, pool, solidify):
    mask = MASKS[name]
    want = np.asarray(jr.runs_tables(jnp.asarray(mask), pool=pool, solidify=solidify))
    got = tr.runs_tables(torch.from_numpy(mask), pool=pool, solidify=solidify)
    assert got.dtype == torch.int16 and tuple(got.shape) == (7, 4096)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("caps", [{"max_runs": 50}, {"k_row": 3}, {"max_runs": 20, "k_row": 2}], ids=str)
@pytest.mark.parametrize("pool", [1, 2])
def test_runs_tables_equal_jax_beyond_the_caps(pool, caps):
    for name in ("boxes", "dots"):
        mask = MASKS[name]
        want = np.asarray(jr.runs_tables(jnp.asarray(mask), pool=pool, **caps))
        got = tr.runs_tables(torch.from_numpy(mask), pool=pool, **caps).numpy()
        np.testing.assert_array_equal(got, want)
        if name == "dots":  # 9 runs a row, 162 in all
            assert got[6, 0] > 0  # orig runs were dropped, and counted


@pytest.mark.parametrize("pool", [1, 2])
def test_runs_to_rect_table_host_matches_jax_numpy_route(pool):
    runs = np.stack(
        [tr.runs_tables(torch.from_numpy(MASKS[n]), pool=pool).numpy() for n in ("boxes", "rotated")]
    )
    want = jr._runs_to_rects_numpy(runs[:, :6], pool, 64)
    np.testing.assert_array_equal(tr._runs_to_rects_numpy(runs[:, :6], pool, 64), want)
    table = tr.runs_to_rect_table_host(runs, pool, 64)
    assert table["valid"].dtype == bool and table["count"].dtype == np.int32
    assert table["valid"].sum(axis=1).tolist() == (want[:, 0] > 0.5).sum(axis=1).tolist()
    assert table["dropped"].tolist() == [0, 0]
    # The run-table route finds the components the multigrid labeller finds.
    if pool == 2:
        labels = _labels(MASKS["boxes"])
        assert int(table["valid"][0].sum()) == len(np.unique(labels)) - 1


def test_pack_rect_table_round_trip_and_field_order():
    assert tr.PACK_FIELDS == jr.PACK_FIELDS
    labels = _labels(MASKS["boxes"])
    table = tr.min_area_rects_device(torch.from_numpy(labels), max_components=32)
    packed = tr.pack_rect_table(table)
    assert packed.dtype == torch.float32 and tuple(packed.shape) == (9, 32)
    want = np.asarray(jr.pack_rect_table(jr.min_area_rects_device(jnp.asarray(labels), max_components=32)))
    np.testing.assert_allclose(packed.numpy(), want, atol=GEOM_ATOL, rtol=0)
    back = tr.unpack_rect_table(packed)
    np.testing.assert_array_equal(back["valid"], table["valid"].numpy())
    np.testing.assert_array_equal(back["count"], table["count"].numpy())
    assert int(back["dropped"]) == int(table["dropped"])
