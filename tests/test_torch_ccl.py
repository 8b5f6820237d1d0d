"""The port's device labelling (ocrs_tpu_torch.ops.connected_components)
against the JAX package's, label for label.

Labels, run ids and counts are integers: they must agree exactly, also where
the static table caps (``max_runs``, ``max_edges``, 32 run starts and 64 edge
candidates per row) drop runs or edges.

One result differs from the JAX package's by design, and a test below shows
it: ``ocrs_tpu``'s ``_run_scan_min`` spreads labels only forwards along a run
(its reverse scan gates on the wrong operand), and where the last pixel of a
row or column is set it leaks the label of the run that touches that edge
into every other run of the row or column, merging separate components. The
port computes what the docstring there says, the minimum of each run. The two
agree exactly on masks whose last row and column are clear, once both have
reached their fixed point (the JAX sweeps need far more iterations for it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from ocrs_tpu.ops import connected_components as jcc
from ocrs_tpu_torch.ops import connected_components as tcc


def _blobs(h, w, n, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), bool)
    for _ in range(n):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y : y + rng.integers(1, 8), x : x + rng.integers(2, 30)] = True
    return m


def _serpentine(h, w):
    """One component snaking across the page: every other row full, joined
    alternately at the right and left ends."""
    m = np.zeros((h, w), bool)
    for i, y in enumerate(range(0, h, 2)):
        m[y, :] = True
        if y + 1 < h:
            m[y + 1, (w - 1) if i % 2 == 0 else 0] = True
    return m


def _noise(h, w, p, seed):
    return np.random.default_rng(seed).random((h, w)) < p


# Two shapes only, both odd-sized: the JAX functions compile once per shape.
HW = (61, 83)
MASKS = {
    "blobs": _blobs(*HW, 30, 1),
    "blobs_dense": _blobs(*HW, 80, 2),
    "serpentine": _serpentine(*HW),
    "empty": np.zeros(HW, bool),
    "full": np.ones(HW, bool),
    "noise_odd": _noise(*HW, 0.4, 3),
    "noise_dense_wide": _noise(41, 201, 0.5, 4),  # > 32 runs and > 64 edges per row
    "one_pixel": np.pad(np.ones((1, 1), bool), ((30, 30), (41, 41))),
}


def _clear_border(m):
    m = m.copy()
    m[-1, :] = False
    m[:, -1] = False
    return m


def _same(fn, mask, **kw):
    want = np.asarray(getattr(jcc, fn)(jnp.asarray(mask), **kw))
    got = getattr(tcc, fn)(torch.from_numpy(mask), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == mask.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("solidify", [False, True])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_rungraph_labels_equal_jax(name, solidify):
    _same("label_components_rungraph", MASKS[name], solidify=solidify)


@pytest.mark.parametrize("solidify", [False, True])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_multigrid_labels_equal_jax(name, solidify):
    _same("label_components_multigrid", MASKS[name], solidify=solidify)


@pytest.mark.parametrize(
    "caps",
    [
        {"max_runs": 64, "max_edges": 32768},
        {"max_runs": 8192, "max_edges": 48},
        {"max_runs": 40, "max_edges": 25},
        {"max_runs": 8192, "max_edges": 32768, "max_iters": 1},
    ],
    ids=["max_runs", "max_edges", "both", "max_iters"],
)
@pytest.mark.parametrize("name", ["blobs_dense", "noise_dense_wide", "serpentine"])
def test_rungraph_equals_jax_beyond_the_caps(name, caps):
    mask = MASKS[name]
    got = _same("label_components_rungraph", mask, **caps)
    if caps["max_runs"] < 100 and name != "serpentine":
        # Runs beyond max_runs lose their pixels.
        assert ((got >= 0) != mask).any()


@pytest.mark.parametrize("solidify", [False, True])
@pytest.mark.parametrize("name", ["blobs", "blobs_dense", "serpentine", "empty", "noise_odd", "one_pixel"])
def test_device_labels_equal_jax(name, solidify):
    # The JAX sweeps spread labels forwards only (see the module docstring),
    # so they need many more iterations than the port's: give them room to
    # reach the fixed point, which is what the two have in common.
    mask = _clear_border(MASKS[name])
    want = np.asarray(jcc.label_components_device(jnp.asarray(mask), solidify=solidify, max_iters=512))
    got = tcc.label_components_device(torch.from_numpy(mask), solidify=solidify)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_sweeps_converge_where_the_jax_sweeps_run_out_of_iterations():
    mask = _clear_border(MASKS["blobs_dense"])
    at_cap = np.asarray(jcc.label_components_device(jnp.asarray(mask), solidify=True))
    fixed_point = np.asarray(jcc.label_components_device(jnp.asarray(mask), solidify=True, max_iters=512))
    assert (at_cap != fixed_point).any()  # 64 forward-only sweeps are not enough here
    tcc.loop_counts.update(iterations=0, host_syncs=0)
    got = tcc.label_components_device(torch.from_numpy(mask), solidify=True).numpy()
    assert tcc.loop_counts["iterations"] < 16
    np.testing.assert_array_equal(got, fixed_point)


@pytest.mark.parametrize("name", ["blobs", "blobs_dense", "noise_odd", "noise_dense_wide", "full", "serpentine"])
def test_device_labels_are_the_components_scipy_finds(name):
    mask = MASKS[name]
    # Dense noise is a maze: give the sweeps room to reach its fixed point.
    labels = tcc.label_components_device(torch.from_numpy(mask), max_iters=512).numpy()
    want, count = ndimage.label(mask, structure=np.ones((3, 3)))
    got, got_count = tcc.compact_labels_host(labels)
    assert got_count == count
    np.testing.assert_array_equal(got > 0, mask)
    # Same partition: each port label meets exactly one scipy label.
    assert len(set(zip(got[mask].tolist(), want[mask].tolist()))) == count
    # Each component is labelled by the smallest linear index of its pixels.
    lin = np.arange(mask.size).reshape(mask.shape)
    for lab in np.unique(labels[mask]):
        assert lin[labels == lab].min() == lab
    if name != "noise_dense_wide":  # there the run graph drops run starts beyond 32 a row
        np.testing.assert_array_equal(tcc.label_components_rungraph(torch.from_numpy(mask)).numpy(), labels)


def test_jax_run_scan_leaks_across_gaps_at_the_last_column_and_the_port_does_not():
    big = np.iinfo(np.int32).max
    row = np.array([[5, big, 3], [1, big, 5], [7, big, big]], np.int32)
    mask = row != big
    leaked = np.asarray(jcc._run_scan_min(jnp.asarray(row), jnp.asarray(mask), 1))
    # The run that touches the last column hands its label to the run across
    # the gap; a run that ends before the last column gets nothing from its
    # right at all.
    assert leaked.tolist() == [[3, big, 3], [1, big, 5], [7, big, big]]
    got = tcc._run_min(torch.from_numpy(row).to(torch.int64), torch.from_numpy(mask), 1)
    assert got.tolist() == [[5, big, 3], [1, big, 5], [7, big, big]]
    # On a whole mask: two blobs that share rows, the one with the smaller
    # label touching the right edge.
    m = np.zeros((8, 12), bool)
    m[1:4, 8:12] = True
    m[2:5, 1:4] = True
    assert len(np.unique(np.asarray(jcc.label_components_device(jnp.asarray(m))))) - 1 == 1
    assert len(np.unique(tcc.label_components_device(torch.from_numpy(m)).numpy())) - 1 == 2


def test_compact_labels_host_equals_jax():
    for name in ("blobs_dense", "empty", "noise_odd"):
        labels = np.asarray(jcc.label_components_rungraph(jnp.asarray(MASKS[name])))
        want, want_count = jcc.compact_labels_host(labels)
        got, count = tcc.compact_labels_host(labels)
        assert count == want_count and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_loop_counts_count_iterations_and_reads():
    tcc.loop_counts.update(iterations=0, host_syncs=0)
    tcc.label_components_multigrid(torch.from_numpy(MASKS["serpentine"]))
    first = dict(tcc.loop_counts)
    assert 1 <= first["iterations"] <= 24 and first["host_syncs"] == first["iterations"]
    tcc.label_components_device(torch.from_numpy(MASKS["blobs"]))
    assert tcc.loop_counts["iterations"] > first["iterations"]


def test_morphology_equals_jax():
    m = MASKS["noise_odd"]
    for fn in ("_dilate3", "_erode3"):
        np.testing.assert_array_equal(
            getattr(tcc, fn)(torch.from_numpy(m)).numpy(), np.asarray(getattr(jcc, fn)(jnp.asarray(m)))
        )
