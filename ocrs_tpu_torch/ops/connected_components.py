"""Connected components of binary text masks: on the host and on the device.

Port of ``ocrs_tpu.ops.connected_components``:

* :func:`label_components_host` -- exact host path (``scipy.ndimage.label``,
  8-connectivity) with :func:`component_boundary_points`.
* :func:`label_components_device` -- iterative min-label propagation over the
  pixel grid, on the mask's device.
* :func:`label_components_rungraph` -- union-find over the graph of row runs;
  :func:`label_components_multigrid` solves it at half resolution and lifts
  the labels back (the engine's default).

The device functions compute what the JAX functions compute, label for label,
including what is dropped at the static table caps, but not in the same way:
where the JAX code compacts with ``top_k`` the port ranks with a cumulative
sum and scatters into a table with one spare slot (PyTorch has no "drop"
scatter mode), and the segmented associative scan becomes a scattered minimum
per run. The loops that end when nothing changes are Python loops that read
one flag from the device per iteration; :data:`loop_counts` counts the
iterations and those reads.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

_EIGHT_CONN = np.ones((3, 3), dtype=bool)
_BIG = int(np.iinfo(np.int32).max)

#: Iterations of the label loops and device-to-host reads, summed over all
#: calls since the caller last zeroed them: one read per loop iteration here,
#: one per rect table in :func:`..ops.rects.rect_table_to_host`.
loop_counts = {"iterations": 0, "host_syncs": 0}


def label_components_host(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connected component labelling. Returns (labels, count) where labels
    is int32 with 0 = background."""
    labels, count = ndimage.label(np.asarray(mask, dtype=bool), structure=_EIGHT_CONN)
    return labels.astype(np.int32), int(count)


def component_boundary_points(labels: np.ndarray, count: int) -> list[np.ndarray]:
    """For each component 1..count, the (K, 2) [x, y] points on its boundary
    (pixels with a non-member 8-neighbour). Min-area rects of the boundary
    equal those of the full component."""
    mask = labels > 0
    interior = ndimage.binary_erosion(mask, structure=_EIGHT_CONN, border_value=0)
    boundary = mask & ~interior
    ys, xs = np.nonzero(boundary)
    lbl = labels[ys, xs]
    order = np.argsort(lbl, kind="stable")
    ys, xs, lbl = ys[order], xs[order], lbl[order]
    splits = np.searchsorted(lbl, np.arange(2, count + 1))
    return [
        np.stack([xs_i, ys_i], axis=1).astype(np.float64)
        for xs_i, ys_i in zip(np.split(xs, splits), np.split(ys, splits))
    ]


# ---------------------------------------------------------------------------
# On the device
# ---------------------------------------------------------------------------


def _pad2d(x: torch.Tensor, pads: tuple[int, int, int, int], value) -> torch.Tensor:
    """Constant padding of an [H, W] tensor of any dtype; `pads` is
    (top, bottom, left, right)."""
    top, bottom, left, right = pads
    h, w = x.shape
    out = x.new_full((h + top + bottom, w + left + right), value)
    out[top : top + h, left : left + w] = x
    return out


def _shift(x: torch.Tensor, dy: int, dx: int, value) -> torch.Tensor:
    """out[y, x] = x[y + dy, x + dx], `value` where that falls outside."""
    h, w = x.shape
    p = _pad2d(x, (1, 1, 1, 1), value)
    return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


_NEIGHBOURS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    p = _pad2d(mask, (1, 1, 1, 1), False)
    out = p[0:h, 0:w].clone()
    for dy, dx in _NEIGHBOURS[1:]:
        out |= p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return out


def _erode3(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    p = _pad2d(mask, (1, 1, 1, 1), False)
    out = p[0:h, 0:w].clone()
    for dy, dx in _NEIGHBOURS[1:]:
        out &= p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return out


def _close3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 closing that keeps every original pixel (closing alone erodes
    isolated 1-2 px specks away)."""
    return _erode3(_dilate3(mask)) | mask


def _propagate_once(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One 8-neighbourhood min-propagation step; background holds `_BIG`."""
    h, w = labels.shape
    p = _pad2d(labels, (1, 1, 1, 1), _BIG)
    out = labels
    for dy, dx in _NEIGHBOURS:
        if dy or dx:
            out = torch.minimum(out, p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return torch.where(mask, out, _BIG)


def _run_min(labels: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """The minimum label of each contiguous run of `mask` along `axis`,
    written to every pixel of the run (what the JAX package's segmented
    associative scans compute, forward and reverse combined)."""
    if axis == 0:
        return _run_min(labels.T, mask.T, 1).T
    h, w = mask.shape
    start = mask & ~_shift(mask, 0, -1, False)
    # Run id of every pixel; a background pixel takes the id of the run
    # before it and brings _BIG, which changes no minimum.
    rid = (torch.cumsum(start.reshape(-1), 0) - 1).clamp_min(0)
    flat = labels.reshape(-1)
    table = torch.full((h * w,), _BIG, dtype=labels.dtype, device=labels.device)
    table.scatter_reduce_(0, rid, flat, "amin")
    return torch.where(mask, table[rid].reshape(h, w), _BIG)


def label_components_device(
    mask: torch.Tensor, max_iters: int = 64, solidify: bool = False
) -> torch.Tensor:
    """8-connected labelling on the mask's device by min-label propagation.

    Each sweep does one 8-neighbour relaxation, then spreads the minimum over
    whole row runs and whole column runs. The loop ends when a sweep changes
    nothing; `max_iters` bounds serpentine shapes. With ``solidify`` the
    labels are computed on the 3x3-closed mask and restricted back to the
    original pixels: closing cannot split a component and merges only
    components within 2 px of each other.

    Returns int32 labels, background -1, each component labelled by the
    smallest linear index of its pixels (of the closed component when
    solidify is on, so a closed-only pixel can carry that index)."""
    h, w = mask.shape
    mask = mask.to(torch.bool)
    if solidify:
        mask = _close3(mask)
    lin = torch.arange(h * w, dtype=torch.int64, device=mask.device).reshape(h, w)
    labels = torch.where(mask, lin, _BIG)

    def sweep(lab):
        lab = _propagate_once(lab, mask)
        lab = _run_min(lab, mask, axis=1)
        return _run_min(lab, mask, axis=0)

    labels = sweep(labels)
    for _ in range(max_iters):
        new = sweep(labels)
        changed = bool((new != labels).any())  # one read from the device
        loop_counts["iterations"] += 1
        loop_counts["host_syncs"] += 1
        labels = new
        if not changed:
            break
    return torch.where(mask, labels, -1).to(torch.int32)


def _ranked_scatter(
    keep: torch.Tensor, values: tuple[torch.Tensor, ...], size: int, fill: int
) -> tuple[torch.Tensor, ...]:
    """Compaction without a sort: the first `size` flat positions where
    `keep` is set, in raster order, each `values[i]` gathered there, into
    tables of length `size` filled with `fill`. Positions beyond the cap go
    to one spare slot that is cut off."""
    keep = keep.reshape(-1)
    rank = torch.cumsum(keep, 0) - 1
    dest = torch.where(keep & (rank < size), rank, size)
    out = []
    for v in values:
        table = torch.full((size + 1,), fill, dtype=torch.int64, device=keep.device)
        table.scatter_(0, dest, v.reshape(-1).to(torch.int64))
        out.append(table[:size])
    return tuple(out)


def _run_graph(mask: torch.Tensor, max_runs: int, max_edges: int):
    """Steps 1 and 2 of :func:`label_components_rungraph` on a bool mask: the
    run id of every pixel (-1 background), the start index of every run, the
    edge table (two id columns, padded with 0-0 self edges) and, for
    reporting, the numbers of runs and of edges found before the table caps."""
    h, w = mask.shape
    dev = mask.device
    # 1. Row runs.
    run_start = mask & ~_shift(mask, 0, -1, False)
    dense = (torch.cumsum(run_start.reshape(-1), 0) - 1).reshape(h, w)
    rid = torch.where(mask & (dense < max_runs), dense, -1)
    r_row = min(32, w)
    rank_in_row = torch.cumsum(run_start, 1) - 1
    lin = torch.arange(h * w, dtype=torch.int64, device=dev)
    ok = (run_start & (rank_in_row < r_row) & (dense < max_runs)).reshape(-1)
    start_lin = torch.zeros(max_runs + 1, dtype=torch.int64, device=dev)
    start_lin.scatter_(0, torch.where(ok, dense.reshape(-1), max_runs), lin)

    # 2. Run-adjacency edges (8-connectivity).
    above = _shift(rid, -1, 0, -1)
    rid_l = _shift(rid, 0, -1, -1)
    keep, edge_b = [], []
    for ab in (_shift(above, 0, -1, -1), above, _shift(above, 0, 1, -1)):
        ok = (rid >= 0) & (ab >= 0)
        dup = ok & (rid == rid_l) & (ab == _shift(ab, 0, -1, -1))
        keep.append(ok & ~dup)
        edge_b.append(ab)
    keep_row = torch.cat(keep, dim=1)  # [h, 3w]
    e_row = min(64, 3 * w)
    keep_row &= (torch.cumsum(keep_row, 1) - 1) < e_row
    ea, eb = _ranked_scatter(
        keep_row, (torch.cat([rid] * 3, dim=1), torch.cat(edge_b, dim=1)), max_edges, 0
    )
    return rid, start_lin, ea, eb, torch.stack([run_start.sum(), keep_row.sum()])


def label_components_rungraph(
    mask: torch.Tensor,
    max_runs: int = 8192,
    max_edges: int = 32768,
    solidify: bool = False,
    max_iters: int = 24,
) -> torch.Tensor:
    """8-connected labelling through the run graph.

    The pixel sweeps of :func:`label_components_device` need dozens of passes
    on serpentine components. Here the hard part moves onto a graph whose
    nodes are row runs, where convergence is logarithmic whatever the shape:

      1. row runs get ids by one cumulative sum (raster order);
      2. run-adjacency edges come from the three 8-neighbour offsets of the
         row above, deduplicated against the left neighbour and compacted to
         a table of ``max_edges``;
      3. union-find over the ``[max_runs]`` parent table: scatter-min hooking
         and two pointer-jumping compressions per iteration, ending when a
         pass changes nothing;
      4. a pixel's label is its root run's start index.

    Same result as :func:`label_components_device`: int32, -1 background,
    each component labelled by the smallest linear index of its pixels. The
    caps behave as in the JAX package: runs beyond ``max_runs`` lose their
    pixels; per row only the first 32 runs record their start index and the
    first 64 edge candidates (upper-left, then upper, then upper-right
    neighbours) survive; edges beyond ``max_edges`` are dropped and can split
    a component."""
    mask = mask.to(torch.bool)
    if solidify:
        mask = _close3(mask)
    rid, start_lin, ea, eb, _ = _run_graph(mask, max_runs, max_edges)

    # 3. Union-find: hook + compress.
    def uf_step(parent):
        pa, pb = parent[ea], parent[eb]
        mn = torch.minimum(pa, pb)
        new = parent.scatter_reduce(0, pa, mn, "amin")
        new = new.scatter_reduce(0, pb, mn, "amin")
        new = new[new]
        return new[new]

    parent = torch.arange(max_runs, dtype=torch.int64, device=mask.device)
    for _ in range(max(max_iters, 1)):
        new = uf_step(parent)
        changed = bool((new != parent).any())  # one read from the device
        loop_counts["iterations"] += 1
        loop_counts["host_syncs"] += 1
        parent = new
        if not changed:
            break

    # 4. Per-pixel labels.
    root = parent[rid.clamp_min(0)]
    return torch.where(rid >= 0, start_lin[root], -1).to(torch.int32)


def _pool2_any(mask: torch.Tensor) -> torch.Tensor:
    """2x2 any-pooling of a bool mask, zero-padded to even sizes."""
    h, w = mask.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    m = _pad2d(mask, (0, ph - h, 0, pw - w), False)
    return m.reshape(ph // 2, 2, pw // 2, 2).any(dim=3).any(dim=1)


def label_components_multigrid(
    mask: torch.Tensor, max_iters: int = 64, solidify: bool = True
) -> torch.Tensor:
    """Labelling through a half-resolution solve lifted back to full
    resolution.

    The mask is 2x2 any-pooled, labelled at half resolution on the run graph
    and the labels are nearest-upsampled onto the full-resolution mask.
    Pooling can only merge components, and only those within about 2 px of
    each other, below the separation the detector is trained to produce.
    Component extents stay exact because rect fitting reads full-resolution
    pixels; only connectivity is decided at half resolution.

    Returns int32 labels (arbitrary ids, -1 background). `max_iters` is
    accepted as in the JAX package, which does not use it either."""
    del max_iters
    h, w = mask.shape
    mask = mask.to(torch.bool)
    labels_half = label_components_rungraph(
        _pool2_any(mask), max_runs=4096, max_edges=8192, solidify=solidify
    )
    up = labels_half.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    return torch.where(mask, up, -1)


def compact_labels_host(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """Renumber device labels (arbitrary non-negative ids, -1 background) to
    contiguous 1..count with 0 background."""
    lab = np.asarray(labels)
    uniq, inverse = np.unique(lab, return_inverse=True)
    inverse = inverse.reshape(lab.shape)
    n_background = int((uniq < 0).sum())
    out = np.where(lab >= 0, inverse - n_background + 1, 0).astype(np.int32)
    return out, int(uniq.size - n_background)
