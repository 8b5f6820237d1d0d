"""Oriented word rects from labelled masks, on the mask's device.

Port of ``ocrs_tpu.ops.rects`` as plain tensor code:

  1. a labeller of :mod:`.connected_components` labels the mask;
  2. **row-run endpoints** are taken (pixels whose left or right neighbour
     has another label). Every scanned angle has |th| <= ~48 deg, so both
     projection directions are monotonic in x along a row and a component's
     extremes are attained at run endpoints;
  3. the endpoints are compacted in raster order to ``max_boundary``, one
     stable sort by label groups each component contiguously, and each
     component's points are gathered into a dense ``[max_components, K]``
     tile as blocks of 128 of the sorted arrays, masked by segment bounds
     (components longer than the tile are subsampled by block, as in the JAX
     package);
  4. the min-area angle search, a scan over 16 candidate angles with two
     refinement rounds of 8, is one ``[C, K]`` elementwise pass and reduction
     per angle.

Only the ``[9, max_components]`` result table crosses to the host, packed
into one array so that one copy is paid (:func:`pack_rect_table`).

:func:`runs_tables` is the other reduction of a mask: packed int16 row-run
tables, finished on the host by :func:`runs_to_rect_table_host` (union-find
over runs, exact hull and calipers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import RotatedRect, min_area_rect
from ..utils.log import warn
from .connected_components import (
    _close3,
    _pool2_any,
    _ranked_scatter,
    _shift,
    label_components_device,
    label_components_multigrid,
    loop_counts,
)

_INT_MAX = int(np.iinfo(np.int32).max)


def min_area_rects_device(
    labels: torch.Tensor,
    max_components: int = 1024,
    max_points: int = 256,
    coarse_steps: int = 16,
    rounds: int = 3,
    max_boundary: int = 32768,
) -> dict[str, torch.Tensor]:
    """Fit oriented min-area rects to each labelled component.

    `labels`: int [H, W], -1 = background. Returns a dict of tensors of
    length ``max_components``: ``valid`` (bool), ``cx, cy, ux, uy, w, h``
    (float32) where (ux, uy) is the rect's "up" axis, ``count`` (run-endpoint
    point counts) and the scalar ``dropped`` (components beyond
    ``max_components``). Extents are max-min of pixel-centre projections.
    Pages with more endpoints than ``max_boundary`` lose the raster-order
    tail."""
    h, w = labels.shape
    dev = labels.device
    labels = labels.to(torch.int64)
    mask = labels >= 0
    endpoint = mask & ((labels != _shift(labels, 0, -1, -2)) | (labels != _shift(labels, 0, 1, -2)))

    p = max_boundary
    lin = torch.arange(h * w, dtype=torch.int64, device=dev)
    (bidx,) = _ranked_scatter(endpoint, (lin,), p, 0)
    pos = torch.arange(p, dtype=torch.int64, device=dev)
    has = pos < endpoint.sum()
    blab = torch.where(has, labels.reshape(-1)[bidx], _INT_MAX)
    # Stable: groups components, keeps raster order within each, padding last.
    slab, order_b = torch.sort(blab, stable=True)
    src = bidx[order_b]
    xs_sorted = (src % w).to(torch.float32)
    ys_sorted = (src // w).to(torch.float32)

    valid_pt = slab != _INT_MAX
    n_valid = valid_pt.sum()
    new_seg = valid_pt & ((pos == 0) | (slab != torch.roll(slab, 1)))
    # One extra start, so that with more than max_components components the
    # last kept segment still ends at the first dropped segment's start.
    (starts_ext,) = _ranked_scatter(new_seg, (pos,), max_components + 1, p)
    starts = starts_ext[:max_components]
    ends = torch.minimum(starts_ext[1:], n_valid)
    counts = (ends - starts).clamp_min(0)
    valid = counts > 0
    dropped = (new_seg.sum() - max_components).clamp_min(0)

    # Gather each component's points into a dense tile, by aligned blocks of
    # the sorted point arrays; a component spanning more than `nb` blocks
    # gets uniformly subsampled blocks (approximate extents).
    kb = 128
    nb = max(-(-max_points // kb) + 1, 2)
    p_pad = -(-p // kb) * kb
    if p_pad != p:
        xs_sorted = torch.nn.functional.pad(xs_sorted, (0, p_pad - p))
        ys_sorted = torch.nn.functional.pad(ys_sorted, (0, p_pad - p))
    blocks_x = xs_sorted.reshape(p_pad // kb, kb)
    blocks_y = ys_sorted.reshape(p_pad // kb, kb)
    first_blk = starts // kb
    last_blk = torch.maximum(ends - 1, starts) // kb
    nspan = last_blk - first_blk + 1
    j = torch.arange(nb, dtype=torch.int64, device=dev)
    blk_idx = first_blk[:, None] + (j[None, :] * nspan[:, None]) // nb  # [C, nb]
    blk_idx = blk_idx.clamp(0, p_pad // kb - 1)
    px = blocks_x[blk_idx].reshape(max_components, nb * kb)
    py = blocks_y[blk_idx].reshape(max_components, nb * kb)
    gpos = (blk_idx[:, :, None] * kb + torch.arange(kb, dtype=torch.int64, device=dev)).reshape(
        max_components, nb * kb
    )
    in_seg = (gpos >= starts[:, None]) & (gpos < ends[:, None])
    # Out-of-segment lanes collapse onto the segment's first point so they
    # never affect the extents.
    first = starts.clamp(0, p - 1)
    px = torch.where(in_seg, px, xs_sorted[first][:, None])
    py = torch.where(in_seg, py, ys_sorted[first][:, None])

    # Dense angle scan. The min-area angle is 90-deg periodic: scan
    # [-45, 45) coarsely, then refine around the best angle.
    def scan(base, half_range, steps, best):
        """best = (area, th, pu_mn, pu_mx, pv_mn, pv_mx), all [C]."""
        stats = []
        for ai in range(steps):
            th = base + (ai / steps - 0.5) * (2 * half_range)  # [C]
            c = torch.cos(th)[:, None]
            s = torch.sin(th)[:, None]
            pu = px * c + py * s  # [C, K]
            pv = py * c - px * s
            pu_mn, pu_mx = pu.amin(dim=1), pu.amax(dim=1)
            pv_mn, pv_mx = pv.amin(dim=1), pv.amax(dim=1)
            stats.append(torch.stack([(pu_mx - pu_mn) * (pv_mx - pv_mn), th, pu_mn, pu_mx, pv_mn, pv_mx]))
        st = torch.stack(stats)  # [A, 6, C]
        a = torch.argmin(st[:, 0], dim=0)  # [C]; the first of equal areas
        cand = torch.gather(st, 0, a[None, None, :].expand(1, 6, -1))[0]  # [6, C]
        return torch.where(cand[0] < best[0], cand, best)

    best = torch.zeros((6, max_components), dtype=torch.float32, device=dev)
    best[0] = 3.4e38
    half = float(np.deg2rad(45.0))
    step = 2 * half / coarse_steps
    best = scan(best[1], half, coarse_steps, best)
    for _ in range(rounds - 1):
        best = scan(best[1], step, 8, best)
        step = 2 * step / 8

    _, th, pu_mn, pu_mx, pv_mn, pv_mx = best
    c, s = torch.cos(th), torch.sin(th)
    cu = (pu_mn + pu_mx) / 2.0
    cv = (pv_mn + pv_mx) / 2.0
    return {
        "valid": valid,
        "count": counts,
        "dropped": dropped,
        "cx": cu * c - cv * s,
        "cy": cu * s + cv * c,
        "ux": -s,  # up axis = the scanned v direction
        "uy": c,
        "w": pu_mx - pu_mn,
        "h": pv_mx - pv_mn,
    }


def rects_from_mask_device(
    mask: torch.Tensor,
    expand_dist: float,
    min_area: float,
    max_components: int = 1024,
    solidify: bool = True,
    multigrid: bool = False,
) -> list[RotatedRect]:
    """Labelling and dense rect fitting on the mask's device; only the small
    rect table is copied to the host. Applies upstream's expand + min-area
    filtering (detection.rs:104-122). `solidify` closes stroke-shaped blobs
    before labelling; `multigrid` solves connectivity at half resolution,
    which merges fragments within ~4-5 px."""
    if multigrid:
        labels = label_components_multigrid(mask, solidify=solidify)
    else:
        labels = label_components_device(mask, solidify=solidify)
    table = min_area_rects_device(labels, max_components=max_components)
    return rect_table_to_host(table, expand_dist, min_area)


# ---------------------------------------------------------------------------
# Run tables: the device reduces the mask to row-run tables; the host does
# union-find and exact hull/calipers over the runs.
# ---------------------------------------------------------------------------


def _runs_of(mask: torch.Tensor, k_row: int, max_runs: int):
    """[h, w] bool -> (row, xs, xe) int64 [max_runs] each, raster order,
    -1-padded, and the number of runs dropped. Rows with more than `k_row`
    runs lose the rightmost extras; then the table keeps the first
    `max_runs`."""
    h, w = mask.shape
    rs = mask & ~_shift(mask, 0, -1, False)
    re = mask & ~_shift(mask, 0, 1, False)
    col = torch.arange(w, dtype=torch.int64, device=mask.device).expand(h, w)
    row = torch.arange(h, dtype=torch.int64, device=mask.device)[:, None].expand(h, w)
    keep_s = rs & ((torch.cumsum(rs, 1) - 1) < k_row)
    keep_e = re & ((torch.cumsum(re, 1) - 1) < k_row)
    # The i-th kept end of a row closes its i-th kept start, so both rank
    # alike in raster order.
    row_o, xs_o = _ranked_scatter(keep_s, (row, col), max_runs, -1)
    (xe_o,) = _ranked_scatter(keep_e, (col,), max_runs, -1)
    dropped = rs.sum() - (row_o >= 0).sum()
    return row_o, xs_o, xe_o, dropped


def runs_tables(
    mask: torch.Tensor,
    *,
    pool: int = 2,
    solidify: bool = True,
    max_runs: int = 4096,
    k_row: int = 48,
) -> torch.Tensor:
    """Reduce a [H, W] bool mask to packed run tables, int16 [7, max_runs]:

    * channels 0-2: ORIG runs (row, xs, xe) of the raw mask at full
      resolution, the exact pixel extents for rect fitting;
    * channels 3-5: CONN runs of the connectivity mask (2x2 any-pooled when
      ``pool == 2``, then 3x3-closed when `solidify`), which decide which orig
      runs merge into one component, as the multigrid labeller does;
    * channel 6: [0] = orig runs dropped by the table caps, [1] = conn runs
      dropped.

    Consumed by :func:`runs_to_rect_table_host`."""
    mask = mask.to(torch.bool)
    conn = _pool2_any(mask) if pool == 2 else mask
    if solidify:
        conn = _close3(conn)
    o_row, o_xs, o_xe, o_drop = _runs_of(mask, k_row, max_runs)
    c_row, c_xs, c_xe, c_drop = _runs_of(conn, k_row, max_runs)
    extras = torch.zeros(max_runs, dtype=torch.int64, device=mask.device)
    extras[0] = o_drop.clamp_max(32767)
    extras[1] = c_drop.clamp_max(32767)
    return torch.stack([o_row, o_xs, o_xe, c_row, c_xs, c_xe, extras]).to(torch.int16)


def runs_to_rect_table_host(runs: np.ndarray, pool: int, max_components: int) -> dict:
    """Host tail of the run-table path: union-find over conn runs, orig-run
    containment mapping, exact min-area rects, in numpy and Python.

    `runs`: int16 [B, 7, K] from :func:`runs_tables` (batched). Returns the
    unpacked rect-table dict of :func:`unpack_rect_table`."""
    runs = np.asarray(runs)
    assert runs.shape[1] >= 7, "expected [B, 7, K] packed run tables"
    table_drop = runs[:, 6, 0].astype(np.int32) + runs[:, 6, 1].astype(np.int32)
    packed = _runs_to_rects_numpy(runs[:, :6], pool, max_components)
    out = {f: packed[:, i, :] for i, f in enumerate(PACK_FIELDS)}
    out["valid"] = out["valid"] > 0.5
    out["count"] = out["count"].astype(np.int32)
    out["dropped"] = out["dropped"][:, 0].astype(np.int32) + table_drop
    return out


def _runs_to_rects_numpy(runs: np.ndarray, pool: int, max_components: int) -> np.ndarray:
    b = runs.shape[0]
    c_cap = max_components
    out = np.zeros((b, 9, c_cap), np.float64)
    for pg in range(b):
        o_row, o_xs, o_xe, c_row, c_xs, c_xe = (runs[pg, i].astype(np.int32) for i in range(6))
        n_conn = int((c_row >= 0).sum())
        n_orig = int((o_row >= 0).sum())
        parent = list(range(n_conn))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        # Adjacency with the previous row (8-connectivity: intervals dilated by 1).
        row_start: dict[int, int] = {}
        for i in range(n_conn):
            row_start.setdefault(int(c_row[i]), i)
        for i in range(n_conn):
            r = int(c_row[i])
            j = row_start.get(r - 1)
            if j is None:
                continue
            while j < n_conn and c_row[j] == r - 1:
                if c_xe[j] + 1 >= c_xs[i] - 1 and c_xs[j] - 1 <= c_xe[i] + 1:
                    a, bb = find(i), find(j)
                    if a != bb:
                        parent[max(a, bb)] = min(a, bb)
                j += 1
        comp_of_root: dict[int, int] = {}
        comp_pts: list[list] = []
        dropped = 0
        for i in range(n_orig):
            r = int(o_row[i]) // pool
            x = int(o_xs[i]) // pool
            j = row_start.get(r)
            found = -1
            while j is not None and j < n_conn and c_row[j] == r:
                if c_xs[j] <= x <= c_xe[j]:
                    found = j
                    break
                j += 1
            if found < 0:
                dropped += 1
                continue
            root = find(found)
            cid = comp_of_root.get(root)
            if cid is None:
                cid = len(comp_pts)
                comp_of_root[root] = cid
                comp_pts.append([])
            if cid < c_cap:
                comp_pts[cid].append((float(o_xs[i]), float(o_row[i])))
                comp_pts[cid].append((float(o_xe[i]), float(o_row[i])))
        n_comp = len(comp_pts)
        dropped += max(n_comp - c_cap, 0)
        out[pg, 2, :] = dropped
        for cid in range(min(n_comp, c_cap)):
            rect = min_area_rect(np.array(comp_pts[cid]))
            if rect is None:
                continue
            out[pg, :, cid] = (
                1.0, len(comp_pts[cid]), dropped,
                rect.center[0], rect.center[1], rect.up[0], rect.up[1], rect.width, rect.height,
            )
    return out


#: Field order of the packed rect-table array (see pack_rect_table).
PACK_FIELDS = ("valid", "count", "dropped", "cx", "cy", "ux", "uy", "w", "h")


def pack_rect_table(table: dict) -> torch.Tensor:
    """Pack a rect table (dict of [..., C] tensors) into one float32
    [..., len(PACK_FIELDS), C] tensor, so that one copy to the host carries
    all of it. All packed values are exactly representable in float32
    (counts < 2^24)."""
    ref = table["cx"].to(torch.float32)
    rows = []
    for k in PACK_FIELDS:
        v = torch.as_tensor(table[k], device=ref.device).to(torch.float32)
        while v.dim() < ref.dim():
            v = v[..., None]
        rows.append(v.expand(ref.shape))
    return torch.stack(rows, dim=-2)


def unpack_rect_table(packed) -> dict:
    """Inverse of :func:`pack_rect_table` (host side, returns numpy)."""
    a = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    out = {k: a[..., i, :] for i, k in enumerate(PACK_FIELDS)}
    out["valid"] = out["valid"] > 0.5
    out["count"] = out["count"].astype(np.int32)
    out["dropped"] = out["dropped"][..., 0].astype(np.int32)
    return out


def rect_table_to_host(table: dict, expand_dist: float, min_area: float) -> list[RotatedRect]:
    """One blocking copy of the packed table to the host, then the expand
    and min-area filter."""
    table = unpack_rect_table(pack_rect_table(table).cpu())
    loop_counts["host_syncs"] += 1
    dropped = int(table["dropped"])
    if dropped > 0:
        warn(
            f"min_area_rects_device: mask had {dropped} more components than "
            "max_components; the overflow components were dropped"
        )
    out: list[RotatedRect] = []
    for i in np.nonzero(table["valid"])[0]:
        w = float(table["w"][i]) + 2.0 * expand_dist
        h = float(table["h"][i]) + 2.0 * expand_dist
        if w * h < min_area:
            continue
        out.append(
            RotatedRect(
                (float(table["cx"][i]), float(table["cy"][i])),
                (float(table["ux"][i]), float(table["uy"][i])),
                w,
                h,
            )
        )
    return out
