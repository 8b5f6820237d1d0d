"""Layout analysis: group word rects into lines in reading order.

Port of ``ocrs_tpu.layout`` (host code; the input is a few hundred word rects
at most). Each hot function has two routes with identical semantics
(upstream layout_analysis.rs): the C++ one of :mod:`ocrs_tpu_torch.native`
when that library is available, and the numpy one otherwise:

  * :func:`group_into_lines` -- greedy left-to-right chaining with
    vertical overlap >= 5 px, horizontal overlap <= 5 px and
    separator-crossing checks (layout_analysis.rs:19-71).
  * :func:`max_empty_rects` -- Breuel-2002 branch-and-bound over
    maximal whitespace rectangles (empty_rects.rs:86-166).
  * :func:`find_block_separators` -- median spacing/height statistics and
    the Shafait tall-rect score (layout_analysis.rs:83-155).
  * :func:`find_text_lines` -- separator-aware line grouping + greedy
    paragraph clustering into reading order (layout_analysis.rs:158-232);
    :func:`find_text_lines_idx_arrays` is the same in one native call, from
    rect component arrays.
  * :func:`is_vertical_line`, :func:`merge_vertical_chains` -- the
    vertical-text post-pass (no upstream counterpart).
"""

from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from . import native
from .geometry import Line, Rect, RotatedRect, point

# Minimum vertical overlap (px) for two words to share a line
# (layout_analysis.rs:27).
OVERLAP_THRESHOLD = 5
# Maximum horizontal overlap (px) of a candidate word with the last word in a
# line (layout_analysis.rs:35).
MAX_H_OVERLAP = 5


def _segments_intersect_matrix(
    p: np.ndarray, q: np.ndarray, s1: np.ndarray, s2: np.ndarray
) -> np.ndarray:
    """Vectorized segment intersection: segments (p, q[i]) against segments
    (s1[j], s2[j]). Touching counts. p: (2,), q: (N, 2), s1/s2: (S, 2).
    Returns (N, S) bool."""
    d = q - p[None, :]  # (N, 2)
    e = s2 - s1  # (S, 2)
    qp = s1[None, :, :] - p[None, None, :]  # (1, S, 2)

    dx, dy = d[:, 0][:, None], d[:, 1][:, None]  # (N, 1)
    ex, ey = e[:, 0][None, :], e[:, 1][None, :]  # (1, S)
    qpx, qpy = qp[0, :, 0][None, :], qp[0, :, 1][None, :]  # (1, S)

    denom = dx * ey - dy * ex  # (N, S)
    t_num = qpx * ey - qpy * ex
    u_num = qpx * dy - qpy * dx
    nonpar = denom != 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / denom
        u = u_num / denom
    hit = nonpar & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    collinear = (~nonpar) & (u_num == 0.0)
    if collinear.any():
        rr = (d * d).sum(axis=1)[:, None]  # (N, 1)
        rr = np.where(rr == 0.0, 1.0, rr)
        t0 = (qpx * dx + qpy * dy) / rr
        t1 = t0 + (ex * dx + ey * dy) / rr
        lo = np.minimum(t0, t1)
        hi = np.maximum(t0, t1)
        hit |= collinear & (hi >= 0.0) & (lo <= 1.0)
    return hit


class _WordIndex:
    """Struct-of-arrays over word rects for the greedy chaining: centers,
    leftmost/rightmost edge midpoints and y-intervals."""

    def __init__(self, rects: Sequence[RotatedRect]):
        n = len(rects)
        centers = np.array([r.center for r in rects]).reshape(n, 2)
        ups = np.array([r.up for r in rects]).reshape(n, 2)
        whs = np.array([(r.width, r.height) for r in rects]).reshape(n, 2)
        rights = np.stack([-ups[:, 1], ups[:, 0]], axis=1)  # rot90(up)
        rw = rights * (whs[:, 0:1] / 2.0)
        uh = ups * (whs[:, 1:2] / 2.0)
        cs = np.stack(
            [
                centers + rw - uh,
                centers - rw - uh,
                centers - rw + uh,
                centers + rw + uh,
            ],
            axis=1,
        )  # (n, 4, 2)
        order = np.argsort(cs[:, :, 0], axis=1, kind="stable")
        sorted_x = np.take_along_axis(cs[:, :, 0], order, axis=1)
        sorted_y = np.take_along_axis(cs[:, :, 1], order, axis=1)
        self.cx = centers[:, 0]
        self.cy = centers[:, 1]
        self.bleft = cs[:, :, 0].min(axis=1)
        self.lcx = (sorted_x[:, 0] + sorted_x[:, 1]) / 2.0
        self.ly0 = np.minimum(sorted_y[:, 0], sorted_y[:, 1])
        self.ly1 = np.maximum(sorted_y[:, 0], sorted_y[:, 1])
        self.rcx = (sorted_x[:, 2] + sorted_x[:, 3]) / 2.0
        self.ry0 = np.minimum(sorted_y[:, 2], sorted_y[:, 3])
        self.ry1 = np.maximum(sorted_y[:, 2], sorted_y[:, 3])


def group_into_lines(
    rects: Sequence[RotatedRect], separators: Sequence[Line] = ()
) -> list[list[RotatedRect]]:
    return [[rects[i] for i in line] for line in _group_into_lines_idx(rects, separators)]


def _group_into_lines_idx(
    rects: Sequence[RotatedRect],
    separators: Sequence[Line] = (),
    idx: Optional[_WordIndex] = None,
) -> list[list[int]]:
    """Chain word rects into lines, left to right (layout_analysis.rs:19-71).
    Returns lists of indices into `rects`."""
    n = len(rects)
    if n == 0:
        return []
    if idx is None:
        idx = _WordIndex(rects)

    # Native route (identical semantics, see native/ocrs_native.cpp).
    feat = np.stack(
        [idx.cx, idx.cy, idx.bleft, idx.lcx, idx.ly0, idx.ly1, idx.rcx, idx.ry0, idx.ry1],
        axis=1,
    )
    seps_arr = (
        np.array([[s.start[0], s.start[1], s.end[0], s.end[1]] for s in separators])
        if len(separators)
        else np.zeros((0, 4))
    )
    nat = native.group_lines(feat, seps_arr, float(OVERLAP_THRESHOLD), float(MAX_H_OVERLAP))
    if nat is not None:
        line_id, rank, n_lines = nat
        lines_out: list[list[int]] = [[] for _ in range(n_lines)]
        for i in np.lexsort((rank, line_id)):
            lines_out[line_id[i]].append(int(i))
        return lines_out

    # Stable sort by integer left coordinate (upstream sorts by
    # `bounding_rect().left() as i32`; ties keep input order). All arrays are
    # re-ordered positionally so "first remaining" is a simple cursor scan.
    order = np.array(
        sorted(range(n), key=lambda i: int(idx.bleft[i])), dtype=np.int64
    )
    cx = idx.cx[order]
    cy = idx.cy[order]
    lcx = idx.lcx[order]
    ly0 = idx.ly0[order]
    ly1 = idx.ly1[order]
    rcx = idx.rcx[order]
    ry0 = idx.ry0[order]
    ry1 = idx.ry1[order]
    cx_int = cx.astype(np.int64)

    have_seps = len(separators) > 0
    if have_seps:
        s1 = np.stack([np.asarray(s.start, float) for s in separators])
        s2 = np.stack([np.asarray(s.end, float) for s in separators])

    alive = np.ones(n, dtype=bool)
    pos_iota = np.arange(n)
    lines: list[list[int]] = []
    n_alive = n
    cursor = 0
    while n_alive:
        while not alive[cursor]:
            cursor += 1
        seed = cursor
        alive[seed] = False
        n_alive -= 1
        line = [seed]
        last = seed
        while n_alive:
            cond = (
                alive
                & (cx > cx[last])
                & (lcx - rcx[last] >= -float(MAX_H_OVERLAP))
                & (
                    np.minimum(ry1[last], ly1) - np.maximum(ry0[last], ly0)
                    >= float(OVERLAP_THRESHOLD)
                )
            )
            if have_seps and cond.any():
                cand = pos_iota[cond]
                p = np.array([cx[last], cy[last]])
                q = np.stack([cx[cand], cy[cand]], axis=1)
                blocked = _segments_intersect_matrix(p, q, s1, s2).any(axis=1)
                cond[cand[blocked]] = False
            if not cond.any():
                break
            cands = pos_iota[cond]
            # min_by_key(center.x as i32): first minimum in remaining order.
            best = int(cands[np.argmin(cx_int[cands])])
            alive[best] = False
            n_alive -= 1
            line.append(best)
            last = best
        lines.append([int(order[i]) for i in line])
    return lines


def max_empty_rects(
    obstacles: Sequence[Rect],
    boundary: Rect,
    score: Callable[[Rect], float],
    min_width: float,
    min_height: float,
) -> Iterator[Rect]:
    """Yield obstacle-free rects inside `boundary` in decreasing score order
    (see :func:`_max_empty_rects_tlbr`)."""
    obs_sorted = sorted(obstacles, key=lambda o: (int(o.center()[0]), int(o.center()[1])))
    yield from _max_empty_rects_tlbr(
        np.array([[o.top, o.left, o.bottom, o.right] for o in obs_sorted], dtype=np.float64).reshape(-1, 4),
        (boundary.top, boundary.left, boundary.bottom, boundary.right),
        lambda t, l, b, r: score(Rect.from_tlbr(t, l, b, r)),
        min_width,
        min_height,
    )


def _max_empty_rects_tlbr(
    obs: np.ndarray,
    boundary: tuple[float, float, float, float],
    score: Callable[[float, float, float, float], float],
    min_width: float,
    min_height: float,
) -> Iterator[Rect]:
    """Yield obstacle-free rects inside `boundary` in decreasing score order:
    branch-and-bound on a priority queue of (boundary, contained obstacles)
    partitions split around a central pivot obstacle (Breuel 2002;
    empty_rects.rs:86-137). `score` must be monotone under containment."""
    bt, bl, bb, br = boundary
    counter = itertools.count()  # tie-break for the heap
    queue: list = []
    if br - bl > 0 and bb - bt > 0:
        heapq.heappush(queue, (-score(bt, bl, bb, br), next(counter), boundary, obs))

    while queue:
        _, _, (t, l, b, r), part_obs = heapq.heappop(queue)
        if len(part_obs) == 0:
            yield Rect.from_tlbr(t, l, b, r)
            continue
        pt, pl, pb, pr = part_obs[len(part_obs) // 2]
        for st, sl, sb, sr in (
            (t, l, pt, r),  # top
            (t, l, b, pl),  # left
            (pb, l, b, r),  # bottom
            (t, pr, b, r),  # right
        ):
            w = sr - sl
            h = sb - st
            if max(w, 0) < min_width or max(h, 0) < min_height or w <= 0 or h <= 0:
                continue
            inter = (
                (np.minimum(part_obs[:, 2], sb) > np.maximum(part_obs[:, 0], st))
                & (np.minimum(part_obs[:, 3], sr) > np.maximum(part_obs[:, 1], sl))
            )
            heapq.heappush(
                queue, (-score(st, sl, sb, sr), next(counter), (st, sl, sb, sr), part_obs[inter])
            )


def filter_overlapping(rect_iter: Iterable[Rect], factor: float) -> Iterator[Rect]:
    """Drop rects whose IoU with an already-yielded rect is >= `factor`
    (empty_rects.rs:170-229)."""
    found: list[Rect] = []
    for r in rect_iter:
        if any(f.iou(r) >= factor for f in found):
            continue
        found.append(r)
        yield r


def _bounding_rects(rects: Sequence[RotatedRect]) -> np.ndarray:
    """(n, 4) t/l/b/r bounding boxes of rotated rects (vectorized)."""
    n = len(rects)
    centers = np.array([r.center for r in rects]).reshape(n, 2)
    ups = np.array([r.up for r in rects]).reshape(n, 2)
    whs = np.array([(r.width, r.height) for r in rects]).reshape(n, 2)
    rights = np.stack([-ups[:, 1], ups[:, 0]], axis=1)
    ext = np.abs(rights) * (whs[:, 0:1] / 2.0) + np.abs(ups) * (whs[:, 1:2] / 2.0)
    return np.stack(
        [
            centers[:, 1] - ext[:, 1],
            centers[:, 0] - ext[:, 0],
            centers[:, 1] + ext[:, 1],
            centers[:, 0] + ext[:, 0],
        ],
        axis=1,
    )


def find_block_separators(
    words: Sequence[RotatedRect], idx: Optional[_WordIndex] = None
) -> list[Rect]:
    """Find whitespace rects separating columns/sections
    (layout_analysis.rs:83-155)."""
    if not words:
        return []
    boxes = _bounding_rects(words)
    page = (
        math.floor(boxes[:, 0].min()),
        math.floor(boxes[:, 1].min()),
        math.ceil(boxes[:, 2].max()),
        math.ceil(boxes[:, 3].max()),
    )

    # Estimate spacing statistics from a separator-free line grouping.
    lines_idx = _group_into_lines_idx(words, (), idx=idx)
    lines_idx.sort(key=lambda li: int(round(boxes[li[0], 0])))

    all_spacings: list[int] = []
    for li in lines_idx:
        if len(li) > 1:
            arr = boxes[li]
            spacings = np.maximum(arr[1:, 1] - arr[:-1, 3], 0.0)
            all_spacings.extend(sorted(int(round(s)) for s in spacings))
    all_spacings.sort()

    median_word_spacing = all_spacings[len(all_spacings) // 2] if all_spacings else 10
    # nb. matches upstream exactly: the "median" height is the height of the
    # middle element of `words` in *input order* (layout_analysis.rs:113).
    median_height = int(round(words[len(words) // 2].height))

    def score(t: float, l: float, b: float, r: float) -> float:
        """Shafait tall-rect score (layout_analysis.rs:127-135)."""
        w = r - l
        h = b - t
        aspect = h / w
        la = abs(math.log2(aspect)) if aspect > 0 else float("inf")
        weight = 0.5 if la < 3.0 else (1.5 if la < 5.0 else la)
        return math.sqrt(max(w, 0) * max(h, 0) * weight)

    # Integral bounding boxes of the words are the obstacles.
    obs = np.stack(
        [
            np.floor(boxes[:, 0]),
            np.floor(boxes[:, 1]),
            np.ceil(boxes[:, 2]),
            np.ceil(boxes[:, 3]),
        ],
        axis=1,
    )
    order = sorted(
        range(len(words)),
        key=lambda i: (int((obs[i, 1] + obs[i, 3]) / 2), int((obs[i, 0] + obs[i, 2]) / 2)),
    )
    obs = obs[order]

    min_width = median_word_spacing * 3
    min_height = 3 * max(median_height, 0)

    nat = native.find_separators(obs, page, min_width, min_height, 0.5, 80)
    if nat is not None:
        return [Rect.from_tlbr(*row) for row in nat]
    it = _max_empty_rects_tlbr(obs, page, score, min_width, min_height)
    return list(itertools.islice(filter_overlapping(it, 0.5), 80))


def _word_features_arrays(
    cx: np.ndarray,
    cy: np.ndarray,
    ux: np.ndarray,
    uy: np.ndarray,
    w: np.ndarray,
    h: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(feat [n, 9], boxes [n, 4 tlbr]) for the native layout entry, computed
    straight from rect component arrays (mirrors _WordIndex +
    _bounding_rects without constructing RotatedRect objects)."""
    rx, ry = -uy, ux  # rot90(up)
    rwx, rwy = rx * (w / 2.0), ry * (w / 2.0)
    uhx, uhy = ux * (h / 2.0), uy * (h / 2.0)
    cs_x = np.stack(
        [cx + rwx - uhx, cx - rwx - uhx, cx - rwx + uhx, cx + rwx + uhx], axis=1
    )
    cs_y = np.stack(
        [cy + rwy - uhy, cy - rwy - uhy, cy - rwy + uhy, cy + rwy + uhy], axis=1
    )
    order = np.argsort(cs_x, axis=1, kind="stable")
    sx = np.take_along_axis(cs_x, order, axis=1)
    sy = np.take_along_axis(cs_y, order, axis=1)
    feat = np.stack(
        [
            cx,
            cy,
            cs_x.min(axis=1),
            (sx[:, 0] + sx[:, 1]) / 2.0,
            np.minimum(sy[:, 0], sy[:, 1]),
            np.maximum(sy[:, 0], sy[:, 1]),
            (sx[:, 2] + sx[:, 3]) / 2.0,
            np.minimum(sy[:, 2], sy[:, 3]),
            np.maximum(sy[:, 2], sy[:, 3]),
        ],
        axis=1,
    )
    ext_x = np.abs(rx) * (w / 2.0) + np.abs(ux) * (h / 2.0)
    ext_y = np.abs(ry) * (w / 2.0) + np.abs(uy) * (h / 2.0)
    boxes = np.stack([cy - ext_y, cx - ext_x, cy + ext_y, cx + ext_x], axis=1)
    return feat, boxes


def find_text_lines_idx_arrays(
    cx: np.ndarray,
    cy: np.ndarray,
    ux: np.ndarray,
    uy: np.ndarray,
    w: np.ndarray,
    h: np.ndarray,
) -> Optional[list[list[int]]]:
    """The whole of :func:`find_text_lines` in one native call, from rect
    component arrays: word index lists per line, lines in reading order, or
    None when the native library is not available (callers then run
    :func:`find_text_lines` over constructed rects). One C call replaces the
    Python glue between the three layout kernels."""
    n = len(cx)
    if n == 0:
        return []
    feat, boxes = _word_features_arrays(cx, cy, ux, uy, w, h)
    median_height = float(round(float(h[n // 2])))
    res = native.find_text_lines(
        feat, boxes, median_height, float(OVERLAP_THRESHOLD), float(MAX_H_OVERLAP)
    )
    if res is None:
        return None
    out_word, out_line, n_lines = res
    lines: list[list[int]] = [[] for _ in range(n_lines)]
    for widx, lid in zip(out_word.tolist(), out_line.tolist()):
        lines[lid].append(widx)
    return lines


def find_text_lines(words: Sequence[RotatedRect]) -> list[list[RotatedRect]]:
    """Group words into lines and sort into reading order
    (layout_analysis.rs:158-232)."""
    if not words:
        return []
    idx = _WordIndex(words)
    separators = find_block_separators(words, idx=idx)
    vertical_seps = [
        Line(point(r.center()[0], r.top), point(r.center()[0], r.bottom))
        for r in separators
    ]

    lines_idx = _group_into_lines_idx(words, vertical_seps, idx=idx)

    # Approximate each text line by the 1-D segment from the centre of its
    # first word's left bbox edge to the centre of its last word's right
    # bbox edge (layout_analysis.rs:182-189); precompute once.
    boxes = _bounding_rects(words)
    mid = np.empty((len(lines_idx), 4))  # x0, y0, x1, y1
    for k, li in enumerate(lines_idx):
        f, l = boxes[li[0]], boxes[li[-1]]
        mid[k] = (f[1], (f[0] + f[2]) / 2.0, l[3], (l[0] + l[2]) / 2.0)

    # Sort lines by the midpoint's vertical position.
    order = sorted(
        range(len(lines_idx)), key=lambda k: int((mid[k, 1] + mid[k, 3]) / 2.0)
    )
    lines_idx = [lines_idx[k] for k in order]
    mid = mid[order]

    if separators:
        h1 = np.stack([[r.left, r.center()[1]] for r in separators])
        h2 = np.stack([[r.right, r.center()[1]] for r in separators])

    # Greedy paragraph clustering: repeatedly seed a paragraph with the first
    # unassigned line, then absorb all following lines that horizontally
    # overlap the paragraph's current last line and are not separated from it.
    n = len(lines_idx)
    alive = np.ones(n, dtype=bool)
    result: list[int] = []
    remaining = n
    cursor = 0
    while remaining:
        while not alive[cursor]:
            cursor += 1
        seed = cursor
        alive[seed] = False
        remaining -= 1
        para = [seed]
        prev = mid[seed]
        for i in range(seed + 1, n):
            if not alive[i]:
                continue
            cand = mid[i]
            lo = max(min(prev[0], prev[2]), min(cand[0], cand[2]))
            hi = min(max(prev[0], prev[2]), max(cand[0], cand[2]))
            if hi - lo <= 0.0:
                continue
            if separators:
                p = np.array([(prev[0] + prev[2]) / 2.0, (prev[1] + prev[3]) / 2.0])
                q = np.array([[(cand[0] + cand[2]) / 2.0, (cand[1] + cand[3]) / 2.0]])
                if _segments_intersect_matrix(p, q, h1, h2).any():
                    continue
            alive[i] = False
            remaining -= 1
            para.append(i)
            prev = cand
        result.extend(para)
    return [[words[i] for i in lines_idx[k]] for k in result]


# ---------------------------------------------------------------------------
# Vertical text (no upstream counterpart)
# ---------------------------------------------------------------------------

#: Geometry gates for treating a word stack as a vertical text line.
VERTICAL_MIN_ASPECT = 2.5  # chain bbox height >= 2.5x its width
VERTICAL_SINGLE_ASPECT = 4.0  # a lone word needs to be clearly tall
VERTICAL_MIN_WIDTH = 6.0  # px; thinner stacks are rules/noise, not glyphs


def is_vertical_line(words: Sequence[RotatedRect]) -> bool:
    """True when a line's geometry says "rotated text": the word-union
    bounding box is much taller than wide. Detectors trained on horizontal
    text fragment a 90°-rotated line into a vertical stack of glyph blobs;
    :func:`merge_vertical_chains` assembles the stack and this predicate is
    the shared gate (also used by recognition to route such lines through
    the rotated-warp crop instead of the axis-aligned one)."""
    boxes = _bounding_rects(words)
    t, l = boxes[:, 0].min(), boxes[:, 1].min()
    b, r = boxes[:, 2].max(), boxes[:, 3].max()
    w, h = r - l, b - t
    if w < VERTICAL_MIN_WIDTH:
        return False
    if len(words) == 1:
        return h >= VERTICAL_SINGLE_ASPECT * w
    return h >= VERTICAL_MIN_ASPECT * w


def merge_vertical_chains(
    lines: list[list[RotatedRect]],
) -> tuple[list[list[RotatedRect]], list[bool]]:
    """Post-pass over :func:`find_text_lines` output: assemble vertically
    stacked single-word lines into vertical text lines (90°-rotated text,
    e.g. a plot's y-axis label). Returns ``(lines, is_vertical)`` where each
    assembled chain replaces its topmost member's slot and the member slots
    are dropped; all other lines pass through unchanged.

    Only SINGLE-word lines are candidates (a word that chained horizontally
    with a neighbour is ordinary text), and a chain is kept only when its
    union box passes :func:`is_vertical_line` — a digits column in a table
    does not, because its row pitch exceeds the chaining gap (1.2x the
    member width, the scale of rotated-glyph spacing)."""
    if not lines:
        return lines, []
    cand: list[tuple[int, np.ndarray]] = []  # (line slot, tlbr box)
    for k, ws in enumerate(lines):
        if len(ws) == 1:
            b = _bounding_rects(ws)[0]
            cand.append((k, b))
    if len(cand) < 2:
        return lines, [False] * len(lines)

    cand.sort(key=lambda kb: (kb[1][0] + kb[1][2]) / 2.0)  # by centre y
    chains: list[list[int]] = []  # indices into cand
    open_chains: list[int] = []  # chain ids still accepting members
    for i, (_, box) in enumerate(cand):
        t, l, b, r = box
        w = r - l
        attached = False
        for cid in open_chains:
            _, last = cand[chains[cid][-1]]
            lw = last[3] - last[1]
            x_overlap = min(r, last[3]) - max(l, last[1])
            gap = t - last[2]
            # Rotated-glyph blobs overlap vertically (ascender/descender
            # boxes of adjacent glyphs interleave): allow up to ~half a
            # member of overlap, not a fixed 4 px — a matplotlib y-label's
            # stack breaks into fragments otherwise.
            if (
                x_overlap >= min(4.0, 0.8 * min(w, lw))
                and -0.6 * max(w, lw) <= gap <= 1.2 * max(w, lw)
            ):
                chains[cid].append(i)
                attached = True
                break
        if not attached:
            chains.append([i])
            open_chains.append(len(chains) - 1)
        # Chains whose last member is far above the sweep line can be closed
        # (candidates arrive in y order); keeps the scan near-linear.
        def _alive(cid: int) -> bool:
            last_box = cand[chains[cid][-1]][1]
            return t - last_box[2] <= 1.2 * max(last_box[3] - last_box[1], w, 1.0)

        open_chains = [cid for cid in open_chains if _alive(cid)]

    drop: set[int] = set()
    replace: dict[int, list[RotatedRect]] = {}
    for chain in chains:
        if len(chain) < 2:
            continue
        slots = [cand[i][0] for i in chain]
        members = [lines[s][0] for s in slots]
        if not is_vertical_line(members):
            continue
        top_slot = min(slots)
        replace[top_slot] = members
        drop.update(s for s in slots if s != top_slot)

    out: list[list[RotatedRect]] = []
    vertical: list[bool] = []
    for k, ws in enumerate(lines):
        if k in drop:
            continue
        if k in replace:
            out.append(replace[k])
            vertical.append(True)
        else:
            out.append(ws)
            # A lone tall word the detector kept whole is vertical too.
            vertical.append(len(ws) == 1 and is_vertical_line(ws))
    return out, vertical
