"""Host-side geometry value types used by the OCR pipeline.

A numpy copy of ``ocrs_tpu.geometry`` (the port imports nothing of the JAX
package). These are the Python equivalents of the ``rten-imageproc`` geometry
types the upstream ocrs library builds on (``Rect``, ``RotatedRect``,
``Line``), used for the tiny-N host-side work: layout analysis, rect fitting
and the public API surface.

Conventions:
  * Points are ``(x, y)`` pairs (numpy ``float64`` arrays or 2-sequences).
  * ``Rect`` is stored as float t/l/b/r; helpers produce integral rects where
    the upstream library uses integer rects.
  * ``RotatedRect`` is (center, up-axis unit vector, width, height) where
    *width* is the extent perpendicular to *up* and *height* along it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

Point = np.ndarray  # shape (2,), [x, y]


def point(x: float, y: float) -> Point:
    return np.array([x, y], dtype=np.float64)


# ---------------------------------------------------------------------------
# Rect
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rect:
    """Axis-aligned rectangle stored as top/left/bottom/right.

    Mirrors the semantics of ``rten_imageproc::Rect`` as used by the reference
    (layout_analysis.rs, recognition.rs:162-193). ``bottom``/``right`` are
    exclusive-ish bounds in the sense that ``width = right - left``.
    """

    top: float
    left: float
    bottom: float
    right: float

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_tlbr(top: float, left: float, bottom: float, right: float) -> "Rect":
        return Rect(top, left, bottom, right)

    @staticmethod
    def from_tlhw(top: float, left: float, height: float, width: float) -> "Rect":
        return Rect(top, left, top + height, left + width)

    @staticmethod
    def from_hw(height: float, width: float) -> "Rect":
        return Rect(0.0, 0.0, height, width)

    # -- accessors ---------------------------------------------------------
    @property
    def width(self) -> float:
        return self.right - self.left

    @property
    def height(self) -> float:
        return self.bottom - self.top

    @property
    def area(self) -> float:
        return max(self.width, 0.0) * max(self.height, 0.0)

    def center(self) -> Point:
        return point((self.left + self.right) / 2.0, (self.top + self.bottom) / 2.0)

    def is_empty(self) -> bool:
        return self.width <= 0 or self.height <= 0

    def corners(self) -> list[Point]:
        """Corner points in the same order as ``RotatedRect.corners`` for an
        axis-aligned rect with the default (up = -y) orientation."""
        return RotatedRect.from_rect(self).corners()

    # -- algebra -----------------------------------------------------------
    def union(self, other: "Rect") -> "Rect":
        return Rect(
            min(self.top, other.top),
            min(self.left, other.left),
            max(self.bottom, other.bottom),
            max(self.right, other.right),
        )

    def intersection(self, other: "Rect") -> "Rect":
        return Rect(
            max(self.top, other.top),
            max(self.left, other.left),
            min(self.bottom, other.bottom),
            min(self.right, other.right),
        )

    def intersects(self, other: "Rect") -> bool:
        r = self.intersection(other)
        return r.width > 0 and r.height > 0

    def iou(self, other: "Rect") -> float:
        inter = self.intersection(other)
        ia = inter.area if (inter.width > 0 and inter.height > 0) else 0.0
        ua = self.area + other.area - ia
        return ia / ua if ua > 0 else 0.0

    def contains(self, other: "Rect") -> bool:
        return (
            self.top <= other.top
            and self.left <= other.left
            and self.bottom >= other.bottom
            and self.right >= other.right
        )

    def contains_point(self, p: Sequence[float]) -> bool:
        x, y = float(p[0]), float(p[1])
        return self.left <= x <= self.right and self.top <= y <= self.bottom

    def adjust_tlbr(self, dt: float, dl: float, db: float, dr: float) -> "Rect":
        return Rect(self.top + dt, self.left + dl, self.bottom + db, self.right + dr)

    def integral_bounding_rect(self) -> "Rect":
        """Smallest integer-coordinate rect containing self."""
        return Rect(
            math.floor(self.top),
            math.floor(self.left),
            math.ceil(self.bottom),
            math.ceil(self.right),
        )

    def clamp(self, boundary: "Rect") -> "Rect":
        return Rect(
            min(max(self.top, boundary.top), boundary.bottom),
            min(max(self.left, boundary.left), boundary.right),
            max(min(self.bottom, boundary.bottom), boundary.top),
            max(min(self.right, boundary.right), boundary.left),
        )

    # -- edges (used by layout analysis midpoint lines) --------------------
    def left_edge(self) -> "Line":
        return Line(point(self.left, self.top), point(self.left, self.bottom))

    def right_edge(self) -> "Line":
        return Line(point(self.right, self.top), point(self.right, self.bottom))

    def top_edge(self) -> "Line":
        return Line(point(self.left, self.top), point(self.right, self.top))

    def bottom_edge(self) -> "Line":
        return Line(point(self.left, self.bottom), point(self.right, self.bottom))


def bounding_rect(rects: Iterable[Rect]) -> Optional[Rect]:
    """Union of a sequence of rects; None when the sequence is empty."""
    out: Optional[Rect] = None
    for r in rects:
        out = r if out is None else out.union(r)
    return out


# ---------------------------------------------------------------------------
# Line
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Line:
    """A 2-D line segment between two points."""

    start: Point
    end: Point

    @staticmethod
    def from_endpoints(start: Sequence[float], end: Sequence[float]) -> "Line":
        return Line(np.asarray(start, dtype=np.float64), np.asarray(end, dtype=np.float64))

    def center(self) -> Point:
        return (self.start + self.end) / 2.0

    def rightwards(self) -> "Line":
        if self.start[0] <= self.end[0]:
            return self
        return Line(self.end, self.start)

    def downwards(self) -> "Line":
        """Endpoints sorted top-to-bottom (geom_util.rs:20-26)."""
        if self.start[1] <= self.end[1]:
            return self
        return Line(self.end, self.start)

    def bounding_rect(self) -> Rect:
        xs = (self.start[0], self.end[0])
        ys = (self.start[1], self.end[1])
        return Rect(min(ys), min(xs), max(ys), max(xs))

    def vertical_overlap(self, other: "Line") -> float:
        """Amount of overlap of the y-ranges of the two segments."""
        a0, a1 = sorted((self.start[1], self.end[1]))
        b0, b1 = sorted((other.start[1], other.end[1]))
        return max(0.0, min(a1, b1) - max(a0, b0))

    def horizontal_overlap(self, other: "Line") -> float:
        """Amount of overlap of the x-ranges of the two segments."""
        a0, a1 = sorted((self.start[0], self.end[0]))
        b0, b1 = sorted((other.start[0], other.end[0]))
        return max(0.0, min(a1, b1) - max(a0, b0))

    def y_for_x(self, x: float) -> Optional[float]:
        """Interpolated y at the given x, or None if x is outside the
        segment's x range (recognition.rs:175-185 relies on this)."""
        x0, x1 = self.start[0], self.end[0]
        lo, hi = (x0, x1) if x0 <= x1 else (x1, x0)
        if x < lo or x > hi or x0 == x1:
            return None
        t = (x - x0) / (x1 - x0)
        return float(self.start[1] + t * (self.end[1] - self.start[1]))

    def intersects(self, other: "Line") -> bool:
        """Segment intersection test (touching counts as intersecting)."""
        p, r = self.start, self.end - self.start
        q, s = other.start, other.end - other.start

        def cross(a: np.ndarray, b: np.ndarray) -> float:
            return float(a[0] * b[1] - a[1] * b[0])

        denom = cross(r, s)
        qp = q - p
        if denom == 0.0:
            if cross(qp, r) != 0.0:
                return False  # parallel, non-collinear
            # Collinear: check 1-D overlap along the dominant axis.
            rr = float(r @ r)
            if rr == 0.0:
                return bool(np.all(np.abs(qp) < 1e-12))
            t0 = float(qp @ r) / rr
            t1 = t0 + float(s @ r) / rr
            lo, hi = min(t0, t1), max(t0, t1)
            return hi >= 0.0 and lo <= 1.0
        t = cross(qp, s) / denom
        u = cross(qp, r) / denom
        return 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0


# ---------------------------------------------------------------------------
# RotatedRect
# ---------------------------------------------------------------------------


def _rot90(v: np.ndarray) -> np.ndarray:
    """Perpendicular ("right") axis for an up axis: up=(0,-1) -> right=(1,0)."""
    return np.array([-v[1], v[0]], dtype=np.float64)


@dataclass
class RotatedRect:
    """Oriented rectangle: center + unit up-axis + width/height.

    Width is the extent along the right axis (perpendicular to up); height is
    the extent along up. Corner order matches the reference JSON fixture:
    for an axis-aligned rect with up=(0,-1) the corners come out as
    [bottom-right, bottom-left, top-left, top-right].
    """

    center: Point
    up: Point
    width: float
    height: float

    def __init__(self, center: Sequence[float], up: Sequence[float], width: float, height: float):
        self.center = np.asarray(center, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        n = float(np.hypot(up[0], up[1]))
        self.up = up / n if n > 0 else np.array([0.0, -1.0])
        self.width = float(width)
        self.height = float(height)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def _raw(cx: float, cy: float, ux: float, uy: float, w: float, h: float) -> "RotatedRect":
        """Trusted fast constructor: (ux, uy) must already be unit. For batch
        paths that build thousands of rects from validated arrays."""
        r = RotatedRect.__new__(RotatedRect)
        r.center = np.array((cx, cy))
        r.up = np.array((ux, uy))
        r.width = w
        r.height = h
        return r

    @staticmethod
    def from_rect(rect: Rect) -> "RotatedRect":
        c = rect.center()
        return RotatedRect(c, point(0.0, -1.0), rect.width, rect.height)

    # -- accessors ----------------------------------------------------------
    def right_axis(self) -> np.ndarray:
        return _rot90(self.up)

    def corners(self) -> list[Point]:
        r = self.right_axis() * (self.width / 2.0)
        u = self.up * (self.height / 2.0)
        c = self.center
        return [c + r - u, c - r - u, c - r + u, c + r + u]

    def area(self) -> float:
        return self.width * self.height

    def bounding_rect(self) -> Rect:
        cs = np.stack(self.corners())
        return Rect(cs[:, 1].min(), cs[:, 0].min(), cs[:, 1].max(), cs[:, 0].max())

    # -- mutators (reference: detection.rs:54-58 uses resize) ----------------
    def resize(self, width: float, height: float) -> None:
        self.width = float(width)
        self.height = float(height)

    def orient_towards(self, up: Sequence[float]) -> "RotatedRect":
        """Flip/rotate axes (in 90° steps) so the up axis points closest to
        `up`, preserving the covered area (text_items.rs:29-30)."""
        up = np.asarray(up, dtype=np.float64)
        best = None
        best_dot = -np.inf
        for k in range(4):
            if k % 2 == 0:
                cand_up, w, h = self.up * (1 if k == 0 else -1), self.width, self.height
            else:
                sign = 1 if k == 1 else -1
                cand_up, w, h = _rot90(self.up) * sign, self.height, self.width
            d = float(cand_up @ up)
            if d > best_dot:
                best_dot = d
                best = RotatedRect(self.center.copy(), cand_up, w, h)
        assert best is not None
        return best


# ---------------------------------------------------------------------------
# Edges of rotated rects (geom_util.rs:6-26)
# ---------------------------------------------------------------------------


def leftmost_edge(r: RotatedRect) -> Line:
    cs = sorted(r.corners(), key=lambda p: p[0])
    return Line(cs[0], cs[1])


def rightmost_edge(r: RotatedRect) -> Line:
    cs = sorted(r.corners(), key=lambda p: p[0])
    return Line(cs[2], cs[3])


def bounding_rect_of_rotated(rects: Iterable[RotatedRect]) -> Optional[Rect]:
    return bounding_rect(r.bounding_rect() for r in rects)


# ---------------------------------------------------------------------------
# Min-area rotated rect (convex hull + rotating calipers)
# ---------------------------------------------------------------------------


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull. `points` is (N,2) [x,y]; returns hull
    vertices (M,2) in counter-clockwise order (in a y-down frame this is
    visually clockwise)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # sort by x then y
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(iterable):
        out: list[np.ndarray] = []
        for p in iterable:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> Optional[RotatedRect]:
    """Minimum-area oriented bounding rectangle of a point set.

    Uses the rotating-calipers property that an optimal rect has one edge
    collinear with a hull edge. Matches the usage of
    ``rten_imageproc::min_area_rect`` (detection.rs:52, text_items.rs:25):
    width/height are measured as coordinate extents of the point set.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.size == 0:
        return None
    hull = convex_hull(pts)
    if len(hull) == 1:
        return RotatedRect(hull[0], point(0.0, -1.0), 0.0, 0.0)
    if len(hull) == 2:
        d = hull[1] - hull[0]
        n = float(np.hypot(d[0], d[1]))
        dirv = d / n
        c = (hull[0] + hull[1]) / 2.0
        return RotatedRect(c, _rot90(dirv), n, 0.0)

    best = None
    best_area = np.inf
    nh = len(hull)
    for i in range(nh):
        e = hull[(i + 1) % nh] - hull[i]
        n = float(np.hypot(e[0], e[1]))
        if n == 0:
            continue
        ex = e / n  # edge direction
        ey = _rot90(ex)
        proj_x = hull @ ex
        proj_y = hull @ ey
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        a = w * h
        if a < best_area:
            cx = (proj_x.max() + proj_x.min()) / 2.0
            cy = (proj_y.max() + proj_y.min()) / 2.0
            center = cx * ex + cy * ey
            best_area = a
            best = RotatedRect(center, ey, w, h)
    return best
