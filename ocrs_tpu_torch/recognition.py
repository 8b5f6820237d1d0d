"""Text recognition: batched line extraction, recognizer forward, CTC decoding.

Port of ``ocrs_tpu.recognition`` (upstream ocrs/src/recognition.rs:404-561):

  * per line: the line polygon from its word rects (top edges left to right,
    bottom edges right to left), and the resized width
    ``clamp(height * aspect, 10, 2400)``;
  * lines are grouped by bucketed width (and by whether they are cropped
    along a rotated rect) and chunked into batches;
  * every line of a batch is extracted on the device in one call
    (:func:`ops.warp.extract_line_batch_packed`, or
    :func:`ops.warp.extract_line_batch_rotated` for deskewed and vertical
    lines), cast to bf16 and run through the recognizer
    (``[N,1,H,W] -> [seq,N,classes]``, transposed to batch-major);
  * excluded characters are masked to -inf, then CTC: greedy (argmax on the
    device, collapse on the host) or beam search (per-frame top-k on the
    device, prefix beam on the host);
  * every batch's device work and its copy to the host are started before
    any copy is waited for;
  * decoded steps map back to per-character image rects through the CTC
    downsample factor and the width scale (recognition.rs:241-311).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .errors import WrongOutputError
from .geometry import Line, Rect, RotatedRect, bounding_rect, min_area_rect
from .models.protocol import Model, fixed_height_or
from .ops.ctc import (
    BEAM_EMISSION_GAP,
    CtcStep,
    beam_candidate_k,
    beam_decode_topk,
    beam_topk_packed,
    collapse_greedy_batch,
    greedy_labels_u8,
    mask_excluded,
    text_confidence,
    unpack_topk,
)
from .ops.resize import _interp_matrix
from .ops.warp import extract_line_batch_packed, extract_line_batch_rotated, pad_chain
from .preprocess import BLACK_VALUE
from .text_items import TextChar, TextLine


@dataclass(frozen=True)
class Greedy:
    pass


@dataclass(frozen=True)
class BeamSearch:
    width: int = 100


DecodeMethod = Union[Greedy, BeamSearch]


@dataclass
class RecognitionOpt:
    """Options for ``recognize_text_lines`` (recognition.rs:206-215)."""

    debug: bool = False
    decode_method: DecodeMethod = field(default_factory=Greedy)
    alphabet: str = ""
    excluded_char_labels: Optional[Sequence[int]] = None
    #: Drop decoded lines whose character-frame confidence
    #: (:func:`ops.ctc.text_confidence`) is below this, in (0, 1]. Suppresses
    #: graphics strokes that the detector boxed and the recognizer "read" as
    #: low-probability glyph soup. None = off (default).
    min_line_confidence: Optional[float] = None


MIN_LINE_WIDTH = 10.0
#: Cap on resized line width; ~150 chars of text (recognition.rs:58-75).
MAX_LINE_WIDTH = 2400.0


def resized_line_width(orig_width: float, orig_height: float, height: int) -> int:
    """Width to resize a line image to for a given target height
    (recognition.rs:58-75)."""
    aspect = float(orig_width) / float(orig_height)
    return int(np.clip(height * aspect, MIN_LINE_WIDTH, MAX_LINE_WIDTH))


def line_polygon(words: Sequence[RotatedRect]) -> np.ndarray:
    """Closed polygon that tightly follows a line's word rects: top-edge
    endpoints left-to-right, then bottom-edge endpoints right-to-left, floored
    to integers (recognition.rs:29-55). Returns (4 * len(words), 2) int [x, y].

    For each word, the leftmost edge is the two smallest-x corners and the
    rightmost edge the two largest-x corners, each ordered top to bottom."""
    k = len(words)
    centers = np.array([w.center for w in words]).reshape(k, 2)
    ups = np.array([w.up for w in words]).reshape(k, 2)
    whs = np.array([(w.width, w.height) for w in words]).reshape(k, 2)
    rights = np.stack([-ups[:, 1], ups[:, 0]], axis=1)
    rw = rights * (whs[:, 0:1] / 2.0)
    uh = ups * (whs[:, 1:2] / 2.0)
    cs = np.stack(
        [centers + rw - uh, centers - rw - uh, centers - rw + uh, centers + rw + uh],
        axis=1,
    )  # (k, 4, 2)
    order = np.argsort(cs[:, :, 0], axis=1, kind="stable")
    sx = np.take_along_axis(cs[:, :, 0], order, axis=1)
    sy = np.take_along_axis(cs[:, :, 1], order, axis=1)

    def edge(i0, i1):
        """Edge (corners i0, i1 of the x-sorted order) as downwards
        (start.y <= end.y) start/end points: (k, 2, 2)."""
        swap = sy[:, i0] > sy[:, i1]
        x0 = np.where(swap, sx[:, i1], sx[:, i0])
        y0 = np.where(swap, sy[:, i1], sy[:, i0])
        x1 = np.where(swap, sx[:, i0], sx[:, i1])
        y1 = np.where(swap, sy[:, i0], sy[:, i1])
        return np.stack([np.stack([x0, y0], 1), np.stack([x1, y1], 1)], axis=1)

    left = edge(0, 1)
    right = edge(2, 3)
    top_pts = np.stack([left[:, 0], right[:, 0]], axis=1).reshape(2 * k, 2)
    bot_pts = np.stack([right[:, 1], left[:, 1]], axis=1)[::-1].reshape(2 * k, 2)
    return np.floor(np.concatenate([top_pts, bot_pts])).astype(np.int64)


def line_rotated_rect(words: Sequence[RotatedRect]) -> RotatedRect:
    """Min-area rotated rect over a line's word corners, oriented so the
    height axis points up (toward -y): the deskewing counterpart of the
    axis-aligned ``_line_rect``. For a straight line of axis-aligned words it
    equals their union bounding rect; for a skewed line it follows the text
    angle, so :func:`ops.warp.extract_line_batch_rotated` samples the glyphs
    upright."""
    pts = np.concatenate([np.stack(w.corners()) for w in words])
    r = min_area_rect(pts)
    assert r is not None, "line has no words"
    return r.orient_towards((0.0, -1.0))


def line_polygons_batch(
    lines: Sequence[Sequence[RotatedRect]],
) -> tuple[list[np.ndarray], list[Rect]]:
    """Batched :func:`line_polygon` + word-union bounding rect for many lines
    at once.

    Returns ``(polys, rects)`` where ``polys[i]`` is bit-identical to
    ``line_polygon(lines[i])`` and ``rects[i]`` equals the integral bounding
    rect of the union of ``lines[i]``'s word bounding rects. One vectorized
    pass over a [L, Kmax] padded word table replaces ~25 small numpy calls
    per line (which dominate the pooled pipeline's host-side batch build at
    a few hundred lines per page group)."""
    L = len(lines)
    if L == 0:
        return [], []
    ks = np.array([len(ws) for ws in lines], dtype=np.int64)
    kmax = int(ks.max())
    centers = np.zeros((L, kmax, 2))
    ups = np.zeros((L, kmax, 2))
    whs = np.ones((L, kmax, 2))
    for l, ws in enumerate(lines):
        k = len(ws)
        centers[l, :k] = [w.center for w in ws]
        ups[l, :k] = [w.up for w in ws]
        whs[l, :k] = [(w.width, w.height) for w in ws]

    rights = np.stack([-ups[..., 1], ups[..., 0]], axis=-1)
    rw = rights * (whs[..., 0:1] / 2.0)
    uh = ups * (whs[..., 1:2] / 2.0)
    cs = np.stack(
        [centers + rw - uh, centers - rw - uh, centers - rw + uh, centers + rw + uh],
        axis=2,
    )  # (L, K, 4, 2)
    order = np.argsort(cs[..., 0], axis=2, kind="stable")
    sx = np.take_along_axis(cs[..., 0], order, axis=2)
    sy = np.take_along_axis(cs[..., 1], order, axis=2)

    def edge(i0, i1):
        swap = sy[..., i0] > sy[..., i1]
        x0 = np.where(swap, sx[..., i1], sx[..., i0])
        y0 = np.where(swap, sy[..., i1], sy[..., i0])
        x1 = np.where(swap, sx[..., i0], sx[..., i1])
        y1 = np.where(swap, sy[..., i0], sy[..., i1])
        return (
            np.stack([x0, y0], axis=-1),  # start (downwards)
            np.stack([x1, y1], axis=-1),  # end
        )

    left_s, left_e = edge(0, 1)
    right_s, right_e = edge(2, 3)
    top_pts = np.stack([left_s, right_s], axis=2).reshape(L, 2 * kmax, 2)
    # Bottoms right-to-left: reversed word order per line (padded tails are
    # clipped to index 0 and sliced away below).
    rev = np.clip(ks[:, None] - 1 - np.arange(kmax)[None, :], 0, None)
    r_rev = np.take_along_axis(right_e, rev[..., None], axis=1)
    l_rev = np.take_along_axis(left_e, rev[..., None], axis=1)
    bot_pts = np.stack([r_rev, l_rev], axis=2).reshape(L, 2 * kmax, 2)
    top_i = np.floor(top_pts).astype(np.int64)
    bot_i = np.floor(bot_pts).astype(np.int64)

    # Word-union bounding rect per line from the same corner table (equals
    # unioning each word's RotatedRect.bounding_rect()).
    valid = (np.arange(kmax)[None, :] < ks[:, None])[..., None]  # (L, K, 1)
    big = np.where(valid, cs[..., 0], np.inf), np.where(valid, cs[..., 1], np.inf)
    small = (
        np.where(valid, cs[..., 0], -np.inf),
        np.where(valid, cs[..., 1], -np.inf),
    )
    min_x = np.floor(big[0].min(axis=(1, 2)))
    min_y = np.floor(big[1].min(axis=(1, 2)))
    max_x = np.ceil(small[0].max(axis=(1, 2)))
    max_y = np.ceil(small[1].max(axis=(1, 2)))

    polys: list[np.ndarray] = []
    rects: list[Rect] = []
    for l in range(L):
        k = int(ks[l])
        polys.append(np.concatenate([top_i[l, : 2 * k], bot_i[l, : 2 * k]]))
        rects.append(Rect(min_y[l], min_x[l], max_y[l], max_x[l]))
    return polys, rects


def _round_half_away(y: np.ndarray) -> np.ndarray:
    """Round half away from zero (Rust f32::round), not banker's rounding."""
    return np.sign(y) * np.floor(np.abs(y) + 0.5)


def _polygon_slices(
    polys: Sequence[np.ndarray], poly_of: np.ndarray, min_x: np.ndarray, max_x: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bounding rect of the slice x in [min_x[c], max_x[c]] of
    ``polys[poly_of[c]]`` for every slice c at once (recognition.rs:162-193):
    float64 ``(top, left, bottom, right, hit)``, where ``hit[c]`` is False
    when no edge reaches the slice (its four edges are then meaningless).

    The polygons are padded to the largest vertex count with edges that
    reach no slice. Each slice keeps the edges of its own polygon that reach
    it, in polygon order, and only those go through upstream's float64
    arithmetic; the edges are the same, so are the rects."""
    vs = np.array([len(p) for p in polys], dtype=np.int64)
    v = max(int(vs.max(initial=0)), 1)
    col = np.arange(v)
    edge = col[None, :] < vs[:, None]  # (P, V): real edges
    p1 = np.zeros((len(polys), v, 2))
    if vs.sum():
        p1[edge] = np.concatenate([p for p in polys if len(p)])
    # Each vertex's successor on its own polygon: np.roll(poly, -1).
    nxt = np.where(col[None, :] + 1 < vs[:, None], col[None, :] + 1, 0)
    p2 = np.take_along_axis(p1, nxt[..., None], axis=1)
    # rightwards(): endpoints ordered by increasing x.
    swap = p1[..., 0] > p2[..., 0]
    x1 = np.where(edge, np.where(swap, p2[..., 0], p1[..., 0]), np.inf)
    y1 = np.where(swap, p2[..., 1], p1[..., 1])
    x2 = np.where(edge, np.where(swap, p1[..., 0], p2[..., 0]), -np.inf)
    y2 = np.where(swap, p1[..., 1], p2[..., 1])

    # An edge reaches a slice unless both its ends lie left of it or both
    # right of it; with x1 <= x2 that is x2 >= min_x and x1 <= max_x.
    mn = np.asarray(min_x, dtype=np.float64)
    mx = np.asarray(max_x, dtype=np.float64)
    keep = (x2[poly_of] >= mn[:, None]) & (x1[poly_of] <= mx[:, None])  # (C, V)
    c, e = np.nonzero(keep)  # kept (slice, edge) pairs, by slice then edge
    at = poly_of[c] * v + e
    x1, y1, x2, y2 = (a.ravel()[at] for a in (x1, y1, x2, y2))
    mn, mx = mn[c], mx[c]
    nonvert = x1 != x2
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.where(nonvert, (y2 - y1) / (x2 - x1), 0.0)

    def truncate(xq, x_dflt, y_dflt):
        valid = nonvert & (xq >= x1) & (xq <= x2)
        yq = _round_half_away(y1 + (xq - x1) * slope)
        return np.where(valid, xq, x_dflt), np.where(valid, yq, y_dflt)

    sx, sy = truncate(mn, x1, y1)
    ex, ey = truncate(mx, x2, y2)

    # Each slice's kept edges are one run of the pairs.
    n = np.bincount(c, minlength=len(poly_of))
    hit = n > 0
    first = (np.cumsum(n) - n)[hit]

    def per_slice(ufunc, a, b, empty):
        out = np.full(len(poly_of), empty)
        out[hit] = ufunc.reduceat(ufunc(a, b), first)
        return out

    return (
        per_slice(np.minimum, sy, ey, np.inf),
        per_slice(np.minimum, sx, ex, np.inf),
        per_slice(np.maximum, sy, ey, -np.inf),
        per_slice(np.maximum, sx, ex, -np.inf),
        hit,
    )


def polygon_slice_bounding_rects(
    poly: np.ndarray, ranges: np.ndarray
) -> list[Optional[Rect]]:
    """Bounding rect of the slice x in [min_x, max_x] of `poly`, for each of
    the (C, 2) `ranges` at once; None where no edge reaches the slice
    (recognition.rs:162-193)."""
    if len(ranges) == 0:
        return []
    cols = _polygon_slices([poly], np.zeros(len(ranges), np.int64), ranges[:, 0], ranges[:, 1])
    return [Rect(t, l, b, r) if hit else None for t, l, b, r, hit in zip(*(c.tolist() for c in cols))]


def polygon_slice_bounding_rect(
    poly: np.ndarray, min_x: float, max_x: float
) -> Optional[Rect]:
    """Bounding rect of the polygon slice with x in [min_x, max_x]
    (recognition.rs:162-193)."""
    n = len(poly)
    out: Optional[Rect] = None
    for i in range(n):
        e = Line.from_endpoints(poly[i], poly[(i + 1) % n]).rightwards()
        if (e.start[0] < min_x and e.end[0] < min_x) or (
            e.start[0] > max_x and e.end[0] > max_x
        ):
            continue
        y_min = e.y_for_x(float(min_x))
        start = (
            (min_x, float(_round_half_away(np.float64(y_min))))
            if y_min is not None
            else (e.start[0], e.start[1])
        )
        y_max = e.y_for_x(float(max_x))
        end = (
            (max_x, float(_round_half_away(np.float64(y_max))))
            if y_max is not None
            else (e.end[0], e.end[1])
        )
        edge_br = Line.from_endpoints(start, end).bounding_rect()
        out = edge_br if out is None else out.union(edge_br)
    return out


def reference_bucket(width: int) -> int:
    """Upstream's bucket law: next multiple of 50 (recognition.rs:437)."""
    return ((width + 49) // 50) * 50


#: Width-bucket ladders in multiples of 128. Decoded characters falling in
#: the BLACK right-padding are clipped (recognition.rs:271-276). For a
#: recurrent recognizer the padding is not fully inert (a backward GRU walks
#: the padding frames before it reaches content); ConvCTC is local, so its
#: output at content frames does not depend on the padding length.
WIDTH_LADDER: tuple[int, ...] = (128, 256, 384, 512, 768, 1024, 1536, 2048, 2432)
COARSE_WIDTH_LADDER: tuple[int, ...] = (1216, 2432)


def ladder_bucket(ladder: Sequence[int]) -> Callable[[int], int]:
    lad = sorted(ladder)

    def bucket(width: int) -> int:
        for w in lad:
            if width <= w:
                return w
        return lad[-1]

    return bucket


def single_bucket(width: int) -> int:
    """The engine's width law: ONE bucket, so one recognition batch per
    image (the compute width is still trimmed to the batch's widest line)."""
    return 2432


def _pad_batch_size(n: int, cap: int) -> int:
    """Round a batch size up to a power of two (capped), so the recognizer
    sees a handful of batch shapes rather than one per line count."""
    p = 1
    while p < n:
        p *= 2
    return min(p, max(cap, n))


def _fill_polygon_mask(poly: np.ndarray, rect: Rect, page_hw: tuple[int, int]) -> np.ndarray:
    """Even-odd scanline fill of `poly` restricted to `rect`, like
    ``Polygon::fill_iter`` (recognition.rs:110). Returns a bool mask of shape
    (rect.height, rect.width) marking pixels to copy from the page."""
    t, l = int(rect.top), int(rect.left)
    h, w = int(rect.height), int(rect.width)
    mask = np.zeros((h, w), dtype=bool)
    xs_edge = poly[:, 0].astype(np.float64)
    ys_edge = poly[:, 1].astype(np.float64)
    x2 = np.roll(xs_edge, -1)
    y2 = np.roll(ys_edge, -1)
    for row in range(h):
        y = t + row
        crosses = ((ys_edge <= y) & (y2 > y)) | ((y2 <= y) & (ys_edge > y))
        if not crosses.any():
            continue
        xi = xs_edge[crosses] + (y - ys_edge[crosses]) * (
            (x2[crosses] - xs_edge[crosses]) / (y2[crosses] - ys_edge[crosses])
        )
        xi = np.sort(xi)
        for a, b in zip(xi[::2], xi[1::2]):
            x0 = max(int(math.ceil(a)), l)
            x1 = min(int(math.floor(b)), l + w - 1)
            if x1 >= x0:
                mask[row, x0 - l : x1 - l + 1] = True
    # Page clipping (recognition.rs:111-116): both the source point and the
    # buffer-local point must lie within the page's index rect.
    ph, pw = page_hw
    ys_idx = t + np.arange(h)
    xs_idx = l + np.arange(w)
    in_page = ((ys_idx >= 0) & (ys_idx <= ph - 1))[:, None] & (
        (xs_idx >= 0) & (xs_idx <= pw - 1)
    )[None, :]
    local_ok = ((np.arange(h) <= ph - 1))[:, None] & ((np.arange(w) <= pw - 1))[None, :]
    return mask & in_page & local_ok


def prepare_text_line_host(
    image: np.ndarray, poly: np.ndarray, resized_width: int, output_height: int
) -> np.ndarray:
    """Host-exact upstream ``prepare_text_line`` (recognition.rs:91-126):
    polygon fill into a BLACK buffer, then bilinear resize to
    (output_height, resized_width)."""
    page = np.asarray(image)
    if page.ndim == 3:
        page = page[0]
    ph, pw = page.shape
    rect = Rect.from_tlbr(
        float(poly[:, 1].min()),
        float(poly[:, 0].min()),
        float(poly[:, 1].max()),
        float(poly[:, 0].max()),
    )
    t, l = int(rect.top), int(rect.left)
    h, w = int(rect.height), int(rect.width)
    buf = np.full((max(h, 1), max(w, 1)), BLACK_VALUE, dtype=np.float32)
    if h > 0 and w > 0:
        mask = _fill_polygon_mask(poly, rect, (ph, pw))
        ys = np.clip(t + np.arange(h), 0, ph - 1)
        xs = np.clip(l + np.arange(w), 0, pw - 1)
        buf = np.where(mask, page[np.ix_(ys, xs)], BLACK_VALUE).astype(np.float32)
    ry = _interp_matrix(buf.shape[0], output_height)
    rx = _interp_matrix(buf.shape[1], int(resized_width))
    return (ry @ buf @ rx.T).astype(np.float32)


@dataclass
class _RecLine:
    """Internal per-line record (recognition.rs:183-196 ``TextRecLine``)."""

    index: int
    poly: np.ndarray  # (V, 2) int polygon
    rect: Rect  # integral bounding rect of the polygon
    resized_width: int
    #: Deskew/vertical mode: the line's min-area rotated rect. When set, the
    #: crop samples along this rect's axes and char rects are mapped back
    #: through the rotation.
    rrect: Optional[RotatedRect] = None
    #: Vertical-text direction voting: 0 = bottom-up reading, 1 = top-down.
    #: Both variants of one line share ``index``; the decode with the higher
    #: mean per-frame confidence wins. -1 = not a voting variant.
    variant: int = -1


#: Decoded steps of one line: CtcStep objects (the engine), or a (pos, label)
#: int32 array pair (the page pipeline, see ops.ctc.collapse_greedy_batch_arrays).
Steps = Union[list[CtcStep], tuple[np.ndarray, np.ndarray]]


def _step_arrays(steps: Steps) -> tuple[np.ndarray, np.ndarray]:
    """Either representation of decoded steps as (frame positions, labels)."""
    if isinstance(steps, tuple):
        return steps
    return (
        np.array([s.pos for s in steps], dtype=np.int64),
        np.array([s.label for s in steps], dtype=np.int64),
    )


@dataclass
class _LineResult:
    line: _RecLine
    rec_input_len: int
    ctc_input_len: int
    steps: Steps
    #: Mean over frames of the max log-probability (only read back for
    #: direction-voting batches; 0.0 otherwise).
    conf: float = 0.0


class _HostCopies:
    """Copies of device tensors to the host, started at construction and
    waited for at :meth:`numpy`. On CUDA the copies go to pinned memory
    without blocking and one event marks their end: the bytes may only be
    read after the event, so the wait is explicit. On the CPU there is
    nothing to copy."""

    def __init__(self, tensors: Sequence[Optional[torch.Tensor]]):
        self._event = None
        self._host: list[Optional[torch.Tensor]] = []
        for t in tensors:
            if t is not None and t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t = host
                self._event = self._event or torch.cuda.Event()
            self._host.append(t)
        if self._event is not None:
            self._event.record()

    def numpy(self) -> list[Optional[np.ndarray]]:
        if self._event is not None:
            self._event.synchronize()
        return [None if t is None else t.numpy() for t in self._host]


#: Maximum vertices per padded polygon chain (= max words per line times 2;
#: longer chains are downsampled in pad_chain).
MAX_CHAIN_V = 64


class TextRecognizer:
    """Extracts character sequences and boxes from detected text lines."""

    def __init__(
        self,
        model: Model,
        width_bucket: Optional[Callable[[int], int]] = None,
        max_lines_per_batch: int = 20,
        deskew: bool = False,
    ):
        self._model = model
        self._input_height = fixed_height_or(model.input_shape(), default=50)
        self._bucket = width_bucket or ladder_bucket(WIDTH_LADDER)
        self._max_lines = max_lines_per_batch
        #: Deskew mode (no upstream counterpart): crop each line along its
        #: min-area rotated rect so slanted text reaches the recognizer
        #: upright. Upstream's crops are always axis-aligned.
        self._deskew = deskew

    @property
    def input_height(self) -> int:
        return self._input_height

    def run(self, batch: torch.Tensor) -> torch.Tensor:
        """[N, 1, H, W] -> [N, seq, classes] log-probabilities
        (recognition.rs:340-360)."""
        out = self._model.run(batch)
        if out.dim() != 3:
            raise WrongOutputError(
                f"expected recognition output to have 3 dims but it has {out.dim()}"
            )
        return out.transpose(0, 1)

    def prepare_input(self, image: torch.Tensor, line: Sequence[RotatedRect]) -> np.ndarray:
        """Host-exact preprocessing of one line, for debugging
        (recognition.rs:366-392). Returns (H, W) float32."""
        rect = self._line_rect(line)
        poly = line_polygon(line)
        width = resized_line_width(rect.width, rect.height, self._input_height)
        return prepare_text_line_host(image.cpu().numpy(), poly, width, self._input_height)

    @staticmethod
    def _line_rect(line: Sequence[RotatedRect]) -> Rect:
        br = bounding_rect(r.bounding_rect() for r in line)
        assert br is not None, "line has no words"
        return br.integral_bounding_rect()

    def recognize_text_lines(
        self,
        image: torch.Tensor,
        lines: Sequence[Sequence[RotatedRect]],
        opts: RecognitionOpt,
        vertical: Optional[Sequence[bool]] = None,
    ) -> list[Optional[TextLine]]:
        if image.dim() != 3 or image.shape[0] != 1:
            raise ValueError(f"expected (1, H, W) image, got {tuple(image.shape)}")
        page = image[0]

        rec_lines: list[_RecLine] = []
        for index, words in enumerate(lines):
            if vertical is not None and vertical[index]:
                # Vertical text (90-degree-rotated, e.g. a plot's y-axis
                # label): crop along the stack's min-area rect in BOTH
                # reading directions, bottom-up (glyph tops point left, the
                # typographic convention) and top-down, and let decode
                # confidence pick the winner.
                mr = min_area_rect(np.concatenate([np.stack(w.corners()) for w in words]))
                assert mr is not None, "line has no words"
                for variant, up in enumerate(((-1.0, 0.0), (1.0, 0.0))):
                    rr = mr.orient_towards(up)
                    rec_lines.append(
                        _RecLine(
                            index=index,
                            poly=np.round(np.stack(rr.corners())).astype(np.int64),
                            rect=rr.bounding_rect().integral_bounding_rect(),
                            resized_width=resized_line_width(rr.width, rr.height, self._input_height),
                            rrect=rr,
                            variant=variant,
                        )
                    )
                continue
            poly = line_polygon(words)
            # The POLYGON's bounding rect is the coordinate base for the crop
            # and the char-rect back-mapping (recognition.rs:248-249); the
            # resized width comes from the WORDS' integral bounding rect
            # (recognition.rs:432-436). The two can differ by ~1px.
            rect = Rect.from_tlbr(
                float(poly[:, 1].min()),
                float(poly[:, 0].min()),
                float(poly[:, 1].max()),
                float(poly[:, 0].max()),
            )
            if self._deskew:
                # Geometry follows the line's min-area rotated rect, both the
                # crop sampling and the width law, so a slanted line's
                # resized width reflects its true length, not its (taller,
                # shorter) bounding box.
                rrect = line_rotated_rect(words)
                rec_lines.append(
                    _RecLine(
                        index=index,
                        poly=poly,
                        rect=rect,
                        resized_width=resized_line_width(rrect.width, rrect.height, self._input_height),
                        rrect=rrect,
                    )
                )
                continue
            lr = self._line_rect(words)
            rec_lines.append(
                _RecLine(
                    index=index,
                    poly=poly,
                    rect=rect,
                    resized_width=resized_line_width(lr.width, lr.height, self._input_height),
                )
            )

        # Bucket by padded width, then chunk into batches. Each batch's
        # compute width is trimmed to its widest line, rounded up to 128.
        groups: dict[tuple[int, bool], list[_RecLine]] = {}
        for rl in rec_lines:
            key = (self._bucket(rl.resized_width), rl.rrect is not None)
            groups.setdefault(key, []).append(rl)
        batches: list[tuple[int, list[_RecLine], bool]] = []
        for (width, rotated), group in groups.items():
            for i in range(0, len(group), self._max_lines):
                chunk = group[i : i + self._max_lines]
                w_eff = min(
                    width,
                    max(-(-max(rl.resized_width for rl in chunk) // 128) * 128, 128),
                )
                batches.append((w_eff, chunk, rotated))

        excluded = (
            sorted(set(opts.excluded_char_labels)) if opts.excluded_char_labels else None
        )
        greedy = isinstance(opts.decode_method, Greedy)

        # Phase 1: start every batch's device work (extraction, model, decode
        # reduction) and its copy to the host without waiting. Phase 2 waits
        # for each copy and finishes the decode on the host.
        inflight = []
        n_classes = 0
        for group_width, batch, rotated in batches:
            if opts.debug:
                print(f"Processing group of {len(batch)} lines of width {group_width}")
            logprobs = self._run_batch(page, batch, group_width, rotated)  # [N, T, C]
            n_classes = logprobs.shape[-1]
            if len(opts.alphabet) + 1 != n_classes:
                raise WrongOutputError(
                    f"output column count ({n_classes}) does not match "
                    f"alphabet size ({len(opts.alphabet) + 1})"
                )
            if excluded is not None:
                onehot = torch.zeros(n_classes, dtype=torch.bool, device=logprobs.device)
                onehot[[e for e in excluded if e < n_classes]] = True
                logprobs = mask_excluded(logprobs, onehot)
            # u8 labels for greedy; the beam reads back only the per-frame
            # top-k candidates, which is all it ever looks at.
            if greedy:
                out = greedy_labels_u8(logprobs)
            else:
                out = beam_topk_packed(
                    logprobs,
                    k=beam_candidate_k(opts.decode_method.width, n_classes),
                    gap=BEAM_EMISSION_GAP,
                )
            # Direction-voting batches also read back a per-line confidence
            # (mean over frames of the max log-prob).
            conf_dev = None
            if any(rl.variant >= 0 for rl in batch):
                conf_dev = logprobs.amax(dim=-1).mean(dim=1)
            tconf_dev = None
            if opts.min_line_confidence is not None:
                tconf_dev = text_confidence(logprobs)
            copies = _HostCopies((out, conf_dev, tconf_dev))
            inflight.append((group_width, batch, int(logprobs.shape[1]), copies))

        results: list[_LineResult] = []
        for group_width, batch, ctc_input_len, copies in inflight:
            host, conf, tconf = copies.numpy()
            if greedy:
                decoded = collapse_greedy_batch(host[: len(batch)])
            else:
                k = beam_candidate_k(opts.decode_method.width, n_classes)
                vals, idx = unpack_topk(host[: len(batch)], k)
                decoded = beam_decode_topk(vals, idx, opts.decode_method.width, n_classes)
            if conf is None:
                conf = np.zeros(len(batch), dtype=np.float32)
            if tconf is None:
                tconf = np.ones(len(batch), dtype=np.float32)
            for rl, steps, c, tc in zip(batch, decoded, conf, tconf):
                if opts.min_line_confidence is not None and steps and tc < opts.min_line_confidence:
                    steps = []  # low-confidence glyph soup: emit nothing
                results.append(
                    _LineResult(
                        line=rl,
                        rec_input_len=group_width,
                        ctc_input_len=ctc_input_len,
                        steps=steps,
                        conf=float(c),
                    )
                )

        results = _pick_direction_variants(results)
        results.sort(key=lambda r: r.line.index)
        return _text_lines_from_results(results, opts.alphabet)

    def _run_batch(
        self, page: torch.Tensor, batch: list[_RecLine], group_width: int, rotated: bool = False
    ) -> torch.Tensor:
        n = len(batch)
        n_pad = _pad_batch_size(n, self._max_lines)
        if rotated:
            geom = np.empty((10, n_pad), dtype=np.float32)
            for col, rl in enumerate(batch):
                rr = rl.rrect
                right, down = rr.right_axis(), -rr.up
                geom[0:2, col] = _rrect_origin(rr)
                geom[2:4, col] = right
                geom[4:6, col] = down
                geom[6:10, col] = (rr.width, rr.height, rl.resized_width, 0.0)
            geom[:, n:] = geom[:, n - 1 : n]
            crops = extract_line_batch_rotated(
                page, torch.from_numpy(geom).to(page.device), out_h=self._input_height, out_w=group_width
            )
        else:
            geom = np.empty((6, n_pad), dtype=np.float32)
            for col, rl in enumerate(batch):
                geom[:, col] = (
                    rl.rect.top, rl.rect.left, rl.rect.height, rl.rect.width, rl.resized_width, 0.0,
                )
            geom[:, n:] = geom[:, n - 1 : n]

            v = MAX_CHAIN_V
            chains = np.empty((n_pad, 2, v, 2), dtype=np.float32)
            for col, rl in enumerate(batch):
                half = len(rl.poly) // 2
                chains[col, 0] = pad_chain(rl.poly[:half], v)
                chains[col, 1] = pad_chain(rl.poly[half:][::-1], v)
            chains[n:] = chains[n - 1 : n]

            crops = extract_line_batch_packed(
                page,
                torch.from_numpy(geom).to(page.device),
                torch.from_numpy(chains).to(page.device),
                out_h=self._input_height,
                out_w=group_width,
            )
        # bf16 crops: the recognizer computes in bf16.
        logprobs = self.run(crops.to(torch.bfloat16))  # [n_pad, T, C]
        return logprobs[:n]


def _rrect_origin(rr: RotatedRect) -> np.ndarray:
    """Page coordinates of a rotated rect's top-left corner (in its own
    frame: against the text direction and up the glyphs)."""
    return rr.center - rr.right_axis() * (rr.width / 2.0) + rr.up * (rr.height / 2.0)


def _pick_direction_variants(results: list[_LineResult]) -> list[_LineResult]:
    """Resolve vertical-text direction voting: of the two reading-direction
    variants sharing a line index, keep the decode with the higher mean
    per-frame confidence. A variant that decodes at least 2 characters beats
    an (near-)empty one whatever the confidence: an unreadable direction
    often collapses to confident all-blank frames."""
    if all(r.line.variant < 0 for r in results):
        return results
    by_index: dict[int, list[_LineResult]] = {}
    out: list[_LineResult] = []
    for r in results:
        if r.line.variant < 0:
            out.append(r)
        else:
            by_index.setdefault(r.line.index, []).append(r)
    for variants in by_index.values():
        if len(variants) == 1:
            out.append(variants[0])
            continue
        a, b = variants[:2]
        n_a, n_b = (len(r.steps[0]) if isinstance(r.steps, tuple) else len(r.steps) for r in (a, b))
        if (n_a >= 2) != (n_b >= 2):
            out.append(a if n_a >= 2 else b)
        else:
            out.append(a if a.conf >= b.conf else b)
    return out


def _text_line_from_rotated_result(result: _LineResult, alphabet: str) -> Optional[TextLine]:
    """Deskew-mode counterpart of the char-rect back-mapping: decoded step
    positions advance along the ROTATED rect's width axis, and each char's
    rect is the axis-aligned bounding box of its slanted slice. Positions
    follow the same downsample / x-scale / truncation law as the
    axis-aligned path."""
    rr = result.line.rrect
    pos, labels = _step_arrays(result.steps)
    if len(pos) == 0:
        return None
    x_scale = float(rr.width) / float(result.line.resized_width)
    downsample = round(result.rec_input_len / result.ctc_input_len)
    pos = pos.astype(np.float64) * downsample
    end = np.concatenate([pos[1:], [float(result.line.resized_width)]])
    start_lx = np.trunc(pos * x_scale)  # rect-local, along the width axis
    end_lx = np.trunc(end * x_scale)
    in_bounds = start_lx < rr.width
    start_lx, end_lx = start_lx[in_bounds], np.minimum(end_lx[in_bounds], rr.width)
    labels = labels[in_bounds]

    right, down = rr.right_axis(), -rr.up
    origin = _rrect_origin(rr)
    # Corners of each char's slanted slice: origin + lx*right + ly*down for
    # lx in {start, end}, ly in {0, h}.
    lxs = np.stack([start_lx, end_lx], axis=1)  # (C, 2)
    corners = (
        origin[None, None, None, :]
        + lxs[:, :, None, None] * right[None, None, None, :]
        + np.array([0.0, rr.height])[None, None, :, None] * down[None, None, None, :]
    )  # (C, 2, 2, 2) -> [char, lx, ly, xy]
    xs = corners[..., 0].reshape(len(lxs), 4)
    ys = corners[..., 1].reshape(len(lxs), 4)

    chars = []
    for i, label in enumerate(labels.tolist()):
        label_idx = label - 1
        ch = alphabet[label_idx] if 0 <= label_idx < len(alphabet) else "?"
        rect = Rect.from_tlbr(ys[i].min(), xs[i].min(), ys[i].max(), xs[i].max())
        chars.append(TextChar(char=ch, rect=rect))
    return TextLine(chars) if chars else None


def _text_lines_from_results(results: list[_LineResult], alphabet: str) -> list[Optional[TextLine]]:
    """Build TextLines with per-char rects from decode results
    (recognition.rs:241-311), in the order of `results`; None for a line
    with no char in bounds.

    The axis-aligned lines are assembled in one pass over all their chars
    (the page pipeline hands over a whole page group at once); rotated lines
    go through :func:`_text_line_from_rotated_result`."""
    out: list[Optional[TextLine]] = [None] * len(results)
    flat = []
    for i, result in enumerate(results):
        if result.line.rrect is not None:
            out[i] = _text_line_from_rotated_result(result, alphabet)
        else:
            flat.append(i)
    if not flat:
        return out
    lines = [results[i].line for i in flat]
    steps = [_step_arrays(results[i].steps) for i in flat]
    counts = np.array([len(p) for p, _ in steps], dtype=np.int64)
    line_of = np.repeat(np.arange(len(flat)), counts)
    # Per-line columns, gathered to the chars.
    left = np.array([int(l.rect.left) for l in lines], dtype=np.int64)
    right = np.array([l.rect.right for l in lines], dtype=np.float64)
    resized = np.array([l.resized_width for l in lines], dtype=np.float64)
    x_scale = np.array([l.rect.width for l in lines], dtype=np.float64) / resized
    downsample = np.array(
        [round(results[i].rec_input_len / results[i].ctc_input_len) for i in flat], dtype=np.float64
    )
    pos = np.concatenate([p for p, _ in steps]).astype(np.float64) * downsample[line_of]
    labels = np.concatenate([lab for _, lab in steps]).astype(np.int64)
    # A char ends where the next char of its line starts; the last one at
    # the line's resized width.
    end = np.empty_like(pos)
    end[:-1] = pos[1:]
    has = counts > 0
    end[np.cumsum(counts)[has] - 1] = resized[has]
    # nb. upstream truncates (x * scale) BEFORE adding the (integer) rect
    # left (recognition.rs:264-265); this matters for negative lefts.
    scale = x_scale[line_of]
    start_x = left[line_of] + np.trunc(pos * scale).astype(np.int64)
    end_x = left[line_of] + np.trunc(end * scale).astype(np.int64)
    # Characters predicted in the padding region are dropped
    # (recognition.rs:271-276).
    in_bounds = start_x < right[line_of]
    line_of = line_of[in_bounds]
    top, rleft, bottom, rright, hit = _polygon_slices(
        [l.poly for l in lines], line_of, start_x[in_bounds], end_x[in_bounds]
    )
    assert hit.all(), "invalid X coords"
    # Label l is alphabet[l - 1]; the blank and labels past the alphabet
    # read "?".
    table = ["?", *alphabet]
    labels = labels[in_bounds]
    labels[(labels < 1) | (labels > len(alphabet))] = 0
    rects = map(Rect, top.tolist(), rleft.tolist(), bottom.tolist(), rright.tolist())
    chars = list(map(TextChar, map(table.__getitem__, labels.tolist()), rects))
    ends = np.cumsum(np.bincount(line_of, minlength=len(flat))).tolist()
    for i, a, b in zip(flat, [0, *ends], ends):
        if b > a:
            out[i] = TextLine(chars[a:b])
    return out


def arbitrate_word_gaps(
    line_rects: Sequence[RotatedRect], text_line: Optional[TextLine], *, span_margin: float = 0.5
) -> Optional[TextLine]:
    """Insert missing spaces at DETECTED word boundaries.

    The detector is a second witness of word segmentation: when a line's
    decode runs two words together at a tight gap, the detector has usually
    still produced two word rects with a gap between them. For each adjacent pair of the line's word rects, if no decoded
    space covers the gap and no decoded glyph SPANS the gap midpoint (a
    spanning glyph means the recognizer merged ink across the boundary —
    e.g. a wide char rect absorbing its neighbour — where inserting would
    corrupt the word), insert a space TextChar at the gap.

    No upstream counterpart: upstream relies on its recognizer alone for
    spaces. Returns a new TextLine (or the input unchanged).
    """
    if text_line is None or len(line_rects) < 2:
        return text_line
    chars = list(text_line.chars())
    if not chars:
        return text_line
    rects = sorted((r.bounding_rect() for r in line_rects), key=lambda b: b.left)
    inserted = False
    for a, b in zip(rects[:-1], rects[1:]):
        if b.left <= a.left or b.right <= a.right:
            continue  # nested/degenerate boxes, not a reading-order pair
        mid = (a.right + b.left) / 2.0
        blocked = False
        covered = False
        for c in chars:
            cl, cr = c.rect.left, c.rect.right
            if c.char == " ":
                if cl <= mid <= cr or (a.right - 2.0 <= cl and cr <= b.left + 2.0):
                    covered = True
                    break
            elif cl < mid - span_margin and cr > mid + span_margin:
                blocked = True
                break
        if covered or blocked:
            continue
        pos = 0
        while pos < len(chars) and (chars[pos].rect.left + chars[pos].rect.right) / 2.0 <= mid:
            pos += 1
        if pos == 0 or pos >= len(chars):
            continue  # gap outside the decoded span: nothing to separate
        top = min(a.top, b.top)
        bottom = max(a.bottom, b.bottom)
        left = min(a.right, mid - 0.5)
        right = max(b.left, mid + 0.5)
        chars.insert(pos, TextChar(" ", Rect.from_tlbr(top, left, bottom, right)))
        inserted = True
    return TextLine(chars) if inserted else text_line
