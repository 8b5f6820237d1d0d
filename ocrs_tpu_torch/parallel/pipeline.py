"""Multi-page batched OCR pipeline for throughput.

Port of ``ocrs_tpu.parallel.pipeline``. Upstream processes one image at a
time and gets its parallelism from a CPU thread pool. The throughput shape on
an accelerator is different: batch pages through every stage so each device
call is large, and synchronize with the host as rarely as possible:

  * one batched detection forward for the whole page group;
  * the masks of all pages reduced to ONE table for the group (row runs by
    default, fitted rects otherwise) -> one device-to-host copy;
  * rect fitting (run tables) and layout analysis on the host (tiny N; C++
    through :mod:`ocrs_tpu_torch.native` when that library is available);
  * recognition lines POOLED ACROSS PAGES into width buckets (a line batch
    may span pages through the page-indexed gather of
    :func:`ocrs_tpu_torch.ops.warp.extract_line_batch_packed`), so batches
    stay full;
  * CTC reductions (argmax, top-k) on the device, copied to pinned host
    memory without blocking.

Host waits per page group: 1 (the table) + one per recognition batch, each
for a copy started long before. PyTorch runs eagerly, so the JAX pipeline's
fused ``jit`` programs and their fallbacks have no counterpart; its ``mesh``
option (pages sharded over several devices) is not ported.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..detection import EXPAND_DIST, TextDetectorParams, _tile_offsets
from ..engine import resolve_device
from ..errors import WrongOutputError
from ..geometry import RotatedRect, min_area_rect
from ..layout import (
    find_text_lines,
    find_text_lines_idx_arrays,
    is_vertical_line,
    merge_vertical_chains,
)
from ..models.protocol import Model, fixed_height_or, fixed_hw
from ..ops.connected_components import label_components_device, label_components_multigrid
from ..ops.ctc import (
    BEAM_EMISSION_GAP,
    beam_candidate_k,
    beam_decode_topk_arrays,
    beam_topk_packed,
    collapse_greedy_batch_arrays,
    greedy_labels_u8,
    mask_excluded,
    text_confidence,
    unpack_topk,
)
from ..ops.rects import (
    min_area_rects_device,
    pack_rect_table,
    runs_tables,
    runs_to_rect_table_host,
    unpack_rect_table,
)
from ..ops.resize import resize_bilinear
from ..ops.warp import (
    _unpack4,
    extract_line_batch_packed,
    extract_line_batch_rotated,
    pad_chain,
    strip_mask_normalize_crops,
)
from ..preprocess import BLACK_VALUE, ITU_WEIGHTS
from ..recognition import (
    MAX_CHAIN_V,
    DecodeMethod,
    Greedy,
    _HostCopies,
    _LineResult,
    _RecLine,
    _pad_batch_size,
    _pick_direction_variants,
    _rrect_origin,
    _text_lines_from_results,
    line_polygons_batch,
    line_rotated_rect,
    resized_line_width,
    single_bucket,
)
from ..text_items import TextLine
from ..utils.log import warn
from ..utils.tracing import StageTimer


def _normalize_batch(imgs: torch.Tensor, is_u8: bool) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W] normalized greyscale (see preprocess.py)."""
    c = imgs.shape[-1]
    weights = [1.0] if c == 1 else list(ITU_WEIGHTS) + [0.0] * (c - 3)
    w = torch.tensor(weights, dtype=torch.float32, device=imgs.device)
    if is_u8:
        w = w / 255.0
    if c == 1:
        # One weight: its product in place, without a matrix product's copies
        # of a stack that is hundreds of megabytes at 300 dpi.
        return imgs[..., 0].to(torch.float32, copy=True).mul_(w[0]).add_(BLACK_VALUE)
    return (imgs.to(torch.float32) @ w).add_(BLACK_VALUE)


def _detect_pre_batch(pages: torch.Tensor, *, input_hw, pads) -> torch.Tensor:
    """[B, H, W] -> [B, 1, in_h, in_w] padded+resized detector input."""
    pad_bottom, pad_right = pads
    x = pages[:, None]
    if pad_bottom or pad_right:
        x = F.pad(x, (0, pad_right, 0, pad_bottom), value=BLACK_VALUE)
    if tuple(x.shape[-2:]) != tuple(input_hw):
        x = resize_bilinear(x, input_hw)
    return x


def _masks_to_tables(
    probs: torch.Tensor, *, crop_hw, threshold, max_components,
    multigrid=True, solidify=True, max_boundary=16384,
) -> torch.Tensor:
    """[B, 1, mh, mw] probabilities -> packed rect tables [B, 9, C] f32.

    Labelling and rect fitting on the device, page by page: their scatters
    and their loops that end when nothing changes take one mask at a time.
    Multigrid labelling solves connectivity at half resolution; with
    `solidify` the connectivity mask is also 3x3-closed, which can merge
    components less than ~4-5 px apart at detector resolution. Pass both
    False for the exact connectivity of the host path."""
    masks = probs[:, 0, : crop_hw[0], : crop_hw[1]] > threshold
    label = label_components_multigrid if multigrid else label_components_device
    tables = []
    for mask in masks:
        # max_points=256 keeps every run endpoint of components of up to ~256
        # runs (any real word at detector resolution); larger blobs are
        # subsampled by block.
        table = min_area_rects_device(
            label(mask, solidify=solidify),
            max_components=max_components, max_points=256, max_boundary=max_boundary,
        )
        tables.append(pack_rect_table(table))
    return torch.stack(tables)


def _masks_to_run_tables(
    probs: torch.Tensor, *, crop_hw, threshold, multigrid=True, solidify=True, max_runs=4096
) -> torch.Tensor:
    """[B, 1, mh, mw] probabilities -> packed int16 run tables [B, 7, K].

    The run-table geometry path: instead of labelling and fitting rects on
    the device, the device reduces every mask of the group to its row runs in
    one batched call and the host does union-find and exact hull/calipers
    over the runs (see ops.rects.runs_tables)."""
    masks = probs[:, 0, : crop_hw[0], : crop_hw[1]] > threshold
    return runs_tables(masks, pool=2 if multigrid else 1, solidify=solidify, max_runs=max_runs)


def _extract_tiles_batch(pages: torch.Tensor, *, input_hw, offsets) -> torch.Tensor:
    """[B, H, W] pages -> [B*T, 1, th, tw] overlapping tiles (T per page)."""
    th, tw = input_hw
    b, h, w = pages.shape
    pad_b, pad_r = max(th - h, 0), max(tw - w, 0)
    if pad_b or pad_r:
        pages = F.pad(pages, (0, pad_r, 0, pad_b), value=BLACK_VALUE)
    tiles = torch.stack([pages[:, y : y + th, x : x + tw] for (y, x) in offsets], dim=1)
    return tiles.reshape(b * len(offsets), 1, th, tw)


def _stitch_tiles_batch(probs: torch.Tensor, *, page_hw, offsets, batch) -> torch.Tensor:
    """[B*T, 1, th, tw] tile probabilities -> [B, H, W] max-blended pages."""
    h, w = page_hw
    _, _, th, tw = probs.shape
    probs = probs.reshape(batch, len(offsets), th, tw)
    out = probs.new_zeros(
        (batch, max(h, th + max(y for y, _ in offsets)), max(w, tw + max(x for _, x in offsets)))
    )
    for i, (y, x) in enumerate(offsets):
        region = out[:, y : y + th, x : x + tw]
        torch.maximum(region, probs[:, i], out=region)
    return out[:, :h, :w]


def _scale_rotated_rect(rect: RotatedRect, sx: float, sy: float) -> RotatedRect:
    """Anisotropically scale a rotated rect by scaling its corners and
    re-fitting (exact for axis-aligned rects; a tight 4-point min-area fit
    otherwise). The (near-)isotropic and axis-aligned cases skip the hull."""
    ux, uy = rect.up
    if abs(sx - sy) < 1e-9:
        return RotatedRect(
            (rect.center[0] * sx, rect.center[1] * sy), (ux, uy), rect.width * sx, rect.height * sy
        )
    if abs(ux) < 1e-9 or abs(uy) < 1e-9:
        # Axis-aligned (possibly swapped): widths scale along their axes.
        wx_axis = abs(uy)  # 1 if up is vertical -> width is along x
        new_w = rect.width * (sx if wx_axis else sy)
        new_h = rect.height * (sy if wx_axis else sx)
        return RotatedRect((rect.center[0] * sx, rect.center[1] * sy), (ux, uy), new_w, new_h)
    fitted = min_area_rect(np.stack(rect.corners()) * np.array([sx, sy])[None, :])
    assert fitted is not None
    return fitted


def _normalize_det_input(det_u8: torch.Tensor, *, pack4=False) -> torch.Tensor:
    """[B, in_h, in_w] u8 detector input (resized on the host by
    native.resize_pages) -> [B, 1, in_h, in_w] normalized float32. pack4:
    the last axis carries two 4-bit pixels per byte (high nibble first)."""
    if pack4:
        det_u8 = _unpack4(det_u8)
    return (det_u8.to(torch.float32) / 255.0 + BLACK_VALUE)[:, None]


#: Links slower than this (MB/s host->device) pick the "lowbw" transport in
#: auto mode. PCIe measures in the GB/s.
_LOWBW_THRESHOLD_MBPS = 500.0

_probed_h2d_mbps: dict[str, float] = {}


def probe_h2d_mbps(device: torch.device | str = "cuda") -> float:
    """Host->device bandwidth of `device`, measured once per process: an
    8 MB pageable upload between two synchronizations."""
    device = torch.device(device)
    key = str(device)
    if key not in _probed_h2d_mbps:
        buf = torch.zeros(8 << 20, dtype=torch.uint8)

        def upload() -> float:
            t0 = time.perf_counter()
            buf.to(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        upload()  # warm the transfer
        _probed_h2d_mbps[key] = buf.numel() / 1e6 / max(upload(), 1e-9)
    return _probed_h2d_mbps[key]


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`, queued on the calling thread's
    current stream. To a card the bytes go through pinned memory without
    blocking; the pinned blocks come from PyTorch's caching host allocator,
    which hands a block out again only after the copy that read it has
    finished, so groups reuse them and nothing is pinned anew per group."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


class _HostPages:
    """Pages staged for the LOW-BANDWIDTH transport: the full-resolution u8
    greyscale pages stay in host memory; only the detector-resolution input
    (a few percent of the bytes at 300 dpi) crosses the link. Recognition
    later uploads line crops extracted on the host
    (native.extract_lines_strip) instead of gathering from pages on the
    device. See PagePipeline `transport`."""

    def __init__(self, host_u8: np.ndarray, det_dev: torch.Tensor, pads, pack4: bool):
        self.host = host_u8  # [B, H, W] u8 greyscale, full resolution
        self.det_dev = det_dev  # [B, in_h, stride] u8 on the device
        self.pads = pads  # (pad_bottom, pad_right) in page pixels
        self.pack4 = pack4

    @property
    def shape(self):
        return self.host.shape


def _to_grey_u8(pages: np.ndarray) -> np.ndarray:
    """[B, H, W(, C)] u8/float -> [B, H, W] u8 greyscale on the host (the
    low-bandwidth twin of _normalize_batch's weighting; BT.601 for colour)."""
    if pages.ndim == 4:
        c = pages.shape[-1]
        if c == 1:
            pages = pages[..., 0]
        else:
            grey = pages[..., :3].astype(np.float32) @ np.asarray(ITU_WEIGHTS, np.float32)
            if pages.dtype != np.uint8:
                grey = grey * 255.0
            return np.clip(np.rint(grey), 0, 255).astype(np.uint8)
    if pages.dtype == np.uint8:
        return pages
    return np.clip(np.rint(pages.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)


@dataclass
class PageResult:
    """Recognition output for one page."""

    words: list[RotatedRect]
    lines: list[list[RotatedRect]]
    text_lines: list[Optional[TextLine]]

    @property
    def text(self) -> str:
        return "\n".join(str(l) for l in self.text_lines if l is not None)


class PagePipeline:
    """Batched multi-page OCR (see module docstring)."""

    def __init__(
        self,
        detection_model: Model,
        recognition_model: Model,
        alphabet: str,
        detector_params: TextDetectorParams = TextDetectorParams(),
        width_bucket: Optional[Callable[[int], int]] = None,
        max_lines_per_batch: int = 128,
        max_components: int = 512,
        multigrid: bool = True,
        solidify: bool = True,
        decode_method: Optional[DecodeMethod] = None,
        allowed_chars: Optional[str] = None,
        tiled_detection: bool = False,
        tile_overlap: int = 64,
        run_table_geometry: bool = True,
        transport: str = "auto",
        transport_pack4: bool = True,
        deskew: bool = False,
        vertical_text: bool = False,
        min_line_confidence: Optional[float] = None,
        debug: bool = False,
        *,
        device: torch.device | str | None = None,
    ):
        """`device`: where the pipeline runs; CUDA when None, and asking for
        CUDA where there is none raises. The models are moved there.

        `multigrid`/`solidify` control how mask pixels join into words: the
        defaults decide connectivity at half resolution on the 3x3-closed
        mask; pass both False to match the exact host connectivity on dense
        pages where closing and pooling could merge adjacent words.

        `decode_method`/`allowed_chars` mirror the single-image engine's
        options (lib.rs:38-71): beam search decodes on the host from the
        per-frame top-k candidates; excluded characters are masked to -inf
        on the device before decoding (recognition.rs:547-561).

        `tiled_detection`: for pages larger than the detector input, run the
        detector over overlapping native-resolution tiles and post-process
        at page resolution (keeps small text on very large pages; the
        engine's counterpart is ``detection_tiled``).

        `run_table_geometry`: reduce the masks to row-run tables on the
        device and fit exact min-area rects on the host (the default),
        instead of labelling and fitting by angle scan on the device. Tiled
        detection always takes the device route.

        `transport`: how page pixels reach the device.
          * "hbm": upload full pages; every later stage reads them in device
            memory (the right answer on PCIe: one upload).
          * "lowbw": for slow links. Pages stay in host memory; the detect
            pass uploads a detector-resolution input resized on the host and
            recognition uploads line crops extracted on the host
            (native/ocrs_native.cpp), several times fewer bytes per page with
            the same sampling laws (crop pixels differ only by u8 rounding;
            masks are bit-identical). Needs the native library, and raises
            with the reason when that cannot be built.
          * "auto": probe the link on first use (:func:`probe_h2d_mbps`);
            below _LOWBW_THRESHOLD_MBPS picks "lowbw" when the native library
            is available, else "hbm".
        `transport_pack4`: in lowbw mode pack two 4-bit pixels per byte
        (half the bytes again; about +-8/255 of quantization)."""
        self.device = resolve_device(device)
        for model in (detection_model, recognition_model):
            if isinstance(model, torch.nn.Module):
                model.to(self.device)
        self._det = detection_model
        self._rec = recognition_model
        self._alphabet = alphabet
        self._params = detector_params
        self._det_hw = fixed_hw(detection_model.input_shape())
        self._rec_h = fixed_height_or(recognition_model.input_shape(), 50)
        # One pooled bucket: fewest (bucket, batch) combinations, so fewest
        # batches to dispatch and wait for.
        self._bucket = width_bucket or single_bucket
        self._max_lines = max_lines_per_batch
        self._max_components = max_components
        self._multigrid = multigrid
        self._solidify = solidify
        self._decode = decode_method if decode_method is not None else Greedy()
        self._tiled = tiled_detection
        self._tile_overlap = tile_overlap
        self._run_tables = run_table_geometry
        if transport not in ("auto", "hbm", "lowbw"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "lowbw" and not native.available():
            raise RuntimeError(
                "transport='lowbw' requires the native library (native/ocrs_native.cpp): "
                f"{native.build_error()}"
            )
        self._transport = transport
        self._pack4 = transport_pack4
        self._deskew = deskew
        self._vertical = vertical_text
        self._min_conf = min_line_confidence
        self._debug = debug
        # process_stream's worker thread uploads on a stream of its own, so
        # that a group's upload runs beside the device work of the groups
        # before it.
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # Label i (>=1) maps to alphabet[i-1]; labels outside the allowed set
        # are excluded (lib.rs:153-170).
        self._excluded_onehot: Optional[torch.Tensor] = None
        if allowed_chars is not None:
            allowed = set(allowed_chars)
            onehot = [False] + [ch not in allowed for ch in alphabet]
            self._excluded_onehot = torch.tensor(onehot, dtype=torch.bool, device=self.device)

    def _transport_mode(self) -> str:
        """Resolve "auto" to "hbm"/"lowbw" (probing the link on first call)."""
        if self._transport == "auto":
            if self._tiled or not native.available() or self.device.type == "cpu":
                # Tiled detection post-processes at page resolution, which
                # needs the full pages on the device. On the CPU there is no
                # link to save.
                self._transport = "hbm"
            else:
                mbps = probe_h2d_mbps(self.device)
                self._transport = "lowbw" if mbps < _LOWBW_THRESHOLD_MBPS else "hbm"
                if self._debug:
                    print(f"[ocrs_tpu_torch pipeline] h2d {mbps:.0f} MB/s -> transport={self._transport}")
        return self._transport

    # -- detection ------------------------------------------------------------

    def _detect_tables(self, pages_dev):
        """Staged pages -> (table tensor for the group, (sx, sy) from table
        to page coordinates)."""
        if isinstance(pages_dev, _HostPages):
            # The detector-resolution upload of the low-bandwidth transport:
            # same tables and the same (page/crop) scale law as below.
            _, page_h, page_w = pages_dev.host.shape
            pad_bottom, pad_right = pages_dev.pads
            x = _normalize_det_input(pages_dev.det_dev, pack4=pages_dev.pack4)
        else:
            _, page_h, page_w = pages_dev.shape
            in_h, in_w = self._det_hw
            if self._tiled and (page_h > in_h or page_w > in_w):
                return self._detect_tables_tiled(pages_dev)
            pad_bottom, pad_right = max(in_h - page_h, 0), max(in_w - page_w, 0)
            x = _detect_pre_batch(pages_dev, input_hw=self._det_hw, pads=(pad_bottom, pad_right))
        crop_h, crop_w = self._det_hw[0] - pad_bottom, self._det_hw[1] - pad_right
        probs = self._det.run(x)
        if self._run_tables:
            tables = _masks_to_run_tables(
                probs,
                crop_hw=(crop_h, crop_w),
                threshold=self._params.text_threshold,
                multigrid=self._multigrid,
                solidify=self._solidify,
            )
        else:
            tables = _masks_to_tables(
                probs,
                crop_hw=(crop_h, crop_w),
                threshold=self._params.text_threshold,
                max_components=self._max_components,
                multigrid=self._multigrid,
                solidify=self._solidify,
            )
        return tables, (page_w / crop_w, page_h / crop_h)

    def _detect_tables_tiled(self, pages_dev: torch.Tensor):
        """Tiled detection at page resolution: every page's overlapping
        native-resolution tiles run as ONE model batch [B*T, 1, th, tw];
        probability maps are max-stitched per page and post-processed at
        page resolution (scale = 1), so small text on very large pages
        survives (counterpart of the engine's tiled detection)."""
        b, page_h, page_w = pages_dev.shape
        offsets = _tile_offsets((page_h, page_w), self._det_hw, self._tile_overlap)
        tiles = _extract_tiles_batch(pages_dev, input_hw=self._det_hw, offsets=offsets)
        probs = self._det.run(tiles)  # [B*T, 1, th, tw]
        page_probs = _stitch_tiles_batch(probs, page_hw=(page_h, page_w), offsets=offsets, batch=b)
        # Page-resolution masks carry more run endpoints than the detector
        # input; scale the compaction buffer with the area ratio.
        area_ratio = max((page_h * page_w) / (self._det_hw[0] * self._det_hw[1]), 1.0)
        tables = _masks_to_tables(
            page_probs[:, None],
            crop_hw=(page_h, page_w),
            threshold=self._params.text_threshold,
            max_components=self._max_components,
            multigrid=self._multigrid,
            solidify=self._solidify,
            max_boundary=int(min(2**18, 16384 * area_ratio)),
        )
        return tables, (1.0, 1.0)

    def _tables_to_words_arrays(self, tables, scale):
        """Returns (per_page_words, per_page_arrays) where arrays is the
        (cx, cy, ux, uy, w, h) tuple matching the words list, for the
        array-based layout entry. `tables` is the group's table on the
        device, or its copy to the host already under way."""
        sx, sy = scale
        # ONE device->host copy: a packed [B, 9, C] rect table or a packed
        # [B, 7, K] int16 run table.
        raw = tables.numpy()[0] if isinstance(tables, _HostCopies) else tables.cpu().numpy()
        if raw.dtype == np.int16:
            t = runs_to_rect_table_host(raw, 2 if self._multigrid else 1, self._max_components)
        else:
            t = unpack_rect_table(raw)
        dropped = int(np.asarray(t["dropped"]).sum())
        if dropped > 0:
            warn(
                f"detection rect table overflow: {dropped} components beyond "
                "max_components were dropped"
            )
        b = t["valid"].shape[0]
        iso = abs(sx - sy) < 1e-9
        per_page: list[list[RotatedRect]] = []
        per_arrays: list = []
        for i in range(b):
            idx = np.nonzero(t["valid"][i])[0]
            cx, cy, ux, uy, w, h = (t[k][i][idx].astype(np.float64) for k in ("cx", "cy", "ux", "uy", "w", "h"))
            # Vectorized _scale_rotated_rect for the isotropic and
            # axis-aligned cases (the general case re-fits below).
            axis_aligned = (np.abs(ux) < 1e-9) | (np.abs(uy) < 1e-9)
            if iso:
                sw, sh = w * sx, h * sy
            else:
                wx_axis = np.abs(uy) >= 1e-9  # width lies along x when up is vertical
                sw = np.where(wx_axis, w * sx, w * sy)
                sh = np.where(wx_axis, h * sy, h * sx)
            scx, scy = cx * sx, cy * sy
            # Scale-proportional expansion: see detection.py
            # _detect_words_model_res.
            ew = sw + 2.0 * EXPAND_DIST * sx
            eh = sh + 2.0 * EXPAND_DIST * sy
            if not (iso or bool(axis_aligned.all())):
                # General anisotropic case, vectorized. A rotated rect's
                # corners scale to a PARALLELOGRAM whose min-area rect has
                # an edge collinear with one of the two distinct edge
                # directions: project the 4 corners on both candidate frames
                # and keep the smaller-area fit (what min_area_rect's hull
                # scan finds, without the hull).
                gen = ~axis_aligned
                cxy = np.stack([cx[gen], cy[gen]], 1)
                up2 = np.stack([ux[gen], uy[gen]], 1)
                rt2 = np.stack([-uy[gen], ux[gen]], 1)  # right axis (rot90 of up)
                half_w = (w[gen] / 2.0)[:, None]
                half_h = (h[gen] / 2.0)[:, None]
                corners = np.stack(
                    [
                        cxy + rt2 * half_w + up2 * half_h,
                        cxy - rt2 * half_w + up2 * half_h,
                        cxy - rt2 * half_w - up2 * half_h,
                        cxy + rt2 * half_w - up2 * half_h,
                    ],
                    axis=1,
                )  # [G, 4, 2]
                corners *= np.array([sx, sy])[None, None, :]
                best = None
                for k in range(2):  # two distinct edge directions
                    e = corners[:, k + 1] - corners[:, k]
                    n_ = np.maximum(np.hypot(e[:, 0], e[:, 1]), 1e-12)
                    ex = e / n_[:, None]
                    ey = np.stack([-ex[:, 1], ex[:, 0]], 1)
                    px_ = np.einsum("gcd,gd->gc", corners, ex)
                    py_ = np.einsum("gcd,gd->gc", corners, ey)
                    ww_ = px_.max(1) - px_.min(1)
                    hh_ = py_.max(1) - py_.min(1)
                    ctr = (
                        ((px_.max(1) + px_.min(1)) / 2.0)[:, None] * ex
                        + ((py_.max(1) + py_.min(1)) / 2.0)[:, None] * ey
                    )
                    cand = (ww_ * hh_, ctr, ey, ww_, hh_)
                    if best is None:
                        best = cand
                    else:
                        pick = cand[0] < best[0]
                        best = tuple(
                            np.where(pick[(...,) + (None,) * (old.ndim - 1)], new, old)
                            for new, old in zip(cand, best)
                        )
                _, ctr, ey, ww_, hh_ = best
                scx[gen], scy[gen] = ctr[:, 0], ctr[:, 1]
                ux[gen], uy[gen] = ey[:, 0], ey[:, 1]
                # Expansion as after _scale_rotated_rect: x-expansion on
                # width, y-expansion on height.
                ew[gen] = ww_ + 2.0 * EXPAND_DIST * sx
                eh[gen] = hh_ + 2.0 * EXPAND_DIST * sy
            k = np.nonzero(ew * eh >= self._params.min_area)[0]
            a = (scx[k], scy[k], ux[k], uy[k], ew[k], eh[k])
            per_arrays.append(a)
            per_page.append([RotatedRect._raw(*vals) for vals in zip(*(col.tolist() for col in a))])
        return per_page, per_arrays

    def _layout(self, words: list[RotatedRect], arrays) -> list[list[RotatedRect]]:
        """One page's words -> reading-order lines, as the engine groups
        them: in one native call from the rect arrays where the library is
        there, else :func:`find_text_lines`; then the vertical-text
        post-pass (``merge_vertical_chains``) when that option is on."""
        idx = find_text_lines_idx_arrays(*arrays)
        lines = find_text_lines(words) if idx is None else [[words[i] for i in li] for li in idx]
        if self._vertical:
            lines, _ = merge_vertical_chains(lines)
        return lines

    # -- recognition ----------------------------------------------------------

    def _dispatch_recognition(self, pages_dev, per_page_lines: list[list[list[RotatedRect]]]):
        """Start every recognition batch of the group and its copy to the
        host; nothing is waited for."""
        # Pooled line records tagged (page, line_index): polygons and union
        # rects for ALL lines in the group come from one vectorized pass.
        flat = [(pg, li) for pg, lines in enumerate(per_page_lines) for li in range(len(lines))]
        flat_words = [words for lines in per_page_lines for words in lines]
        polys, rects = line_polygons_batch(flat_words)
        pooled: list[tuple[int, _RecLine]] = []
        for (pg, li), poly, lr, words in zip(flat, polys, rects, flat_words):
            if self._vertical and is_vertical_line(words):
                # Vertical stack: crop along its min-area rect in BOTH
                # reading directions; decode confidence picks the winner
                # (as recognition.py recognize_text_lines does).
                mr = min_area_rect(np.concatenate([np.stack(w.corners()) for w in words]))
                assert mr is not None, "line has no words"
                for variant, up in enumerate(((-1.0, 0.0), (1.0, 0.0))):
                    rr = mr.orient_towards(up)
                    rec_line = _RecLine(
                        index=li,
                        poly=np.round(np.stack(rr.corners())).astype(np.int64),
                        rect=rr.bounding_rect().integral_bounding_rect(),
                        resized_width=resized_line_width(rr.width, rr.height, self._rec_h),
                        rrect=rr,
                        variant=variant,
                    )
                    pooled.append((pg, rec_line))
                continue
            rrect = line_rotated_rect(words) if self._deskew else None
            width, height = (rrect.width, rrect.height) if self._deskew else (lr.width, lr.height)
            rec_line = _RecLine(
                index=li,
                poly=poly,
                rect=lr,
                resized_width=resized_line_width(width, height, self._rec_h),
                rrect=rrect,
            )
            pooled.append((pg, rec_line))

        groups: dict[tuple[int, bool], list[tuple[int, _RecLine]]] = {}
        for item in pooled:
            key = (self._bucket(item[1].resized_width), item[1].rrect is not None)
            groups.setdefault(key, []).append(item)
        batches = []
        for (width, rotated), group in groups.items():
            for i in range(0, len(group), self._max_lines):
                chunk = group[i : i + self._max_lines]
                # Trim the compute width to the batch's own widest line,
                # rounded up to 128 so that shapes repeat: the bucket law
                # only groups lines, it need not set the padded width.
                w_eff = min(width, max(-(-max(rl.resized_width for _, rl in chunk) // 128) * 128, 128))
                batches.append((w_eff, chunk, rotated))

        greedy = isinstance(self._decode, Greedy)
        inflight = []
        for group_width, batch, rotated in batches:
            if self._debug:
                print(f"Processing group of {len(batch)} lines of width {group_width}")
            with_conf = any(rl.variant >= 0 for _, rl in batch)
            run = self._run_pooled_batch_rotated if rotated else self._run_pooled_batch
            out = run(pages_dev, batch, group_width, greedy, with_conf)
            inflight.append((group_width, batch, _HostCopies(out)))
        return inflight

    def _collect_recognition(self, per_page_lines, inflight) -> list[list[Optional[TextLine]]]:
        """Wait for each batch's copy, finish the decode on the host and
        assemble the lines of every page."""
        greedy = isinstance(self._decode, Greedy)
        any_voting = False
        per_page_results: list[list[_LineResult]] = [[] for _ in per_page_lines]
        for group_width, batch, copies in inflight:
            host, conf, tconf = copies.numpy()
            if conf is None:
                conf = np.zeros(len(batch), dtype=np.float32)
            else:
                any_voting = True
            ctc_input_len = host.shape[1]
            if greedy:
                # Array-pair steps: no per-step object construction.
                decoded = collapse_greedy_batch_arrays(host)
            else:
                n_classes = len(self._alphabet) + 1
                k = beam_candidate_k(self._decode.width, n_classes)
                vals, idx = unpack_topk(host, k)
                decoded = beam_decode_topk_arrays(vals, idx, self._decode.width, n_classes)
            for col, ((pg, rl), steps, c) in enumerate(zip(batch, decoded, conf)):
                if tconf is not None and tconf[col] < self._min_conf:
                    # Low-confidence glyph soup (graphics strokes boxed by
                    # the detector): emit nothing for this line.
                    steps = (steps[0][:0], steps[1][:0])
                per_page_results[pg].append(
                    _LineResult(
                        line=rl,
                        rec_input_len=group_width,
                        ctc_input_len=ctc_input_len,
                        steps=steps,
                        conf=float(c),
                    )
                )

        out: list[list[Optional[TextLine]]] = []
        for results in per_page_results:
            if any_voting:
                results = _pick_direction_variants(results)
            results.sort(key=lambda r: r.line.index)
            out.append(_text_lines_from_results(results, self._alphabet))
        return out

    def _run_pooled_batch(self, pages_dev, batch, group_width, greedy, with_conf):
        """Axis-aligned crops of one pooled batch -> the device outputs of
        :meth:`_rec_decode_tail`, cut to the batch's lines."""
        n = len(batch)
        n_pad = _pad_batch_size(n, self._max_lines)

        # ALL per-line geometry in two arrays -> two uploads per batch.
        geom = np.empty((6, n_pad), dtype=np.float32)
        v = MAX_CHAIN_V
        chains = np.empty((n_pad, 2, v, 2), dtype=np.float32)
        for col, (pg, rl) in enumerate(batch):
            geom[:, col] = (rl.rect.top, rl.rect.left, rl.rect.height, rl.rect.width, rl.resized_width, pg)
            half = len(rl.poly) // 2
            chains[col, 0] = pad_chain(rl.poly[:half], v)
            chains[col, 1] = pad_chain(rl.poly[half:][::-1], v)
        # Padding lines repeat the last one, so that shapes repeat.
        geom[:, n:] = geom[:, n - 1 : n]
        chains[n:] = chains[n - 1 : n]

        if isinstance(pages_dev, _HostPages):
            # Low-bandwidth transport: extract and resize the crops on the
            # host from the full-resolution pages that never left it, and
            # upload them STRIP-PACKED: every line at its own resized width,
            # side by side along the column axis (native.extract_lines_strip),
            # without the padding to the batch's widest line. The device
            # gathers each line's window back out of the strip, applies the
            # bit-identical polygon/in-page/width mask from the geometry
            # (ops/warp.strip_mask_normalize_crops) and normalizes.
            _, page_h, page_w = pages_dev.host.shape
            geom[4, n:] = 0.0  # padding lines: rwidth 0 -> fully masked BLACK
            n_cols = np.clip(geom[4].astype(np.int64), 0, group_width)
            segs = ((n_cols + 1) // 2) * 2  # even: pack4 segments own bytes
            offs = np.zeros(n_pad, np.int32)
            np.cumsum(segs[:-1], out=offs[1:])
            # The strip length in steps of 4,096, so that shapes repeat
            # across groups.
            total_w = max(int(offs[-1] + segs[-1]), 2)
            total_w = ((total_w + 4095) // 4096) * 4096
            strip_host = native.extract_lines_strip(
                pages_dev.host, geom, offs, out_h=self._rec_h, total_w=total_w, pack4=pages_dev.pack4
            )
            if strip_host is None:
                native.require()
            crops = strip_mask_normalize_crops(
                _to_device(strip_host, self.device),
                _to_device(offs, self.device),
                _to_device(geom, self.device),
                _to_device(chains, self.device),
                page_hw=(page_h, page_w),
                pack4=pages_dev.pack4,
                out_w=group_width,
            )
        else:
            crops = extract_line_batch_packed(
                pages_dev,
                _to_device(geom, self.device),
                _to_device(chains, self.device),
                out_h=self._rec_h,
                out_w=group_width,
            )
        return tuple(None if t is None else t[:n] for t in self._rec_decode_tail(crops, greedy, with_conf))

    def _run_pooled_batch_rotated(self, pages_dev, batch, group_width, greedy, with_conf):
        """Deskew/vertical batches: crops sampled along each line's rotated
        rect (ops.warp.extract_line_batch_rotated; its C++ twin on the
        low-bandwidth transport). `with_conf` also returns the per-line mean
        max-log-prob for reading-direction voting."""
        n = len(batch)
        n_pad = _pad_batch_size(n, self._max_lines)
        geom = np.empty((10, n_pad), dtype=np.float32)
        for col, (pg, rl) in enumerate(batch):
            rr = rl.rrect
            geom[0:2, col] = _rrect_origin(rr)
            geom[2:4, col] = rr.right_axis()
            geom[4:6, col] = -rr.up
            geom[6:10, col] = (rr.width, rr.height, rl.resized_width, pg)
        geom[:, n:] = geom[:, n - 1 : n]

        if isinstance(pages_dev, _HostPages):
            crops_host = native.extract_lines_rotated(
                pages_dev.host, geom[:, :n], out_h=self._rec_h, out_w=group_width, pack4=pages_dev.pack4
            )
            if crops_host is None:
                native.require()
            # Padding lines are BLACK (zero bytes). The C++ kernel already
            # applied the in-page and valid-column BLACK; only dequantize
            # and normalize remain.
            crops_u8 = np.zeros((n_pad, self._rec_h, crops_host.shape[-1]), np.uint8)
            crops_u8[:n] = crops_host
            crops = _normalize_det_input(_to_device(crops_u8, self.device), pack4=pages_dev.pack4)
        else:
            crops = extract_line_batch_rotated(
                pages_dev, _to_device(geom, self.device), out_h=self._rec_h, out_w=group_width
            )
        return tuple(None if t is None else t[:n] for t in self._rec_decode_tail(crops, greedy, with_conf))

    def _rec_decode_tail(self, crops: torch.Tensor, greedy: bool, with_conf: bool = False):
        """Recognizer forward and decode head on extracted crops, shared by
        both transports -> (labels or top-k candidates, voting confidence or
        None, text confidence or None). ``with_conf`` asks for the per-line
        mean (over frames) max log-prob used by vertical-text
        reading-direction voting."""
        # bf16 crops: the recognizer computes in bf16.
        logprobs = self._rec.run(crops.to(torch.bfloat16))  # [T, n_pad, C]
        n_classes = int(logprobs.shape[-1])
        if len(self._alphabet) + 1 != n_classes:
            # Raised on the first batch (recognition.rs:487-493).
            raise WrongOutputError(
                f"output column count ({n_classes}) does not match "
                f"alphabet size ({len(self._alphabet) + 1})"
            )
        lp = logprobs.transpose(0, 1)  # [n_pad, T, C]
        if self._excluded_onehot is not None:
            lp = mask_excluded(lp, self._excluded_onehot[:n_classes])
        if greedy:
            out = greedy_labels_u8(lp)
        else:
            # Beam: the beam never extends past the top beam_candidate_k
            # classes of a frame, so only those cross to the host, packed
            # into one buffer.
            k = beam_candidate_k(self._decode.width, n_classes)
            out = beam_topk_packed(lp, k=k, gap=BEAM_EMISSION_GAP)
        conf = lp.amax(dim=-1).mean(dim=1).to(torch.float32) if with_conf else None
        tconf = text_confidence(lp) if self._min_conf is not None else None
        return out, conf, tconf

    # -- entry ------------------------------------------------------------------

    def _stage_pages(self, pages):
        """Upload and normalize a page stack on the calling thread's current
        stream, without waiting for the device. A [B, H, W] float32 tensor is
        taken as already normalized; staged pages pass through."""
        if isinstance(pages, _HostPages):
            return pages
        if isinstance(pages, torch.Tensor):
            if pages.dim() == 3 and pages.dtype == torch.float32:
                return pages.to(self.device)
            pages = pages.cpu().numpy()
        if self._transport_mode() == "lowbw":
            grey = _to_grey_u8(np.asarray(pages))
            in_h, in_w = self._det_hw
            _, h, w = grey.shape
            pads = (max(in_h - h, 0), max(in_w - w, 0))
            det_u8 = native.resize_pages(grey, (in_h, in_w), pack4=self._pack4)
            if det_u8 is None:
                native.require()
            return _HostPages(grey, _to_device(det_u8, self.device), pads, self._pack4)
        imgs = np.asarray(pages)
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        return _normalize_batch(_to_device(imgs, self.device), imgs.dtype == np.uint8)  # [B, H, W]

    def _stage_pages_ahead(self, pages):
        """:meth:`_stage_pages` for process_stream's worker thread: on the
        pipeline's copy stream, with an event that marks the end of the
        staging. The consumer's stream waits for the event."""
        if self._copy_stream is None:
            return self._stage_pages(pages), None
        with torch.cuda.stream(self._copy_stream):
            staged = self._stage_pages(pages)
            event = torch.cuda.Event()
            event.record()
        return staged, event

    def process(self, pages: np.ndarray) -> list[PageResult]:
        """Run OCR on a stack of same-sized pages.

        `pages`: [B, H, W] or [B, H, W, C] u8/float numpy array."""
        return self.process_normalized(self._stage_pages(pages))

    def process_stream(self, page_batches: Iterable) -> list[list[PageResult]]:
        """Run OCR over an iterable of page stacks as a software pipeline:

        * staging (grey conversion, the low-bandwidth transport's C++ resize
          on the host, the upload and the normalization) runs ONE GROUP AHEAD
          on a worker thread and on a CUDA stream of its own; the C++ kernels
          and the copies release the interpreter lock, so group N+1's staging
          costs the main thread nothing while it does group N's layout,
          dispatch and collect. The main stream waits for the staging's
          event before the detector reads the pages;
        * DETECT is dispatched up to TWO groups ahead, with the table's copy
          to the host started at once, so the device does not idle while the
          host does per-group work;
        * each group's host tail is SPLIT: dispatch (table wait, layout,
          recognition dispatch with the label copies started) and collect
          (CTC collapse and line assembly) are separate phases, and group N
          is collected only after group N+1 has dispatched. Group N's
          recognition queues behind group N+1's detect on the device, so a
          collect right after dispatch would stall the host for the whole
          detect+recognize queue; deferring it by one group lets that queue
          drain while the host does group N+1's layout, leaving steady-state
          wall time at max(device, host) per group instead of their sum.

        Returns per-group results, in order. Upstream has no analog (one
        image at a time); this takes the place of its thread-pool overlap
        (recognition.rs:464-467) at page granularity."""
        results: list[list[PageResult]] = []
        staged: list = []  # uploaded, detect not yet dispatched
        detected: list[tuple] = []  # (pages_dev, table copies, scale), in order
        dispatched: list[tuple] = []  # (words, lines, inflight), in order
        it = iter(page_batches)
        self._transport_mode()  # probe the link here, not on the worker thread
        exhausted = False
        stage_fut = None

        def pump():
            while staged and len(detected) < 2:
                pages = staged.pop(0)
                tables, scale = self._detect_tables(pages)
                detected.append((pages, _HostCopies((tables,)), scale))

        ex = ThreadPoolExecutor(max_workers=1)

        def submit_stage():
            nonlocal stage_fut, exhausted
            if stage_fut is None and not exhausted:
                try:
                    nxt = next(it)
                except StopIteration:
                    exhausted = True
                    return
                stage_fut = ex.submit(self._stage_pages_ahead, nxt)

        try:
            submit_stage()
            while True:
                if stage_fut is not None:
                    pages, event = stage_fut.result()
                    stage_fut = None
                    if event is not None:
                        # Everything queued from here on runs after the
                        # staging; the staged tensor's memory belongs to the
                        # copy stream's pool and is marked as used here.
                        main = torch.cuda.current_stream(self.device)
                        main.wait_event(event)
                        (pages.det_dev if isinstance(pages, _HostPages) else pages).record_stream(main)
                    staged.append(pages)
                    submit_stage()  # prefetch the NEXT batch under this turn
                pump()
                if detected and (exhausted or len(detected) >= 2):
                    dispatched.append(self._dispatch_group(*detected.pop(0)))
                    pump()
                while dispatched and (len(dispatched) > 1 or (exhausted and not staged and not detected)):
                    results.append(self._collect_group(dispatched.pop(0)))
                if exhausted and not staged and not detected and not dispatched:
                    return results
        finally:
            ex.shutdown(wait=True)

    def _dispatch_group(self, pages_dev, tables, scale) -> tuple:
        """Host-side head of one group's tail: table read-back, layout, and
        recognition dispatch (device work queued, label copies started)."""
        per_page_words, per_arrays = self._tables_to_words_arrays(tables, scale)
        per_page_lines = [self._layout(words, arrs) for words, arrs in zip(per_page_words, per_arrays)]
        inflight = self._dispatch_recognition(pages_dev, per_page_lines)
        return per_page_words, per_page_lines, inflight

    def _collect_group(self, group: tuple) -> list[PageResult]:
        """Collect a dispatched group: CTC collapse and line assembly."""
        per_page_words, per_page_lines, inflight = group
        per_page_text = self._collect_recognition(per_page_lines, inflight)
        return [
            PageResult(words=w, lines=l, text_lines=t)
            for w, l, t in zip(per_page_words, per_page_lines, per_page_text)
        ]

    def process_normalized(self, pages_dev, timer: Optional[StageTimer] = None) -> list[PageResult]:
        """Run OCR on pages already normalized and on the device ([B, H, W]
        float32 in [-0.5, 0.5]), or staged by :meth:`_stage_pages`. The
        stages' wall times go to `timer` (pass one with ``fence_device`` to
        have each stage wait for its device work); with ``debug=True`` they
        are printed like the engine's get_text."""
        timer = timer or StageTimer(debug=self._debug)
        with timer.stage("detect"):
            tables, scale = self._detect_tables(pages_dev)
        with timer.stage("rects_to_host"):
            per_page_words, per_arrays = self._tables_to_words_arrays(tables, scale)
        with timer.stage("layout"):
            per_page_lines = [self._layout(words, arrs) for words, arrs in zip(per_page_words, per_arrays)]
        with timer.stage("recognize"):
            per_page_text = self._collect_recognition(
                per_page_lines, self._dispatch_recognition(pages_dev, per_page_lines)
            )
        if self._debug:
            n_words = sum(len(w) for w in per_page_words)
            n_lines = sum(len(l) for l in per_page_lines)
            print(
                f"[ocrs_tpu_torch pipeline] {pages_dev.shape[0]} pages, {n_words} words, "
                f"{n_lines} lines; " + timer.summary()
            )
        return [
            PageResult(words=w, lines=l, text_lines=t)
            for w, l, t in zip(per_page_words, per_page_lines, per_page_text)
        ]
