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
fused ``jit`` programs and their fallbacks have no counterpart.

In :meth:`PagePipeline.process_stream` on a card the detector (its input
to its tables) and each axis-aligned recognition batch (its geometry to its
decode outputs) run as CUDA graphs (:class:`..utils.graphs.GraphCache`, one
per pipeline and per shard, with one memory pool): a key (the shapes and the
branches) is run eagerly when first seen, captured when seen again, and
replayed from then on, so a page group reaches the card as a few replays and
copies in place of some 1,300 launches. There the host runs groups ahead of
the card and its launches set the pace. ``process`` and
``process_normalized`` (one group, then its results: the batching service)
run the same bodies eagerly: there the launches overlap the card's work on
the group, and graphs bought the service nothing while holding a pool per
page-stack shape and capturing in a request's path. The work is the same function either way (``_detect_graph_body``,
``_rec_graph_body``), run by the cache. A capture or replay that fails
raises. What stays eager: the CPU
(where the tests run; its path and results are those without graphs), the
"lowbw" transport, tiled detection, rotated and vertical batches
(``_run_pooled_batch_rotated``), the device labelling of
``run_table_geometry=False`` (its loops read a flag back every pass; the
U-Net before it is graphed), models other than the port's U-Net and
ConvCTC modules (fakes, a caller's own, and the CRNN, whose hand-written
GRU kernel counts its launches on the host, where a replay would not), and
keys beyond the cache's bound. The engine (:class:`..engine.OcrEngine`)
does not graph: its labelling reads a flag back every sweep.

``mesh=`` (a :class:`.sharding.DataMesh`) shards each page group over
several devices, as the JAX pipeline's ``mesh`` shards it over a ``"data"``
axis: the group is cut into one contiguous slice per mesh entry (an uneven
group raises ``ValueError``, as JAX's ``device_put`` does), and each entry
runs a single-device pipeline of its own on its slice, on a long-lived
worker thread of its own and on a CUDA stream of its own, so that the host work of the shards
overlaps and two shards may share one card. Recognition batches are pooled
per shard. Results come back in page order.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from functools import lru_cache
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
from ..models.detection_net import DetectionModel
from ..models.protocol import Model, fixed_height_or, fixed_hw
from ..models.recognition_net import RecognitionModel
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
from ..utils.graphs import GraphCache
from ..utils.log import warn
from ..utils.tracing import NO_TRACE, StageTimer, TimelineRecorder
from .sharding import DataMesh, replicate, shard_batch_dim, split_batch_dim


@lru_cache(maxsize=32)
def _channel_weights(c: int, is_u8: bool, device: torch.device) -> torch.Tensor:
    """The [C] float32 channel weights of :func:`_normalize_batch` on
    `device`, copied there once (the copy waits for the device); made
    outside inference mode, so that autograd may save them."""
    with torch.inference_mode(False):
        w = torch.tensor(list(ITU_WEIGHTS) + [0.0] * (c - 3), dtype=torch.float32, device=device)
        return w / 255.0 if is_u8 else w


def _normalize_batch(imgs: torch.Tensor, is_u8: bool) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W] normalized greyscale (see preprocess.py).
    Nothing here waits for the device."""
    if imgs.shape[-1] == 1:
        # One weight, a float32 scalar: its product in place, without a matrix
        # product's copies of a stack that is hundreds of megabytes at 300 dpi.
        scale = float(np.float32(1.0) / np.float32(255.0)) if is_u8 else 1.0
        return imgs[..., 0].to(torch.float32, copy=True).mul_(scale).add_(BLACK_VALUE)
    w = _channel_weights(imgs.shape[-1], is_u8, imgs.device)
    if imgs.is_cuda:
        w.record_stream(torch.cuda.current_stream(imgs.device))
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


def _name_thread(name: str) -> None:
    threading.current_thread().name = name


def _concat(parts: Iterable[list]) -> list:
    """The shards' results, one list, in page order."""
    return [r for part in parts for r in part]


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
        mesh: Optional[DataMesh] = None,
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

        `mesh`: a :class:`.sharding.DataMesh`; each page group is sharded
        over its entries (see the module docstring). The models are moved to
        the first entry's device and copied once to each other device; the
        entries that share a device share them. `device`, where given, must
        be the first entry's. Under a mesh, ``transport="auto"`` is "hbm",
        as in the JAX pipeline (host crops do not shard), and "lowbw" still
        needs the native library but stages pages as "hbm" does.

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
        if mesh is not None:
            first = resolve_device(mesh.devices[0])
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
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
        # Sharded (mesh) runs keep pages on the devices: host crops don't shard.
        self._transport = "hbm" if (mesh is not None and transport == "auto") else transport
        self._pack4 = transport_pack4
        self._deskew = deskew
        self._vertical = vertical_text
        self._min_conf = min_line_confidence
        self._debug = debug
        # process_stream's worker thread uploads on a stream of its own, so
        # that a group's upload runs beside the device work of the groups
        # before it.
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # CUDA graphs of the detector and of the axis-aligned recognition
        # batches in process_stream (see the module docstring); on the CPU
        # the cache runs everything eagerly.
        self._graphs = GraphCache(self.device)
        self._graph_det = isinstance(detection_model, DetectionModel)
        self._graph_rec = isinstance(recognition_model, RecognitionModel) and recognition_model.arch != "crnn"
        # Label i (>=1) maps to alphabet[i-1]; labels outside the allowed set
        # are excluded (lib.rs:153-170).
        self._excluded_onehot: Optional[torch.Tensor] = None
        if allowed_chars is not None:
            allowed = set(allowed_chars)
            onehot = [False] + [ch not in allowed for ch in alphabet]
            self._excluded_onehot = torch.tensor(onehot, dtype=torch.bool, device=self.device)
        self._mesh = mesh
        self._shards: Optional[list[PagePipeline]] = None
        if mesh is not None:
            options = dict(
                detector_params=detector_params, width_bucket=width_bucket, max_lines_per_batch=max_lines_per_batch,
                max_components=max_components, multigrid=multigrid, solidify=solidify,
                decode_method=decode_method, allowed_chars=allowed_chars, tiled_detection=tiled_detection,
                tile_overlap=tile_overlap, run_table_geometry=run_table_geometry, transport="hbm",
                transport_pack4=transport_pack4, deskew=deskew, vertical_text=vertical_text,
                min_line_confidence=min_line_confidence, debug=debug,
            )
            replicas = replicate(mesh, (detection_model, recognition_model))
            self._shards = [
                PagePipeline(det, rec, alphabet, **options, device=dev)
                for (det, rec), dev in zip(replicas, mesh.devices)
            ]
            self._shard_streams = [
                torch.cuda.Stream(shard.device) if shard.device.type == "cuda" else None for shard in self._shards
            ]
            # One long-lived worker thread per shard, named ocrs-shard-<i>: a
            # thread keeps its cuBLAS and cuDNN handles and plans, which a
            # fresh thread sets up again.
            self._shard_workers = [
                ThreadPoolExecutor(max_workers=1, initializer=_name_thread, initargs=(f"ocrs-shard-{i}",))
                for i in range(len(self._shards))
            ]

    def graph_stats(self) -> dict:
        """The graph cache's counts since construction (``graph_captures``,
        ``graph_replays``, ``eager_batches``), the graphs it holds and the
        bytes of their input buffers and memory pool; under a mesh, summed
        over the shards."""
        caches = [self._graphs] if self._shards is None else [shard._graphs for shard in self._shards]
        total: dict = {}
        for stats in (cache.stats() for cache in caches):
            for k, v in stats.items():
                total[k] = v if k not in total else (None if v is None or total[k] is None else total[k] + v)
        return total

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

    def _detect_tables(self, pages_dev, trace=NO_TRACE, graphs: bool = False):
        """Staged pages -> (the group's table, its copy to the host started
        (:class:`_HostCopies`), (sx, sy) from table to page coordinates).
        Untiled, the detector runs :meth:`_detect_graph_body` through the
        graph cache: as a graph where `graphs` asks for one and the detector
        can be graphed, else eagerly. `trace` spans the
        detector's input (``detect_pre``), the network and the run tables
        (``detect_net``, through a graph the input's copy and the replay)
        and what follows (``detect_post``: the tables' copy to the host, and
        the labelling of ``run_table_geometry=False``)."""
        if isinstance(pages_dev, _HostPages):
            # The detector-resolution upload of the low-bandwidth transport:
            # same tables and the same (page/crop) scale law as below.
            _, page_h, page_w = pages_dev.host.shape
            pad_bottom, pad_right = pages_dev.pads
            with trace.span("detect_pre"):
                x = _normalize_det_input(pages_dev.det_dev, pack4=pages_dev.pack4)
        else:
            _, page_h, page_w = pages_dev.shape
            in_h, in_w = self._det_hw
            if self._tiled and (page_h > in_h or page_w > in_w):
                tables, scale = self._detect_tables_tiled(pages_dev)
                return _HostCopies((tables,)), scale
            pad_bottom, pad_right = max(in_h - page_h, 0), max(in_w - page_w, 0)
            with trace.span("detect_pre"):
                x = _detect_pre_batch(pages_dev, input_hw=self._det_hw, pads=(pad_bottom, pad_right))
        crop_hw = (self._det_hw[0] - pad_bottom, self._det_hw[1] - pad_right)

        def finish(out):
            # Through a graph the tables are its output in the shared pool:
            # their copy to pinned memory is queued on this stream right
            # after the replay, so the next replay (the next group's
            # detector, or a recognition batch), queued later on the same
            # stream, cannot overwrite them before the copy has read them.
            return _HostCopies((out if self._run_tables else self._label_tables(out, crop_hw),))

        graphed = graphs and self._graph_det and not isinstance(pages_dev, _HostPages)
        copies = self._graphs.run(
            self._detect_graph_key(x, crop_hw) if graphed else None,
            functools.partial(self._detect_graph_body, crop_hw=crop_hw),
            {"detect_input": x},
            finish,
            trace,
            run_span="detect_net",
            finish_span="detect_post",
        )
        return copies, (page_w / crop_hw[1], page_h / crop_hw[0])

    def _detect_graph_body(self, x: torch.Tensor, *, crop_hw) -> torch.Tensor:
        """What the detector's graph runs, as a plain function of its input:
        the U-Net and the run tables, or the U-Net alone where the tables
        are labelled on the device (:meth:`_label_tables`, whose loops read
        a flag back every pass, which no graph can hold)."""
        probs = self._det.run(x)
        if not self._run_tables:
            return probs
        return _masks_to_run_tables(
            probs,
            crop_hw=crop_hw,
            threshold=self._params.text_threshold,
            multigrid=self._multigrid,
            solidify=self._solidify,
        )

    def _label_tables(self, probs: torch.Tensor, crop_hw) -> torch.Tensor:
        """The detector's probabilities -> rect tables labelled and fitted on
        the device (``run_table_geometry=False``)."""
        return _masks_to_tables(
            probs,
            crop_hw=crop_hw,
            threshold=self._params.text_threshold,
            max_components=self._max_components,
            multigrid=self._multigrid,
            solidify=self._solidify,
        )

    def _detect_graph_key(self, x: torch.Tensor, crop_hw) -> tuple:
        """Everything the detector's graph's shapes and branches depend on."""
        return ("detect", tuple(x.shape), x.dtype, tuple(crop_hw), self._run_tables, self._multigrid, self._solidify)

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

    def _tables_to_words_arrays(self, tables, scale, trace=NO_TRACE):
        """Returns (per_page_words, per_page_arrays) where arrays is the
        (cx, cy, ux, uy, w, h) tuple matching the words list, for the
        array-based layout entry. `tables` is the group's table on the
        device, or its copy to the host already under way."""
        sx, sy = scale
        # ONE device->host copy: a packed [B, 9, C] rect table or a packed
        # [B, 7, K] int16 run table.
        with trace.span("tables_wait"):
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

    def _layout_group(self, per_page_words, per_arrays, trace=NO_TRACE) -> list[list[list[RotatedRect]]]:
        """:meth:`_layout` of every page of a group."""
        with trace.span("layout"):
            per_page_lines = [self._layout(words, arrs) for words, arrs in zip(per_page_words, per_arrays)]
        if trace.enabled:
            trace.count("pages", len(per_page_words))
            trace.count("words", sum(len(w) for w in per_page_words))
            trace.count("lines", sum(len(l) for l in per_page_lines))
        return per_page_lines

    # -- recognition ----------------------------------------------------------

    def _dispatch_recognition(
        self, pages_dev, per_page_lines: list[list[list[RotatedRect]]], trace=NO_TRACE, graphs: bool = False
    ):
        """Start every recognition batch of the group and its copy to the
        host; nothing is waited for. `graphs`: run the axis-aligned batches
        as graphs where they can be graphed."""
        with trace.span("rec_prep"):
            # Pooled line records tagged (page, line_index): polygons and
            # union rects for ALL lines in the group come from one vectorized
            # pass.
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
        trace.count("batches", len(batches))

        greedy = isinstance(self._decode, Greedy)
        inflight = []
        # A graph reads its inputs at the addresses it was captured with:
        # the group's page stack is copied into the cache's fixed buffer,
        # once a group, and the axis-aligned batches crop from there.
        graphs = graphs and self._graph_rec and not isinstance(pages_dev, _HostPages)
        fixed = graphs and any(not r for _, _, r in batches)
        with (self._graphs.fixed_input("pages", pages_dev, trace, span="rec_crops") if fixed
              else contextlib.nullcontext(pages_dev)) as pages_fixed:
            for group_width, batch, rotated in batches:
                if self._debug:
                    print(f"Processing group of {len(batch)} lines of width {group_width}")
                with_conf = any(rl.variant >= 0 for _, rl in batch)
                if rotated:
                    out = self._run_pooled_batch_rotated(pages_dev, batch, group_width, greedy, with_conf, trace)
                else:
                    out = self._run_pooled_batch(pages_fixed, batch, group_width, greedy, with_conf, trace, graphs)
                inflight.append((group_width, batch, out))
        return inflight

    def _collect_recognition(self, per_page_lines, inflight, trace=NO_TRACE) -> list[list[Optional[TextLine]]]:
        """Wait for each batch's copy, finish the decode on the host and
        assemble the lines of every page, all pages in one pass."""
        greedy = isinstance(self._decode, Greedy)
        any_voting = False
        per_page_results: list[list[_LineResult]] = [[] for _ in per_page_lines]
        for group_width, batch, copies in inflight:
            with trace.span("labels_wait"):
                host, conf, tconf = copies.numpy()
            with trace.span("ctc_collapse"):
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

        with trace.span("line_assembly"):
            for pg, results in enumerate(per_page_results):
                if any_voting:
                    results = per_page_results[pg] = _pick_direction_variants(results)
                results.sort(key=lambda r: r.line.index)
            # One assembly over the lines of every page, cut back into pages.
            flat = _text_lines_from_results([r for results in per_page_results for r in results], self._alphabet)
            ends = np.cumsum([len(results) for results in per_page_results]).tolist()
            return [flat[a:b] for a, b in zip([0, *ends], ends)]

    @staticmethod
    def _count_columns(trace, n_pad: int, group_width: int, widths: np.ndarray) -> None:
        """A batch's line slots and recognizer columns: its lines' own
        (content) and the batch's padded ones."""
        if trace.enabled:
            trace.count("line_slots", n_pad)
            trace.count("content_columns", int(np.minimum(widths, group_width).sum()))
            trace.count("padded_columns", n_pad * group_width)

    def _run_pooled_batch(self, pages_dev, batch, group_width, greedy, with_conf, trace=NO_TRACE, graphs=False):
        """Axis-aligned crops of one pooled batch -> the device outputs of
        :meth:`_rec_decode_tail`, cut to the batch's lines, their copy to
        the host started; as a graph where `graphs` asks for one."""
        n = len(batch)
        n_pad = _pad_batch_size(n, self._max_lines)

        with trace.span("rec_geometry"):
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
        self._count_columns(trace, n_pad, group_width, geom[4, :n])
        with trace.span("rec_launch"), trace.card("card.recognize"):
            if not isinstance(pages_dev, _HostPages):
                # The crops, the recognizer and the decode head through the
                # graph cache (eagerly where they are not graphed); the
                # page stack is the group's fixed buffer
                # (_dispatch_recognition), the geometry is uploaded.
                return self._graphs.run(
                    self._rec_graph_key(pages_dev, n_pad, group_width, greedy, with_conf)
                    if graphs and self._graph_rec
                    else None,
                    functools.partial(self._rec_graph_body, out_w=group_width, greedy=greedy, with_conf=with_conf),
                    {"pages": pages_dev, "geom": geom, "chains": chains},
                    lambda out: _HostCopies(tuple(None if t is None else t[:n] for t in out)),
                    trace,
                    load_span="rec_crops",
                    run_span="rec_net",
                )
            with trace.span("rec_crops"):
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
            with trace.span("rec_net"):
                out = self._rec_decode_tail(crops, greedy, with_conf)
                return _HostCopies(tuple(None if t is None else t[:n] for t in out))

    def _rec_graph_body(self, pages, geom, chains, *, out_w: int, greedy: bool, with_conf: bool):
        """What an axis-aligned recognition batch's graph runs, as a plain
        function of its inputs (the page stack, the batch's geometry and
        polygon chains on the device): the crops, the recognizer and the
        decode head -> :meth:`_rec_decode_tail`'s outputs for every slot."""
        crops = extract_line_batch_packed(pages, geom, chains, out_h=self._rec_h, out_w=out_w)
        return self._rec_decode_tail(crops, greedy, with_conf)

    def _rec_graph_key(self, pages, n_pad: int, out_w: int, greedy: bool, with_conf: bool) -> tuple:
        """Everything an axis-aligned recognition batch's graph's shapes and
        branches depend on."""
        beam_k = None if greedy else beam_candidate_k(self._decode.width, len(self._alphabet) + 1)
        return (
            "recognize", n_pad, out_w, tuple(pages.shape), pages.dtype, greedy, beam_k, with_conf,
            self._min_conf is not None, self._excluded_onehot is not None,
        )

    def _run_pooled_batch_rotated(self, pages_dev, batch, group_width, greedy, with_conf, trace=NO_TRACE):
        """Deskew/vertical batches: crops sampled along each line's rotated
        rect (ops.warp.extract_line_batch_rotated; its C++ twin on the
        low-bandwidth transport). `with_conf` also returns the per-line mean
        max-log-prob for reading-direction voting; the copy to the host is
        started."""
        n = len(batch)
        n_pad = _pad_batch_size(n, self._max_lines)
        with trace.span("rec_geometry"):
            geom = np.empty((10, n_pad), dtype=np.float32)
            for col, (pg, rl) in enumerate(batch):
                rr = rl.rrect
                geom[0:2, col] = _rrect_origin(rr)
                geom[2:4, col] = rr.right_axis()
                geom[4:6, col] = -rr.up
                geom[6:10, col] = (rr.width, rr.height, rl.resized_width, pg)
            geom[:, n:] = geom[:, n - 1 : n]
        self._count_columns(trace, n_pad, group_width, geom[8, :n])
        with trace.span("rec_launch"), trace.card("card.recognize"):
            with trace.span("rec_crops"):
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
            with trace.span("rec_net"):
                out = self._rec_decode_tail(crops, greedy, with_conf)
                return _HostCopies(tuple(None if t is None else t[:n] for t in out))

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
        taken as already normalized; staged pages pass through. Under a mesh:
        a list of each shard's staged slice."""
        if self._shards is not None:
            if isinstance(pages, list):
                return pages
            return [shard._stage_pages(part) for shard, part in zip(self._shards, split_batch_dim(self._mesh, pages))]
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

    def _stage_pages_ahead(self, pages, trace=NO_TRACE):
        """:meth:`_stage_pages` for process_stream's worker thread: on the
        pipeline's copy stream, with an event that marks the end of the
        staging. The consumer's stream waits for the event."""
        with trace.span("stage"):
            if self._copy_stream is None:
                return self._stage_pages(pages), None
            with torch.cuda.stream(self._copy_stream):
                with trace.card("card.stage"):
                    staged = self._stage_pages(pages)
                event = torch.cuda.Event()
                event.record()
            return staged, event

    def process(self, pages: np.ndarray, recorder: Optional[TimelineRecorder] = None) -> list[PageResult]:
        """Run OCR on a stack of same-sized pages.

        `pages`: [B, H, W] or [B, H, W, C] u8/float numpy array. `recorder`:
        see :meth:`process_stream`; the pages are its group 0."""
        if self._shards is not None:
            parts = split_batch_dim(self._mesh, pages)
            return _concat(self._run_shards(lambda shard, part: shard.process(part, recorder), parts))
        trace = NO_TRACE if recorder is None else recorder.group(0)
        with trace.span("stage"), trace.card("card.stage"):
            staged = self._stage_pages(pages)
        return self.process_normalized(staged, recorder=recorder)

    # -- shards (mesh) ------------------------------------------------------------

    def _run_shards(self, fn: Callable, parts: list) -> list:
        """Run ``fn(shard, part)`` for each shard on its worker thread and
        its CUDA stream, which first waits for the work the calling thread
        queued on that device (its staging, the models' upload). Waits for
        every shard, then raises the first shard's error or returns the
        shards' results in order."""
        caller = {
            shard.device: torch.cuda.current_stream(shard.device)
            for shard in self._shards
            if shard.device.type == "cuda"
        }

        def run(i: int):
            shard, stream = self._shards[i], self._shard_streams[i]
            if stream is None:
                return fn(shard, parts[i])
            stream.wait_stream(caller[shard.device])
            with torch.cuda.stream(stream):
                return fn(shard, parts[i])

        futures = [worker.submit(run, i) for i, worker in enumerate(self._shard_workers)]
        wait(futures)
        return [f.result() for f in futures]

    def _process_stream_sharded(self, page_batches: Iterable, recorder) -> list[list[PageResult]]:
        """process_stream under a mesh: each shard streams its slices of the
        groups through its own pipeline (:meth:`process_stream`) on its
        worker, recording into `recorder` under its thread's name. The groups
        are read lazily: the shard that first needs a group reads and splits
        it, and keeps the other shards' slices for them."""
        source, lock, end = iter(page_batches), threading.Lock(), object()
        pending = [collections.deque() for _ in self._shards]

        def slices(i: int):
            while True:
                with lock:
                    if not pending[i]:
                        group = next(source, end)
                        if group is end:
                            return
                        for kept, part in zip(pending, split_batch_dim(self._mesh, group)):
                            kept.append(part)
                    part = pending[i].popleft()
                yield part

        per_shard = self._run_shards(
            lambda shard, i: shard.process_stream(slices(i), recorder), list(range(len(self._shards)))
        )
        return [_concat(groups) for groups in zip(*per_shard)]

    def process_stream(
        self, page_batches: Iterable, recorder: Optional[TimelineRecorder] = None
    ) -> list[list[PageResult]]:
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
        (recognition.rs:464-467) at page granularity. Under a mesh each shard
        runs this on its slices of the groups.

        `recorder` (off when None): a :class:`TimelineRecorder` that gets,
        for group i (in the order the groups are read) under ``group(i)``,
        the spans of the host's work on this thread (``stage_wait``;
        ``detect_launch`` holding ``detect_pre``, ``detect_net`` and
        ``detect_post``; ``dispatch`` holding ``tables_to_words`` >
        ``tables_wait``, ``layout``, ``rec_prep`` and per batch
        ``rec_geometry`` and ``rec_launch`` > ``rec_crops`` (the inputs'
        upload or copy), ``rec_net`` (the crops, the recognizer and the
        decode head, or their replay), and on a card one ``rec_crops`` for
        the group's page copy; ``collect`` holding per batch
        ``labels_wait`` and ``ctc_collapse``, then ``line_assembly`` and
        ``page_results``) and on the staging
        thread (``stage``), and the interpreter's collections (``gc``); on a card
        the intervals ``card.stage`` (copy stream), ``card.detect`` and
        per batch ``card.recognize`` (this thread's stream); and the counts
        ``pages``, ``words``, ``lines``, ``batches``, ``line_slots``,
        ``content_columns`` and ``padded_columns``, and on a card
        ``graph_replays``, ``graph_captures`` (a capture is followed by its
        first replay) and ``eager_batches`` (detector calls and recognition
        batches whose key is not captured yet). The results are the same
        with and without it."""
        if self._shards is not None:
            return self._process_stream_sharded(page_batches, recorder)
        rec = NO_TRACE if recorder is None else recorder
        results: list[list[PageResult]] = []
        staged: list = []  # (group index, pages): uploaded, detect not yet dispatched
        detected: list[tuple] = []  # (group index, pages_dev, table copies, scale), in order
        dispatched: list[tuple] = []  # (group index, (words, lines, inflight)), in order
        it = iter(page_batches)
        self._transport_mode()  # probe the link here, not on the worker thread
        exhausted = False
        stage_fut = None  # (group index, future)
        n_read = 0

        def pump():
            while staged and len(detected) < 2:
                g, pages = staged.pop(0)
                trace = rec.group(g)
                with trace.span("detect_launch"), trace.card("card.detect"):
                    tables, scale = self._detect_tables(pages, trace, graphs=True)
                    detected.append((g, pages, tables, scale))

        ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"{threading.current_thread().name}-stage")

        def submit_stage():
            nonlocal stage_fut, exhausted, n_read
            if stage_fut is None and not exhausted:
                try:
                    nxt = next(it)
                except StopIteration:
                    exhausted = True
                    return
                stage_fut = (n_read, ex.submit(self._stage_pages_ahead, nxt, rec.group(n_read)))
                n_read += 1

        try:
            submit_stage()
            while True:
                if stage_fut is not None:
                    g, fut = stage_fut
                    with rec.group(g).span("stage_wait"):
                        pages, event = fut.result()
                    stage_fut = None
                    if event is not None:
                        # Everything queued from here on runs after the
                        # staging; the staged tensor's memory belongs to the
                        # copy stream's pool and is marked as used here.
                        main = torch.cuda.current_stream(self.device)
                        main.wait_event(event)
                        (pages.det_dev if isinstance(pages, _HostPages) else pages).record_stream(main)
                    staged.append((g, pages))
                    submit_stage()  # prefetch the NEXT batch under this turn
                pump()
                if detected and (exhausted or len(detected) >= 2):
                    g, *group = detected.pop(0)
                    dispatched.append((g, self._dispatch_group(*group, trace=rec.group(g))))
                    pump()
                while dispatched and (len(dispatched) > 1 or (exhausted and not staged and not detected)):
                    g, group = dispatched.pop(0)
                    results.append(self._collect_group(group, rec.group(g)))
                if exhausted and not staged and not detected and not dispatched:
                    return results
        finally:
            ex.shutdown(wait=True)

    def _dispatch_group(self, pages_dev, tables, scale, trace=NO_TRACE) -> tuple:
        """Host-side head of one group's tail: table read-back, layout, and
        recognition dispatch (device work queued, label copies started)."""
        with trace.span("dispatch"):
            with trace.span("tables_to_words"):
                per_page_words, per_arrays = self._tables_to_words_arrays(tables, scale, trace)
            per_page_lines = self._layout_group(per_page_words, per_arrays, trace)
            inflight = self._dispatch_recognition(pages_dev, per_page_lines, trace, graphs=True)
        return per_page_words, per_page_lines, inflight

    def _collect_group(self, group: tuple, trace=NO_TRACE) -> list[PageResult]:
        """Collect a dispatched group: CTC collapse and line assembly."""
        per_page_words, per_page_lines, inflight = group
        with trace.span("collect"):
            per_page_text = self._collect_recognition(per_page_lines, inflight, trace)
            with trace.span("page_results"):
                return [
                    PageResult(words=w, lines=l, text_lines=t)
                    for w, l, t in zip(per_page_words, per_page_lines, per_page_text)
                ]

    def process_normalized(
        self, pages_dev, timer: Optional[StageTimer] = None, recorder: Optional[TimelineRecorder] = None
    ) -> list[PageResult]:
        """Run OCR on pages already normalized and on the device ([B, H, W]
        float32 in [-0.5, 0.5]), or staged by :meth:`_stage_pages`. The
        stages' wall times go to `timer` (pass one with ``fence_device`` to
        have each stage wait for its device work); with ``debug=True`` they
        are printed like the engine's get_text. Under a mesh `pages_dev` is
        a list of the shards' staged slices (:meth:`_stage_pages`), or one
        tensor that is sharded first, and `timer` times the shards as one
        stage, "shards". `recorder`: see :meth:`process_stream`; the pages
        are its group 0."""
        timer = timer or StageTimer(debug=self._debug)
        if self._shards is not None:
            parts = pages_dev if isinstance(pages_dev, list) else shard_batch_dim(self._mesh, pages_dev)
            with timer.stage("shards"):
                return _concat(
                    self._run_shards(lambda shard, part: shard.process_normalized(part, recorder=recorder), parts)
                )
        trace = NO_TRACE if recorder is None else recorder.group(0)
        with timer.stage("detect"), trace.span("detect_launch"), trace.card("card.detect"):
            tables, scale = self._detect_tables(pages_dev, trace)
        with timer.stage("rects_to_host"), trace.span("tables_to_words"):
            per_page_words, per_arrays = self._tables_to_words_arrays(tables, scale, trace)
        with timer.stage("layout"):
            per_page_lines = self._layout_group(per_page_words, per_arrays, trace)
        with timer.stage("recognize"):
            per_page_text = self._collect_recognition(
                per_page_lines, self._dispatch_recognition(pages_dev, per_page_lines, trace), trace
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
