"""Loader for the native host library (``native/ocrs_native.cpp``).

The port's own copy of ``ocrs_tpu.native``: the same ten ``oc_*`` entry points
behind typed ctypes wrappers, built with ``g++`` from the unedited source at
first use into ``build/native/`` (keyed on the source's sha256, so a stale
binary never shadows newer source) and shared with nothing else.

Every entry point has a numpy or tensor route in :mod:`ocrs_tpu_torch.layout`,
:mod:`ocrs_tpu_torch.ops.ctc` and :mod:`ocrs_tpu_torch.ops.rects`; a wrapper
returns ``None`` when the library is not available and its caller takes that
route, so a machine without a C++ toolchain loses speed only. The reason is
kept: a failed build stores the compiler's output, :func:`build_error` returns
it and :func:`require` raises it. :func:`disabled` turns the library off for
a block, which is how the tests reach the numpy routes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SRC = _REPO_ROOT / "native" / "ocrs_native.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_disabled = 0

_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I16 = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _build(lib_path: Path) -> None:
    """Compile the source into `lib_path`; raises RuntimeError with the
    compiler's output. The library is written beside its final name and
    renamed, so that a second process never loads a half-written file."""
    compiler = shutil.which(os.environ.get("CXX", "g++"))
    if compiler is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr.strip()}")
    os.replace(tmp, lib_path)


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry point."""
    lib.oc_find_separators.restype = ctypes.c_int
    lib.oc_find_separators.argtypes = [
        _F64,
        ctypes.c_int,
        _F64,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        _F64,
    ]
    lib.oc_group_lines.restype = ctypes.c_int
    lib.oc_group_lines.argtypes = [
        _F64,
        ctypes.c_int,
        _F64,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        _I32,
        _I32,
    ]
    lib.oc_find_text_lines.restype = ctypes.c_int
    lib.oc_find_text_lines.argtypes = [
        _F64,
        _F64,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        _I32,
        _I32,
    ]
    lib.oc_runs_to_rects.restype = None
    lib.oc_runs_to_rects.argtypes = [
        _I16,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _F64,
    ]
    lib.oc_ctc_collapse.restype = None
    lib.oc_ctc_collapse.argtypes = [
        _I32,
        ctypes.c_int,
        ctypes.c_int,
        _I32,
        _I32,
        _I32,
    ]
    lib.oc_ctc_beam.restype = None
    lib.oc_ctc_beam.argtypes = [
        _F32,
        _I32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _I32,
        _I32,
        _I32,
    ]
    lib.oc_resize_pages.restype = None
    lib.oc_resize_pages.argtypes = [
        _U8,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _U8,
    ]
    lib.oc_extract_lines.restype = None
    lib.oc_extract_lines.argtypes = [
        _U8,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _F32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _U8,
    ]
    lib.oc_extract_lines_rotated.restype = None
    lib.oc_extract_lines_rotated.argtypes = list(lib.oc_extract_lines.argtypes)
    lib.oc_extract_lines_strip.restype = None
    lib.oc_extract_lines_strip.argtypes = [
        _U8,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _F32,
        _I32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        _U8,
    ]

def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _disabled:
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not _SRC.exists():
                raise RuntimeError(f"{_SRC} is missing")
            digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()
            lib_path = _BUILD_DIR / f"libocrs_native-{digest[:16]}.so"
            if not lib_path.exists():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            _declare(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (the compiler's output for a failed
    build), or None when it is, or was not tried yet."""
    return _error


def require() -> None:
    """Build and load the library, or raise RuntimeError with the reason."""
    if _load() is None:
        reason = "switched off by native.disabled()" if _disabled else _error
        raise RuntimeError(f"the native library (native/ocrs_native.cpp) is not available: {reason}")


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Inside the block every wrapper returns None, so that callers take
    their numpy routes."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def find_separators(
    obs_sorted: np.ndarray,
    boundary: tuple[float, float, float, float],
    min_w: float,
    min_h: float,
    iou_thresh: float,
    max_out: int,
) -> Optional[np.ndarray]:
    """C++ max-empty-rects; returns (n, 4) tlbr array or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    obs = np.ascontiguousarray(obs_sorted, dtype=np.float64).reshape(-1, 4)
    out = np.empty((max_out, 4), dtype=np.float64)
    n = lib.oc_find_separators(
        obs,
        obs.shape[0],
        np.asarray(boundary, dtype=np.float64),
        float(min_w),
        float(min_h),
        float(iou_thresh),
        int(max_out),
        out,
    )
    return out[:n]


def group_lines(
    feat: np.ndarray,
    seps: np.ndarray,
    overlap_threshold: float,
    max_h_overlap: float,
) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
    """C++ greedy line chaining; returns (line_id, rank, n_lines) or None."""
    lib = _load()
    if lib is None:
        return None
    feat = np.ascontiguousarray(feat, dtype=np.float64)
    seps = np.ascontiguousarray(seps, dtype=np.float64).reshape(-1, 4)
    n = feat.shape[0]
    out_line = np.empty(n, dtype=np.int32)
    out_rank = np.empty(n, dtype=np.int32)
    n_lines = lib.oc_group_lines(
        feat,
        n,
        seps,
        seps.shape[0],
        float(overlap_threshold),
        float(max_h_overlap),
        out_line,
        out_rank,
    )
    return out_line, out_rank, n_lines


def find_text_lines(
    feat: np.ndarray,
    boxes: np.ndarray,
    median_height: float,
    overlap_threshold: float,
    max_h_overlap: float,
) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
    """C++ full layout (separators + chaining + paragraph order). Returns
    (word_order, line_of_position, n_lines) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    feat = np.ascontiguousarray(feat, dtype=np.float64)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    n = feat.shape[0]
    out_word = np.empty(n, dtype=np.int32)
    out_line = np.empty(n, dtype=np.int32)
    n_lines = lib.oc_find_text_lines(
        feat,
        boxes,
        n,
        float(median_height),
        float(overlap_threshold),
        float(max_h_overlap),
        out_word,
        out_line,
    )
    return out_word, out_line, n_lines


def runs_to_rects(
    runs: np.ndarray, pool: int, max_components: int
) -> Optional[np.ndarray]:
    """C++ run-table CCL + exact min-area rects (see oc_runs_to_rects).
    `runs`: int16 [B, 6, K]. Returns float64 [B, 9, max_components] in
    PACK_FIELDS order, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    runs = np.ascontiguousarray(runs, dtype=np.int16)
    b, ch, k = runs.shape
    assert ch == 6
    out = np.empty((b, 9, max_components), dtype=np.float64)
    lib.oc_runs_to_rects(runs, b, k, int(pool), int(max_components), out)
    return out


def resize_pages(
    pages: np.ndarray, out_hw: tuple[int, int], pack4: bool = False
) -> Optional[np.ndarray]:
    """C++ host-side page downscale to detector input resolution (pad
    bottom/right with black to at least out_hw, then 2-tap half-pixel
    bilinear — the exact law of ops/resize). `pages`: u8 [B, H, W]. Returns
    u8 [B, out_h, out_w] (pack4: last axis (out_w+1)//2, two 4-bit pixels
    per byte, high nibble first), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    b, h, w = pages.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    stride = (out_w + 1) // 2 if pack4 else out_w
    out = np.empty((b, out_h, stride), dtype=np.uint8)
    lib.oc_resize_pages(pages, b, h, w, out_h, out_w, int(pack4), out)
    return out


def extract_lines(
    pages: np.ndarray,
    geom: np.ndarray,
    out_h: int,
    out_w: int,
    pack4: bool = False,
) -> Optional[np.ndarray]:
    """C++ host-side text-line crop extraction (the low-bandwidth transport
    path): bilinear sample + resize each line region from full-res host
    pages with the exact law of ops/warp._extract_impl (the polygon band
    mask is applied later on device from the tiny geometry arrays).

    `pages`: u8 [B, H, W]; `geom`: f32 [6, N] (top, left, height, width,
    resized_width, page_index). Returns u8 [N, out_h, out_w] (pack4: last
    axis (out_w+1)//2), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    geom = np.ascontiguousarray(geom, dtype=np.float32)
    b, h, w = pages.shape
    n = geom.shape[1]
    stride = (out_w + 1) // 2 if pack4 else out_w
    out = np.empty((n, out_h, stride), dtype=np.uint8)
    lib.oc_extract_lines(pages, b, h, w, geom, n, out_h, out_w, int(pack4), out)
    return out


def extract_lines_strip(
    pages: np.ndarray,
    geom: np.ndarray,
    offs: np.ndarray,
    out_h: int,
    total_w: int,
    pack4: bool = False,
) -> Optional[np.ndarray]:
    """C++ strip-packed text-line crops (low-bandwidth transport): each line
    is extracted at its own resized width into a shared [out_h, total_w]
    strip at column offset ``offs[i]`` instead of padding every line to the
    batch-max width (~48% of the bytes on dense pages). Same sampling law
    as :func:`extract_lines`; the device side gathers windows back out of
    the strip (ops/warp.strip_gather) and masks identically.

    `geom`: f32 [6, N]; `offs`: i32 [N] ascending, line i owning columns
    [offs[i], offs[i+1]) (last line to total_w); with ``pack4`` both offs
    and total_w must be even. Returns u8 [out_h, total_w] (pack4: last axis
    total_w//2), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    geom = np.ascontiguousarray(geom, dtype=np.float32)
    offs = np.ascontiguousarray(offs, dtype=np.int32)
    b, h, w = pages.shape
    n = geom.shape[1]
    stride = (total_w + 1) // 2 if pack4 else total_w
    out = np.empty((out_h, stride), dtype=np.uint8)
    lib.oc_extract_lines_strip(
        pages, b, h, w, geom, offs, n, out_h, total_w, int(pack4), out
    )
    return out


def extract_lines_rotated(
    pages: np.ndarray,
    geom: np.ndarray,
    out_h: int,
    out_w: int,
    pack4: bool = False,
) -> Optional[np.ndarray]:
    """C++ deskewing line crops (the low-bandwidth twin of
    ops/warp.extract_line_batch_rotated — see that op for the sampling law).
    `geom`: f32 [10, N] (ox, oy, rx, ry, dx, dy, w, h, rwidth, page)."""
    lib = _load()
    if lib is None:
        return None
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    geom = np.ascontiguousarray(geom, dtype=np.float32)
    b, h, w = pages.shape
    n = geom.shape[1]
    stride = (out_w + 1) // 2 if pack4 else out_w
    out = np.empty((n, out_h, stride), dtype=np.uint8)
    lib.oc_extract_lines_rotated(pages, b, h, w, geom, n, out_h, out_w, int(pack4), out)
    return out


def ctc_collapse_batch(labels: np.ndarray) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C++ batch greedy CTC collapse; returns (pos, lab, counts) or None."""
    lib = _load()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    n, t = labels.shape
    out_pos = np.empty((n, t), dtype=np.int32)
    out_lab = np.empty((n, t), dtype=np.int32)
    out_count = np.empty(n, dtype=np.int32)
    lib.oc_ctc_collapse(labels, n, t, out_pos, out_lab, out_count)
    return out_pos, out_lab, out_count


def ctc_beam_topk(
    vals: np.ndarray, idx: np.ndarray, beam_width: int
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C++ batch CTC prefix beam search over per-frame TOP-K candidates.

    vals/idx are [N, T, K] descending candidate log-probs and class ids
    (-inf vals are padding) — typically the device's per-frame top-k read back.
    Returns (pos, lab, counts) with pos/lab [N, T] int32, or None when the
    native library is unavailable (callers fall back to the Python beam).
    """
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    n, t, k = vals.shape
    out_pos = np.empty((n, t), dtype=np.int32)
    out_lab = np.empty((n, t), dtype=np.int32)
    out_count = np.empty(n, dtype=np.int32)
    lib.oc_ctc_beam(vals, idx, n, t, k, int(beam_width), out_pos, out_lab, out_count)
    return out_pos, out_lab, out_count


def ctc_beam_batch(
    logprobs: np.ndarray,
    beam_width: int,
    excluded_onehot: Optional[np.ndarray] = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """:func:`ctc_beam_topk` over full [N, T, C] log-probs: computes the
    per-frame top-max(W,8) candidates on host (argsort-descending order,
    matching the Python oracle's pruning) then runs the C++ kernel."""
    if _load() is None:
        return None
    lp = np.asarray(logprobs, dtype=np.float32)
    if excluded_onehot is not None:
        lp = np.where(excluded_onehot.astype(bool), -np.inf, lp)
    k = min(max(int(beam_width), 8), lp.shape[-1])
    # argsort descending over classes, keep K: ties resolve to the higher
    # class id, same as the oracle's np.argsort(frame)[::-1].
    idx = np.argsort(lp, axis=-1)[..., ::-1][..., :k].astype(np.int32)
    vals = np.take_along_axis(lp, idx, axis=-1)
    return ctc_beam_topk(vals, idx, beam_width)
