"""Separable bilinear resize as two matrix products.

Port of ``ocrs_tpu.ops.resize``. Upstream ocrs resizes with ONNX ``Resize``
(bilinear, half-pixel coordinate transform, no antialiasing). The same law is
built here as two dense interpolation matrices. ``F.interpolate`` is not used:
it is not shown to match the half-pixel, edge-clamped law bit for bit, and the
JAX package's matrices are the reference the tests hold this module against.

On a card the matrices stay on the device (:func:`_device_interp_matrix`): a
copy from pageable host memory would wait for every kernel queued before it.
"""

from __future__ import annotations

import contextlib
import threading
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, half-pixel convention
    with edge clamping (ONNX Resize ``coordinate_transformation_mode =
    half_pixel``, ``mode = linear``)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float64)
    lo0 = np.clip(lo, 0, in_size - 1)
    lo1 = np.clip(lo + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo0), 1.0 - frac)
    np.add.at(m, (rows, lo1), frac)
    return m.astype(np.float32)


#: Bytes of device memory the cached matrices may hold together, over all
#: devices. The largest matrix of the page pipeline's detector input at 300
#: dpi (3508 rows to 800) is 800 x 3508 float32, 11.2 MB.
DEVICE_CACHE_BYTES = 256 << 20

_device_cache: dict[tuple[int, int, torch.device], torch.Tensor] = {}
_device_cache_bytes = 0
_device_cache_lock = threading.Lock()
_retained = threading.local()


@contextlib.contextmanager
def retain_device_matrices():
    """Yields a list that collects every device matrix this thread's calls
    of :func:`_device_interp_matrix` return while inside. A CUDA graph
    captured meanwhile reads those matrices by address, so its owner keeps
    the list: a matrix the cache drops later stays alive for the graph."""
    kept: list[torch.Tensor] = []
    outer = getattr(_retained, "kept", None)
    _retained.kept = kept
    try:
        yield kept
    finally:
        _retained.kept = outer


def _device_interp_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix` as a tensor on `device`, built once per
    ``(in_size, out_size, device)``.

    The first call copies the matrix to the device and waits for the copy
    (warm-up); a call that finds it makes no copy and does not wait. The
    cache holds at most :data:`DEVICE_CACHE_BYTES` (256 MiB) of matrices and
    drops the oldest first; a matrix larger than that alone is copied on
    every call. Lookups take no lock; two threads that miss together both
    build the matrix, and one copy stays. The cached tensors are never
    written. On the CPU an entry wraps the numpy matrix without a copy."""
    key = (in_size, out_size, device)
    m = _device_cache.get(key)
    if m is None:
        # Made outside inference mode, where a warm-up may run: a tensor made
        # there could not be saved for a backward pass (the U-Net trains).
        with torch.inference_mode(False):
            m = torch.from_numpy(_interp_matrix(in_size, out_size)).to(device)
        _cache_insert(key, m)
    kept = getattr(_retained, "kept", None)
    if kept is not None:
        kept.append(m)
    return m


def _cache_insert(key, m: torch.Tensor) -> None:
    global _device_cache_bytes
    size = m.numel() * m.element_size()
    if size > DEVICE_CACHE_BYTES:
        return
    with _device_cache_lock:
        if key in _device_cache:
            return
        # Dicts keep insertion order: the first keys are the oldest.
        while _device_cache_bytes + size > DEVICE_CACHE_BYTES:
            old = _device_cache.pop(next(iter(_device_cache)))
            _device_cache_bytes -= old.numel() * old.element_size()
        _device_cache[key] = m
        _device_cache_bytes += size


@contextlib.contextmanager
def _true_f32_matmul():
    """Run float32 matrix products in full float32: TF32 off while inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize_bilinear(
    img: torch.Tensor, out_hw: tuple[int, int], precision: str = "highest"
) -> torch.Tensor:
    """Bilinear-resize the trailing two dims of `img` to `out_hw` -> float32.

    Works for any leading batch/channel dims. The products run in float32
    (a bf16 `img` is promoted, as JAX promotes it against the float32
    matrices). ``precision="highest"`` switches TF32 off for the call, so
    they are true float32 products on the card, for image-parity call sites.
    ``"default"`` leaves PyTorch's float32 matmul setting as the caller set
    it; on the TPU the JAX package's default precision runs bf16 passes
    there, but on the JAX CPU backend, which the parity tests use, it is
    full float32, and so is PyTorch's own default."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    ry = _device_interp_matrix(in_h, out_h, img.device)
    rx = _device_interp_matrix(in_w, out_w, img.device)
    if img.is_cuda:
        # A cached matrix may be read on another thread's stream than the
        # one it was made on: its memory is then not reused before this
        # stream has read it, even once the cache has dropped it.
        stream = torch.cuda.current_stream(img.device)
        ry.record_stream(stream)
        rx.record_stream(stream)
    ctx = _true_f32_matmul() if precision == "highest" else contextlib.nullcontext()
    with ctx:
        # (..., H, W) -> (..., out_h, W) -> (..., out_h, out_w)
        out = torch.matmul(ry, img.to(torch.float32))
        return torch.matmul(out, rx.T)
