"""Tracing and per-stage timing.

Port of ``ocrs_tpu.utils.tracing``. Upstream's observability is a debug flag
that prints per-op timings and batch sizes (detection.rs:177-182,
recognition.rs:469-475, main.rs:486-494). Here:

  * :class:`StageTimer`: wall-clock per-stage timings behind the same debug
    flag. PyTorch returns before the device has finished, so a caller that
    wants a stage's device work inside its time passes ``fence_device``.
  * :func:`fence`: ``torch.cuda.synchronize`` of one device; nothing on the CPU.
  * :func:`trace`: context manager around ``torch.profiler.profile`` that
    writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def fence(device: torch.device | str | None = None) -> None:
    """Wait until all work queued on `device` has finished (the current CUDA
    device when None). A no-op for the CPU, where nothing is queued."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(dev)


class StageTimer:
    """Collects named stage timings; prints them when debug is on. With
    `fence_device` every stage ends with :func:`fence` on that device, so
    that its time holds the device work it queued."""

    def __init__(self, debug: bool = False, fence_device: torch.device | str | None = None):
        self.debug = debug
        self.fence_device = fence_device
        self.timings: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        yield
        if self.fence_device is not None:
            fence(self.fence_device)
        elapsed = time.perf_counter() - start
        self.timings[name] = self.timings.get(name, 0.0) + elapsed
        if self.debug:
            print(f"[ocrs_tpu_torch] {name}: {elapsed * 1000:.1f}ms")

    def summary(self) -> str:
        total = sum(self.timings.values())
        parts = [f"{k}={v * 1000:.1f}ms" for k, v in self.timings.items()]
        return f"total={total * 1000:.1f}ms " + " ".join(parts)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card) around a code block and write it to ``log_dir/trace.json``.

    Usage: ``with trace("ocr-trace"): engine.get_text(inp)``; open the file
    in ``chrome://tracing`` or Perfetto. With ``log_dir=None`` nothing is
    traced."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
