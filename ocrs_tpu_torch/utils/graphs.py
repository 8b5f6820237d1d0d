"""CUDA graphs of fixed-shape device work: captured once, then replayed.

A :class:`GraphCache` holds the graphs of one owner (a page pipeline, or one
shard of it). The owner hands it a key (everything that fixes the work's
shapes and branches, or None for work that is never graphed), a body (a
plain function of device tensors that launches the work and returns its
outputs without waiting for the card), the body's inputs (tensors on the
card, or host arrays), and a `finish` that consumes the outputs. The first
time a key is seen the body runs eagerly; the second time it is captured
(warmed up on the stream that replays, then captured on a side stream); from
then on its inputs are copied into the graph's fixed buffers and the graph is
replayed, one launch in place of the body's hundreds. A key beyond the
cache's bound (:data:`MAX_GRAPHS`, :data:`MAX_INPUT_BYTES`) runs eagerly
every time. A capture or replay that fails raises: nothing falls back to the
eager body on an error.

An input that several runs read (the page stack that every recognition batch
of a group crops from) is copied once, by :meth:`GraphCache.fixed_input`,
into a buffer that the runs inside that block read as it is.

Why one memory pool may serve all of an owner's graphs. PyTorch's rule for a
shared pool (``torch.cuda.graph(pool=...)``) is that graphs captured into it
may be replayed in any order only if no graph reads memory that another
graph's replay writes while it is still needed. A graph's replay writes
every block its capture used: its intermediates, and its outputs. A block
that was an intermediate of one graph may hold another graph's outputs. So
here (a) every replay is queued on the calling thread's current stream, one
after another, under the cache's lock; (b) `finish` queues every consumer of
a graph's outputs (their copy to pinned host memory, or the eager tail) on
that same stream before the lock is released, so before any later replay can
run on the card; (c) the inputs are buffers allocated outside the pool,
written only by the copies in front of a replay or by ``fixed_input``. Work
on another stream than the last first waits for the event recorded after the
last one's consumers. No output leaves `finish` as a device tensor of the
pool.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.resize import retain_device_matrices
from .tracing import NO_TRACE

#: Graphs one cache keeps: a key seen when the cache is full runs eagerly.
MAX_GRAPHS = 64

#: Bytes of fixed input buffers one cache may allocate (the page pipeline's
#: page stack at 300 dpi is 16 x 3508 x 2480 float32, 557 MB): a key that
#: would need more runs eagerly.
MAX_INPUT_BYTES = 4 << 30

#: One capture at a time in the process, as PyTorch asks of graph captures
#: (shards of one pipeline capture on threads of their own).
_capture_lock = threading.Lock()


class _Graph:
    """A captured graph, its outputs, and the device matrices its kernels
    read by address."""

    __slots__ = ("graph", "outputs", "kept")

    def __init__(self, graph, outputs, kept):
        self.graph, self.outputs, self.kept = graph, outputs, kept


class GraphCache:
    """Graphs keyed by shape and branch (see the module docstring). On any
    device but a card every call runs its body eagerly and nothing is
    counted."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.enabled = self.device.type == "cuda"
        self._graphs: dict = {}
        self._seen: set = set()
        self._buffers: dict = {}  # (name, shape, dtype) -> fixed input buffer
        self._input_bytes = 0
        self._pool = None
        self._stream = None
        self._lock = threading.RLock()
        self._last: Optional[tuple] = None  # (stream, event) after the last run's consumers
        self.captures = 0
        self.replays = 0
        self.eager = 0

    @contextlib.contextmanager
    def fixed_input(self, name: str, tensor: torch.Tensor, trace=NO_TRACE, span: Optional[str] = None):
        """Copy `tensor` into the cache's buffer for `name` (made on first
        use) on the current stream, and yield the buffer: a run inside the
        block that passes it as its input `name` reads it without a copy.
        The cache's lock is held for the whole block, so no other thread's
        run rewrites the buffer meanwhile. Yields `tensor` itself where the
        cache is off or a new buffer would pass the budget. `span` names the
        trace's span around the copy."""
        if not self.enabled:
            yield tensor
            return
        with self._lock:
            with _span(trace, span):
                bkey = _buffer_key(name, tensor)
                if bkey not in self._buffers and self._input_bytes + _nbytes(tensor) > MAX_INPUT_BYTES:
                    buf = tensor
                else:
                    self._after_last()
                    buf = self._buffer(bkey, tensor)
                    buf.copy_(tensor, non_blocking=True)
                    self._mark_last()
            yield buf

    def run(
        self,
        key,
        body: Callable,
        inputs: dict,
        finish: Callable,
        trace=NO_TRACE,
        load_span: Optional[str] = None,
        run_span: Optional[str] = None,
        finish_span: Optional[str] = None,
    ):
        """``finish(body(*inputs.values()))``, through a graph of `key` when
        the cache holds one. `inputs` maps a buffer name to a tensor on the
        card or a host array (uploaded through pinned memory without
        blocking); a graph's inputs are copied into its fixed buffers, but
        for a buffer of :meth:`fixed_input`, read as it is. `body` must not
        write its inputs. `key` None runs eagerly, uncounted. The trace's
        spans: `load_span` around the inputs' upload or copy (inside
        `run_span` where it is None), `run_span` around the body or the
        replay, `finish_span` around `finish`. Counts ``graph_replays``,
        ``graph_captures`` and ``eager_batches`` in `trace`."""
        if key is None or not self.enabled:
            return self._spanned(trace, load_span, run_span, finish_span, self._upload, body, inputs, finish)
        with self._lock:
            mode = self._plan(key, inputs)
            if mode == "eager":
                self.eager += 1
                trace.count("eager_batches")
                return self._spanned(trace, load_span, run_span, finish_span, self._upload, body, inputs, finish)

            def replay(*args):
                if mode == "capture":
                    self._capture(key, body, args)
                    self.captures += 1
                    trace.count("graph_captures")
                entry = self._graphs[key]
                entry.graph.replay()
                self.replays += 1
                trace.count("graph_replays")
                return entry.outputs

            self._after_last()
            # Every consumer of the outputs is queued before the lock is
            # released (module docstring).
            result = self._spanned(trace, load_span, run_span, finish_span, self._load, replay, inputs, finish)
            self._mark_last()
            return result

    def stats(self) -> dict:
        """Counts since construction, graphs held, bytes of input buffers and
        of the pool (its segments in the allocator's snapshot; None where the
        snapshot does not name pools)."""
        return {
            "graph_captures": self.captures,
            "graph_replays": self.replays,
            "eager_batches": self.eager,
            "graphs": len(self._graphs),
            "input_buffer_bytes": self._input_bytes,
            "pool_bytes": self.pool_bytes(),
        }

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the allocator's segments in this cache's pool."""
        if self._pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(self._pool))

    # -- internals -----------------------------------------------------------

    def _plan(self, key, inputs: dict) -> str:
        """What :meth:`run` does with `key` now: ``"replay"`` a graph it
        holds, ``"capture"`` one on the key's second sight, or ``"eager"``
        (first sight, a full cache, or input buffers over their budget).
        Counts the sighting."""
        if key in self._graphs:
            return "replay"
        if key not in self._seen:
            self._seen.add(key)
            return "eager"
        if len(self._graphs) >= MAX_GRAPHS:
            return "eager"
        new_bytes = sum(_nbytes(src) for name, src in inputs.items() if _buffer_key(name, src) not in self._buffers)
        return "eager" if self._input_bytes + new_bytes > MAX_INPUT_BYTES else "capture"

    @staticmethod
    def _spanned(trace, load_span, run_span, finish_span, load, body, inputs, finish):
        if load_span is None:
            with _span(trace, run_span):
                out = body(*load(inputs))
        else:
            with _span(trace, load_span):
                args = load(inputs)
            with _span(trace, run_span):
                out = body(*args)
        with _span(trace, finish_span):
            return finish(out)

    def _after_last(self) -> None:
        """Order this work after the last run's consumers when those were
        queued on another stream."""
        stream = torch.cuda.current_stream(self.device)
        if self._last is not None and self._last[0] != stream:
            stream.wait_event(self._last[1])

    def _mark_last(self) -> None:
        stream = torch.cuda.current_stream(self.device)
        event = torch.cuda.Event()
        event.record(stream)
        self._last = (stream, event)

    def _upload(self, inputs: dict) -> list:
        """The inputs as tensors on the cache's device: a host array through
        pinned memory without blocking, a tensor as it is."""
        out = []
        for src in inputs.values():
            if isinstance(src, torch.Tensor):
                out.append(src)
            elif not self.enabled:
                out.append(torch.from_numpy(np.ascontiguousarray(src)))
            else:
                out.append(_pinned(src).to(self.device, non_blocking=True))
        return out

    def _buffer(self, bkey: tuple, src) -> torch.Tensor:
        buf = self._buffers.get(bkey)
        if buf is None:
            dtype = torch.from_numpy(src[:0]).dtype if isinstance(src, np.ndarray) else src.dtype
            with torch.inference_mode(False):
                buf = torch.empty(src.shape, dtype=dtype, device=self.device)
            self._buffers[bkey] = buf
            self._input_bytes += _nbytes(buf)
        return buf

    def _load(self, inputs: dict) -> list:
        """Each input in its fixed buffer, copied there on the current
        stream (a host array through pinned memory), but for a buffer of
        :meth:`fixed_input`, which is taken as it is; returns the buffers in
        order."""
        out = []
        for name, src in inputs.items():
            bkey = _buffer_key(name, src)
            if self._buffers.get(bkey) is not src:
                buf = self._buffer(bkey, src)
                buf.copy_(_pinned(src) if isinstance(src, np.ndarray) else src, non_blocking=True)
                src = buf
            out.append(src)
        return out

    def _capture(self, key, body, args) -> None:
        """Warm the body up on the stream that replays (blocks it frees go
        back to that stream's cache, where the eager work reuses them), then
        capture it on the side stream into the cache's pool; the graph is
        kept under `key`. The capture calls ``CUDAGraph.capture_begin`` and
        ``capture_end`` as ``torch.cuda.graph`` does, without that context's
        synchronization of the device and emptying of the device and
        pinned-host caches: in a stream those drained the groups queued
        ahead and made the next groups allocate their memory and pinned
        staging buffers anew."""
        main = torch.cuda.current_stream(self.device)
        with _capture_lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            body(*args)
            self._stream.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream), retain_device_matrices() as kept:
                # thread_local: the staging thread goes on uploading the next
                # group on its copy stream while this thread captures.
                graph.capture_begin(self._pool, capture_error_mode="thread_local")
                try:
                    outputs = body(*args)
                finally:
                    graph.capture_end()
            main.wait_stream(self._stream)
        self._graphs[key] = _Graph(graph, outputs, kept)


def _buffer_key(name: str, src) -> tuple:
    return (name, tuple(src.shape), src.dtype)


def _nbytes(src) -> int:
    return src.nbytes if isinstance(src, np.ndarray) else src.numel() * src.element_size()


def _pinned(arr: np.ndarray) -> torch.Tensor:
    """A host array copied into pinned memory from PyTorch's caching host
    allocator, which hands a block out again only after the copies that read
    it have finished: a copy from there to the card does not block, where
    one from pageable memory would wait for the stream's queued work."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned


def _span(trace, name: Optional[str]):
    return trace.span(name) if name is not None else contextlib.nullcontext()
