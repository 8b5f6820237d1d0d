"""Embedding / serving API: sessions, micro-batching and the HTTP server.

Port of ``ocrs_tpu.serve``. Upstream embeds its engine in browsers through a
wasm-bindgen API (ocrs/src/wasm_api.rs:11-367) with detection and
recognition callable apart (the Chrome extension recognizes lazily,
ocrs-extension/src/background.ts:196-211). Here that role is an in-process
session API plus an HTTP server for callers in other processes.

Method parity with the wasm API:

  * ``OcrSession.load_image``      <- ``OcrEngine.loadImage`` (wasm_api.rs:116-123)
  * ``OcrSession.detect_text``     <- ``detectText`` (wasm_api.rs:130-148):
    detection + line finding, returns line handles with word rects.
  * ``OcrSession.recognize_text``  <- ``recognizeText`` (wasm_api.rs:155-180):
    recognize a subset of previously detected lines (lazy recognition).
  * ``OcrSession.get_text``        <- ``getText`` (wasm_api.rs:186-190)
  * ``OcrSession.get_text_lines``  <- ``getTextLines`` (wasm_api.rs:197-214)

The HTTP layer (:func:`serve`) is a thin stdlib wrapper with the JAX
package's routes, status codes and bodies: POST /ocr with an image body
returns the JSON document, GET /healthz reports the engine's device, and the
session endpoints expose the same lifecycle to other processes (the `js/`
client uses them):

  * ``POST /session``                  image body -> ``{"id": ...}``
  * ``POST /session/<id>/detect``      -> detected lines with word rects
  * ``POST /session/<id>/recognize``   ``{"lines": [i, ...]}`` -> lazy
    per-line recognition (extension pattern, background.ts:196-211)
  * ``GET  /session/<id>/text``        -> full-pipeline plain text
  * ``DELETE /session/<id>``           -> drop the session
  * ``POST /ocr/detect``               stateless detect-only

Request bodies are decoded by :func:`png.decode_image`: PNG without any
imaging package, other formats through Pillow where it is installed.

Rect encodings mirror the wasm API: ``rect`` = [left, top, right, bottom]
(``boundingRect``), ``corners`` = flat [x0, y0, ... x3, y3]
(wasm_api.rs:263-269).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .engine import OcrEngine, OcrInput
from .geometry import RotatedRect
from .output import FormatJsonArgs, format_json_output
from .parallel.pipeline import PagePipeline
from .png import decode_image
from .preprocess import BLACK_VALUE, DimOrder, ImageSource
from .text_items import TextLine

#: Static assets for the browser overlay demo (GET /demo, GET /client.mjs).
_JS_DIR = Path(__file__).resolve().parent.parent / "js"

#: Threads that handle the server's requests. They live as long as the
#: server: a thread's first engine call pays PyTorch's per-thread CUDA set-up
#: (about 70 ms on an H100, against 25 ms for a whole ``get_text`` of a small
#: page), which a thread per request would pay on every request.
HANDLER_THREADS = 32


@dataclass
class DetectedLine:
    """A detected-but-not-yet-recognized line (wasm_api.rs ``DetectedLine``)."""

    index: int
    words: list[RotatedRect]


class OcrSession:
    """Stateful wrapper holding one prepared image, mirroring the wasm
    ``OcrEngine`` object lifecycle (wasm_api.rs:94-214)."""

    def __init__(self, engine: OcrEngine):
        self._engine = engine
        self._input: Optional[OcrInput] = None
        self._lines: Optional[list[DetectedLine]] = None

    def load_image(self, image: np.ndarray) -> None:
        """HWC u8/float array -> prepared input on the engine's device."""
        self._input = self._engine.prepare_input(ImageSource.from_tensor(np.asarray(image), DimOrder.HWC))
        self._lines = None

    def detect_text(self) -> list[DetectedLine]:
        """Detect words and group into lines (wasm_api.rs:130-148)."""
        if self._input is None:
            raise RuntimeError("no image loaded")
        words = self._engine.detect_words(self._input)
        lines = self._engine.find_text_lines(self._input, words)
        self._lines = [DetectedLine(i, list(l)) for i, l in enumerate(lines)]
        return self._lines

    def recognize_text(self, lines: Sequence[DetectedLine]) -> list[Optional[TextLine]]:
        """Recognize a subset of detected lines: the extension's lazy/eager
        hybrid pattern (background.ts:373-466)."""
        if self._input is None:
            raise RuntimeError("no image loaded")
        return self._engine.recognize_text(self._input, [l.words for l in lines])

    def get_text_lines(self) -> list[Optional[TextLine]]:
        if self._lines is None:
            self.detect_text()
        return self.recognize_text(self._lines)

    def get_text(self) -> str:
        return "\n".join(str(l) for l in self.get_text_lines() if l is not None)


class BatchingOcrService:
    """Micro-batching request queue: concurrent requests SHARE one
    detection forward AND pooled recognition batches.

    All waiting requests' pages are padded on the engine's device to the
    largest page in the batch (BLACK padding, outside every glyph), stacked,
    and run through :class:`~.parallel.pipeline.PagePipeline` on that device:
    ONE padded detection forward, batched layout, and pooled recognition, so
    4 concurrent requests cost about one detection dispatch and one
    recognition dispatch instead of four of each (the extension's batch-4
    eager recognition, background.ts:427-434). Mixed-size batches share one
    pad-to-max + resize geometry (the pipeline's law) instead of each image
    resizing on its own (detection.rs:148-171).

    The worker thread runs inside ``torch.cuda.device`` of the engine's
    device (a thread's current device and stream are its own). An error in a
    batch, a CUDA error included, fails every future of that batch."""

    def __init__(
        self,
        engine: OcrEngine,
        detection_model,
        recognition_model,
        alphabet: str,
        max_batch: int = 8,
        max_wait_ms: float = 15.0,
    ):
        self._engine = engine
        self._pipeline = PagePipeline(
            detection_model, recognition_model, alphabet, max_lines_per_batch=128, device=engine.device
        )
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._queue: list[tuple[np.ndarray, Future]] = []
        self._cv = threading.Condition()
        self._gate = threading.Event()  # tests clear this to force batching
        self._gate.set()
        self.batch_sizes: list[int] = []  # observability: per-batch sizes
        self.batch_ms: list[float] = []  # and each batch's wall ms, up to its results
        self._thread = threading.Thread(target=self._worker, name="ocrs-batching-worker", daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue an HWC image; returns a Future resolving to the list of
        recognized TextLines (None entries for undecodable lines)."""
        fut: Future = Future()
        with self._cv:
            self._queue.append((np.asarray(image), fut))
            self._cv.notify()
        return fut

    def _collect(self) -> list[tuple[np.ndarray, Future]]:
        with self._cv:
            while not self._queue:
                self._cv.wait()
            deadline = time.monotonic() + self._max_wait
            while len(self._queue) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break
            batch, self._queue = self._queue[: self._max_batch], self._queue[self._max_batch :]
            return batch

    def _worker(self) -> None:
        dev = self._engine.device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while True:
                self._run_batch(self._collect())

    def _run_batch(self, batch: list[tuple[np.ndarray, Future]]) -> None:
        self._gate.wait()
        with self._cv:  # drain anything that arrived while gated
            extra = self._queue[: self._max_batch - len(batch)]
            self._queue = self._queue[len(extra) :]
            batch.extend(extra)
        self.batch_sizes.append(len(batch))
        t0 = time.perf_counter()
        try:
            images = [
                self._engine.prepare_input(ImageSource.from_tensor(img, DimOrder.HWC)).image[0] for img, _ in batch
            ]
            # One padded stack (word and line coordinates are page-local;
            # BLACK padding is outside every glyph), then the whole
            # pipeline: one detection forward, batched layout, pooled
            # recognition.
            h_max = max(i.shape[0] for i in images)
            w_max = max(i.shape[1] for i in images)
            stack = torch.stack(
                [F.pad(i, (0, w_max - i.shape[1], 0, h_max - i.shape[0]), value=BLACK_VALUE) for i in images]
            )
            pages = self._pipeline.process_normalized(stack)
            for (_, fut), page in zip(batch, pages):
                fut.set_result(page.text_lines)
        except Exception as exc:  # noqa: BLE001 - fail the whole batch, keep serving
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
        finally:
            self.batch_ms.append((time.perf_counter() - t0) * 1e3)


def _rect_json(r) -> list[float]:
    """[left, top, right, bottom] like wasm boundingRect."""
    return [float(r.left), float(r.top), float(r.right), float(r.bottom)]


def _rrect_json(rr: RotatedRect) -> dict:
    """Bounding rect + flat corners, wasm_api.rs:263-269 encoding."""
    br = rr.bounding_rect()
    corners = [float(v) for c in rr.corners() for v in c]
    return {"rect": _rect_json(br), "corners": corners}


def _detected_lines_json(lines: list[DetectedLine]) -> dict:
    return {"lines": [{"index": l.index, "words": [_rrect_json(w) for w in l.words]} for l in lines]}


def _recognized_json(indexes, text_lines) -> dict:
    out = []
    for idx, tl in zip(indexes, text_lines):
        if tl is None:
            out.append({"index": idx, "text": None, "words": []})
            continue
        words = [{"text": str(w), "rect": _rect_json(w.bounding_rect())} for w in tl.words()]
        out.append({"index": idx, "text": str(tl), "words": words})
    return {"lines": out}


def _device_names(dev: torch.device) -> list[str]:
    """The engine's device for /healthz: the card's name where it is CUDA."""
    if dev.type != "cuda":
        return [str(dev)]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return [f"cuda:{index} {torch.cuda.get_device_name(index)}"]


class SessionStore:
    """In-memory session map with TTL eviction for the HTTP session API."""

    def __init__(self, engine: OcrEngine, ttl_s: float = 300.0, max_sessions: int = 32):
        self._engine = engine
        self._ttl = ttl_s
        self._max = max_sessions
        self._lock = threading.Lock()
        self._sessions: dict[str, tuple[float, OcrSession]] = {}

    def _evict_locked(self) -> None:
        now = time.monotonic()
        dead = [k for k, (t, _) in self._sessions.items() if now - t > self._ttl]
        for k in dead:
            del self._sessions[k]
        while len(self._sessions) >= self._max:
            oldest = min(self._sessions, key=lambda k: self._sessions[k][0])
            del self._sessions[oldest]

    def create(self, image: np.ndarray) -> str:
        session = OcrSession(self._engine)
        session.load_image(image)
        sid = uuid.uuid4().hex[:16]
        with self._lock:
            self._evict_locked()
            self._sessions[sid] = (time.monotonic(), session)
        return sid

    def get(self, sid: str) -> Optional[OcrSession]:
        with self._lock:
            entry = self._sessions.get(sid)
            if entry is None:
                return None
            self._sessions[sid] = (time.monotonic(), entry[1])
            return entry[1]

    def delete(self, sid: str) -> bool:
        with self._lock:
            return self._sessions.pop(sid, None) is not None


def make_handler(engine: OcrEngine, service: Optional[BatchingOcrService] = None):
    sessions = SessionStore(engine)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, obj, code: int = 200) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _session_route(self):
            """Parse /session/<id>/<verb> -> (session, verb) or respond."""
            parts = self.path.strip("/").split("/")
            if len(parts) < 2:
                self.send_error(404)
                return None
            session = sessions.get(parts[1])
            if session is None:
                self.send_error(404, "unknown session")
                return None
            return session, (parts[2] if len(parts) > 2 else "")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json({"status": "ok", "devices": _device_names(engine.device)})
            elif self.path in ("/demo", "/demo/"):
                # Browser overlay demo (the reference Chrome extension's UX,
                # content.ts:68-180, as a served page), same-origin so that
                # no CORS setup is needed.
                p = _JS_DIR / "examples" / "overlay.html"
                if not p.exists():
                    self.send_error(404, "overlay.html not found")
                    return
                self._reply(200, p.read_bytes(), "text/html; charset=utf-8")
            elif self.path == "/client.mjs":
                p = _JS_DIR / "ocr-client.mjs"
                if not p.exists():
                    self.send_error(404, "ocr-client.mjs not found")
                    return
                self._reply(200, p.read_bytes(), "text/javascript; charset=utf-8")
            elif self.path.startswith("/session/"):
                route = self._session_route()
                if route is None:
                    return
                session, verb = route
                if verb != "text":
                    self.send_error(404)
                    return
                try:
                    text = session.get_text()
                except Exception as exc:  # noqa: BLE001 - report to client
                    self._reply(400, f"error: {exc}".encode(), "text/plain")
                    return
                self._reply(200, text.encode(), "text/plain; charset=utf-8")
            else:
                self.send_error(404)

        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if len(parts) == 2 and parts[0] == "session":
                if sessions.delete(parts[1]):
                    self._reply_json({"deleted": True})
                else:
                    self.send_error(404, "unknown session")
            else:
                self.send_error(404)

        def do_POST(self):
            try:
                if self.path in ("/ocr", "/ocr/text"):
                    self._post_ocr()
                elif self.path == "/ocr/detect":
                    session = OcrSession(engine)
                    session.load_image(decode_image(self._read_body()))
                    self._reply_json(_detected_lines_json(session.detect_text()))
                elif self.path == "/session":
                    self._reply_json({"id": sessions.create(decode_image(self._read_body()))})
                elif self.path.startswith("/session/"):
                    self._post_session()
                else:
                    self.send_error(404)
            except Exception as exc:  # noqa: BLE001 - report to client
                self._reply(400, f"error: {exc}".encode(), "text/plain")

        def _post_ocr(self):
            img = decode_image(self._read_body())
            if service is not None:
                text_lines = service.submit(img).result(timeout=600)
            else:
                session = OcrSession(engine)
                session.load_image(img)
                text_lines = session.get_text_lines()
            if self.path == "/ocr/text":
                body = "\n".join(str(l) for l in text_lines if l is not None).encode()
                self._reply(200, body, "text/plain; charset=utf-8")
            else:
                body = format_json_output(
                    FormatJsonArgs(input_path="<request>", input_hw=(img.shape[0], img.shape[1]), text_lines=text_lines)
                ).encode()
                self._reply(200, body, "application/json")

        def _post_session(self):
            route = self._session_route()
            if route is None:
                return
            session, verb = route
            if verb == "detect":
                self._reply_json(_detected_lines_json(session.detect_text()))
            elif verb == "recognize":
                req = json.loads(self._read_body() or b"{}")
                if session._lines is None:
                    session.detect_text()
                lines = session._lines
                indexes = req.get("lines")
                if indexes is None:
                    indexes = [l.index for l in lines]
                text_lines = session.recognize_text([lines[i] for i in indexes])
                self._reply_json(_recognized_json(indexes, text_lines))
            else:
                self.send_error(404)

    return Handler


class PooledHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` whose requests run on a pool of
    :data:`HANDLER_THREADS` long-lived threads instead of a new thread each."""

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self._pool = ThreadPoolExecutor(max_workers=HANDLER_THREADS, thread_name_prefix="ocrs-http")

    def process_request(self, request, client_address):
        self._pool.submit(self.process_request_thread, request, client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=True)


def serve(
    engine: OcrEngine,
    host: str = "127.0.0.1",
    port: int = 8765,
    service: Optional[BatchingOcrService] = None,
) -> PooledHTTPServer:
    """Start the HTTP server in a background thread; returns the server
    (call ``.shutdown()`` to stop, then ``.server_close()`` to release the
    port and the handler threads). Pass a :class:`BatchingOcrService` to
    share recognition batches across concurrent POSTs."""
    server = PooledHTTPServer((host, port), make_handler(engine, service))
    thread = threading.Thread(target=server.serve_forever, name="ocrs-http-server", daemon=True)
    thread.start()
    return server
