#!/usr/bin/env python3
"""Where a served request's time goes, on the GPU.

Run from a checkout of the repository on a machine with a CUDA device:

    python3 tools/torch_serve_profile.py

One text page (``chip_smoke.text_page()``, PNG from ``encode_png``) and the
shipped weights with default parameters. Medians of 20 after a warm-up, host
clock, each ending in ``torch.cuda.synchronize()``:

  * ``get_text`` on the main thread, on one long-lived thread, and on a
    fresh thread per call (as ``ThreadingHTTPServer`` runs each request);
    on a fresh thread also a single small op of each library the engine
    calls (an elementwise op, a bf16 product, a bf16 convolution), to find
    the per-thread set-up;
  * the parts of a request on the main thread: ``decode_image``,
    ``prepare_input`` + ``get_text_lines``, ``format_json_output``;
  * POST /ocr and /ocr/text to the handler of ``serve`` under a
    ``ThreadingHTTPServer`` (a thread per request, as the JAX package
    serves), with urllib's client, and with a client whose socket sends
    without delay (TCP_NODELAY) and writes the request in one piece; the
    same with the handler sending without delay (``disable_nagle_algorithm``);
    and ``serve`` itself (a pool of long-lived handler threads);
  * a handler that answers a fixed body without OCR: the HTTP cost alone;
  * the batching service's work on A4 pages at 150 dpi (drawn as
    ``chip_smoke.py`` draws them for the serving times), stage by stage and
    fenced: ``prepare_input`` of each page and the padded stack, then
    ``process_normalized``'s stages, for batches of 1, 4 and 8 pages; batches
    of 5 pages in six compositions, each run twice in a row (recognition
    batches of new shapes, then of shapes seen); the service without HTTP
    (8 closed-loop threads submitting decoded pages: requests/s, batch sizes,
    each batch's ms); the service behind the server under ``chip_smoke.py``'s
    load client, with the handlers decoding each PNG and with the decoding
    replaced by a look-up (what the handlers' work costs the batches); and
    ``get_text``'s stages on one such page (the server without the service).

Prints one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import http.client
import json
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def median_ms(fn, reps=20, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def urllib_post(port, path, body):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        return r.read()


def nodelay_post(port, path, body):
    """One request written in one piece from a socket without Nagle's delay."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    head = (
        f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Length: {len(body)}\r\n"
        "Content-Type: application/octet-stream\r\nConnection: close\r\n\r\n"
    ).encode()
    conn.sock.sendall(head + body)
    resp = http.client.HTTPResponse(conn.sock)
    resp.begin()
    data = resp.read()
    conn.close()
    assert resp.status == 200
    return data


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from ocrs_tpu_torch import serve as tserve
    from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
    from ocrs_tpu_torch.output import FormatJsonArgs, format_json_output
    from ocrs_tpu_torch.png import decode_image, encode_png
    from ocrs_tpu_torch.preprocess import DimOrder, ImageSource

    det = load_detection_model(REPO / "weights" / "text-detection.npz")
    rec = load_recognition_model(REPO / "weights" / "text-recognition.npz")
    engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=rec))
    body = encode_png(chip_smoke.text_page())
    rgb = decode_image(body)
    inp = engine.prepare_input(ImageSource.from_tensor(rgb, DimOrder.HWC))
    report = {"page_hw": list(rgb.shape[:2]), "png_bytes": len(body)}

    report["get_text_main_thread_ms"] = median_ms(lambda: engine.get_text(inp))

    def on_fresh_thread():
        t = threading.Thread(target=lambda: engine.get_text(inp))
        t.start()
        t.join()

    report["get_text_fresh_thread_ms"] = median_ms(on_fresh_thread)
    x = torch.randn(64, 64, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(8, 1, 3, 3, device="cuda", dtype=torch.bfloat16)
    ops = {
        "elementwise": lambda: x + 1,
        "bf16_matmul": lambda: x @ x,
        "bf16_conv2d": lambda: torch.nn.functional.conv2d(x[None, None], w),
    }
    for name, op in ops.items():

        def fresh(op=op):
            t = threading.Thread(target=op)
            t.start()
            t.join()

        report[f"fresh_thread_{name}_ms"] = median_ms(fresh)
        report[f"main_thread_{name}_ms"] = median_ms(op)
    calls, done = [], []
    cv = threading.Condition()

    def worker():
        while True:
            with cv:
                while not calls:
                    cv.wait()
                fn = calls.pop()
            fn()
            with cv:
                done.append(1)
                cv.notify_all()

    threading.Thread(target=worker, daemon=True).start()

    def on_worker():
        with cv:
            n = len(done)
            calls.append(lambda: engine.get_text(inp))
            cv.notify_all()
            while len(done) == n:
                cv.wait()

    report["get_text_long_lived_thread_ms"] = median_ms(on_worker)

    def session_lines():
        session = tserve.OcrSession(engine)
        session.load_image(rgb)
        return session.get_text_lines()

    lines = session_lines()
    report["parts_ms"] = {
        "decode_image": median_ms(lambda: decode_image(body)),
        "prepare_input_and_get_text_lines": median_ms(session_lines),
        "format_json_output": median_ms(
            lambda: format_json_output(FormatJsonArgs(input_path="<request>", input_hw=rgb.shape[:2], text_lines=lines))
        ),
    }

    servers = {}
    for nodelay in (False, True):
        handler = tserve.make_handler(engine)
        handler.disable_nagle_algorithm = nodelay
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers["thread_per_request_nodelay" if nodelay else "thread_per_request"] = server
    servers["serve_pooled"] = tserve.serve(engine, port=0)

    class Fixed(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(b"fixed answer")

    fixed = ThreadingHTTPServer(("127.0.0.1", 0), Fixed)
    threading.Thread(target=fixed.serve_forever, daemon=True).start()
    servers["fixed_answer"] = fixed
    want = engine.get_text(inp)
    for name, server in servers.items():
        port = server.server_address[1]
        for client_name, client in (("urllib", urllib_post), ("nodelay_client", nodelay_post)):
            for path in ("/ocr", "/ocr/text"):
                if name == "fixed_answer" and path == "/ocr":
                    continue
                key = f"{name}.{client_name}.{path}"
                report[key + "_ms"] = median_ms(lambda: client(port, path, body))
                if name != "fixed_answer" and path == "/ocr/text":
                    assert client(port, path, body).decode() == want
    for server in servers.values():
        server.shutdown()
        server.server_close()

    # The service's work on A4 pages at 150 dpi, stage by stage.
    import torch.nn.functional as F

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.parallel.pipeline import PagePipeline
    from ocrs_tpu_torch.preprocess import BLACK_VALUE
    from ocrs_tpu_torch.utils.tracing import StageTimer

    a4 = [
        chip_smoke.full_page(
            seed, hw=chip_smoke.A4_150_HW, scale=chip_smoke.A4_150_SCALE, pitch=chip_smoke.A4_150_PITCH, left=chip_smoke.A4_150_LEFT
        )[0]
        for seed in range(8)
    ]
    a4_rgb = [decode_image(encode_png(p)) for p in a4]
    report["a4_decode_image_ms"] = median_ms(lambda: decode_image(encode_png(a4[0])), reps=5) - median_ms(
        lambda: encode_png(a4[0]), reps=5
    )
    pipe = PagePipeline(det, rec, DEFAULT_ALPHABET, max_lines_per_batch=128)

    def stack(imgs):
        images = [engine.prepare_input(ImageSource.from_tensor(im, DimOrder.HWC)).image[0] for im in imgs]
        h, w = max(i.shape[0] for i in images), max(i.shape[1] for i in images)
        return torch.stack([F.pad(i, (0, w - i.shape[1], 0, h - i.shape[0]), value=BLACK_VALUE) for i in images])

    def stages(fn, reps=3):
        runs = []
        for _ in range(reps + 1):
            timer = StageTimer(fence_device="cuda")
            fn(timer)
            runs.append(timer.timings)
        return {k: statistics.median(r[k] for r in runs[1:]) * 1e3 for k in runs[0]}

    for b in (1, 4, 8):

        def service_batch(timer, b=b):
            with timer.stage("prepare_and_stack"):
                pages = stack(a4_rgb[:b])
            pipe.process_normalized(pages, timer=timer)

        report[f"a4_service_batch_{b}_stages_ms"] = stages(service_batch)
    # Batches of 5 pages in six compositions, each run twice in a row: the
    # first run of a composition meets recognition batches of new shapes
    # (the lines' count and widest crop), the second finds them seen.
    firsts, seconds = [], []
    for k in range(6):
        pages = stack([a4_rgb[(k + i) % 8] for i in range(5)])
        for times in (firsts, seconds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.process_normalized(pages)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    report["a4_batch_5_new_compositions_first_run_ms"] = firsts
    report["a4_batch_5_new_compositions_second_run_ms"] = seconds
    # The service without HTTP: 8 closed-loop threads submit decoded pages
    # and wait for their results, 8 times each, after a warm-up round.
    from ocrs_tpu_torch.serve import BatchingOcrService

    service = BatchingOcrService(engine, det, rec, DEFAULT_ALPHABET, max_batch=8, max_wait_ms=15.0)

    def submit_load():
        def client(c):
            for k in range(8):
                service.submit(a4_rgb[(c + k) % 8]).result(timeout=600)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    submit_load()
    service.batch_sizes.clear()
    service.batch_ms.clear()
    seconds = submit_load()
    report["a4_service_without_http"] = {
        "requests_per_s": 64 / seconds,
        "batch_sizes": list(service.batch_sizes),
        "batch_ms": list(service.batch_ms),
    }
    # The same service behind the server, loaded by chip_smoke.LOAD_CLIENT (a
    # client process of its own, 8 threads x 8 requests of /ocr/text), with
    # the handlers decoding each PNG, and with the decoding replaced by a
    # look-up of the already decoded page: what the handlers' work under the
    # interpreter lock costs the worker's batches.
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="serve_profile_", dir=REPO / "build"))
    bodies = [encode_png(p) for p in a4]
    paths = []
    for i, b in enumerate(bodies):
        paths.append(work / f"page-{i}.png")
        paths[-1].write_bytes(b)
    decoded = dict(zip(bodies, a4_rgb))
    original = tserve.decode_image
    for name, decode in (("decoding", original), ("decoded_beforehand", decoded.__getitem__)):
        tserve.decode_image = decode
        server = tserve.serve(engine, port=0, service=service)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        cmd = [sys.executable, "-c", chip_smoke.LOAD_CLIENT, base, "8", "8", *map(str, paths)]
        subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=True)  # warm-up
        service.batch_sizes.clear()
        service.batch_ms.clear()
        out = json.loads(subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=True).stdout)
        server.shutdown()
        server.server_close()
        assert not out["errors"], out["errors"]
        report[f"a4_service_http_{name}"] = {
            "requests_per_s": len(out["latencies_ms"]) / out["seconds"],
            "p50_ms": statistics.median(out["latencies_ms"]),
            "batch_sizes": list(service.batch_sizes),
            "batch_ms": list(service.batch_ms),
        }
    tserve.decode_image = original
    shutil.rmtree(work, ignore_errors=True)
    a4_input = engine.prepare_input(ImageSource.from_tensor(a4_rgb[0], DimOrder.HWC))

    def engine_page(timer):
        with timer.stage("detect_words"):
            words = engine.detect_words(a4_input)
        with timer.stage("find_text_lines"):
            lines = engine.find_text_lines(a4_input, words)
        with timer.stage("recognize_text"):
            engine.recognize_text(a4_input, lines)

    report["a4_get_text_stages_ms"] = stages(engine_page)
    report["a4_lines_per_page"] = len(engine.find_text_lines(a4_input, engine.detect_words(a4_input)))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    report["card"] = smi
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
