"""The port's serving path (ocrs_tpu_torch/serve.py) against the JAX
package's (ocrs_tpu/serve.py): the counterparts of the serving tests in
tests/test_serve_train.py, each run on the port's server and on JAX's with
the same request bodies, with the fake models and with the shipped weights
on the text page. Texts must be equal; rounded vertices within 1 px (the two
U-Nets compute in bf16); with the fake models everything is equal.

Also: the micro-batching service (one detection dispatch per gated batch,
mixed page sizes), and ``cuda_build.load`` under threads.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from ocrs_tpu.engine import OcrEngine as JaxEngine
from ocrs_tpu.engine import OcrEngineParams as JaxParams
from ocrs_tpu.models.fakes import FakeDetectionModel as JaxFakeDetectionModel
from ocrs_tpu.models.fakes import FakeRecognitionModel as JaxFakeRecognitionModel
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu import serve as jserve
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import cuda_build
from ocrs_tpu_torch import serve as tserve
from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.png import encode_png
from test_torch_support import (
    DET_WEIGHTS,
    REC_WEIGHTS,
    assert_same_ocr_json,
    jax_native,  # noqa: F401 - a fixture, used by pytestmark
    text_page_rgb,
)

# The JAX engine's layout and CTC collapse take its native library.
pytestmark = pytest.mark.usefixtures("jax_native")

ALPHABET = ot.DEFAULT_ALPHABET[:63]


def _fake_engines():
    port = ot.OcrEngine(
        ot.OcrEngineParams(detection_model=FakeDetectionModel(), recognition_model=FakeRecognitionModel(), alphabet=ALPHABET),
        device="cpu",
    )
    jax = JaxEngine(
        JaxParams(detection_model=JaxFakeDetectionModel(), recognition_model=JaxFakeRecognitionModel(), alphabet=ALPHABET)
    )
    return port, jax


def _word_image():
    img = np.zeros((100, 200, 3), dtype=np.float32)
    img[30:50, 20:90] = 1.0
    img[30:50, 110:180] = 1.0
    return img


def _corners(words):
    return sorted(tuple(sorted((round(float(x), 3), round(float(y), 3)) for x, y in w.corners())) for w in words)


def test_session_lazy_recognition():
    port, jax = _fake_engines()
    sessions = [tserve.OcrSession(port), jserve.OcrSession(jax)]
    for s in sessions:
        s.load_image(_word_image())
    detected = [s.detect_text() for s in sessions]
    assert len(detected[0]) >= 1
    assert [l.index for l in detected[0]] == [l.index for l in detected[1]]
    for a, b in zip(*detected):
        assert _corners(a.words) == _corners(b.words)
    # Recognize only the first line (the extension's lazy pattern).
    first = [s.recognize_text(d[:1]) for s, d in zip(sessions, detected)]
    assert len(first[0]) == 1 and str(first[0][0]) == str(first[1][0])
    # Full text then covers all lines.
    assert sessions[0].get_text() == sessions[1].get_text() != ""
    assert [str(l) for l in sessions[0].get_text_lines()] == [str(l) for l in sessions[1].get_text_lines()]


def test_session_requires_image():
    port, _ = _fake_engines()
    session = tserve.OcrSession(port)
    with pytest.raises(RuntimeError, match="no image"):
        session.detect_text()
    with pytest.raises(RuntimeError, match="no image"):
        session.recognize_text([])


def _request(base, path, data=None, method=None):
    """(status, content type, body) of one request; errors are answers too."""
    req = urllib.request.Request(f"{base}{path}", data=data, method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture(scope="module")
def servers():
    """Port and JAX servers, on the fake models and on the shipped weights."""
    port_fake, jax_fake = _fake_engines()
    port_real = ot.OcrEngine(
        ot.OcrEngineParams(
            detection_model=load_detection_model(DET_WEIGHTS), recognition_model=load_recognition_model(REC_WEIGHTS)
        ),
        device="cpu",
    )
    jax_real = JaxEngine(
        JaxParams(
            detection_model=jax_load_detection_model(DET_WEIGHTS),
            recognition_model=jax_load_recognition_model(REC_WEIGHTS),
        )
    )
    started = {
        "fake": (tserve.serve(port_fake, port=0), jserve.serve(jax_fake, port=0)),
        "real": (tserve.serve(port_real, port=0), jserve.serve(jax_real, port=0)),
    }
    yield {k: tuple(f"http://127.0.0.1:{s.server_address[1]}" for s in pair) for k, pair in started.items()}
    for pair in started.values():
        for s in pair:
            s.shutdown()
            s.server_close()


def _bodies(kind):
    if kind == "fake":
        return encode_png((_word_image() * 255).astype(np.uint8))
    return encode_png(text_page_rgb())


@pytest.mark.parametrize("kind", ["fake", "real"])
def test_http_server_roundtrip(servers, kind):
    port_base, jax_base = servers[kind]
    png = _bodies(kind)
    status, ctype, body = _request(port_base, "/healthz")
    health = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert health == {"status": "ok", "devices": ["cpu"]}
    assert set(health) == set(json.loads(_request(jax_base, "/healthz")[2]))

    got, want = (_request(base, "/ocr", png) for base in (port_base, jax_base))
    assert got[:2] == want[:2] == (200, "application/json")
    doc = json.loads(got[2])
    h, w = (100, 200) if kind == "fake" else text_page_rgb().shape[:2]
    assert doc["image_height"] == h and doc["image_width"] == w and doc["url"] == "<request>"
    if kind == "fake":
        assert doc == json.loads(want[2])
    else:
        assert_same_ocr_json(doc, json.loads(want[2]))
        assert [l["text"] for l in doc["paragraphs"][0]["lines"]] == ["Section 12 notes", "This line is longer"]
    text = [_request(base, "/ocr/text", png) for base in (port_base, jax_base)]
    assert text[0] == text[1] and text[0][0] == 200 and text[0][2].decode() != ""

    # probe: garbage body -> clean 400; unknown routes -> 404
    for base in (port_base, jax_base):
        status, _, body = _request(base, "/ocr", b"not an image")
        assert status == 400 and body.startswith(b"error: ")
        assert _request(base, "/nowhere", b"")[0] == _request(base, "/nowhere")[0] == 404


def test_http_demo_assets_served(servers):
    port_base, jax_base = servers["fake"]
    for path, ctype, needle in (("/demo", "text/html", "/client.mjs"), ("/client.mjs", "text/javascript", "OcrClient")):
        got, want = _request(port_base, path), _request(jax_base, path)
        assert got == want
        assert got[0] == 200 and ctype in got[1] and needle in got[2].decode()
    assert _request(port_base, "/demo/")[2] == _request(port_base, "/demo")[2]


@pytest.mark.parametrize("kind", ["fake", "real"])
def test_http_session_api_lazy_recognition(servers, kind):
    """Session endpoints mirror the wasm OcrEngine lifecycle over HTTP
    (load -> detect -> lazy recognize subset -> full text -> delete)."""
    png = _bodies(kind)
    answers = []
    for base in servers[kind]:
        run = {}

        def post(path, data=b""):
            status, _, body = _request(base, path, data)
            assert status == 200, (path, status, body)
            return json.loads(body)

        run["detect"] = post("/ocr/detect", png)
        sid = post("/session", png)["id"]
        run["session_detect"] = post(f"/session/{sid}/detect")
        run["recognize"] = post(f"/session/{sid}/recognize", json.dumps({"lines": [0]}).encode())
        run["recognize_all"] = post(f"/session/{sid}/recognize")
        run["text"] = _request(base, f"/session/{sid}/text")
        run["bad_verb"] = _request(base, f"/session/{sid}/nothing")[0], _request(base, f"/session/{sid}/nothing", b"")[0]
        run["delete"] = _request(base, f"/session/{sid}", method="DELETE")[2]
        run["after"] = (
            _request(base, f"/session/{sid}/detect", b"")[0],
            _request(base, f"/session/{sid}/text")[0],
            _request(base, f"/session/{sid}", method="DELETE")[0],
        )
        answers.append(run)
    got, want = answers
    assert len(got["detect"]["lines"]) >= 1 and got["detect"] == got["session_detect"]
    assert len(got["detect"]["lines"][0]["words"][0]["corners"]) == 8
    atol = 1e-6 if kind == "fake" else 1.0
    for key in ("detect", "session_detect"):
        assert [l["index"] for l in got[key]["lines"]] == [l["index"] for l in want[key]["lines"]]
        for gl, wl in zip(got[key]["lines"], want[key]["lines"]):
            assert len(gl["words"]) == len(wl["words"])
            a = sorted(tuple(np.round(np.reshape(w["corners"], (4, 2)), 3).tolist()) for w in gl["words"])
            b = sorted(tuple(np.round(np.reshape(w["corners"], (4, 2)), 3).tolist()) for w in wl["words"])
            np.testing.assert_allclose(np.array(a), np.array(b), atol=atol)
    for key in ("recognize", "recognize_all"):
        assert [(l["index"], l["text"], [w["text"] for w in l["words"]]) for l in got[key]["lines"]] == [
            (l["index"], l["text"], [w["text"] for w in l["words"]]) for l in want[key]["lines"]
        ]
        for gl, wl in zip(got[key]["lines"], want[key]["lines"]):
            for gw, ww in zip(gl["words"], wl["words"]):
                np.testing.assert_allclose(gw["rect"], ww["rect"], atol=atol)
    assert len(got["recognize"]["lines"]) == 1 and got["recognize"]["lines"][0]["index"] == 0
    assert got["text"][0] == 200 and got["text"][2] == want["text"][2]
    assert got["bad_verb"] == want["bad_verb"] == (404, 404)
    assert json.loads(got["delete"]) == json.loads(want["delete"]) == {"deleted": True}
    assert got["after"] == want["after"] == (404, 404, 404)


def test_session_store_ttl_and_cap(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(tserve, "time", types.SimpleNamespace(monotonic=lambda: now[0]))
    port, _ = _fake_engines()
    store = tserve.SessionStore(port, ttl_s=5.0, max_sessions=3)
    img = _word_image()
    ids = []
    for _ in range(4):
        ids.append(store.create(img))
        now[0] += 1.0
    # The cap evicts the oldest before a new one is stored.
    assert store.get(ids[0]) is None and all(store.get(i) is not None for i in ids[1:])
    now[0] += 3.0  # a get renews a session: ids[1:] were read at 104
    assert store.get(ids[1]) is not None
    now[0] += 3.0  # 110: ids[2:] idle for 6 s, ids[1] for 3 s
    fresh = store.create(img)
    assert [store.get(i) is not None for i in ids] == [False, True, False, False] and store.get(fresh) is not None
    assert store.delete(fresh) and not store.delete(fresh)


def _gated_service(module, engine, images, det, rec):
    """Submit `images` to a service whose worker is held, then release it;
    returns (results, batch sizes, detection dispatch sizes)."""
    service = module.BatchingOcrService(engine, det, rec, ALPHABET, max_batch=8, max_wait_ms=50.0)
    service._gate.clear()  # hold the worker so all submissions coalesce
    detect_calls = []
    inner_detect = service._pipeline._detect_tables
    service._pipeline._detect_tables = lambda pages: (detect_calls.append(int(pages.shape[0])), inner_detect(pages))[1]
    futs = [service.submit(img) for img in images]
    time.sleep(0.1)
    service._gate.set()
    results = [f.result(timeout=300) for f in futs]
    if module is tserve:  # the port also times each batch
        assert len(service.batch_ms) == len(service.batch_sizes) and min(service.batch_ms) > 0
    return results, service.batch_sizes, detect_calls


def _texts(results):
    return ["\n".join(str(l) for l in tls if l is not None) for tls in results]


@pytest.mark.parametrize("sizes", ["same", "mixed"])
def test_batching_service_shares_recognition_batches(sizes):
    """Concurrent submissions execute as ONE pooled batch with ONE detection
    dispatch and read what the single-image session path reads, and what
    the JAX package's service reads."""
    images = []
    for k in range(4):
        # Mixed pages fit the fake detector's 200 x 100 input, so neither the
        # batch's pad-to-max nor a page alone is resized.
        hw = (100, 200) if sizes == "same" else ((100, 90), (150, 80), (120, 100), (90, 70))[k]
        img = np.zeros((*hw, 3), dtype=np.float32)
        if sizes == "same":
            img[30:50, 20 + 4 * k : 90 + 4 * k] = 1.0
        else:
            img[20 + 5 * k : 40 + 5 * k, 10 : hw[1] - 10 - 3 * k] = 1.0
            img[hw[0] - 30 : hw[0] - 15, 15 : 40 + 5 * k] = 1.0
        images.append(img)
    port, jax = _fake_engines()
    results, batch_sizes, detect_calls = _gated_service(tserve, port, images, FakeDetectionModel(), FakeRecognitionModel())
    assert batch_sizes == [4]  # one shared batch, not 4 singles
    assert detect_calls == [4]  # ONE detect dispatch for the whole batch
    sessions = []
    for img in images:
        session = tserve.OcrSession(port)
        session.load_image(img)
        sessions.append(session.get_text_lines())
    assert _texts(results) == _texts(sessions) and all(_texts(results))
    jresults, jbatch, jdetect = _gated_service(jserve, jax, images, JaxFakeDetectionModel(), JaxFakeRecognitionModel())
    assert jbatch == [4] and jdetect == [4]
    assert _texts(results) == _texts(jresults)


def test_batching_service_fails_every_future_of_a_failed_batch_and_serves_on():
    port, _ = _fake_engines()
    good = _word_image()
    bad = np.zeros((100, 200, 2), np.float32)  # two channels: refused by prepare_input
    service = tserve.BatchingOcrService(port, FakeDetectionModel(), FakeRecognitionModel(), ALPHABET, max_wait_ms=50.0)
    assert service._pipeline.device == port.device and service._thread.name == "ocrs-batching-worker"
    service._gate.clear()
    futs = [service.submit(good), service.submit(bad)]
    time.sleep(0.1)
    service._gate.set()
    for f in futs:
        with pytest.raises(ot.ImageSourceError):
            f.result(timeout=300)
    # The worker goes on with the next batch.
    assert _texts([service.submit(good).result(timeout=300)]) == [_session_text(port, good)]


def _session_text(engine, img):
    session = tserve.OcrSession(engine)
    session.load_image(img)
    return session.get_text()


def test_server_with_service_answers_as_without(servers):
    port, _ = _fake_engines()
    service = tserve.BatchingOcrService(port, FakeDetectionModel(), FakeRecognitionModel(), ALPHABET)
    server = tserve.serve(port, port=0, service=service)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        png = _bodies("fake")
        results = [None] * 3

        def call(i):
            results[i] = _request(base, "/ocr", png)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        want = _request(servers["fake"][0], "/ocr", png)
        assert all(r == want for r in results) and sum(service.batch_sizes) == 3
    finally:
        server.shutdown()
        server.server_close()


def test_cuda_build_load_from_two_threads_builds_once(tmp_path, monkeypatch):
    """Two threads that first reach a kernel together: one nvcc run, into a
    temporary file named by process and thread, moved into place; the other
    thread waits for it and loads the same library."""
    nvcc_runs = []

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]
            nvcc_runs.append(self.out)
            self.returncode = 0

        def communicate(self):
            time.sleep(0.2)  # long enough for the other thread to arrive
            with open(self.out, "wb") as f:
                f.write(b"\x7fELF")
            return "ptxas info", None

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    opened = []
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: opened.append(path) or object())
    barrier = threading.Barrier(2)
    libs = [None, None]

    def first_use(i):
        barrier.wait(timeout=30)
        libs[i] = cuda_build.load("gru_seq")

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(nvcc_runs) == 1 and len(opened) == 1
    assert libs[0] is libs[1] is not None
    assert f".{os.getpid()}-" in nvcc_runs[0] and nvcc_runs[0].endswith(".tmp")
    assert sorted(p.name for p in tmp_path.iterdir()) == [cuda_build.library_path("gru_seq").name]
    assert cuda_build.load("gru_seq") is libs[0] and len(nvcc_runs) == 1
    # A failed build raises with the compiler's output; nothing falls back.
    monkeypatch.setattr(cuda_build, "_loaded", {})
    (tmp_path / cuda_build.library_path("gru_seq").name).unlink()

    class FailingNvcc(FakeNvcc):
        def communicate(self):
            self.returncode = 1
            return "error: no such architecture", None

    monkeypatch.setattr(cuda_build.subprocess, "Popen", FailingNvcc)
    with pytest.raises(RuntimeError, match="no such architecture"):
        cuda_build.load("gru_seq")


def test_server_runs_requests_on_long_lived_handler_threads():
    """A thread's first engine call pays PyTorch's per-thread CUDA set-up, so
    the server keeps a pool of handler threads instead of one per request."""
    port, _ = _fake_engines()
    seen = []
    detect = port.detect_words
    port.detect_words = lambda inp: (seen.append(threading.current_thread()), detect(inp))[1]
    server = tserve.serve(port, port=0)
    assert isinstance(server, tserve.PooledHTTPServer)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    png = _bodies("fake")
    try:
        answers = [_request(base, "/ocr/text", png) for _ in range(4)]
    finally:
        server.shutdown()
        server.server_close()
    assert len({a for a in answers}) == 1 and answers[0][0] == 200
    assert len(seen) == 4 and all(t.name.startswith("ocrs-http") for t in seen)
    assert len(set(seen)) < 4  # threads are reused
    assert set(seen) <= set(server._pool._threads) and not any(t.is_alive() for t in seen)
