"""The port's ``PagePipeline(mesh=...)`` on the CPU against its unsharded
pipeline and against the JAX pipeline under ``mesh=make_data_mesh(n)`` (on
the 8 virtual JAX devices of tests/conftest.py).

Meshes of 2 and 4 CPU entries: the fake models on the 8 pages of
tests/test_parallel.py, and the shipped U-Net and ConvCTC on 4 pages of
800 x 608 drawn as ``__graft_entry__._dryrun_real_arch_pipeline`` draws them.
Text must be equal, with the same number of words per page: exactly among
the port's runs and the JAX runs. Between the two packages the shipped
ConvCTC computes in bf16, and Pillow's face is read at near-ties ("ocr" as
"oer" or "oeer"): there a frame may flip, so each frame whose label differs
on the same crops must be a near-tie (top-2 margin within
``chip_smoke.FLIP_MARGIN_MAX`` nats) and the texts may differ by no more
characters than frames flipped. Also
``process_stream`` and ``process_normalized`` under a mesh, ``"auto"`` ->
``"hbm"``, ``"lowbw"`` under a mesh, the CRNN under a mesh (each shard is
the unsharded pipeline on its slice), one thread per entry with the models
shared where entries repeat a device, and uneven groups raising as JAX's do.
"""

import difflib
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from ocrs_tpu.models.fakes import FakeDetectionModel as JaxFakeDetectionModel
from ocrs_tpu.models.fakes import FakeRecognitionModel as JaxFakeRecognitionModel
from ocrs_tpu.models.weights import load_detection_model as jax_load_detection_model
from ocrs_tpu.models.weights import load_recognition_model as jax_load_recognition_model
from ocrs_tpu.parallel.pipeline import PagePipeline as JaxPagePipeline
from ocrs_tpu.parallel.sharding import make_data_mesh as jax_make_data_mesh
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import native
from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.parallel.dryrun import _dryrun_pages
from ocrs_tpu_torch.parallel.sharding import make_data_mesh
from ocrs_tpu_torch.utils.tracing import StageTimer
from test_torch_support import jax_native  # noqa: F401 - a fixture, used by pytestmark

# Held against JAX routes that take the JAX package's native library.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parent.parent
ALPHABET = ot.DEFAULT_ALPHABET[:63]


def _cpu_mesh(n):
    return make_data_mesh(n, device_type="cpu")


def _fake_pages(n=8, shift=0):
    """tests/test_parallel.py's pages: a white word block on each."""
    pages = np.zeros((n, 100, 200), dtype=np.float32)
    for i in range(n):
        pages[i, 30:50, 20 + 5 * (i + shift) : 90 + 5 * (i + shift)] = 1.0
    return pages


def _fake_pipe(mesh=None, **kw):
    return ot.PagePipeline(
        FakeDetectionModel(), FakeRecognitionModel(), ALPHABET, max_lines_per_batch=8, mesh=mesh,
        device=None if mesh is not None else "cpu", **kw,
    )


def _jax_fake_pipe(mesh=None, **kw):
    return JaxPagePipeline(JaxFakeDetectionModel(), JaxFakeRecognitionModel(), ALPHABET, max_lines_per_batch=8,
                           mesh=mesh, **kw)


def _texts(results):
    return [r.text for r in results]


def _words(results):
    return [len(r.words) for r in results]


@pytest.mark.parametrize("n", [2, 4])
def test_fake_models_sharded_equal_unsharded_and_jax(n):
    pages = _fake_pages()
    plain = _fake_pipe().process(pages)
    sharded = _fake_pipe(_cpu_mesh(n)).process(pages)
    jax_sharded = _jax_fake_pipe(jax_make_data_mesh(n)).process(pages)
    assert len(plain) == len(sharded) == len(jax_sharded) == 8
    assert _texts(sharded) == _texts(plain) == _texts(jax_sharded)
    assert _words(sharded) == _words(plain) == _words(jax_sharded)
    assert any(t.strip() for t in _texts(plain))


@pytest.fixture(scope="module")
def real():
    """The shipped models of both packages, the 4 drawn pages, the JAX
    pipeline's results under a mesh of 4 and unsharded, and the port's
    unsharded results with the frames that flip against JAX's ConvCTC on
    the port's own crops (with the port's top-2 margins there)."""
    pages, drawn = _dryrun_pages(4)
    jdet = jax_load_detection_model(REPO / "weights" / "text-detection.npz")
    jrec = jax_load_recognition_model(REPO / "weights" / "text-recognition.npz")
    jax_sharded = JaxPagePipeline(jdet, jrec, ot.DEFAULT_ALPHABET, mesh=jax_make_data_mesh(4)).process(pages)
    jax_plain = JaxPagePipeline(jdet, jrec, ot.DEFAULT_ALPHABET).process(pages)
    det = load_detection_model(REPO / "weights" / "text-detection.npz")
    rec = load_recognition_model(REPO / "weights" / "text-recognition.npz")
    captured = []
    hook = rec.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0], out)))
    plain = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, device="cpu").process(pages)
    hook.remove()
    flips, margins = 0, []
    for x, lp in captured:
        jlp = torch.from_numpy(np.array(jrec.run(jnp.asarray(x.float().numpy())), np.float32))
        n, m = chip_smoke.frame_flips(lp.float(), jlp)
        flips, margins = flips + n, margins + m
    return {"pages": pages, "drawn": drawn, "det": det, "rec": rec, "jax": jax_sharded, "jax_plain": jax_plain,
            "plain": plain, "flips": flips, "margins": margins}


def _edits(a: str, b: str) -> int:
    """Characters inserted, deleted or replaced between `a` and `b`."""
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")


@pytest.mark.parametrize("n", [2, 4])
def test_shipped_models_sharded_equal_unsharded_and_jax(real, n):
    sharded = ot.PagePipeline(real["det"], real["rec"], ot.DEFAULT_ALPHABET, mesh=_cpu_mesh(n)).process(real["pages"])
    assert _texts(sharded) == _texts(real["plain"])
    assert _texts(real["jax"]) == _texts(real["jax_plain"])
    assert _words(sharded) == _words(real["plain"]) == _words(real["jax"])
    assert [len(r.lines) for r in sharded] == [len(r.lines) for r in real["jax"]]
    # Against JAX: near-tie flips only, and no more differing characters.
    assert all(m <= chip_smoke.FLIP_MARGIN_MAX for m in real["margins"]), real["margins"]
    edits = sum(_edits(a, b) for a, b in zip(_texts(sharded), _texts(real["jax"])))
    assert edits <= real["flips"], (_texts(sharded), _texts(real["jax"]), real["flips"])
    # As the JAX dryrun asks: real text, on all pages but at most one.
    assert sum(bool(t.strip()) for t in _texts(sharded)) >= len(sharded) - 1


def test_process_stream_under_a_mesh_equals_per_group_process():
    groups = [_fake_pages(4, shift=g) for g in range(3)]
    serial = [_texts(_fake_pipe().process(g)) for g in groups]
    pipe = _fake_pipe(_cpu_mesh(2))
    streamed = pipe.process_stream(iter(groups))  # read lazily, group by group
    assert [_texts(r) for r in streamed] == serial
    assert [_words(r) for r in streamed] == [_words(_fake_pipe().process(g)) for g in groups]
    assert pipe.process_stream([]) == []


def test_process_normalized_under_a_mesh_takes_shards_or_one_tensor():
    pages = _fake_pages()
    pipe = _fake_pipe(_cpu_mesh(4))
    want = _texts(_fake_pipe().process(pages))
    staged = pipe._stage_pages(pages)
    assert isinstance(staged, list) and [tuple(s.shape) for s in staged] == [(2, 100, 200)] * 4
    assert _texts(pipe.process_normalized(staged)) == want
    timer = StageTimer()
    normalized = torch.from_numpy(pages) - 0.5  # pages in [0, 1] -> normalized
    assert _texts(pipe.process_normalized(normalized, timer=timer)) == want
    assert list(timer.timings) == ["shards"]


def test_auto_transport_is_hbm_under_a_mesh():
    assert _fake_pipe(_cpu_mesh(2))._transport == "hbm"
    assert _jax_fake_pipe(jax_make_data_mesh(2))._transport == "hbm"
    assert all(shard._transport == "hbm" for shard in _fake_pipe(_cpu_mesh(2))._shards)


def test_lowbw_under_a_mesh_stages_as_hbm_and_needs_the_native_library():
    if not native.available():
        pytest.skip(f"the native library cannot be built here: {native.build_error()}")
    pages = (_fake_pages(4) * 255).astype(np.uint8)
    hbm = _fake_pipe(_cpu_mesh(2), transport="hbm").process(pages)
    low = _fake_pipe(_cpu_mesh(2), transport="lowbw")
    assert low._transport == "lowbw" and all(shard._transport == "hbm" for shard in low._shards)
    got = low.process(pages)
    jax_low = _jax_fake_pipe(jax_make_data_mesh(2), transport="lowbw").process(pages)
    assert _texts(got) == _texts(hbm) == _texts(jax_low)
    assert _words(got) == _words(hbm) == _words(jax_low)
    with native.disabled(), pytest.raises(RuntimeError, match="native"):
        _fake_pipe(_cpu_mesh(2), transport="lowbw")


def test_crnn_under_a_mesh_is_each_shard_unsharded():
    """Recognition batches pool per shard, so a random CRNN (whose text
    depends on its batch's padded width) reads each shard's pages as the
    unsharded pipeline reads that shard alone; the lines are the same."""
    rec = RecognitionModel.create(seed=0, n_classes=len(ALPHABET) + 1, hidden=16, arch="crnn")
    pages = _fake_pages()
    pipe = ot.PagePipeline(FakeDetectionModel(), rec, ALPHABET, max_lines_per_batch=8, mesh=_cpu_mesh(2))
    single = ot.PagePipeline(FakeDetectionModel(), rec, ALPHABET, max_lines_per_batch=8, device="cpu")
    sharded = pipe.process(pages)
    assert _texts(sharded) == _texts(single.process(pages[:4])) + _texts(single.process(pages[4:]))
    assert [len(r.lines) for r in sharded] == [len(r.lines) for r in single.process(pages)]
    assert any(t.strip() for t in _texts(sharded))


class _ThreadRecorder(FakeRecognitionModel):
    """The fake recognizer, noting the threads that ran it (by name and by
    identity)."""

    def __init__(self):
        super().__init__()
        self.threads = set()
        self.idents = set()
        self._lock = threading.Lock()

    def run(self, x):
        with self._lock:
            self.threads.add(threading.current_thread().name)
            self.idents.add(threading.get_ident())
        return super().run(x)


def test_one_thread_per_entry_and_models_shared_where_entries_repeat():
    rec = _ThreadRecorder()
    pipe = ot.PagePipeline(FakeDetectionModel(), rec, ALPHABET, max_lines_per_batch=8,
                           mesh=make_data_mesh(devices=["cpu", "cpu"]))
    assert [s.device for s in pipe._shards] == [torch.device("cpu")] * 2
    assert pipe._shards[0]._rec is pipe._shards[1]._rec is rec
    pipe.process(_fake_pages(4))
    assert rec.threads == {"ocrs-shard-0", "ocrs-shard-1"}


def test_shard_workers_live_across_calls():
    """Every entry point under a mesh runs on the same two worker threads,
    call after call: a fresh thread would set up its cuBLAS and cuDNN
    handles again."""
    rec = _ThreadRecorder()
    pipe = ot.PagePipeline(FakeDetectionModel(), rec, ALPHABET, max_lines_per_batch=8, mesh=_cpu_mesh(2))
    pages = _fake_pages(4)
    want = _texts(pipe.process(pages))
    assert _texts(pipe.process(pages)) == want
    assert [_texts(r) for r in pipe.process_stream([pages, pages])] == [want, want]
    assert _texts(pipe.process_normalized(pipe._stage_pages(pages))) == want
    assert rec.threads == {"ocrs-shard-0", "ocrs-shard-1"} and len(rec.idents) == 2


@pytest.mark.parametrize("n, pages", [(2, 5), (4, 6)])
def test_uneven_group_raises_as_jax_does(n, pages):
    group = _fake_pages(pages)
    with pytest.raises(ValueError):
        _jax_fake_pipe(jax_make_data_mesh(n)).process(group)
    with pytest.raises(ValueError, match="split evenly"):
        _fake_pipe(_cpu_mesh(n)).process(group)
    with pytest.raises(ValueError, match="split evenly"):
        _fake_pipe(_cpu_mesh(n)).process_stream([_fake_pages(2 * n), group])


def test_mesh_device_must_be_the_first_entry():
    with pytest.raises(ValueError, match="first device"):
        ot.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), ALPHABET, mesh=_cpu_mesh(2), device="meta")
