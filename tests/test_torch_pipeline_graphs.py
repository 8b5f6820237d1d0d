"""The page pipeline's CUDA graphs (``ocrs_tpu_torch/utils/graphs.py``,
``PagePipeline._detect_tables`` and ``_run_pooled_batch``), on the CPU.

A CPU has no graphs: these tests hold the cache's keys and its policy, show
that on the CPU nothing is captured and the texts are those the pipeline read
before graphs existed, and drive the graph path's own code (inputs copied into
fixed buffers, the page stack once a group, outputs consumed by `finish`)
through a stand-in whose "replay" runs the captured body again on those
buffers. The card tests (``tests/test_torch_cuda.py``) hold real replays
against the eager bodies bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import ocrs_tpu_torch as ot
from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.png import decode_image
from ocrs_tpu_torch.recognition import BeamSearch
from ocrs_tpu_torch.utils import graphs
from ocrs_tpu_torch.utils.tracing import TimelineRecorder

REPO = Path(__file__).resolve().parent.parent

#: What ``process_stream`` read from the committed test pages with the
#: shipped weights before the pipeline had graphs (the recognizer reads the
#: pages' white blocks as these glyphs).
TEXTS_BEFORE_GRAPHS = [["=", "="], ["~\ne", "~\ne"], ["=", "y"], ["~\ne", "~\ne"]]


@pytest.fixture(scope="module")
def shipped():
    return (
        load_detection_model(REPO / "weights" / "text-detection.npz"),
        load_recognition_model(REPO / "weights" / "text-recognition.npz"),
    )


def _test_page(name: str) -> np.ndarray:
    return decode_image((REPO / "test-data" / f"{name}.png").read_bytes())[..., 0]


def _groups():
    strip, two = _test_page("strip-line"), _test_page("two-lines")
    return [np.stack([strip] * 2), np.stack([two] * 2), np.stack([strip, strip[:, ::-1]]), np.stack([two] * 2)]


def test_graph_keys_separate_every_branch():
    def pipe(**kw):
        return ot.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), ot.DEFAULT_ALPHABET[:63], device="cpu", **kw)

    x = torch.zeros(4, 1, 200, 100)
    base = pipe()
    detect = {
        base._detect_graph_key(x, (200, 100)),
        base._detect_graph_key(torch.zeros(2, 1, 200, 100), (200, 100)),  # batch size
        base._detect_graph_key(torch.zeros(4, 1, 208, 100), (200, 100)),  # detector input size
        base._detect_graph_key(x, (180, 100)),  # crop
        pipe(run_table_geometry=False)._detect_graph_key(x, (200, 100)),
        pipe(multigrid=False)._detect_graph_key(x, (200, 100)),
        pipe(solidify=False)._detect_graph_key(x, (200, 100)),
    }
    assert len(detect) == 7
    assert base._detect_graph_key(x, (200, 100)) == pipe()._detect_graph_key(torch.ones(4, 1, 200, 100), [200, 100])

    pages = torch.zeros(2, 300, 200)
    rec = {
        base._rec_graph_key(pages, 64, 1280, True, False),
        base._rec_graph_key(pages, 128, 1280, True, False),  # n_pad
        base._rec_graph_key(pages, 64, 1408, True, False),  # w_eff
        base._rec_graph_key(torch.zeros(3, 300, 200), 64, 1280, True, False),  # page stack
        pipe(decode_method=BeamSearch())._rec_graph_key(pages, 64, 1280, False, False),  # beam
        base._rec_graph_key(pages, 64, 1280, True, True),  # voting confidence
        pipe(min_line_confidence=0.5)._rec_graph_key(pages, 64, 1280, True, False),
        pipe(allowed_chars="abc")._rec_graph_key(pages, 64, 1280, True, False),
    }
    assert len(rec) == 8


class _Rerun:
    """Stands in for a captured graph on the CPU: a replay runs the body
    again on the fixed input buffers and writes into the captured outputs,
    as a real replay writes into the same memory."""

    def __init__(self, body, args, outputs):
        self.body, self.args, self.outputs = body, args, outputs

    def replay(self):
        with torch.inference_mode():
            fresh = self.body(*self.args)
            old = self.outputs if isinstance(self.outputs, tuple) else (self.outputs,)
            new = fresh if isinstance(fresh, tuple) else (fresh,)
            for o, n in zip(old, new):
                if o is not None:
                    o.copy_(n)


class _CpuGraphCache(graphs.GraphCache):
    """The cache's own policy and buffers, with captures made by
    :class:`_Rerun` and no streams."""

    def __init__(self):
        super().__init__("cpu")
        self.enabled = True
        self.loads = []
        self.copies = []  # (name, copied) of each tensor input loaded
        self.fixed = []  # names of fixed_input's copies

    def _after_last(self):
        pass

    def _mark_last(self):
        pass

    def fixed_input(self, name, tensor, *args, **kwargs):
        self.fixed.append(name)
        return super().fixed_input(name, tensor, *args, **kwargs)

    def _load(self, inputs):
        for name, src in inputs.items():
            if isinstance(src, torch.Tensor):
                self.copies.append((name, self._buffers.get(graphs._buffer_key(name, src)) is not src))
        args = super()._load(inputs)
        self.loads.append({name: args[i].data_ptr() for i, name in enumerate(inputs)})
        return args

    def _capture(self, key, body, args):
        body(*args)  # the warm-up
        rerun = _Rerun(body, args, body(*args))
        self._graphs[key] = graphs._Graph(rerun, rerun.outputs, [])


@pytest.fixture
def host_pinned(monkeypatch):
    # No pinned memory without a card: the buffers take plain host tensors.
    monkeypatch.setattr(graphs, "_pinned", lambda arr: torch.from_numpy(np.ascontiguousarray(arr)))


def test_cache_captures_on_second_sight_and_keeps_its_bound(host_pinned, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    cache = _CpuGraphCache()
    ran = []

    def body(x):
        ran.append(1)
        return x * 2

    def run(key, value):
        rec = TimelineRecorder(None)
        out = cache.run(key, body, {"x": np.full(3, value, np.float32)}, lambda y: y.clone(), rec.group(0))
        counts = rec.finish().counts.get(0, {})
        return out.tolist(), counts

    assert run("a", 1) == ([2, 2, 2], {"eager_batches": 1})
    assert run("a", 2) == ([4, 4, 4], {"graph_captures": 1, "graph_replays": 1})
    assert run("a", 3) == ([6, 6, 6], {"graph_replays": 1})
    assert run("b", 4) == ([8, 8, 8], {"eager_batches": 1})
    assert run("b", 5)[1] == {"graph_captures": 1, "graph_replays": 1}
    # The bound: a third key stays eager however often it comes.
    for value in range(6, 9):
        assert run("c", value) == ([2 * value] * 3, {"eager_batches": 1})
    assert len(cache._graphs) == 2 and set(cache._graphs) == {"a", "b"}
    assert run(None, 9) == ([18] * 3, {})  # no key: eager, uncounted
    assert cache.stats() == {
        "graph_captures": 2, "graph_replays": 3, "eager_batches": 5, "graphs": 2,
        "input_buffer_bytes": 12, "pool_bytes": 0,
    }
    # The two graphs share one input buffer of their shape.
    assert len({load["x"] for load in cache.loads}) == 1


def test_cache_keeps_to_its_input_budget(host_pinned, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_INPUT_BYTES", 40)
    cache = _CpuGraphCache()

    def run(key, n):
        return cache.run(key, lambda x: x + 1, {"x": np.zeros(n, np.float32)}, lambda y: y.tolist())

    for _ in range(3):
        assert run("small", 8) == [1.0] * 8  # 32 bytes: captured on its second sight
    for _ in range(3):
        assert run("large", 4) == [1.0] * 4  # 16 more would pass the budget: eager
    assert set(cache._graphs) == {"small"} and cache.stats()["input_buffer_bytes"] == 32
    # A fixed input over the budget is handed back as it is.
    pages = torch.ones(4)
    with cache.fixed_input("pages", pages) as buf:
        assert buf is pages
    assert cache.stats()["input_buffer_bytes"] == 32


def test_fixed_input_is_copied_once_a_block_and_read_anew_after_a_refill(host_pinned):
    cache = _CpuGraphCache()
    pages = torch.arange(6.0)

    def run(pages, value):
        return cache.run("k", lambda p, g: p.sum() + g.sum(), {"pages": pages, "geom": np.full(2, value, np.float32)},
                         lambda y: float(y))

    with cache.fixed_input("pages", pages) as buf:
        assert buf is not pages
        assert [run(buf, i) for i in range(4)] == [15.0, 17.0, 19.0, 21.0]  # eager, capture, replay, replay
    assert cache.copies == [("pages", False)] * 3  # the graph's runs read the buffer as it is
    pages.add_(1)  # the caller refills its tensor in place
    with cache.fixed_input("pages", pages) as again:
        assert again is buf
        assert run(again, 0) == 21.0  # the replay reads the new contents
    # Outside a block a tensor input is copied into its buffer on every run.
    assert run(pages, 1) == 23.0 and run(pages + 1, 1) == 29.0
    assert cache.copies[3:] == [("pages", False), ("pages", True), ("pages", True)]
    assert cache.stats()["graph_replays"] == 6


def test_cpu_pipeline_captures_nothing_and_reads_what_it_read(shipped):
    det, rec = shipped
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, device="cpu")
    recorder = TimelineRecorder("cpu")
    got = [[r.text for r in g] for g in pipe.process_stream(_groups(), recorder=recorder)]
    assert got == TEXTS_BEFORE_GRAPHS
    assert not pipe._graphs.enabled and pipe._graphs._graphs == {} and pipe._graphs._seen == set()
    stats = pipe.graph_stats()
    assert stats["graph_captures"] == stats["graph_replays"] == stats["eager_batches"] == stats["graphs"] == 0
    counts = recorder.finish().counts
    assert not any(name.startswith(("graph_", "eager_")) for c in counts.values() for name in c)


def test_graph_path_reads_what_the_eager_path_reads(shipped, host_pinned):
    # The graph path's code end to end on the CPU: the detector and the
    # recognition batches through the cache's buffers and a re-running
    # stand-in. Two lines a batch: a group of two two-line pages makes two
    # batches of one key.
    det, rec = shipped
    options = dict(device="cpu", min_line_confidence=1e-6, max_lines_per_batch=2)
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, **options)
    pipe._graphs = cache = _CpuGraphCache()
    groups = [_groups()[1]] * 3
    recorder = TimelineRecorder("cpu")
    got = [[r.text for r in g] for g in pipe.process_stream(groups, recorder=recorder)]
    want = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, **options).process_stream(groups)
    assert got == [[r.text for r in g] for g in want] == [TEXTS_BEFORE_GRAPHS[1]] * 3
    counts = recorder.finish().counts
    assert [c["batches"] for c in counts.values()] == [2, 2, 2]
    # Group 0: the detector and the first batch eager, the second batch (its
    # key's second sight) captured; group 1: the detector captured, both
    # batches replayed; group 2: replays only.
    assert [(c.get("eager_batches", 0), c.get("graph_captures", 0), c.get("graph_replays", 0))
            for c in counts.values()] == [(2, 1, 1), (0, 1, 3), (0, 0, 3)]
    assert sorted(k[0] for k in cache._graphs) == ["detect", "recognize"]
    # Each group's page stack is copied into its buffer once, before its
    # batches, which read the buffer as it is.
    assert cache.fixed == ["pages"] * 3
    assert [copied for name, copied in cache.copies if name == "pages"] == [False] * 5


def test_a_page_stack_refilled_in_place_is_read_anew(shipped, host_pinned):
    # process_stream over one tensor that the caller refills between calls,
    # with the recognition batch's graph warm: the later call reads the new
    # pages, as process_normalized reads them.
    det, rec = shipped
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, device="cpu", max_lines_per_batch=2)
    pipe._graphs = cache = _CpuGraphCache()
    groups = _groups()
    first, second = pipe._stage_pages(groups[0]), pipe._stage_pages(groups[2])
    want = [r.text for r in pipe.process_normalized(second)]
    assert want == TEXTS_BEFORE_GRAPHS[2]
    pages = first.clone()
    for _ in range(3):
        assert [r.text for r in pipe.process_stream([pages])[0]] == TEXTS_BEFORE_GRAPHS[0]
    replays = cache.stats()["graph_replays"]
    pages.copy_(second)
    assert [r.text for r in pipe.process_stream([pages])[0]] == want
    assert cache.stats()["graph_replays"] == replays + 2  # the detector and the batch replayed


def test_one_group_at_a_time_runs_eagerly(shipped, host_pinned):
    # process and process_normalized run the graphs' bodies eagerly and
    # leave the cache untouched: no sighting, capture or replay.
    det, rec = shipped
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, device="cpu", max_lines_per_batch=2)
    pipe._graphs = cache = _CpuGraphCache()
    group = _groups()[1]
    for _ in range(3):
        assert [r.text for r in pipe.process(group)] == TEXTS_BEFORE_GRAPHS[1]
        assert [r.text for r in pipe.process_normalized(pipe._stage_pages(group))] == TEXTS_BEFORE_GRAPHS[1]
    assert cache._seen == set() and cache.fixed == [] and cache.loads == []
    assert cache.stats()["graph_replays"] == cache.stats()["eager_batches"] == 0
