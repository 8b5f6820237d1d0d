"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit, and skip elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ocrs_tpu_torch.ops import gru


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain_version_on_card(reverse):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_len, n, hidden = 64, 5, 192  # n not a multiple of the kernel's row tile
    g = torch.Generator(device="cuda").manual_seed(0)
    xr, xz, xn = (torch.randn(t_len, n, hidden, device="cuda", generator=g) for _ in range(3))
    wh = torch.randn(hidden, 3 * hidden, device="cuda", generator=g) * (2.0 / hidden) ** 0.5
    bh = torch.randn(3 * hidden, device="cuda", generator=g) * 0.1
    before = gru.gru_sequence.launches
    got = gru.gru_sequence(xr, xz, xn, wh, bh, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.gru_sequence.launches == before + 1
    want = gru.gru_sequence_reference(xr, xz, xn, wh, bh, reverse=reverse)
    # f32 on both sides; summation order differs (split-TF32 tiles vs cuBLAS).
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _bigru_operands(t_len, n, hidden, strided, seed=0):
    """Projections [T, N, 3H] of both directions (transposed views of
    [N, T, 3H] tensors when `strided`), and wh, bh of both."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        xps = [torch.randn(n, t_len, 3 * hidden, device="cuda", generator=g).transpose(0, 1) for _ in range(2)]
    else:
        xps = [torch.randn(t_len, n, 3 * hidden, device="cuda", generator=g) for _ in range(2)]
    rec = []
    for _ in range(2):
        rec.append(torch.randn(hidden, 3 * hidden, device="cuda", generator=g) * (2.0 / hidden) ** 0.5)
        rec.append(torch.randn(3 * hidden, device="cuda", generator=g) * 0.1)
    return xps, rec


@pytest.mark.cuda
@pytest.mark.parametrize("t_len", [1, 7, 608])
@pytest.mark.parametrize("n", [1, 3, 20, 33])
@pytest.mark.parametrize("hidden", [32, 192])
def test_bigru_kernel_matches_plain_version_on_card(hidden, n, t_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # Strided operands, as the layer passes them: [N, T, 3H] products and the
    # [N, T, 2H] result, each read and written through its transposed view.
    xps, rec = _bigru_operands(t_len, n, hidden, strided=True)
    out = torch.full((n, t_len, 2 * hidden), float("nan"), device="cuda")
    before = gru.bigru_sequence.launches
    got = gru.bigru_sequence(*xps, *rec, out=out.transpose(0, 1))
    torch.cuda.synchronize()
    assert gru.bigru_sequence.launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    want = gru.bigru_sequence_reference(*xps, *rec)
    # f32 on both sides; the kernel sums split-TF32 products on the tensor
    # cores in another order than cuBLAS, and uses __expf in the gates.
    torch.testing.assert_close(out.transpose(0, 1), want, rtol=0, atol=1e-4)
    # Contiguous operands give the same bits as strided ones.
    again = gru.bigru_sequence(*(xp.contiguous() for xp in xps), *rec)
    torch.testing.assert_close(again, out.transpose(0, 1), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t_len", [1, 7, 608])
@pytest.mark.parametrize("n", [1, 3, 20, 33])
@pytest.mark.parametrize("hidden", [32, 192])
def test_one_direction_matches_plain_version_on_card(hidden, n, t_len, reverse):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    xps, rec = _bigru_operands(t_len, n, hidden, strided=False, seed=1)
    # The r/z/n column slices of one [T, N, 3H] tensor (row stride 3H).
    xr, xz, xn = xps[0].split(hidden, dim=-1)
    got = gru.gru_sequence(xr, xz, xn, rec[0], rec[1], reverse=reverse)
    torch.cuda.synchronize()
    want = gru.gru_sequence_reference(xr, xz, xn, rec[0], rec[1], reverse=reverse)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [20, 100, 256])
def test_hidden_sizes_that_do_not_divide_on_card(hidden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    xps, rec = _bigru_operands(9, 4, hidden, strided=True, seed=2)
    got = gru.bigru_sequence(*xps, *rec)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gru.bigru_sequence_reference(*xps, *rec), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_bigru_layer_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ocrs_tpu_torch.models.nn import BiGRU

    torch.backends.cuda.matmul.allow_tf32 = False
    layer = BiGRU(24, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 40, 24, generator=torch.Generator().manual_seed(1))
    want = layer(x)
    before = gru.bigru_sequence.launches
    got = layer.cuda()(x.cuda())
    assert gru.bigru_sequence.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Plain tensor code of the default path: the card against the CPU.
# ---------------------------------------------------------------------------


def _seeded_mask(kind, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "noise":
        return torch.from_numpy(rng.random((97, 131)) < 0.4)
    m = np.zeros((304, 400), bool)
    for _ in range(120 if kind == "words" else 900):
        y, x = rng.integers(0, 296), rng.integers(0, 370)
        m[y : y + rng.integers(2, 8), x : x + rng.integers(4, 30)] = True
    return torch.from_numpy(m)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "crowded", "noise"])
@pytest.mark.parametrize(
    "fn,kwargs",
    [
        ("label_components_multigrid", {}),
        ("label_components_multigrid", {"solidify": False}),
        ("label_components_rungraph", {}),
        ("label_components_rungraph", {"max_runs": 64, "max_edges": 48}),
        ("label_components_device", {}),
        ("label_components_device", {"solidify": True}),
    ],
    ids=lambda v: v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items()) or "defaults",
)
def test_labelling_on_card_equals_cpu(fn, kwargs, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ocrs_tpu_torch.ops import connected_components as cc

    mask = _seeded_mask(kind)
    want = getattr(cc, fn)(mask, **kwargs)
    got = getattr(cc, fn)(mask.cuda(), **kwargs)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    # Integers: the scattered minima do not depend on the order of the atomics.
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["words", "crowded", "noise"])
@pytest.mark.parametrize("pool,solidify,caps", [(2, True, {}), (1, False, {}), (2, True, {"max_runs": 100, "k_row": 3})])
def test_runs_tables_on_card_equal_cpu(kind, pool, solidify, caps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ocrs_tpu_torch.ops import rects

    mask = _seeded_mask(kind, seed=1)
    want = rects.runs_tables(mask, pool=pool, solidify=solidify, **caps)
    got = rects.runs_tables(mask.cuda(), pool=pool, solidify=solidify, **caps)
    assert got.dtype == torch.int16 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,caps", [("words", {}), ("crowded", {}), ("crowded", {"max_components": 16, "max_boundary": 1000})])
def test_min_area_rects_on_card_match_cpu(kind, caps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ocrs_tpu_torch.ops import connected_components as cc
    from ocrs_tpu_torch.ops import rects

    labels = cc.label_components_multigrid(_seeded_mask(kind, seed=2))
    want = rects.min_area_rects_device(labels, **caps)
    got = rects.min_area_rects_device(labels.cuda(), **caps)
    for k in ("valid", "count", "dropped"):
        assert torch.equal(got[k].cpu(), want[k]), k
    valid = want["valid"]
    # float32 cos/sin and argmin over near-equal areas: a component may pick
    # the neighbouring angle step (0.9 degrees), which moves its extents by
    # less than a pixel at these sizes.
    for k in ("cx", "cy", "w", "h"):
        torch.testing.assert_close(got[k].cpu()[valid], want[k][valid], rtol=0, atol=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["convctc", "crnn"])
def test_recognizer_float32_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from ocrs_tpu_torch.models.recognition_net import RecognitionModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = RecognitionModel.create(0, arch=arch)
        x = torch.rand(3, 1, 64, 256, generator=torch.Generator().manual_seed(0)) - 0.5
        want = model.run(x, dtype=torch.float32)
        got = copy.deepcopy(model).cuda().run(x.cuda(), dtype=torch.float32)
        assert tuple(got.shape) == (64, 3, 97)
        # Same math in float32; sums in another order.
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    finally:
        torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
def test_rotated_extraction_and_beam_reduction_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ocrs_tpu_torch.ops.ctc import beam_topk_packed, text_confidence
    from ocrs_tpu_torch.ops.warp import extract_line_batch_rotated

    g = torch.Generator().manual_seed(3)
    page = torch.rand(200, 300, generator=g) - 0.5
    theta = torch.tensor([0.0, 0.2, -0.4, 1.5708])
    geom = torch.stack(
        [
            torch.tensor([10.0, 40.0, 60.0, 150.0]), torch.tensor([20.0, 30.0, 120.0, 10.0]),
            torch.cos(theta), torch.sin(theta), -torch.sin(theta), torch.cos(theta),
            torch.tensor([120.0, 90.0, 150.0, 100.0]), torch.tensor([20.0, 16.0, 30.0, 24.0]),
            torch.tensor([200.0, 128.0, 256.0, 180.0]), torch.zeros(4),
        ]
    )
    want = extract_line_batch_rotated(page, geom, out_h=64, out_w=256)
    got = extract_line_batch_rotated(page.cuda(), geom.cuda(), out_h=64, out_w=256)
    # The card contracts a*b+c into one rounding (FMA) where the CPU rounds
    # twice, which moves a sample position by an ulp and its value by ~1e-5.
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)

    lp = torch.log_softmax(4.0 * torch.randn(3, 50, 97, generator=g), dim=-1)
    assert torch.equal(beam_topk_packed(lp.cuda(), k=8, gap=10.0).cpu(), beam_topk_packed(lp, k=8, gap=10.0))
    torch.testing.assert_close(text_confidence(lp.cuda()).cpu(), text_confidence(lp), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The page pipeline: the kernel at its batch of 128 lines, the card against
# the CPU, the native loader on the card's machine.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 100])
def test_bigru_kernel_at_the_pipelines_batch_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = gru.launch_plan(n, 192)
    assert plan["tiles"] == -(-n // 16) and plan["cluster"] == 8
    xps, rec = _bigru_operands(608, n, 192, strided=True, seed=3)
    out = torch.full((n, 608, 384), float("nan"), device="cuda")
    before = gru.bigru_sequence.launches
    gru.bigru_sequence(*xps, *rec, out=out.transpose(0, 1))
    torch.cuda.synchronize()
    assert gru.bigru_sequence.launches == before + 1
    # As at N=20: float32 on both sides, sums in another order, __expf.
    torch.testing.assert_close(out.transpose(0, 1), gru.bigru_sequence_reference(*xps, *rec), rtol=0, atol=1e-4)


def _text_pages():
    """The text page of chip_smoke.py and three variants of it, [4, 160, 420] uint8."""
    import sys
    from pathlib import Path

    import numpy as np

    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    lines = chip_smoke.TEXT_LINES
    pages = [chip_smoke.text_page(), chip_smoke.text_page(lines[::-1]), chip_smoke.text_page(left=44, top=30), chip_smoke.text_page(lines[:1])]
    return np.stack([p[..., 0] for p in pages]), list(lines)


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["hbm", "lowbw"])
def test_pipeline_on_card_reads_what_the_cpu_reads(transport):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    from pathlib import Path

    import ocrs_tpu_torch as ot
    from ocrs_tpu_torch import native
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model

    native.require()
    weights = Path(__file__).resolve().parent.parent / "weights"
    det = load_detection_model(weights / "text-detection.npz")
    rec = load_recognition_model(weights / "text-recognition.npz")
    det_cpu, rec_cpu = copy.deepcopy(det), copy.deepcopy(rec)
    pages, lines = _text_pages()
    kw = dict(transport=transport, transport_pack4=False)
    on_cpu = ot.PagePipeline(det_cpu, rec_cpu, ot.DEFAULT_ALPHABET, device="cpu", **kw).process(pages)
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, **kw)
    assert pipe.device.type == "cuda" and pipe._copy_stream is not None
    on_card = pipe.process(pages)
    assert [r.text for r in on_card] == [r.text for r in on_cpu]
    assert on_card[0].text.splitlines() == lines
    assert [len(r.words) for r in on_card] == [len(r.words) for r in on_cpu]
    # The stream stages on its own CUDA stream and returns the groups in order.
    groups = [pages, pages[::-1].copy(), pages[:2]]
    streamed = pipe.process_stream(groups)
    assert [[r.text for r in g] for g in streamed] == [[r.text for r in pipe.process(g)] for g in groups]


@pytest.mark.cuda
def test_crnn_pipeline_on_card_launches_the_kernel_twice_per_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from pathlib import Path

    import ocrs_tpu_torch as ot
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.models.weights import load_detection_model

    det = load_detection_model(Path(__file__).resolve().parent.parent / "weights" / "text-detection.npz")
    rec = RecognitionModel.create(seed=0, arch="crnn")
    pages, _ = _text_pages()
    pipe = ot.PagePipeline(det, rec, ot.DEFAULT_ALPHABET, max_lines_per_batch=4)
    before = gru.bigru_sequence.launches
    results = pipe.process(pages)
    n_lines = sum(len(r.lines) for r in results)
    assert n_lines == 7
    assert gru.bigru_sequence.launches == before + 2 * -(-n_lines // 4)


def _bench_module():
    """``bench_torch.bench`` of this checkout (its loaders of the committed
    inputs)."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        from bench_torch import bench
    finally:
        sys.path.remove(repo)
    return bench


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["hbm", "lowbw"])
def test_pipeline_launch_path_does_not_wait_for_the_card(transport):
    # Between its explicit waits (the tables' and the labels' copies),
    # nothing process_stream's threads call makes the host wait for the card.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ocrs_tpu_torch as ot
    from ocrs_tpu_torch import native
    from ocrs_tpu_torch.recognition import _HostCopies

    native.require()
    bench = _bench_module()
    det, rec, alphabet = bench.load_models()
    pages = bench.load_pages()[0][:4]  # 4 of the A4 pages at 300 dpi
    pipe = ot.PagePipeline(det, rec, alphabet, max_lines_per_batch=bench.PIPELINE_MAX_LINES, transport=transport)
    want = [r.text for r in pipe.process(pages)]
    pipe.process_stream([pages] * 2)  # a warm pipeline
    torch.cuda.synchronize()

    def no_wait(fn):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    staged = no_wait(lambda: pipe._stage_pages(pages))
    before = pipe.graph_stats()
    copies, scale = no_wait(lambda: pipe._detect_tables(staged, graphs=True))
    assert isinstance(copies, _HostCopies)
    lines = pipe._layout_group(*pipe._tables_to_words_arrays(copies, scale))
    inflight = no_wait(lambda: pipe._dispatch_recognition(staged, lines, graphs=True))
    texts = pipe._collect_recognition(lines, inflight)
    assert ["\n".join(str(t) for t in page if t is not None) for page in texts] == want
    after = pipe.graph_stats()
    assert after["graph_captures"] == before["graph_captures"]
    if transport == "hbm":  # warm graph replays, the detector and every batch
        assert after["graph_replays"] - before["graph_replays"] == 1 + len(inflight)
    else:  # the low-bandwidth transport stays eager
        assert after["graph_replays"] == before["graph_replays"] == 0


def _pair_graph_runs_with_direct_calls(pipe) -> list:
    """From now on every run of `pipe`'s graph cache with a key is paired
    with its body called directly on the same inputs just before it, both
    consumed by the run's `finish`: the list gets (key, whether the run
    replayed a graph, the direct call's outputs, the run's outputs)."""
    cache, run = pipe._graphs, pipe._graphs.run
    pairs = []

    def paired(key, body, inputs, finish, *args, **kwargs):
        if key is None:
            return run(key, body, inputs, finish, *args, **kwargs)
        direct = finish(body(*(
            torch.from_numpy(v).to(cache.device) if isinstance(v, np.ndarray) else v for v in inputs.values()
        )))
        replays = cache.replays
        got = run(key, body, inputs, finish, *args, **kwargs)
        pairs.append((key, cache.replays > replays, direct, got))
        return got

    cache.run = paired
    return pairs


@pytest.mark.cuda
def test_pipeline_graph_replays_equal_eager_runs_bit_for_bit():
    # Three groups in flight (the detector two ahead), batches of two widths
    # or more: every replay's run tables, greedy labels and confidences
    # equal those of the same body called directly on the same inputs, bit
    # for bit, in the pass that captures and in the passes that only
    # replay. The first capture is made while the staging thread uploads
    # the next group.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading

    import ocrs_tpu_torch as ot

    bench = _bench_module()
    det, rec, alphabet = bench.load_models()
    pages = bench.load_pages()[0][:4]  # 4 of the A4 pages at 300 dpi
    groups = [pages, pages[::-1].copy(), pages]
    pipe = ot.PagePipeline(det, rec, alphabet, max_lines_per_batch=32, min_line_confidence=1e-6)
    pairs = _pair_graph_runs_with_direct_calls(pipe)
    in_capture, staging_looping = threading.Event(), threading.Event()
    uploads_in_capture, stage_calls = [], []
    stage, capture = pipe._stage_pages, pipe._graphs._capture

    def stage_hook(pages):
        stage_calls.append(1)
        if len(stage_calls) == 3:  # group 2's staging: upload while group 1's detector is captured
            assert in_capture.wait(120)
            staging_looping.set()
            while in_capture.is_set():
                stage(pages)
                uploads_in_capture.append(1)
        return stage(pages)

    def capture_hook(*args):
        if not in_capture.is_set() and not uploads_in_capture:
            in_capture.set()
            try:
                assert staging_looping.wait(120)
                return capture(*args)
            finally:
                in_capture.clear()
        return capture(*args)

    pipe._stage_pages, pipe._graphs._capture = stage_hook, capture_hook
    texts = [[r.text for r in group] for group in pipe.process_stream(groups)]
    first = pipe.graph_stats()
    assert uploads_in_capture and first["graph_captures"] >= 2 and first["graph_replays"] >= first["graph_captures"]
    # A key seen once in the first pass is captured in the second; the third
    # only replays.
    texts_again = [[r.text for r in group] for group in pipe.process_stream(groups)]
    before, runs = pipe.graph_stats(), len(pairs)
    texts_third = [[r.text for r in group] for group in pipe.process_stream(groups)]
    second = pipe.graph_stats()
    assert second["graph_captures"] == before["graph_captures"] and second["eager_batches"] == before["eager_batches"]
    assert all(replayed for _, replayed, _, _ in pairs[runs:]) and len(pairs) - runs > len(groups)
    assert second["graph_replays"] - before["graph_replays"] == len(pairs) - runs
    assert texts == texts_again == texts_third
    assert sum(replayed for _, replayed, _, _ in pairs) == second["graph_replays"]
    for key, _, direct, got in pairs:
        want, have = direct.numpy(), got.numpy()
        assert [x is None for x in have] == [x is None for x in want], key
        for x, y in zip(have, want):
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=str(key))  # tables, labels, confidences: bit for bit
    widths = {key[2] for key in pipe._graphs._graphs if key[0] == "recognize"}
    assert len(widths) >= 2, widths
    assert second["pool_bytes"] is None or second["pool_bytes"] > 0

    # Warm replays make the host wait for nothing.
    del pipe._graphs.run  # the cache's own run again
    staged = pipe._stage_pages(pages)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        copies, scale = pipe._detect_tables(staged, graphs=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    lines = pipe._layout_group(*pipe._tables_to_words_arrays(copies, scale))
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = pipe._dispatch_recognition(staged, lines, graphs=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pipe._collect_recognition(lines, inflight)
    third = pipe.graph_stats()
    assert third["graph_captures"] == second["graph_captures"]
    assert third["graph_replays"] - second["graph_replays"] == 1 + len(inflight)


@pytest.mark.cuda
def test_pipeline_reads_a_page_stack_refilled_in_place():
    # process_stream over one device tensor that the caller refills between
    # calls, with every graph warm: the call after the refill replays the
    # same graphs and reads the new pages. process_normalized, one group at
    # a time, runs eagerly and leaves the cache untouched.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ocrs_tpu_torch as ot

    bench = _bench_module()
    det, rec, alphabet = bench.load_models()
    pages = bench.load_pages()[0][:4]  # 4 of the A4 pages at 300 dpi
    refill = pages[::-1].copy()  # the same lines in another page order: the same graphs
    pipe = ot.PagePipeline(det, rec, alphabet, max_lines_per_batch=bench.PIPELINE_MAX_LINES)
    want = [r.text for r in pipe.process_normalized(pipe._stage_pages(refill))]
    assert pipe.graph_stats()["graph_replays"] == pipe.graph_stats()["eager_batches"] == 0
    stack = pipe._stage_pages(pages)
    first = [r.text for r in pipe.process_stream([stack])[0]]
    assert first != want
    for _ in range(2):  # captured, then replayed
        assert [r.text for r in pipe.process_stream([stack])[0]] == first
    before = pipe.graph_stats()
    stack.copy_(pipe._stage_pages(refill))
    assert [r.text for r in pipe.process_stream([stack])[0]] == want
    after = pipe.graph_stats()
    assert after["graph_captures"] == before["graph_captures"] and after["eager_batches"] == before["eager_batches"]
    assert after["graph_replays"] - before["graph_replays"] >= 2


def _serve_models():
    from pathlib import Path

    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model

    weights = Path(__file__).resolve().parent.parent / "weights"
    return load_detection_model(weights / "text-detection.npz"), load_recognition_model(weights / "text-recognition.npz")


def _post(base, path, data):
    import urllib.request

    with urllib.request.urlopen(urllib.request.Request(base + path, data=data, method="POST"), timeout=300) as r:
        assert r.status == 200
        return r.read()


@pytest.mark.cuda
def test_server_on_card_answers_what_the_engine_reads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import urllib.request

    import ocrs_tpu_torch as ot
    from ocrs_tpu_torch.png import decode_image, encode_png
    from ocrs_tpu_torch.serve import serve

    det, rec = _serve_models()
    engine = ot.OcrEngine(ot.OcrEngineParams(detection_model=det, recognition_model=rec))
    assert engine.device.type == "cuda"
    pages, lines = _text_pages()
    body = encode_png(pages[0])
    want = engine.get_text(engine.prepare_input(ot.ImageSource.from_tensor(decode_image(body), ot.DimOrder.HWC)))
    assert want.splitlines() == lines
    server = serve(engine, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert torch.cuda.get_device_name(0) in health["devices"][0]
        doc = json.loads(_post(base, "/ocr", body))
        assert "\n".join(l["text"] for l in doc["paragraphs"][0]["lines"]) == want
        assert _post(base, "/ocr/text", body).decode() == want
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["convctc", "crnn"])
def test_batching_service_on_card_makes_one_batch(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    import ocrs_tpu_torch as ot
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.serve import BatchingOcrService

    det, rec = _serve_models()
    if arch == "crnn":
        rec = RecognitionModel.create(seed=0, arch="crnn")
    engine = ot.OcrEngine(ot.OcrEngineParams(detection_model=det, recognition_model=rec))
    service = BatchingOcrService(engine, det, rec, ot.DEFAULT_ALPHABET, max_batch=4)
    assert service._pipeline.device == engine.device
    pages, _ = _text_pages()
    service._gate.clear()
    gru.bigru_sequence.launches_by_thread.clear()
    futs = [service.submit(p[..., None]) for p in pages]
    time.sleep(0.2)
    service._gate.set()
    got = ["\n".join(str(l) for l in f.result(timeout=300) if l is not None) for f in futs]
    assert service.batch_sizes == [4]
    worker = gru.bigru_sequence.launches_by_thread.get(service._thread.name, 0)
    want = [engine.get_text(engine.prepare_input(ot.ImageSource.from_tensor(p[..., None], ot.DimOrder.HWC))) for p in pages]
    if arch == "convctc":
        assert got == want and worker == 0
    else:
        # A random CRNN's text depends on the batch's padded width: the lines
        # are the engine's, and the kernel ran on the worker thread.
        assert [len(t.splitlines()) for t in got] == [len(t.splitlines()) for t in want] and worker >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 20])
@pytest.mark.parametrize("hidden", [300, 384, 400, 512])
def test_large_hidden_sizes_on_card(hidden, n):
    # Clusters of 16 blocks; wh's slice in shared memory up to 384, read
    # from global memory above.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    xps, rec = _bigru_operands(37, n, hidden, strided=True, seed=3)
    got = gru.bigru_sequence(*xps, *rec)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gru.bigru_sequence_reference(*xps, *rec), rtol=0, atol=1e-4)
    xr, xz, xn = xps[0].contiguous().split(hidden, dim=-1)
    one = gru.gru_sequence(xr, xz, xn, rec[0], rec[1], reverse=True)
    torch.testing.assert_close(one, gru.gru_sequence_reference(xr, xz, xn, rec[0], rec[1], reverse=True), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kernel_function_gradients_on_card_equal_the_plain_loops():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    xps, rec = _bigru_operands(50, 6, 64, strided=True, seed=4)
    ops = [t.detach().requires_grad_() for t in (*xps, *rec)]
    w = torch.randn(6, 50, 128, device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    before = gru.bigru_sequence.launches
    out = gru.BiGRUSequence.apply(*ops)
    assert out.grad_fn is not None and gru.bigru_sequence.launches == before + 1
    got = torch.autograd.grad((out * w).sum(), ops)
    want = torch.autograd.grad((gru.bigru_sequence_reference(*ops).transpose(0, 1) * w).sum(), ops)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_crnn_train_step_on_card_launches_the_kernel_and_lowers_the_loss():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from ocrs_tpu_torch.train import demo, optim, train

    opt = optim.adam(1e-3)
    state = train.init_recognition_state(opt, hidden=64)
    step = train.make_recognition_train_step(opt)
    batch = demo.make_batch(np.random.default_rng(0), 8, 256)
    before = gru.bigru_sequence.launches
    state, loss1 = step(state, *batch)
    state, loss2 = step(state, *batch)
    assert gru.bigru_sequence.launches == before + 4
    assert state.model.net.gru1.fwd.wh.grad is not None and float(state.model.net.gru1.fwd.wh.grad.abs().sum()) > 0
    assert float(loss2) < float(loss1)


@pytest.mark.cuda
def test_trainer_step_on_card_from_the_committed_caches(tmp_path):
    # What the card's machine can train from: the committed caches (no
    # Pillow), one CRNN step and a validation on the held-out cache.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from pathlib import Path

    from ocrs_tpu_torch.models.weights import load_recognition_model
    from ocrs_tpu_torch.train import train_models
    from ocrs_tpu_torch.train.data import RecognitionDataset

    caches = Path(__file__).resolve().parent.parent / "test-data" / "train"
    val = train_models.validation_batch(RecognitionDataset(0, cache_path=caches / "rec_32_768_s7919.npz"))
    args = train_models.parse_args(["recognition", "--arch", "crnn", "--hidden", "64", "--steps", "1", "--batch", "8",
                                    "--cache", str(caches / "rec_64_768_s0.npz"), "-o", str(tmp_path / "crnn.npz")])
    before = gru.bigru_sequence.launches
    record = train_models.train_recognition(args, val_batch=val)
    # Two BiGRU launches for the step's forward, two for the validation's.
    assert gru.bigru_sequence.launches == before + 4
    assert record["state"].device.type == "cuda" and len(record["losses"]) == 1
    assert record["val_cer"][0][0] == 1 and record["val_size"] == 32
    assert load_recognition_model(tmp_path / "crnn.npz").arch == "crnn"
