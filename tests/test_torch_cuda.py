"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit, and skip elsewhere. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

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
