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
