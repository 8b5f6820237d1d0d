"""The port's preprocessing and resize (ocrs_tpu_torch.preprocess,
ocrs_tpu_torch.ops.resize) against the JAX package on the same inputs."""

import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ocrs_tpu import preprocess as jprep
from ocrs_tpu.ops import resize as jresize
from ocrs_tpu_torch import preprocess as tprep
from ocrs_tpu_torch.errors import ImageSourceError
from ocrs_tpu_torch.ops import resize as tresize
from ocrs_tpu_torch.parallel.pipeline import _normalize_batch
from ocrs_tpu_torch.png import read_png

REPO = Path(__file__).resolve().parent.parent

# Same float32 arithmetic on both sides; the channel weighting may sum in a
# different order (a few ulps of values in [-0.5, 0.5]).
PREP_ATOL = 1e-6
# Two float32 matrix products of length <= 64 over values in [-0.5, 0.5].
RESIZE_ATOL = 1e-5


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("order", ["hwc", "chw"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_prepare_image_matches_jax(channels, order, dtype):
    rng = np.random.default_rng(channels)
    h, w = 8, 12
    if dtype == np.uint8:
        img = rng.integers(0, 256, size=(h, w, channels), dtype=np.uint8)
    else:
        img = rng.random((h, w, channels), dtype=np.float32)
    data = np.moveaxis(img, -1, 0) if order == "chw" else img
    want = np.asarray(jprep.prepare_image(jprep.ImageSource.from_tensor(data, jprep.DimOrder(order))))
    got = tprep.prepare_image(tprep.ImageSource.from_tensor(data, tprep.DimOrder(order)), "cpu")
    assert tuple(got.shape) == (1, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PREP_ATOL, rtol=0)


def test_from_bytes_and_errors_match_jax():
    h, w = 4, 6
    for c in (1, 3, 4):
        data = bytes([i % 256 for i in range(h * w * c)])
        src = tprep.ImageSource.from_bytes(data, (h, w))
        assert src.data.shape == (h, w, c) and src.hw() == (h, w)
    with pytest.raises(ImageSourceError):
        tprep.ImageSource.from_bytes(bytes(4 * 6 * 2), (4, 6))
    with pytest.raises(ImageSourceError):
        tprep.ImageSource.from_tensor(np.zeros((4, 6)), tprep.DimOrder.HWC)
    with pytest.raises(ImageSourceError):
        tprep.prepare_image(
            tprep.ImageSource.from_tensor(np.zeros((4, 6, 3), dtype=np.int32), tprep.DimOrder.HWC), "cpu"
        )


@pytest.mark.parametrize("in_size,out_size", [(7, 7), (10, 4), (13, 5), (4, 10), (5, 17)])
def test_interp_matrix_matches_jax(in_size, out_size):
    np.testing.assert_array_equal(
        tresize._interp_matrix(in_size, out_size), jresize._interp_matrix(in_size, out_size)
    )


@pytest.mark.parametrize("out_hw", [(16, 24), (64, 80)], ids=["down", "up"])
def test_resize_bilinear_matches_jax(out_hw):
    img = np.random.default_rng(1).random((2, 1, 40, 50), dtype=np.float32) - 0.5
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), out_hw))
    got = tresize.resize_bilinear(torch.from_numpy(img), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1) + out_hw
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)


def test_resize_default_precision_on_bf16_matches_jax():
    # The U-Net decoder's call: bf16 activations, default precision, 2x up.
    img = np.random.default_rng(2).random((1, 3, 12, 10), dtype=np.float32)
    xb = jnp.asarray(img).astype(jnp.bfloat16)
    want = np.asarray(jresize.resize_bilinear(xb, (24, 20), precision="default"))
    got = tresize.resize_bilinear(torch.from_numpy(img).to(torch.bfloat16), (24, 20), precision="default")
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)


@pytest.fixture
def empty_matrix_cache(monkeypatch):
    """A resize matrix cache of this test's own, empty."""
    monkeypatch.setattr(tresize, "_device_cache", {})
    monkeypatch.setattr(tresize, "_device_cache_bytes", 0)


def test_cached_matrix_is_built_once_and_equals_interp_matrix(empty_matrix_cache):
    cpu = torch.device("cpu")
    first = tresize._device_interp_matrix(13, 5, cpu)
    assert tresize._device_interp_matrix(13, 5, cpu) is first
    assert first.dtype == torch.float32
    np.testing.assert_array_equal(first.numpy(), tresize._interp_matrix(13, 5))
    assert tresize._device_interp_matrix(5, 13, cpu) is not first
    assert tresize._device_cache_bytes == 2 * 13 * 5 * 4


def _resize_uncached(img, out_hw):
    """resize_bilinear as it was before the cache: the matrices made anew."""
    ry = torch.from_numpy(tresize._interp_matrix(img.shape[-2], out_hw[0]))
    rx = torch.from_numpy(tresize._interp_matrix(img.shape[-1], out_hw[1]))
    return torch.matmul(torch.matmul(ry, img.to(torch.float32)), rx.T)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_is_bit_identical_before_and_after_warm_up(empty_matrix_cache, precision, dtype):
    img = torch.from_numpy(np.random.default_rng(3).random((2, 3, 40, 50), dtype=np.float32) - 0.5).to(dtype)
    cold = tresize.resize_bilinear(img, (16, 72), precision=precision)
    assert len(tresize._device_cache) == 2
    warm = tresize.resize_bilinear(img, (16, 72), precision=precision)
    assert torch.equal(cold, warm)
    assert torch.equal(warm, _resize_uncached(img, (16, 72)))


def test_matrix_cached_in_inference_mode_serves_a_backward_pass(empty_matrix_cache):
    # The engine warms the cache under inference mode; training the same
    # U-Net then differentiates through the same cached matrices.
    img = torch.from_numpy(np.random.default_rng(4).random((1, 2, 6, 8), dtype=np.float32))
    with torch.inference_mode():
        tresize.resize_bilinear(img, (12, 16), precision="default")
    x = img.clone().requires_grad_()
    tresize.resize_bilinear(x, (12, 16), precision="default").sum().backward()
    ry = torch.from_numpy(tresize._interp_matrix(6, 12))
    rx = torch.from_numpy(tresize._interp_matrix(8, 16))
    torch.testing.assert_close(x.grad, (ry.sum(0)[:, None] * rx.sum(0)[None, :]).expand_as(x), rtol=1e-6, atol=1e-6)


def test_matrix_cache_stays_in_its_budget(empty_matrix_cache, monkeypatch):
    # Room for two 16x16 float32 matrices: the third evicts the oldest.
    monkeypatch.setattr(tresize, "DEVICE_CACHE_BYTES", 2 * 16 * 16 * 4)
    cpu = torch.device("cpu")
    a = tresize._device_interp_matrix(16, 16, cpu)
    tresize._device_interp_matrix(15, 16, cpu)
    tresize._device_interp_matrix(17, 16, cpu)
    assert list(tresize._device_cache) == [(15, 16, cpu), (17, 16, cpu)]
    assert tresize._device_cache_bytes == (15 + 17) * 16 * 4
    # Larger than the whole budget: made, not kept.
    big = tresize._device_interp_matrix(64, 64, cpu)
    np.testing.assert_array_equal(big.numpy(), tresize._interp_matrix(64, 64))
    assert (64, 64, cpu) not in tresize._device_cache
    np.testing.assert_array_equal(a.numpy(), tresize._interp_matrix(16, 16))


def test_matrix_cache_under_threads_keeps_its_byte_count(empty_matrix_cache, monkeypatch):
    # More threads than cores, a short switch interval and a budget that
    # evicts all the time: a lost update of the byte count would show.
    monkeypatch.setattr(tresize, "DEVICE_CACHE_BYTES", 6 * 32 * 32 * 4)
    cpu = torch.device("cpu")
    sizes = [(i, o) for i in range(20, 33) for o in (31, 32)]
    errors = []

    def worker(seed):
        order = np.random.default_rng(seed).permutation(len(sizes))
        for k in np.tile(order, 4):
            m = tresize._device_interp_matrix(*sizes[k], cpu)
            if not np.array_equal(m.numpy(), tresize._interp_matrix(*sizes[k])):
                errors.append(sizes[k])

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    held = sum(m.numel() * m.element_size() for m in tresize._device_cache.values())
    assert tresize._device_cache_bytes == held <= tresize.DEVICE_CACHE_BYTES


def _normalize_batch_before(imgs, is_u8):
    """_normalize_batch as it was: the weights made anew as a tensor."""
    from ocrs_tpu_torch.preprocess import BLACK_VALUE, ITU_WEIGHTS

    c = imgs.shape[-1]
    w = torch.tensor([1.0] if c == 1 else list(ITU_WEIGHTS) + [0.0] * (c - 3), dtype=torch.float32)
    if is_u8:
        w = w / 255.0
    if c == 1:
        return imgs[..., 0].to(torch.float32, copy=True).mul_(w[0]).add_(BLACK_VALUE)
    return (imgs.to(torch.float32) @ w).add_(BLACK_VALUE)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_batch_values_are_unchanged(channels, dtype):
    rng = np.random.default_rng(channels)
    if dtype == np.uint8:
        imgs = rng.integers(0, 256, size=(2, 9, 11, channels), dtype=np.uint8)
    else:
        imgs = rng.random((2, 9, 11, channels), dtype=np.float32)
    t = torch.from_numpy(imgs)
    got = _normalize_batch(t, dtype == np.uint8)
    assert got.shape == (2, 9, 11) and got.dtype == torch.float32
    assert torch.equal(got, _normalize_batch_before(t, dtype == np.uint8))


@pytest.mark.parametrize("name", ["two-lines.png", "strip-line.png"])
def test_png_reader_matches_pillow(name):
    got = read_png(REPO / "test-data" / name)
    want = np.asarray(Image.open(REPO / "test-data" / name))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
