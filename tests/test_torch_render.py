"""The port's styled renderer (ocrs_tpu_torch.train.render) against the JAX
package's (ocrs_tpu.train.render): from equal seeds the two draw equal
arrays, texts and word boxes, exactly (no tolerance: both are the same
Pillow and numpy calls in the same order), in every regime."""

import numpy as np
import pytest

from ocrs_tpu.train import render as J
from ocrs_tpu_torch.train import render as T


def test_font_paths_are_the_jax_packages():
    assert T.font_paths() == J.font_paths()
    assert len(T.font_paths()) >= 1
    assert [p for _, p in T.candidate_paths() if p is not None and p in T.font_paths()] == list(T.font_paths())


@pytest.mark.parametrize("seed", range(40))
def test_sample_word_equals_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [T.sample_word(a) for _ in range(25)] == [J.sample_word(b) for _ in range(25)]
    assert a.bit_generator.state == b.bit_generator.state


REGIMES = {
    "default": {},
    "blockify": {"blockify_prob": 1.0},
    "pixel_face": {"pixelfont_prob": 1.0},
    "graphics": {"graphics_prob": 1.0},
    "empty": {"empty_prob": 1.0},
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_render_recognition_sample_equals_jax(regime, seed):
    kw = REGIMES[regime]
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    crop_t, text_t = T.render_recognition_sample(a, 768, **kw)
    crop_j, text_j = J.render_recognition_sample(b, 768, **kw)
    assert text_t == text_j
    assert (text_t == "") == (regime == "empty")
    assert crop_t.dtype == crop_j.dtype and crop_t.shape == crop_j.shape and crop_t.shape[0] == 64
    np.testing.assert_array_equal(crop_t, crop_j)
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize(
    "seed, kw",
    [(0, {}), (1, {"figure_prob": 1.0}), (2, {"figure_prob": 1.0}), (3, {"pixelfont_prob": 1.0}), (4, {})],
)
def test_render_native_page_equals_jax(seed, kw):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    page_t, words_t = T.render_native_page(a, page_hw=(300, 420), **kw)
    page_j, words_j = J.render_native_page(b, page_hw=(300, 420), **kw)
    assert words_t == words_j
    np.testing.assert_array_equal(page_t, page_j)
    assert page_t.dtype == page_j.dtype == np.float32


@pytest.mark.parametrize("seed, kw", [(5, {}), (6, {"figure_prob": 1.0}), (7, {"pixelfont_prob": 1.0})])
def test_render_detection_sample_equals_jax(seed, kw):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    st = T.render_detection_sample(a, det_hw=(200, 152), **kw)
    sj = J.render_detection_sample(b, det_hw=(200, 152), **kw)
    np.testing.assert_array_equal(st.image, sj.image)
    np.testing.assert_array_equal(st.mask, sj.mask)
    assert st.words == sj.words and st.native_hw == sj.native_hw


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"pixelate": 3},
        {"binarize": True},
        {"blur_sigma": 0.9},
        {"jpeg_quality": 40},
        {"noise_sigma": 0.03},
        {"pixelate": 2, "binarize": True, "blur_sigma": 0.5, "jpeg_quality": 70, "noise_sigma": 0.02},
    ],
    ids=lambda d: "+".join(d) or "plain",
)
def test_degrade_equals_jax(overrides):
    rng = np.random.default_rng(11)
    img = rng.uniform(0.0, 1.0, (48, 80)).astype(np.float32)
    base = dict(font_path="f", bg=0.9, fg=0.1, alt_fg=None, alt_fg_prob=0.2, blur_sigma=0.0,
                noise_sigma=0.0, jpeg_quality=None, contrast=1.05, brightness=0.02)
    base.update(overrides)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    out_t = T.degrade(img, a, T.Style(**base))
    out_j = J.degrade(img, b, J.Style(**base))
    np.testing.assert_array_equal(out_t, out_j)


def test_sample_style_and_half_pixel_resize_equal_jax():
    a, b = np.random.default_rng(21), np.random.default_rng(21)
    for _ in range(20):
        assert vars(T.sample_style(a, hard=True)) == vars(J.sample_style(b, hard=True))
    img = np.random.default_rng(4).uniform(0, 1, (37, 91)).astype(np.float32)
    for hw in ((37, 91), (20, 30), (80, 200)):
        np.testing.assert_array_equal(T.resize_half_pixel_np(img, hw), J.resize_half_pixel_np(img, hw))
