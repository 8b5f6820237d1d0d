"""The port's training data (ocrs_tpu_torch.train.data) against the JAX
package's (ocrs_tpu.train.data): streaming batches and both cached datasets
from equal seeds are equal, exactly; a cache written by either package is
byte for byte the other's and reads back in both."""

import numpy as np
import pytest

from ocrs_tpu.train import data as J
from ocrs_tpu_torch.train import data as T


def test_labels_and_random_text_equal_jax():
    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET

    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(50):
        text = T.random_text(a, DEFAULT_ALPHABET)
        assert text == J.random_text(b, DEFAULT_ALPHABET)
        assert T.labels_for(text) == J.labels_for(text)
    assert T.labels_for("a€éb") == J.labels_for("a€éb")


@pytest.mark.parametrize("kw", [{}, {"render_kwargs": {"pixelfont_prob": 0.5, "empty_prob": 0.3}}], ids=["default", "mixed"])
def test_recognition_batches_equal_jax(kw):
    gt, gj = T.recognition_batches(3, width=256, seed=4, **kw), J.recognition_batches(3, width=256, seed=4, **kw)
    for _ in range(2):
        for a, b in zip(next(gt), next(gj)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_detection_batches_equal_jax():
    a = next(T.detection_batches(2, page_hw=(160, 128), seed=3))
    b = next(J.detection_batches(2, page_hw=(160, 128), seed=3))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_render_page_equals_jax():
    for vocab in (False, True):
        a = T.render_page(np.random.default_rng(2), (200, 300), n_lines=4, return_words=True, vocab_words=vocab)
        b = J.render_page(np.random.default_rng(2), (200, 300), n_lines=4, return_words=True, vocab_words=vocab)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    np.testing.assert_array_equal(T.render_line("Tab 12", 32), J.render_line("Tab 12", 32))


def _assert_batches_equal(ds_t, ds_j, batch, n_batches=2):
    for as_u8 in (True, False):
        gt = ds_t.batches(batch, seed=9, as_u8=as_u8)
        gj = ds_j.batches(batch, seed=9, as_u8=as_u8)
        for _ in range(n_batches):
            for a, b in zip(next(gt), next(gj)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_recognition_dataset_caches_cross_both_ways(tmp_path):
    pt, pj = tmp_path / "t" / "rec.npz", tmp_path / "j" / "rec.npz"
    kw = dict(width=192, seed=5, render_kwargs={"blockify_prob": 0.3, "empty_prob": 0.2})
    written_t = T.RecognitionDataset(6, cache_path=pt, **kw)
    written_j = J.RecognitionDataset(6, cache_path=pj, **kw)
    assert pt.read_bytes() == pj.read_bytes()
    # Each package reads the other's file (the render arguments are ignored
    # when the cache exists).
    read_t = T.RecognitionDataset(0, width=192, cache_path=pj)
    read_j = J.RecognitionDataset(0, width=192, cache_path=pt)
    assert len(read_t) == len(read_j) == len(written_t) == 6
    for i in range(6):
        (ct, xt), (cj, xj) = read_t.get(i), written_j.get(i)
        np.testing.assert_array_equal(ct, cj)
        assert xt == xj
    _assert_batches_equal(read_t, read_j, 4)
    _assert_batches_equal(written_t, written_j, 3)
    # extra_caches concatenate in both.
    both_t = T.RecognitionDataset(0, width=192, cache_path=pt, extra_caches=[pj])
    both_j = J.RecognitionDataset(0, width=192, cache_path=pj, extra_caches=[pt])
    assert len(both_t) == len(both_j) == 12
    _assert_batches_equal(both_t, both_j, 5, n_batches=1)


def test_detection_dataset_caches_cross_both_ways(tmp_path):
    pt, pj = tmp_path / "t" / "det.npz", tmp_path / "j" / "det.npz"
    written_t = T.DetectionDataset(3, page_hw=(120, 96), seed=2, cache_path=pt)
    written_j = J.DetectionDataset(3, page_hw=(120, 96), seed=2, cache_path=pj)
    assert pt.read_bytes() == pj.read_bytes()
    read_t = T.DetectionDataset(0, page_hw=(120, 96), cache_path=pj)
    read_j = J.DetectionDataset(0, page_hw=(120, 96), cache_path=pt)
    assert len(read_t) == len(read_j) == 3
    _assert_batches_equal(read_t, read_j, 2)
    _assert_batches_equal(written_t, written_j, 4)
    with pytest.raises(ValueError, match="extra_caches"):
        T.DetectionDataset(1, page_hw=(120, 96), extra_caches=[pt])
