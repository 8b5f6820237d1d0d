"""The port's copy of the pixel face (ocrs_tpu_torch.train.pixelfont) against
ocrs_tpu.train.pixelfont: equal glyphs, bitmaps, lines and word boxes on
seeded texts, scales, weights and letterform draws."""

import numpy as np
import pytest

from ocrs_tpu.train import pixelfont as jpf
from ocrs_tpu_torch.train import pixelfont as tpf

ALPHABET = jpf.supported()


def test_same_glyphs_and_forms():
    assert tpf.supported() == jpf.supported()
    for ch in ALPHABET:
        assert tpf.n_forms(ch) == jpf.n_forms(ch)
        for form in range(jpf.n_forms(ch)):
            for metrics in jpf.METRICS_VARIANTS:
                np.testing.assert_array_equal(tpf.glyph_array(ch, form, metrics), jpf.glyph_array(ch, form, metrics))


@pytest.mark.parametrize("seed", range(6))
def test_lines_and_boxes_equal_on_seeded_texts(seed):
    rng = np.random.default_rng(seed)
    pool = [c for c in ALPHABET if c.isalnum()] + [" "] * 4
    text = "".join(rng.choice(pool) for _ in range(int(rng.integers(3, 19)))).strip() or "a"
    scale = float(rng.uniform(1.0, 6.0))
    weight = int(rng.integers(0, 3))
    draws = [np.random.default_rng(seed + 100) for _ in range(2)]
    got = tpf.render_pixel_line(text, scale, weight=weight, rng=draws[0])
    want = jpf.render_pixel_line(text, scale, weight=weight, rng=draws[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert draws[0].integers(1 << 30) == draws[1].integers(1 << 30)  # the same draws were taken
    np.testing.assert_array_equal(tpf.text_bitmap(text, weight)[0], jpf.text_bitmap(text, weight)[0])
