"""``ocrs_tpu_torch.tools.gen_golden`` draws the committed golden pages of
the CLI tier pixel for pixel (written into a temporary directory; the
repository's pages are never rewritten)."""

import numpy as np

from ocrs_tpu_torch.png import read_png
from ocrs_tpu_torch.tools import gen_golden
from test_torch_support import REPO


def test_written_pages_equal_the_committed_ones(tmp_path, capsys):
    gen_golden.main(tmp_path / "golden")
    assert f"Wrote golden images to {tmp_path / 'golden'}" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "golden").iterdir())
    assert names == ["strip-line.png", "two-lines.png"]
    for name in names:
        got, want = read_png(tmp_path / "golden" / name), read_png(REPO / "test-data" / name)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pages_equal_the_jax_tools_drawing():
    """The JAX tool's drawing routine (called on arrays, not run) gives the
    same pixels."""
    from test_torch_support import repo_tool

    jtool = repo_tool("gen_golden")
    img = np.zeros((160, 320), dtype=np.uint8)
    jtool.draw_line(img, 48, 32, rows=[8, 16, 24, 32, 40, 48])
    np.testing.assert_array_equal(gen_golden.golden_pages()["strip-line.png"], img)
    assert (gen_golden.STRIP, gen_golden.BRIGHT) == (jtool.STRIP, jtool.BRIGHT)
