"""``ocrs_tpu_torch.tools.eval_independent`` against
``tools/eval_independent.py``: the same word-multiset scores, and on the
same pages with the shipped weights the same results within the stated
tolerance."""

import json

import numpy as np
import pytest

from ocrs_tpu_torch.tools import eval_independent as port
from test_torch_support import EVAL_DATA, assert_independent_close, jax_native, repo_tool  # noqa: F401

INDEPENDENT = EVAL_DATA / "independent.npz"


def test_word_prf_equals_the_jax_tools():
    jtool = repo_tool("eval_independent")
    rng = np.random.default_rng(0)
    vocab = ["a", "b", "the", "The", "1969", "fox."]
    for _ in range(300):
        pred, expected = (" ".join(rng.choice(vocab, int(rng.integers(0, 9)))) for _ in range(2))
        assert port.word_prf(pred, expected) == jtool.word_prf(pred, expected)
    assert port.PARAGRAPHS == jtool.PARAGRAPHS and port.TITLES == jtool.TITLES


def test_two_pages_against_the_jax_tool(jax_native, monkeypatch, capsys):
    """The figure page with a rotated axis label and the table, through the
    JAX tool's main (its renderers handing out the committed pages) and the
    port's scoring with the same engine settings."""
    jtool = repo_tool("eval_independent")
    groups = port.read_groups(INDEPENDENT)
    chosen = {"matplotlib": [groups["matplotlib"][1], groups["matplotlib"][3]]}
    monkeypatch.setattr(jtool, "render_matplotlib", lambda seed: chosen["matplotlib"])
    monkeypatch.setattr(jtool, "render_pygame", lambda seed: [])
    monkeypatch.setattr(jtool, "render_heldout_font", lambda seed: [])
    assert jtool.main([]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    engine = port.build_engine(vertical=True, min_line_conf=0.45, device="cpu")
    got, _ = port.score_groups(engine, chosen)
    want.pop("pygame"), want.pop("heldout-font")
    assert_independent_close(got, want)


def test_missing_renderers_raise_render_unavailable(monkeypatch):
    monkeypatch.setattr(port, "MINECRAFT", ("no_such_package_here", "x.ttf"))
    with pytest.raises(port.RenderUnavailable, match="no_such_package_here"):
        port.render_heldout_font(2)
    monkeypatch.setattr(port, "_require", lambda m: (_ for _ in ()).throw(port.RenderUnavailable(m)))
    with pytest.raises(port.RenderUnavailable, match="matplotlib"):
        port.render_matplotlib(0)
