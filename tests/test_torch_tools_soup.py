"""``ocrs_tpu_torch.tools.soup`` writes the JAX tool's file: every leaf and
the metadata equal, bit for bit; different structures are refused as the
JAX tool refuses them."""

import sys

import numpy as np
import pytest

from ocrs_tpu_torch.tools import soup as port
from test_torch_support import REPO, repo_tool

REC = str(REPO / "weights" / "text-recognition.npz")
CAND = str(REPO / "weights" / "cand_r5.npz")
DET = str(REPO / "weights" / "text-detection.npz")


def _run_jax(monkeypatch, argv):
    jtool = repo_tool("soup")
    monkeypatch.setattr(sys, "argv", ["soup.py", *argv])
    jtool.main()


@pytest.mark.parametrize("weights", [None, ["0.3", "0.7"]])
def test_soup_equals_the_jax_tools_leaf_for_leaf(tmp_path, monkeypatch, capsys, weights):
    extra = [] if weights is None else ["--w", *weights]
    _run_jax(monkeypatch, [REC, CAND, "-o", str(tmp_path / "jax.npz"), *extra])
    want_line = capsys.readouterr().out.replace(str(tmp_path / "jax.npz"), "OUT")
    port.main([REC, CAND, "-o", str(tmp_path / "port.npz"), *extra])
    assert capsys.readouterr().out.replace(str(tmp_path / "port.npz"), "OUT") == want_line
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert got.files == want.files
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    from ocrs_tpu_torch.models.weights import load_params

    _, meta = load_params(tmp_path / "port.npz")
    assert meta["soup_of"] == ["text-recognition.npz", "cand_r5.npz"]
    assert meta["soup_weights"] == ([0.5, 0.5] if weights is None else [0.3 / 1.0, 0.7 / 1.0])


def test_different_structures_are_refused_as_the_jax_tool_refuses_them(tmp_path, monkeypatch, capsys):
    for run in (lambda argv: _run_jax(monkeypatch, argv), port.main):
        with pytest.raises(SystemExit) as exc:
            run([REC, DET, "-o", str(tmp_path / "x.npz")])
        assert exc.value.code == 2
        assert "checkpoints have different parameter structures" in capsys.readouterr().err
        with pytest.raises(SystemExit) as exc:
            run([REC, CAND, "--w", "1", "-o", str(tmp_path / "x.npz")])
        assert exc.value.code == 2
        assert "--w must match the number of checkpoints" in capsys.readouterr().err
    assert not (tmp_path / "x.npz").exists()
