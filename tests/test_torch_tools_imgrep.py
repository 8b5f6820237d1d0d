"""``ocrs_tpu_torch.tools.imgrep`` against ``tools/imgrep.py``: the same
lines on the same PNG directory, and the exit codes 0 (a match), 1 (none)
and 2 (usage)."""

import sys

import pytest

from ocrs_tpu_torch.png import read_png, write_png
from ocrs_tpu_torch.tools import imgrep as port
from test_torch_support import REPO, jax_native, repo_tool, text_page_rgb  # noqa: F401


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """The text page (lines the shipped weights read with wide margins) and
    one of the golden pages, in a directory with a subdirectory."""
    root = tmp_path_factory.mktemp("imgrep")
    (root / "sub").mkdir()
    write_png(root / "text.png", text_page_rgb())
    write_png(root / "sub" / "strip.png", read_png(REPO / "test-data" / "strip-line.png"))
    (root / "notes.txt").write_text("not an image")
    return root


def test_same_lines_as_the_jax_tool(pages, monkeypatch, capsys, jax_native):
    jtool = repo_tool("imgrep")
    monkeypatch.setattr(sys, "argv", ["imgrep.py", "S", str(pages)])  # both lines, any case
    want_rc = jtool.main()
    want = capsys.readouterr().out
    assert port.main(["S", str(pages), "--device", "cpu"]) == want_rc == 0
    assert capsys.readouterr().out == want
    text = pages / "text.png"
    assert [l for l in want.splitlines() if l.startswith(f"{text}:")] == [
        f"{text}:1: Section 12 notes", f"{text}:2: This line is longer"
    ]


def test_exit_codes_and_errors(pages, tmp_path, capsys):
    assert port.main(["Section 12 notes", str(pages / "text.png"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == f"{pages / 'text.png'}:1: Section 12 notes\n"
    assert port.main(["--device=cpu", "zebra", str(pages)]) == 1
    assert capsys.readouterr().out == ""
    assert port.main(["Section"]) == 2
    assert "imgrep" in capsys.readouterr().err
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    assert port.main(["Section", str(bad), str(pages / "text.png"), "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert err.startswith(f"{bad}: error: ") and out.startswith(f"{pages / 'text.png'}:1:")


def test_random_weights_without_weight_files(pages, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port, "WEIGHTS_DIR", tmp_path)
    monkeypatch.delenv("OCRS_TPU_DETECT_MODEL", raising=False)
    monkeypatch.delenv("OCRS_TPU_REC_MODEL", raising=False)
    assert port.main(["Section 12 notes", str(pages / "text.png"), "--device", "cpu"]) == 1
    assert "warning: no weights found; using random weights" in capsys.readouterr().err
    monkeypatch.setenv("OCRS_TPU_DETECT_MODEL", str(REPO / "weights" / "text-detection.npz"))
    monkeypatch.setenv("OCRS_TPU_REC_MODEL", str(REPO / "weights" / "text-recognition.npz"))
    assert port.main(["Section 12 notes", str(pages / "text.png"), "--device", "cpu"]) == 0
