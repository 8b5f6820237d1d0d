"""``ocrs_tpu_torch.tools.test_e2e``: the port's CLI prints the committed
golden texts with the fake models, a wrong baseline fails, and ``--update``
rewrites baselines (only ever in a copy)."""

import shutil

from ocrs_tpu_torch.tools import test_e2e as tool
from test_torch_support import REPO


def test_default_tier_over_test_data_passes_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all golden tests passed" in out
    assert out.count("  OK") == len(list((REPO / "test-data").glob("*.png")))


def test_wrong_baseline_fails_and_update_rewrites_it(tmp_path, capsys):
    shutil.copy(REPO / "test-data" / "two-lines.png", tmp_path)
    expected = tmp_path / "two-lines.expected.txt"
    expected.write_text("not what the CLI reads\n")
    assert tool.main([str(tmp_path), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "MISMATCH vs two-lines.expected.txt" in err and "1 failure(s)" in err

    assert tool.main([str(tmp_path), "--device", "cpu", "--update"]) == 0
    assert "updated two-lines.expected.txt" in capsys.readouterr().out
    golden = (REPO / "test-data" / "two-lines.expected.txt").read_text()
    assert tool.strip_whitespace(expected.read_text()) == tool.strip_whitespace(golden)


def test_missing_baseline_and_empty_directory_fail(tmp_path, capsys):
    assert tool.main([str(tmp_path), "--device", "cpu"]) == 1
    assert "no test images" in capsys.readouterr().err
    shutil.copy(REPO / "test-data" / "strip-line.png", tmp_path)
    assert tool.main([str(tmp_path), "--device", "cpu"]) == 1
    assert "MISSING baseline strip-line.expected.txt" in capsys.readouterr().err
