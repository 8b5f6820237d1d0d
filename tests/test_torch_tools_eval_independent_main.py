"""``python -m ocrs_tpu_torch.tools.eval_independent --pages-from`` on the
nine committed pages on the CPU, against the JAX tool's result on the same
pages (``test-data/eval/reference.json``)."""

import json

import numpy as np

from ocrs_tpu_torch.tools import eval_independent as port
from test_torch_support import EVAL_DATA, assert_independent_close

INDEPENDENT = EVAL_DATA / "independent.npz"


def test_main_on_the_page_file_against_the_reference(capsys, tmp_path):
    """All nine committed pages through the port's CLI entry on the CPU,
    against the JAX tool's result in reference.json; --min-f1 gates the
    exit code; --save-dir writes the pages as PNG."""
    from ocrs_tpu_torch.png import read_png

    want = json.loads((EVAL_DATA / "reference.json").read_text())["eval_independent"]["result"]
    assert port.main(["--pages-from", str(INDEPENDENT), "--device", "cpu", "--save-dir", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert_independent_close(got, want)
    groups = port.read_groups(INDEPENDENT)
    np.testing.assert_array_equal(read_png(tmp_path / "pygame-2.png"), groups["pygame"][2][0])
    one = tmp_path / "one.npz"
    port.save_groups(one, {"heldout-font": groups["heldout-font"][:1]})
    assert port.main(["--pages-from", str(one), "--device", "cpu", "--min-f1", "0.99"]) == 1
    assert json.loads(capsys.readouterr().out)["overall"]["pages"] == 1
