"""``ocrs_tpu_torch.tools.profile_stages`` on two small pages on the CPU:
every row of the JAX tool, and the words and lines that
``PagePipeline.process`` finds on the same pages."""

import json

import numpy as np
import pytest

from ocrs_tpu_torch.tools import profile_stages as tool
from test_torch_support import DET_WEIGHTS, REC_WEIGHTS

ROWS = [
    "normalize", "det_pre resize", "unet fwd", "ccl multigrid", "rects fit", "pack", "table readback",
    "FUSED detect", "tables_to_words (host)", "layout (host)", "rec prep: polygons", "rec batch dispatch",
    "extract alone", "rec fwd alone", "argmax (greedy u8)", "label readback", "ctc collapse (host)",
    "FULL recognize stage", "FULL recognize stage 2",
]


@pytest.fixture(scope="module")
def page_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("profile") / "pages.npz"
    np.savez_compressed(path, pages=tool.draw_pages(2, page_hw=(640, 480)))
    return path


def test_rows_and_counts_match_the_pipeline(page_file, capsys):
    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
    from ocrs_tpu_torch.parallel.pipeline import PagePipeline

    assert tool.main(["--pages", "2", "--pages-from", str(page_file), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert list(result["rows"]) == ROWS
    assert [l.split("  ")[0].strip() for l in lines[1:-1] if not l.startswith("  ")] == ROWS
    for row in result["rows"].values():
        assert row["clock"] == "host" and 0 <= row["ms"] <= row["median_ms"]
    assert result["pages"] == [2, 640, 480] and result["device"] == "cpu"
    pages = tool.read_pages(page_file, 2)
    pipe = PagePipeline(
        load_detection_model(DET_WEIGHTS), load_recognition_model(REC_WEIGHTS), DEFAULT_ALPHABET,
        max_lines_per_batch=128, device="cpu",
    )
    results = pipe.process(pages)
    assert result["words"] == sum(len(r.words) for r in results) > 0
    assert result["lines"] == sum(len(r.lines) for r in results) > 0


def test_too_many_pages_are_refused(page_file, capsys):
    with pytest.raises(SystemExit) as exc:
        tool.main(["--pages", "3", "--pages-from", str(page_file), "--device", "cpu"])
    assert exc.value.code == 2 and "2 pages, fewer than the 3" in capsys.readouterr().err
