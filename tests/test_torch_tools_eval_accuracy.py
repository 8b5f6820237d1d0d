"""``ocrs_tpu_torch.tools.eval_accuracy`` against ``tools/eval_accuracy.py``:
the same scoring on the same predictions, and on the same pages with the
shipped weights the same scores within the stated tolerance."""

import json

import numpy as np
import pytest

from ocrs_tpu_torch.tools import eval_accuracy as port
from test_torch_support import (  # noqa: F401
    DET_WEIGHTS, EVAL_DATA, REC_WEIGHTS, TOOLS_F1_TOL as F1_TOL, jax_native, repo_tool,
)

ACCURACY = EVAL_DATA / "accuracy_s1234_p8.npz"


class _Item:
    def __init__(self, text, box):
        self.text, self.box = text, box

    def bounding_rect(self):
        from types import SimpleNamespace

        t, l, b, r = self.box
        return SimpleNamespace(top=t, left=l, bottom=b, right=r)

    def __str__(self):
        return self.text


class _Line:
    def __init__(self, words):
        self._words = words

    def words(self):
        return iter(self._words)


class StubEngine:
    """An engine whose detections and recognized lines are given."""

    def __init__(self, per_page):
        self.per_page = list(per_page)

    def prepare_input(self, image):
        return None

    def detect_words(self, inp):
        self.words, self.lines = self.per_page.pop(0)
        return self.words

    def find_text_lines(self, inp, words):
        return []

    def recognize_text(self, inp, lines):
        return self.lines


def _stub_pages(rng, n_pages):
    """Pages with ground truth, and detections/predictions near it: moved,
    split, misread, missing and spurious words."""
    pages, outputs = [], []
    for _ in range(n_pages):
        gt = []
        for _ in range(int(rng.integers(3, 12))):
            t, l = rng.uniform(0, 300, 2)
            gt.append(("".join(rng.choice(list("abcde1"), int(rng.integers(1, 6)))), (t, l, t + rng.uniform(8, 30), l + rng.uniform(10, 80))))
        dets, words = [], []
        for text, (t, l, b, r) in gt:
            if rng.random() < 0.15:
                continue
            jit = rng.normal(0, 4, 4)
            box = (t + jit[0], l + jit[1], b + jit[2], r + jit[3])
            dets.append(_Item("", box))
            text = text if rng.random() < 0.6 else text[::-1] + ("x" if rng.random() < 0.5 else "")
            words.append(_Item(text, box))
        for _ in range(int(rng.integers(0, 3))):
            t, l = rng.uniform(0, 300, 2)
            dets.append(_Item("", (t, l, t + 10, l + 20)))
            words.append(_Item("zz", (t, l, t + 10, l + 20)))
        lines = [_Line(words[i : i + 3]) for i in range(0, len(words), 3)] + [None]
        pages.append((np.zeros((4, 4), np.uint8), gt))
        outputs.append((dets, lines))
    return pages, outputs


def test_iou_and_edit_distance_equal_the_jax_tools():
    jtool = repo_tool("eval_accuracy")
    rng = np.random.default_rng(0)
    for _ in range(500):
        a, b = (tuple(np.sort(rng.uniform(0, 50, 2)).tolist() * 2) for _ in range(2))
        a = (a[0], a[1] - 10, a[2] + 5, a[3] + 7)
        assert port._iou(a, b) == jtool._iou(a, b)
        s, t = ("".join(rng.choice(list("abc "), int(rng.integers(0, 7)))) for _ in range(2))
        assert port._edit_distance(s, t) == jtool._edit_distance(s, t)


@pytest.mark.parametrize("iou, max_edit", [(0.3, 1), (0.5, 0), (0.1, 2)])
def test_matching_equals_the_jax_tools_on_the_same_predictions(iou, max_edit):
    jtool = repo_tool("eval_accuracy")
    pages, outputs = _stub_pages(np.random.default_rng(int(iou * 10) + max_edit), 6)
    want_engine, got_engine = StubEngine(outputs), StubEngine(outputs)
    with repo_tool("torch_eval_fixtures").jax_pages(pages):
        want = jtool.evaluate(want_engine, len(pages), 0, iou, max_edit)
    assert port.score_pages(got_engine, pages, iou, max_edit) == want


def test_two_smallest_pages_with_the_shipped_weights_against_the_jax_tool(jax_native):
    from ocrs_tpu.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu.models.weights import load_detection_model, load_params, load_recognition_model

    jtool = repo_tool("eval_accuracy")
    pages = port.read_pages(ACCURACY, 8, 1234)
    smallest = sorted(range(8), key=lambda i: pages[i][0].size)[:2]
    chosen = [pages[i] for i in smallest]
    _, meta = load_params(REC_WEIGHTS)
    jengine = OcrEngine(
        OcrEngineParams(
            detection_model=load_detection_model(str(DET_WEIGHTS)),
            recognition_model=load_recognition_model(str(REC_WEIGHTS)),
            alphabet=meta.get("alphabet"),
        )
    )
    with repo_tool("torch_eval_fixtures").jax_pages(chosen):
        want = jtool.evaluate(jengine, 2, 1234, 0.3, 1)
    engine = port.build_engine(DET_WEIGHTS, REC_WEIGHTS, device="cpu")
    got = port.score_pages(engine, chosen, 0.3, 1)
    assert got["pages"] == want["pages"] == 2
    assert got["detection"] == want["detection"]
    assert abs(got["end_to_end"]["f1"] - want["end_to_end"]["f1"]) <= F1_TOL
    # reference.json holds the JAX tool's result on each page alone.
    ref = json.loads((EVAL_DATA / "reference.json").read_text())["eval_accuracy"]["per_page"]
    for i in smallest:
        one = port.score_pages(engine, [pages[i]], 0.3, 1)
        assert one["detection"] == ref[i]["detection"]
        assert abs(one["end_to_end"]["f1"] - ref[i]["end_to_end"]["f1"]) <= F1_TOL


def test_a_page_file_of_another_seed_or_too_few_pages_is_refused(capsys):
    with pytest.raises(ValueError, match="seed 1234, not 999"):
        port.read_pages(ACCURACY, 2, 999)
    with pytest.raises(ValueError, match="8 pages, fewer than the 9"):
        port.read_pages(ACCURACY, 9, 1234)
    with pytest.raises(SystemExit) as exc:
        port.main(["--detect", str(DET_WEIGHTS), "--rec", str(REC_WEIGHTS), "--seed", "7",
                   "--pages-from", str(ACCURACY), "--device", "cpu"])
    assert exc.value.code == 2 and "seed 1234, not 7" in capsys.readouterr().err


def test_main_prints_the_tools_json_from_a_page_file(capsys):
    assert port.main(["--detect", str(DET_WEIGHTS), "--rec", str(REC_WEIGHTS), "--pages", "1",
                      "--pages-from", str(ACCURACY), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    ref = json.loads((EVAL_DATA / "reference.json").read_text())["eval_accuracy"]["per_page"][0]
    assert set(out) == {"pages", "detection", "end_to_end"} and out["pages"] == 1
    assert out["detection"] == ref["detection"]
    assert abs(out["end_to_end"]["f1"] - ref["end_to_end"]["f1"]) <= F1_TOL
