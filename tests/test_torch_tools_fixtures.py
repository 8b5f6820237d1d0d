"""The committed page sets of ``test-data/eval/`` are what the port's
renderers draw, array for array, and what the JAX package's renderers draw
(``tools/torch_eval_fixtures.py`` wrote them; the card reads them through the
tools' ``--pages-from``)."""

import json

import numpy as np
import pytest

from ocrs_tpu_torch.tools import eval_accuracy, eval_independent, profile_stages
from test_torch_support import EVAL_DATA

ACCURACY = EVAL_DATA / "accuracy_s1234_p8.npz"


def _assert_same_npz(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture(scope="module")
def accuracy_pages():
    return eval_accuracy.draw_pages(8, 1234)


def test_accuracy_pages_are_remade_array_for_array(accuracy_pages, tmp_path):
    eval_accuracy.save_pages(tmp_path / "a.npz", accuracy_pages, 1234)
    _assert_same_npz(tmp_path / "a.npz", ACCURACY)
    read = eval_accuracy.read_pages(ACCURACY, 8, 1234)
    for (page, words), (rpage, rwords) in zip(accuracy_pages, read):
        np.testing.assert_array_equal(rpage, page)
        assert [(t, tuple(map(float, b))) for t, b in words] == rwords


def test_first_accuracy_pages_equal_the_jax_renderers(accuracy_pages):
    from ocrs_tpu.train.render import render_native_page

    rng = np.random.default_rng(1234)
    for page, words in accuracy_pages[:2]:
        page01, gt = render_native_page(rng)
        while not gt:
            page01, gt = render_native_page(rng)
        np.testing.assert_array_equal((page01 * 255).astype(np.uint8), page)
        assert gt == words


def test_independent_pages_are_remade_array_for_array(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pygame")
    try:
        eval_independent.minecraft_path()
    except eval_independent.RenderUnavailable as e:
        pytest.skip(str(e))
    groups = eval_independent.draw_groups()
    eval_independent.save_groups(tmp_path / "i.npz", groups)
    _assert_same_npz(tmp_path / "i.npz", EVAL_DATA / "independent.npz")
    assert [(g, len(p)) for g, p in eval_independent.read_groups(EVAL_DATA / "independent.npz").items()] == [
        ("matplotlib", 4), ("pygame", 3), ("heldout-font", 2)
    ]


def test_profile_pages_are_remade_array_for_array():
    with np.load(EVAL_DATA / "profile_p16.npz") as data:
        committed = data["pages"]
    assert committed.shape == (16, 3508, 2480) and committed.dtype == np.uint8
    np.testing.assert_array_equal(profile_stages.draw_pages(16), committed)


def test_reference_describes_the_committed_pages(accuracy_pages):
    """reference.json's JAX results are of these pages: their sizes and
    word counts, one entry a page, the tools' commands and the CPU."""
    ref = json.loads((EVAL_DATA / "reference.json").read_text())
    assert ref["platform"] == "JAX_PLATFORMS=cpu" and len(ref["commit"]) == 40
    acc = ref["eval_accuracy"]
    assert acc["command"].endswith("--pages 8") and acc["result"]["pages"] == 8
    assert [(p["hw"], p["words"]) for p in acc["per_page"]] == [
        (list(page.shape), len(words)) for page, words in accuracy_pages
    ]
    ind = ref["eval_independent"]
    with np.load(EVAL_DATA / "independent.npz") as data:
        shapes = [list(data[f"page_{i}"].shape) for i in range(len(data["groups"]))]
        groups = [str(g) for g in data["groups"]]
    assert [s for g in ind["pages"].values() for s in g] == shapes
    assert {g: len(v) for g, v in ind["result"].items() if g != "overall"} == {
        g: groups.count(g) for g in dict.fromkeys(groups)
    }
