"""The port's HierText loader (ocrs_tpu_torch.train.hiertext) against the
JAX package's on fabricated miniature pages (the fixture of
tests/test_hiertext.py, in this file's own copy): both ground-truth
schemas parse to the same records, and detection and recognition batches
from equal seeds are equal, exactly."""

import json

import numpy as np
import pytest

from ocrs_tpu.train.hiertext import HierTextDataset as JDataset
from ocrs_tpu_torch.train.data import labels_for
from ocrs_tpu_torch.train.hiertext import HierTextDataset as TDataset


def _page(path, lines, size=(400, 160)):
    """Draw `lines` (list of (y, words)) with DejaVu Sans 28 and return the
    official-schema line records with each word's vertices."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", 28)
    img = Image.new("L", size, 255)
    draw = ImageDraw.Draw(img)
    records = []
    for y, texts in lines:
        words, x = [], 20
        for text in texts:
            x0, y0, x1, y1 = draw.textbbox((x, y), text, font=font)
            draw.text((x, y), text, font=font, fill=0)
            words.append({"text": text, "legible": True, "vertices": [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]})
            x = x1 + 18
        records.append({"text": " ".join(texts), "words": words})
    img.save(path)
    return records


@pytest.fixture()
def pages(tmp_path):
    pytest.importorskip("PIL")
    lines1 = _page(tmp_path / "page1.png", [(40, ["hello", "world"])], size=(400, 120))
    lines2 = _page(tmp_path / "page2.png", [(20, ["Tab", "12%", "notes"]), (90, ["second", "line"])])
    # An illegible word and a vertical line, both skipped.
    lines2[1]["words"].append({"text": "xx", "legible": False, "vertices": [[300, 90], [330, 90], [330, 110], [300, 110]]})
    lines2.append({"text": "v", "vertical": True, "words": [{"text": "v", "vertices": [[5, 5], [9, 5], [9, 30], [5, 30]]}]})
    gt = {
        "annotations": [
            {"image_id": "page1", "paragraphs": [{"lines": lines1}]},
            {"image_id": "page2", "paragraphs": [{"lines": lines2}]},
            # No image on disk: skipped, not an error.
            {"image_id": "missing", "paragraphs": [{"lines": [{"text": "x", "words": [
                {"text": "x", "vertices": [[0, 0], [5, 0], [5, 5], [0, 5]]}]}]}]},
        ]
    }
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    # The CLI's JSON output of page 1 (the single-image schema).
    (tmp_path / "single.json").write_text(json.dumps({"url": "page1", "paragraphs": [{"lines": lines1}]}))
    return tmp_path


def _records(ds):
    return [(p.image_path.name, [(l.text, [(w.text, w.box) for w in l.words]) for l in p.lines]) for p in ds.pages]


@pytest.mark.parametrize("gt", ["gt.json", "single.json"])
def test_both_schemas_parse_as_jax_parses_them(pages, gt):
    t, j = TDataset(pages / gt, pages), JDataset(pages / gt, pages)
    assert len(t) == len(j) == (2 if gt == "gt.json" else 1)
    assert _records(t) == _records(j)
    assert t.pages[0].words == j.pages[0].words
    np.testing.assert_array_equal(t.pages[0].load_gray01(), j.pages[0].load_gray01())
    if gt == "gt.json":
        assert [w.text for l in t.pages[1].lines for w in l.words] == ["Tab", "12%", "notes", "second", "line"]


@pytest.mark.parametrize("gt", ["gt.json", "single.json"])
def test_detection_batches_equal_jax(pages, gt):
    gt_, gj = TDataset(pages / gt, pages).detection_batches(3, page_hw=(160, 128), seed=1), JDataset(
        pages / gt, pages
    ).detection_batches(3, page_hw=(160, 128), seed=1)
    for _ in range(2):
        (it, mt), (ij, mj) = next(gt_), next(gj)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(mt, mj)
        assert mt.sum() > 0


@pytest.mark.parametrize("gt", ["gt.json", "single.json"])
def test_recognition_batches_equal_jax(pages, gt):
    t, j = TDataset(pages / gt, pages), JDataset(pages / gt, pages)
    # max_label_len 8 truncates "Tab 12% notes" word-wise.
    for max_len in (40, 8):
        bt = t.recognition_batches(4, width=256, max_label_len=max_len, seed=2)
        bj = j.recognition_batches(4, width=256, max_label_len=max_len, seed=2)
        for _ in range(2):
            for a, b in zip(next(bt), next(bj)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    if gt == "single.json":  # one line: every row is "hello world", ink on paper
        images, labels, lengths = next(t.recognition_batches(2, width=256, seed=0))
        assert all(list(labels[i, : lengths[i]]) == labels_for("hello world") for i in range(2))
        assert images[0].min() < -0.2 and images[0].max() > 0.3


def test_empty_dataset_raises(tmp_path):
    (tmp_path / "gt.json").write_text(json.dumps({"annotations": []}))
    ds = TDataset(tmp_path / "gt.json", tmp_path)
    with pytest.raises(ValueError, match="empty"):
        next(ds.detection_batches(1))
    with pytest.raises(ValueError, match="empty"):
        next(ds.recognition_batches(1))
