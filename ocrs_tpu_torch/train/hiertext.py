"""HierText-format dataset loader: the port of ``ocrs_tpu.train.hiertext``.

The upstream production models are trained on the HierText dataset in the
external ocrs-models repo. This module reads HierText ground-truth JSON (the
schema the CLI's JSON output also follows, ocrs-cli/src/output.rs:24-76)
plus the page images, and feeds them through the SAME pipeline-exact
transforms the synthetic renderer uses (:mod:`.render`):

  * detection samples go through the pad-then-resize law + shrunk word-core
    masks (``render.detection_sample_from_native``);
  * recognition samples go through detection-style expanded word rects, the
    line polygon and the polygon-masked aspect resize
    (``recognition.prepare_text_line_host``).

Accepted ground-truth schemas (auto-detected):

  * official HierText: ``{"annotations": [{"image_id", "paragraphs": [...]}]}``
    with ``paragraphs -> lines -> words``, each word carrying ``vertices``
    (list of [x, y]) and ``text``; illegible/vertical words are skipped.
  * the CLI's JSON output (single image): ``{"url", "paragraphs": [...]}``.

The generators match the batch interfaces of :mod:`.data`, so the trainer's
hyperparameters transfer unchanged. Page images are decoded with Pillow,
imported inside :meth:`HierTextPage.load_gray01`. No dataset is bundled.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..engine import DEFAULT_ALPHABET
from ..geometry import Rect, RotatedRect
from ..preprocess import BLACK_VALUE
from ..recognition import line_polygon, prepare_text_line_host, resized_line_width
from . import render as R
from .data import labels_for


@dataclass
class HierTextWord:
    text: str
    #: tight bounding box (t, l, b, r) in page coordinates.
    box: tuple[float, float, float, float]


@dataclass
class HierTextLine:
    text: str
    words: list[HierTextWord]


@dataclass
class HierTextPage:
    image_path: Path
    lines: list[HierTextLine]

    @property
    def words(self) -> list[tuple[str, tuple[float, float, float, float]]]:
        """(text, (t, l, b, r)) records for every word, the detection-sample
        input format of ``render.detection_sample_from_native``."""
        return [(w.text, w.box) for line in self.lines for w in line.words]

    def load_gray01(self) -> np.ndarray:
        """Page as [H, W] float in [0, 1] (ITU BT.601 luma, the same
        transform the inference pipeline applies — preprocess.rs:171)."""
        img = R.pillow("Image").open(self.image_path).convert("L")
        return np.asarray(img, np.float32) / 255.0


def _word_box(vertices: Sequence[Sequence[float]]) -> tuple[float, float, float, float]:
    v = np.asarray(vertices, np.float64).reshape(-1, 2)
    return (float(v[:, 1].min()), float(v[:, 0].min()),
            float(v[:, 1].max()), float(v[:, 0].max()))


def _parse_paragraphs(paragraphs: list, alphabet: str) -> list[HierTextLine]:
    lines: list[HierTextLine] = []
    for para in paragraphs:
        for line in para.get("lines", ()):
            if line.get("vertical"):
                continue
            words = []
            for word in line.get("words", ()):
                if word.get("legible") is False or word.get("vertical"):
                    continue
                text = "".join(c for c in word.get("text", "") if c in alphabet)
                verts = word.get("vertices")
                if not text or not verts:
                    continue
                words.append(HierTextWord(text, _word_box(verts)))
            if words:
                text = line.get("text") or " ".join(w.text for w in words)
                text = "".join(c for c in text if c in alphabet)
                lines.append(HierTextLine(text, words))
    return lines


class HierTextDataset:
    """Parsed HierText ground truth + image directory.

    ``gt_path`` may be the official ``{"annotations": [...]}`` file or a
    single-image CLI-output JSON. Images resolve as
    ``<images_dir>/<image_id>.jpg`` (or ``.png``; explicit ``image_path``
    keys win).
    """

    def __init__(
        self,
        gt_path: str | Path,
        images_dir: str | Path,
        alphabet: str = DEFAULT_ALPHABET,
    ):
        self.alphabet = alphabet
        images_dir = Path(images_dir)
        doc = json.loads(Path(gt_path).read_text())
        entries = doc["annotations"] if "annotations" in doc else [doc]
        self.pages: list[HierTextPage] = []
        for entry in entries:
            lines = _parse_paragraphs(entry.get("paragraphs", []), alphabet)
            if not lines:
                continue
            path = entry.get("image_path")
            if path is None:
                image_id = entry.get("image_id") or entry.get("url", "page")
                for ext in (".jpg", ".png", ".jpeg", ".webp"):
                    cand = images_dir / f"{image_id}{ext}"
                    if cand.exists():
                        path = cand
                        break
                else:
                    continue  # no image on disk for this annotation
            self.pages.append(HierTextPage(Path(path), lines))

    def __len__(self) -> int:
        return len(self.pages)

    # -- detection ----------------------------------------------------------

    def detection_batches(
        self,
        batch_size: int,
        page_hw: tuple[int, int] = (800, 608),
        seed: int = 0,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Infinite (images [B,1,H,W], masks [B,1,H,W]) batches at detector
        resolution, same contract as ``data.detection_batches``."""
        rng = np.random.default_rng(seed)
        n = len(self.pages)
        if n == 0:
            raise ValueError("empty HierText dataset")
        while True:
            imgs = np.zeros((batch_size, 1, *page_hw), np.float32)
            masks = np.zeros((batch_size, 1, *page_hw), np.float32)
            for i in range(batch_size):
                page = self.pages[int(rng.integers(n))]
                s = R.detection_sample_from_native(
                    page.load_gray01(), page.words, page_hw
                )
                imgs[i, 0] = s.image
                masks[i, 0] = s.mask
            yield imgs, masks

    # -- recognition ---------------------------------------------------------

    def _line_crop(
        self,
        page01: np.ndarray,
        line: HierTextLine,
        rng: np.random.Generator,
        out_h: int,
        width_budget: int,
    ) -> np.ndarray:
        """Pipeline-exact crop of one annotated line: detection-style
        expanded/jittered word rects -> line polygon -> polygon-masked
        aspect resize (mirrors render.render_recognition_sample geometry)."""
        rects = []
        for w in line.words:
            t, l, b, r = w.box
            e_x = 3.0 * float(rng.uniform(1.0, 4.0)) + float(rng.uniform(-1.5, 1.5))
            e_y = 3.0 * float(rng.uniform(0.8, 1.6)) + float(rng.uniform(-1.5, 1.5))
            rects.append(
                RotatedRect.from_rect(
                    Rect.from_tlbr(t - e_y, l - e_x, b + e_y, r + e_x)
                )
            )
        poly = line_polygon(rects)
        lr_w = float(poly[:, 0].max() - poly[:, 0].min())
        lr_h = float(poly[:, 1].max() - poly[:, 1].min())
        rw = min(resized_line_width(lr_w, max(lr_h, 1.0), out_h), width_budget)
        page = page01 + BLACK_VALUE
        return prepare_text_line_host(page[None], poly, rw, out_h)

    def recognition_batches(
        self,
        batch_size: int,
        width: int = 768,
        out_h: int = 64,
        max_label_len: int = 40,
        seed: int = 0,
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Infinite (images [B,1,64,width], labels [B,L], lengths [B])
        batches, same contract as ``data.recognition_batches``. Lines longer
        than ``max_label_len`` chars are truncated word-wise."""
        rng = np.random.default_rng(seed)
        all_lines = [
            (pi, li)
            for pi, page in enumerate(self.pages)
            for li in range(len(page.lines))
        ]
        if not all_lines:
            raise ValueError("empty HierText dataset")
        page_cache: dict[int, np.ndarray] = {}
        while True:
            images = np.full((batch_size, 1, out_h, width), BLACK_VALUE, np.float32)
            labels = np.zeros((batch_size, max_label_len), np.int32)
            lengths = np.zeros((batch_size,), np.int32)
            for i in range(batch_size):
                pi, li = all_lines[int(rng.integers(len(all_lines)))]
                page = self.pages[pi]
                if pi not in page_cache:
                    if len(page_cache) > 32:  # bound host RAM
                        page_cache.clear()
                    page_cache[pi] = page.load_gray01()
                line = page.lines[li]
                # Word-wise truncation to the label budget.
                kept: list[HierTextWord] = []
                total = 0
                for w in line.words:
                    if total + len(w.text) + bool(kept) > max_label_len:
                        break
                    kept.append(w)
                    total += len(w.text) + bool(len(kept) > 1)
                if not kept:
                    kept = [line.words[0]]
                sub = HierTextLine(" ".join(w.text for w in kept), kept)
                crop = self._line_crop(page_cache[pi], sub, rng, out_h, width)
                w = min(crop.shape[1], width)
                images[i, 0, :, :w] = crop[:, :w]
                lab = labels_for(sub.text, self.alphabet)[:max_label_len]
                labels[i, : len(lab)] = lab
                lengths[i] = len(lab) if lab else 1
                if not lab:
                    labels[i, 0] = 1
            yield images, labels, lengths
