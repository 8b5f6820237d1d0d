"""Synthetic training data: the port of ``ocrs_tpu.train.data``.

Supervised data from the styled synthetic renderer (:mod:`.render`), which
covers fonts x sizes x polarities x gray levels x blur/noise/JPEG x layouts
and pushes every sample through the inference pipeline's own geometry
(pad/resize squeeze for detection, polygon-masked crops for recognition).

Two access patterns:

  * streaming generators (:func:`recognition_batches`,
    :func:`detection_batches`) — render on the fly; simple, used by tests
    and small runs.
  * cached datasets (:class:`RecognitionDataset`, :class:`DetectionDataset`)
    — pre-render once into RAM (optionally persisted to an ``.npz``), then
    draw randomized batches with cheap per-batch augmentation. A cache
    file is byte for byte the JAX package's (``flat``, ``offsets``,
    ``widths``, ``texts``; ``images``, ``masks``), so either package reads
    the other's, and a machine without Pillow trains from a cache rendered
    elsewhere: loading one draws nothing.

Drawing needs Pillow (imported inside the functions that draw); where it or
a face is missing they raise :class:`.render.RenderUnavailable`. Batches are
the JAX package's from equal seeds. Real-dataset loaders (:mod:`.hiertext`)
plug in at the same batch interfaces.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..engine import DEFAULT_ALPHABET
from ..preprocess import BLACK_VALUE
from . import render as R


def _font(size: int = 48):
    """DejaVu Sans at `size` (Pillow looks the face up by name)."""
    try:
        return R.pillow("ImageFont").truetype("DejaVuSans.ttf", size)
    except OSError as e:
        raise R.RenderUnavailable(f"the plain renderer needs the face DejaVuSans.ttf, which Pillow cannot find ({e})") from e


def render_line(
    text: str,
    height: int = 64,
    rng: Optional[np.random.Generator] = None,
    invert: bool = False,
) -> np.ndarray:
    """Render `text` as a normalized greyscale line image [height, W].

    Plain single-font renderer kept for tests/debugging; training data comes
    from :mod:`.render`."""
    Image, ImageDraw = R.pillow("Image", "ImageDraw")
    font = _font(int(height * 0.7))
    probe = Image.new("L", (8, 8))
    draw = ImageDraw.Draw(probe)
    x0, y0, x1, y1 = draw.textbbox((0, 0), text, font=font)
    w = max(int(x1 - x0) + 12, 10)
    img = Image.new("L", (w, height), 255 if not invert else 0)
    draw = ImageDraw.Draw(img)
    draw.text((6 - x0, (height - (y1 - y0)) // 2 - y0), text, font=font,
              fill=0 if not invert else 255)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if rng is not None:
        arr = np.clip(arr + rng.normal(0.0, 0.02, arr.shape), 0.0, 1.0)
    return arr + BLACK_VALUE


def labels_for(text: str, alphabet: str = DEFAULT_ALPHABET) -> list[int]:
    """CTC labels: alphabet index + 1 (0 is blank); unknown chars dropped."""
    return [alphabet.index(c) + 1 for c in text if c in alphabet]


def random_text(rng: np.random.Generator, alphabet: str, min_len=3, max_len=18) -> str:
    n = int(rng.integers(min_len, max_len + 1))
    # Weight towards letters/digits for renderability.
    pool = [c for c in alphabet if c.isalnum()] + [" "] * 4
    return "".join(rng.choice(pool) for _ in range(n)).strip() or "a"


# ---------------------------------------------------------------------------
# Recognition batches
# ---------------------------------------------------------------------------


def _place_sample(
    images: np.ndarray,
    labels: np.ndarray,
    lengths: np.ndarray,
    i: int,
    crop: np.ndarray,
    text: str,
    alphabet: str,
) -> None:
    lab = labels_for(text, alphabet)[: labels.shape[1]]
    w = min(crop.shape[1], images.shape[3])
    images[i, 0, :, :w] = crop[:, :w]
    labels[i, : len(lab)] = lab
    lengths[i] = len(lab)


def recognition_batches(
    batch_size: int,
    width: int = 768,
    alphabet: str = DEFAULT_ALPHABET,
    max_label_len: int = 40,
    seed: int = 0,
    augment: bool = True,
    render_kwargs: Optional[dict] = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Infinite generator of (images [B,1,64,width], labels [B,L],
    label_lengths [B]) recognition training batches from the styled
    pipeline-accurate renderer. ``augment=False`` is accepted for API
    compatibility (the styles themselves carry the augmentation)."""
    rng = np.random.default_rng(seed)
    while True:
        images = np.full((batch_size, 1, 64, width), BLACK_VALUE, np.float32)
        labels = np.zeros((batch_size, max_label_len), np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        for i in range(batch_size):
            # Mostly full-budget lines; a share of deliberately short ones so
            # every padding length appears in training (padding robustness).
            budget = (
                width if rng.random() < 0.7 else int(rng.integers(64, width + 1))
            )
            crop, text = R.render_recognition_sample(
                rng,
                width_budget=budget,
                alphabet=alphabet,
                max_chars=max_label_len,
                **(render_kwargs or {}),
            )
            _place_sample(images, labels, lengths, i, crop, text, alphabet)
            if lengths[i] == 0 and text != "":
                # All chars unsupported (shouldn't happen). Deliberately
                # empty-labeled graphics-only crops (text == "") keep
                # length 0: CTC's all-blank path is the supervision.
                images[i] = BLACK_VALUE
                labels[i, 0] = 1
                lengths[i] = 1
        yield images, labels, lengths


class RecognitionDataset:
    """Pre-rendered recognition samples cached in RAM (u8 crops + texts).

    ``cache_path`` (an .npz) persists the rendered set across runs so
    hyperparameter iterations don't pay the render cost again."""

    def __init__(
        self,
        n_samples: int,
        width: int = 768,
        alphabet: str = DEFAULT_ALPHABET,
        max_label_len: int = 40,
        seed: int = 0,
        cache_path: Optional[str | Path] = None,
        log_every: int = 0,
        extra_caches: Optional[list[str | Path]] = None,
        render_kwargs: Optional[dict] = None,
    ):
        self.width = width
        self.alphabet = alphabet
        self.max_label_len = max_label_len
        if cache_path is not None and Path(cache_path).exists():
            data = np.load(cache_path, allow_pickle=True)
            self._flat = data["flat"]
            self._offsets = data["offsets"]
            self._widths = data["widths"]
            self._texts = list(data["texts"])
            self._append_caches(extra_caches)
            return
        rng = np.random.default_rng(seed)
        crops_u8: list[np.ndarray] = []
        texts: list[str] = []
        for k in range(n_samples):
            budget = width if rng.random() < 0.7 else int(rng.integers(64, width + 1))
            crop, text = R.render_recognition_sample(
                rng,
                width_budget=budget,
                alphabet=alphabet,
                max_chars=max_label_len,
                **(render_kwargs or {}),
            )
            crops_u8.append(
                np.clip((crop - BLACK_VALUE) * 255.0, 0, 255).astype(np.uint8)
            )
            texts.append(text)
            if log_every and (k + 1) % log_every == 0:
                print(f"  rendered {k + 1}/{n_samples} lines", flush=True)
        widths = np.array([c.shape[1] for c in crops_u8], np.int64)
        offsets = np.concatenate([[0], np.cumsum(widths * 64)])
        flat = np.concatenate([c.reshape(-1) for c in crops_u8])
        self._flat, self._offsets, self._widths, self._texts = (
            flat,
            offsets,
            widths,
            texts,
        )
        if cache_path is not None:
            Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                cache_path,
                flat=flat,
                offsets=offsets,
                widths=widths,
                texts=np.array(texts, dtype=object),
            )
        self._append_caches(extra_caches)

    def _append_caches(self, extra_caches: Optional[list[str | Path]]) -> None:
        """Concatenate further pre-rendered caches (distribution mixing for
        fine-tuning: e.g. the original styled set + an edge-tight/confusable
        top-up). Works whether the primary set was loaded or just rendered
        (the extras are never written back into the primary cache)."""
        for extra in extra_caches or []:
            d = np.load(extra, allow_pickle=True)
            base = self._flat.shape[0]
            self._flat = np.concatenate([self._flat, d["flat"]])
            self._offsets = np.concatenate(
                [self._offsets, d["offsets"][1:] + base]
            )
            self._widths = np.concatenate([self._widths, d["widths"]])
            self._texts.extend(list(d["texts"]))

    def __len__(self) -> int:
        return len(self._widths)

    def get(self, i: int) -> tuple[np.ndarray, str]:
        w = int(self._widths[i])
        a = self._flat[self._offsets[i] : self._offsets[i + 1]].reshape(64, w)
        return a.astype(np.float32) / 255.0 + BLACK_VALUE, self._texts[i]

    def batches(
        self, batch_size: int, seed: int = 0, noise: float = 0.015, as_u8: bool = False
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Infinite randomized batches with cheap per-batch photometric
        augmentation (fresh noise/brightness per epoch pass).

        ``as_u8=True`` yields raw uint8 crops (normalization happens on
        device in the train step) — 4x less host->device traffic."""
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            idx = rng.integers(0, n, size=batch_size)
            labels = np.zeros((batch_size, self.max_label_len), np.int32)
            lengths = np.zeros((batch_size,), np.int32)
            if as_u8:
                images = np.zeros((batch_size, 1, 64, self.width), np.uint8)
                for row, i in enumerate(idx):
                    i = int(i)
                    w = min(int(self._widths[i]), self.width)
                    crop_u8 = self._flat[
                        self._offsets[i] : self._offsets[i + 1]
                    ].reshape(64, -1)[:, :w]
                    if noise > 0:
                        lvl = rng.uniform(0.0, noise) * 255.0
                        jitter = rng.normal(0.0, lvl, crop_u8.shape)
                        crop_u8 = np.clip(
                            crop_u8.astype(np.int16) + jitter, 0, 255
                        ).astype(np.uint8)
                    images[row, 0, :, :w] = crop_u8
                    text = self._texts[i]
                    lab = labels_for(text, self.alphabet)[: self.max_label_len]
                    labels[row, : len(lab)] = lab
                    # Graphics-only samples carry a deliberate empty label
                    # (length 0 = CTC all-blank supervision); only force a
                    # non-empty label when the TEXT was non-empty but every
                    # char fell outside the alphabet.
                    if lab:
                        lengths[row] = len(lab)
                    elif text != "":
                        labels[row, 0] = 1
                        lengths[row] = 1
                yield images, labels, lengths
                continue
            images = np.full((batch_size, 1, 64, self.width), BLACK_VALUE, np.float32)
            for row, i in enumerate(idx):
                crop, text = self.get(int(i))
                if noise > 0:
                    crop = crop + rng.normal(
                        0.0, rng.uniform(0.0, noise), crop.shape
                    ).astype(np.float32)
                    crop = np.clip(crop, BLACK_VALUE, BLACK_VALUE + 1.0)
                _place_sample(images, labels, lengths, row, crop, text, self.alphabet)
                if lengths[row] == 0 and text != "":
                    labels[row, 0] = 1
                    lengths[row] = 1
            yield images, labels, lengths


# ---------------------------------------------------------------------------
# Detection pages
# ---------------------------------------------------------------------------


def render_page(
    rng: np.random.Generator,
    page_hw: tuple[int, int] = (800, 608),
    n_lines: int = 10,
    alphabet: str = DEFAULT_ALPHABET,
    return_words: bool = False,
    font_size: int = 22,
    vocab_words: bool = False,
):
    """Plain page renderer (black text on white at the given size) kept for
    unit tests; training pages come from
    :func:`.render.render_detection_sample`. With ``return_words`` also returns word records
    ``(text, (t, l, b, r))``.

    ``vocab_words=True`` draws real vocabulary tokens instead of random
    character soup. Benchmarks that GATE on decoded accuracy must use it:
    random strings make l/I/1/| and O/0 glyph pairs (pixel-identical in most
    faces) undecidable without word context, capping word-F1 near 0.87 for
    ANY model — a ceiling of the text source, not of OCR quality."""
    Image, ImageDraw = R.pillow("Image", "ImageDraw")
    h, w = page_hw
    img = Image.new("L", (w, h), 255)
    mask = np.zeros((h, w), np.float32)
    draw = ImageDraw.Draw(img)
    font = _font(font_size)
    words_out: list[tuple[str, tuple[int, int, int, int]]] = []
    y = max(20, font_size)
    for _ in range(n_lines):
        if y > h - 2 * font_size:
            break
        x = 20
        for _ in range(int(rng.integers(2, 6))):
            if vocab_words:
                word = R.sample_word(rng, alphabet).replace(" ", "")
            else:
                word = random_text(rng, alphabet, 3, 8).replace(" ", "")
            x0, y0, x1, y1 = draw.textbbox((x, y), word, font=font)
            if x1 > w - 20:
                break
            draw.text((x, y), word, font=font, fill=0)
            # Shrunk label mask (under-segmentation; detection.rs:108-117).
            sh = 2
            mask[int(y0) + sh : int(y1) + 1 - sh, int(x0) + sh : int(x1) + 1 - sh] = 1.0
            words_out.append((word, (int(y0), int(x0), int(y1), int(x1))))
            x = int(x1) + int(rng.integers(max(12, font_size // 2), max(30, int(font_size * 1.4))))
        y += int(rng.integers(int(font_size * 1.8), int(font_size * 3.2)))
    arr = np.asarray(img, np.float32) / 255.0 + BLACK_VALUE
    if return_words:
        return arr[None], mask[None], words_out
    return arr[None], mask[None]


def detection_batches(
    batch_size: int,
    page_hw: tuple[int, int] = (800, 608),
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Infinite generator of (images [B,1,H,W], masks [B,1,H,W]) styled
    detection samples at detector resolution (native render -> pipeline
    pad/squeeze law -> shrunk word-core mask)."""
    rng = np.random.default_rng(seed)
    while True:
        imgs = np.zeros((batch_size, 1, *page_hw), np.float32)
        masks = np.zeros((batch_size, 1, *page_hw), np.float32)
        for i in range(batch_size):
            s = R.render_detection_sample(rng, det_hw=page_hw)
            imgs[i, 0] = s.image
            masks[i, 0] = s.mask
        yield imgs, masks


class DetectionDataset:
    """Pre-rendered detection samples cached in RAM (u8 images + packed
    masks), optionally persisted to an .npz."""

    def __init__(
        self,
        n_samples: int,
        page_hw: tuple[int, int] = (800, 608),
        seed: int = 0,
        cache_path: Optional[str | Path] = None,
        log_every: int = 0,
        extra_caches: Optional[list[str | Path]] = None,
        render_kwargs: Optional[dict] = None,
    ):
        self.page_hw = tuple(page_hw)
        if cache_path is not None and Path(cache_path).exists():
            data = np.load(cache_path)
            self._images = data["images"]
            self._masks_packed = data["masks"]
            # Distribution mixing for fine-tuning (same rationale as the
            # recognition dataset's extra_caches).
            for extra in extra_caches or []:
                d = np.load(extra)
                self._images = np.concatenate([self._images, d["images"]])
                self._masks_packed = np.concatenate([self._masks_packed, d["masks"]])
            return
        if extra_caches:
            raise ValueError("extra_caches requires an existing cache_path")
        rng = np.random.default_rng(seed)
        h, w = self.page_hw
        images = np.zeros((n_samples, h, w), np.uint8)
        masks = np.zeros((n_samples, (h * w + 7) // 8), np.uint8)
        for k in range(n_samples):
            s = R.render_detection_sample(rng, det_hw=self.page_hw, **(render_kwargs or {}))
            images[k] = np.clip((s.image - BLACK_VALUE) * 255.0, 0, 255).astype(np.uint8)
            masks[k] = np.packbits(s.mask.astype(bool).reshape(-1))
            if log_every and (k + 1) % log_every == 0:
                print(f"  rendered {k + 1}/{n_samples} pages", flush=True)
        self._images = images
        self._masks_packed = masks
        if cache_path is not None:
            Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache_path, images=images, masks=masks)

    def __len__(self) -> int:
        return len(self._images)

    def batches(
        self, batch_size: int, seed: int = 0, noise: float = 0.015, as_u8: bool = False
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """``as_u8=True`` yields raw uint8 images/masks (normalization happens
        on device in the train step) — 4x less host->device traffic."""
        rng = np.random.default_rng(seed)
        h, w = self.page_hw
        n = len(self)
        while True:
            idx = rng.integers(0, n, size=batch_size)
            masks_bits = np.unpackbits(self._masks_packed[idx], axis=1)[:, : h * w]
            if as_u8:
                imgs = self._images[idx][:, None]
                if noise > 0:
                    lvl = rng.uniform(0.0, noise) * 255.0
                    jitter = rng.normal(0.0, lvl, imgs.shape)
                    imgs = np.clip(imgs.astype(np.int16) + jitter, 0, 255).astype(
                        np.uint8
                    )
                masks = masks_bits.reshape(batch_size, 1, h, w)
                yield imgs, masks
                continue
            imgs = (
                self._images[idx].astype(np.float32) / 255.0 + BLACK_VALUE
            )[:, None]
            if noise > 0:
                imgs = imgs + rng.normal(
                    0.0, rng.uniform(0.0, noise), imgs.shape
                ).astype(np.float32)
                imgs = np.clip(imgs, BLACK_VALUE, BLACK_VALUE + 1.0)
            masks = masks_bits.reshape(batch_size, 1, h, w).astype(np.float32)
            yield imgs, masks
