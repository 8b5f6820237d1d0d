"""Train the CRNN recognizer on drawn text lines and show it decoding: the
counterpart of ``tools/train_demo.py``.

    python -m ocrs_tpu_torch.train.demo [--steps 300] [--batch 32] [--width 384]
        [--hidden 96] [--lr 3e-4] [--checkpoint-dir DIR] [--device cpu]

Prints the CTC loss curve and, at the end, greedy decodes of held-out lines,
through the port's ``ops.ctc``. Runs on CUDA unless ``--device`` says
otherwise; the GRU runs in the CUDA kernel there.

The JAX demo draws its lines with Pillow's TrueType renderer
(``ocrs_tpu.train.data``); the card's machine has no Pillow and no fonts, so
this one draws them in the bitmap face of :mod:`.pixelfont`
(``render_pixel_line``, a per-line letterform draw), with texts drawn by the
law of ``ocrs_tpu.train.data.random_text`` from a seeded numpy generator.
That is a different data source, not a different model or step: the
recognizer, the optimizer (``adamw(lr)``, optax's defaults) and the step are
the JAX demo's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..engine import DEFAULT_ALPHABET
from ..models.recognition_net import INPUT_HEIGHT, RecognitionModel
from ..ops.ctc import collapse_greedy_batch
from ..preprocess import BLACK_VALUE
from . import pixelfont
from .optim import adamw
from .train import init_recognition_state, make_recognition_train_step

#: Held-out lines decoded at the end (the JAX demo's).
HELD_OUT = ("hello", "TPU 42", "ocrs")


def random_text(rng: np.random.Generator, alphabet: str, min_len: int = 3, max_len: int = 18) -> str:
    """``ocrs_tpu.train.data.random_text``'s law: 3-18 characters, letters
    and digits of `alphabet` with four spaces in the pool."""
    n = int(rng.integers(min_len, max_len + 1))
    pool = [c for c in alphabet if c.isalnum()] + [" "] * 4
    return "".join(rng.choice(pool) for _ in range(n)).strip() or "a"


def labels_for(text: str, alphabet: str = DEFAULT_ALPHABET) -> list[int]:
    """CTC labels: alphabet index + 1 (0 is blank); unknown characters dropped."""
    return [alphabet.index(c) + 1 for c in text if c in alphabet]


def draw_line(text: str, width: int, rng: np.random.Generator | None = None, scale: float | None = None) -> np.ndarray:
    """`text` in the pixel face as a normalized line crop [64, width]: dark
    ink (-0.5) on paper (0.5) with a margin, cut at `width`, and the
    recognizer's padding value (-0.5) after it. `rng` draws the scale (3 to
    5.5 px a cell, smaller where the line would not fit), the margins and
    the letterforms; without it the line is drawn plainly at `scale` (4)."""
    mask, _ = pixelfont.render_pixel_line(text, 1.0)
    cells = mask.shape[1]
    if scale is None:
        scale = float(rng.uniform(3.0, 5.5)) if rng is not None else 4.0
    left = int(rng.integers(2, 12)) if rng is not None else 6
    scale = max(1.0, min(scale, (width - 2 * left) / max(cells, 1), (INPUT_HEIGHT - 6) / pixelfont.GRID_ROWS))
    mask, _ = pixelfont.render_pixel_line(text, scale, rng=rng)
    h, w = mask.shape
    top = (INPUT_HEIGHT - h) // 2 + (int(rng.integers(-2, 3)) if rng is not None else 0)
    top = min(max(top, 0), INPUT_HEIGHT - h)
    crop_w = min(left + w + left, width)
    out = np.full((INPUT_HEIGHT, width), BLACK_VALUE, np.float32)
    out[:, :crop_w] = 0.5
    out[top : top + h, left : min(left + w, width)] -= mask[:, : max(min(w, width - left), 0)]
    return out


def make_batch(rng: np.random.Generator, batch: int, width: int, alphabet: str = DEFAULT_ALPHABET,
               max_label_len: int = 40):
    """(images [B, 1, 64, width] float32, labels [B, max_label_len] int32,
    lengths [B] int32) of random lines. Labels fit their frames: at most
    18 characters against width / 4 frames."""
    images = np.empty((batch, 1, INPUT_HEIGHT, width), np.float32)
    labels = np.zeros((batch, max_label_len), np.int32)
    lengths = np.zeros(batch, np.int32)
    for i in range(batch):
        text = random_text(rng, alphabet)
        images[i, 0] = draw_line(text, width, rng)
        lab = labels_for(text, alphabet)[:max_label_len]
        labels[i, : len(lab)] = lab
        lengths[i] = len(lab)
    return images, labels, lengths


def greedy_text(model: RecognitionModel, images: np.ndarray, alphabet: str = DEFAULT_ALPHABET) -> list[str]:
    """Greedy CTC decodes of a batch of line crops."""
    device = next(model.parameters()).device
    logprobs = model.run(torch.from_numpy(images).to(device))  # [T, N, C]
    labels = logprobs.argmax(dim=-1).transpose(0, 1).cpu().numpy()
    return [
        "".join(alphabet[s.label - 1] if 0 < s.label <= len(alphabet) else "?" for s in steps)
        for steps in collapse_greedy_batch(labels)
    ]


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--width", type=int, default=384)
    parser.add_argument("--hidden", type=int, default=96)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    alphabet = DEFAULT_ALPHABET
    optimizer = adamw(args.lr)
    step_fn = make_recognition_train_step(optimizer)
    state = init_recognition_state(
        optimizer, n_classes=len(alphabet) + 1, hidden=args.hidden, device=args.device
    )
    rng = np.random.default_rng(0)
    curve = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        state, loss = step_fn(state, *make_batch(rng, args.batch, args.width, alphabet))
        if step % 25 == 0 or step == 1 or step == args.steps:
            curve.append((step, float(loss)))
            print(f"step {step:4d}  ctc loss {curve[-1][1]:8.3f}  ({time.time() - t0:.0f}s)", flush=True)

    if args.checkpoint_dir:
        from .checkpoint import save_checkpoint

        print(f"saved {save_checkpoint(args.checkpoint_dir, state)}")

    held = np.stack([draw_line(text, args.width)[None] for text in HELD_OUT])
    decodes = greedy_text(state.model, held, alphabet)
    for text, decoded in zip(HELD_OUT, decodes):
        print(f"  {text!r:12} -> {decoded!r}")
    return {"loss_curve": curve, "decodes": dict(zip(HELD_OUT, decodes)), "seconds": time.time() - t0}


if __name__ == "__main__":
    main()
