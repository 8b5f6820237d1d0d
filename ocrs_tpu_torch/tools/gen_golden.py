"""Draw the golden pages of the CLI tier: the port of ``tools/gen_golden.py``.

The pages are made for the deterministic fake models (``models/fakes.py``):
a faint full-height strip makes the detector see a word block, and one
bright row per character column range drives the fake recognizer's
row-as-class-probability decoding. ``tools/test_e2e.py`` and
``ocrs_tpu_torch.tools.test_e2e`` diff the CLI's text on them against the
``<name>.expected.txt`` beside them.

    python -m ocrs_tpu_torch.tools.gen_golden --out-dir DIR

PNGs are written by :mod:`ocrs_tpu_torch.png` (grey, 8 bits), without
Pillow. The default directory is the repository's ``test-data/``, as in
the JAX tool.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..png import write_png

OUT_DIR = Path(__file__).resolve().parents[2] / "test-data"

STRIP = 110  # faint background (detected as text, loses every argmax)
BRIGHT = 255  # character row


def draw_line(img: np.ndarray, y0: int, x0: int, rows: list[int], char_w: int = 24):
    """Draw one 64px-tall 'line': a faint strip plus one bright row per char."""
    width = char_w * len(rows)
    img[y0 : y0 + 64, x0 : x0 + width] = STRIP
    for i, row in enumerate(rows):
        x = x0 + i * char_w
        img[y0 + row : y0 + row + 2, x : x + char_w] = BRIGHT


def golden_pages() -> dict[str, np.ndarray]:
    """The golden pages by file name."""
    # Image 1: one line of six "characters".
    img1 = np.zeros((160, 320), dtype=np.uint8)
    draw_line(img1, 48, 32, rows=[8, 16, 24, 32, 40, 48])
    # Image 2: two lines with distinct codes (checks reading order).
    img2 = np.zeros((240, 320), dtype=np.uint8)
    draw_line(img2, 24, 16, rows=[10, 20, 30])
    draw_line(img2, 140, 16, rows=[40, 30, 20, 10])
    return {"strip-line.png": img1, "two-lines.png": img2}


def main(out_dir: Path | str = OUT_DIR) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(exist_ok=True)
    for name, img in golden_pages().items():
        write_png(out_dir / name, img)
    print(f"Wrote golden images to {out_dir}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Draw the golden pages of the CLI tier.")
    parser.add_argument("--out-dir", default=str(OUT_DIR), help="directory to write into (default: test-data/)")
    main(parser.parse_args().out_dir)
