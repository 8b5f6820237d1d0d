"""Procedural pixel-font family for training data (the port's own copy).

A copy of ``ocrs_tpu.train.pixelfont``, which imports numpy alone; the port
keeps its own so that it imports nothing of the JAX package. Same glyphs,
same alternates, same metrics variants, same arrays and word boxes from the
same arguments (``tests/test_torch_pixelfont.py``). It draws text on a
machine without Pillow or fonts, such as the card's, for the training demo
(:mod:`.demo`) and ``chip_smoke.py``'s training phase.

An original hand-drawn 5x7-grid bitmap font (plus programmatic bold/heavy
variants) covering the engine's full default alphabet: real bitmap faces are
designed directly on a ~5x7 grid with uniform 1-px strokes, square terminals
and staircase diagonals.

Glyph grid: 10 rows. Rows 0-6 are the cap/ascender band (baseline under
row 6), rows 7-9 the descender band. Lowercase x-height spans rows 2-6.
Widths vary per glyph (1-5 columns).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

#: rows above the baseline (caps/digits occupy exactly these).
BASELINE_ROW = 7
#: total grid rows including descenders.
GRID_ROWS = 10

# fmt: off
_G: dict[str, list[str]] = {
    "0": [".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."],
    "1": ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    "2": [".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"],
    "3": [".###.", "#...#", "....#", "..##.", "....#", "#...#", ".###."],
    "4": ["...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."],
    "5": ["#####", "#....", "####.", "....#", "....#", "#...#", ".###."],
    "6": ["..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."],
    "7": ["#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."],
    "8": [".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."],
    "9": [".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."],
    "A": [".###.", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"],
    "B": ["####.", "#...#", "#...#", "####.", "#...#", "#...#", "####."],
    "C": [".###.", "#...#", "#....", "#....", "#....", "#...#", ".###."],
    "D": ["###..", "#..#.", "#...#", "#...#", "#...#", "#..#.", "###.."],
    "E": ["#####", "#....", "#....", "####.", "#....", "#....", "#####"],
    "F": ["#####", "#....", "#....", "####.", "#....", "#....", "#...."],
    "G": [".###.", "#...#", "#....", "#.###", "#...#", "#...#", ".###."],
    "H": ["#...#", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"],
    "I": ["###", ".#.", ".#.", ".#.", ".#.", ".#.", "###"],
    "J": ["..###", "...#.", "...#.", "...#.", "...#.", "#..#.", ".##.."],
    "K": ["#...#", "#..#.", "#.#..", "##...", "#.#..", "#..#.", "#...#"],
    "L": ["#....", "#....", "#....", "#....", "#....", "#....", "#####"],
    "M": ["#...#", "##.##", "#.#.#", "#.#.#", "#...#", "#...#", "#...#"],
    "N": ["#...#", "##..#", "#.#.#", "#..##", "#...#", "#...#", "#...#"],
    "O": [".###.", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."],
    "P": ["####.", "#...#", "#...#", "####.", "#....", "#....", "#...."],
    "Q": [".###.", "#...#", "#...#", "#...#", "#.#.#", "#..#.", ".##.#"],
    "R": ["####.", "#...#", "#...#", "####.", "#.#..", "#..#.", "#...#"],
    "S": [".####", "#....", "#....", ".###.", "....#", "....#", "####."],
    "T": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."],
    "U": ["#...#", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."],
    "V": ["#...#", "#...#", "#...#", "#...#", ".#.#.", ".#.#.", "..#.."],
    "W": ["#...#", "#...#", "#...#", "#.#.#", "#.#.#", "##.##", "#...#"],
    "X": ["#...#", "#...#", ".#.#.", "..#..", ".#.#.", "#...#", "#...#"],
    "Y": ["#...#", "#...#", ".#.#.", "..#..", "..#..", "..#..", "..#.."],
    "Z": ["#####", "....#", "...#.", "..#..", ".#...", "#....", "#####"],
    "a": ["", "", ".###.", "....#", ".####", "#...#", ".####"],
    "b": ["#....", "#....", "####.", "#...#", "#...#", "#...#", "####."],
    "c": ["", "", ".###", "#...", "#...", "#...", ".###"],
    "d": ["....#", "....#", ".####", "#...#", "#...#", "#...#", ".####"],
    "e": ["", "", ".###.", "#...#", "#####", "#....", ".###."],
    "f": ["..##", ".#..", "####", ".#..", ".#..", ".#..", ".#.."],
    "g": ["", "", ".####", "#...#", "#...#", "#...#", ".####",
          "....#", ".###."],
    "h": ["#....", "#....", "####.", "#...#", "#...#", "#...#", "#...#"],
    "i": [".#.", "...", "##.", ".#.", ".#.", ".#.", "###"],
    "j": ["..#.", "....", "..#.", "..#.", "..#.", "..#.", "..#.",
          "#.#.", ".#.."],
    "k": ["#...", "#...", "#..#", "#.#.", "##..", "#.#.", "#..#"],
    "l": ["#.", "#.", "#.", "#.", "#.", "#.", "##"],
    "m": ["", "", "##.#.", "#.#.#", "#.#.#", "#.#.#", "#.#.#"],
    "n": ["", "", "#.##.", "##..#", "#...#", "#...#", "#...#"],
    "o": ["", "", ".###.", "#...#", "#...#", "#...#", ".###."],
    "p": ["", "", "####.", "#...#", "#...#", "#...#", "####.",
          "#....", "#...."],
    "q": ["", "", ".####", "#...#", "#...#", "#...#", ".####",
          "....#", "....#"],
    "r": ["", "", "#.##", "##..", "#...", "#...", "#..."],
    "s": ["", "", ".###", "#...", ".##.", "...#", "###."],
    "t": [".#..", ".#..", "####", ".#..", ".#..", ".#..", "..##"],
    "u": ["", "", "#...#", "#...#", "#...#", "#..##", ".##.#"],
    "v": ["", "", "#...#", "#...#", "#...#", ".#.#.", "..#.."],
    "w": ["", "", "#...#", "#...#", "#.#.#", "#.#.#", ".#.#."],
    "x": ["", "", "#...#", ".#.#.", "..#..", ".#.#.", "#...#"],
    "y": ["", "", "#...#", "#...#", "#...#", "#...#", ".####",
          "....#", ".###."],
    "z": ["", "", "####", "..#.", ".#..", "#...", "####"],
    "!": ["#", "#", "#", "#", "#", ".", "#"],
    '"': ["#.#", "#.#", "", "", "", "", ""],
    "#": ["", ".#.#.", "#####", ".#.#.", ".#.#.", "#####", ".#.#."],
    "$": ["..#..", ".####", "#.#..", ".###.", "..#.#", "####.", "..#.."],
    "%": ["##..#", "##..#", "...#.", "..#..", ".#...", "#..##", "#..##"],
    "&": [".##..", "#..#.", "#.#..", ".#...", "#.#.#", "#..#.", ".##.#"],
    "'": ["#", "#", "", "", "", "", ""],
    "(": [".#", "#.", "#.", "#.", "#.", "#.", ".#"],
    ")": ["#.", ".#", ".#", ".#", ".#", ".#", "#."],
    "*": ["", "..#..", "#.#.#", ".###.", "#.#.#", "..#..", ""],
    "+": ["", "", "..#..", "..#..", "#####", "..#..", "..#.."],
    ",": ["", "", "", "", "", ".#", ".#", "#.", ""],
    "-": ["", "", "", "####", "", "", ""],
    ".": ["", "", "", "", "", "##", "##"],
    "/": ["....#", "...#.", "...#.", "..#..", ".#...", ".#...", "#...."],
    ":": ["", "", "##", "##", "", "##", "##"],
    ";": ["", "", ".#", ".#", "", ".#", ".#", "#.", ""],
    "<": ["...#", "..#.", ".#..", "#...", ".#..", "..#.", "...#"],
    "=": ["", "", "####", "....", "####", "", ""],
    ">": ["#...", ".#..", "..#.", "...#", "..#.", ".#..", "#..."],
    "?": [".###.", "#...#", "....#", "..##.", "..#..", ".....", "..#.."],
    "@": [".###.", "#...#", "#.###", "#.#.#", "#.###", "#....", ".###."],
    "[": ["##", "#.", "#.", "#.", "#.", "#.", "##"],
    "\\": ["#....", ".#...", ".#...", "..#..", "...#.", "...#.", "....#"],
    "]": ["##", ".#", ".#", ".#", ".#", ".#", "##"],
    "^": ["..#..", ".#.#.", "#...#", "", "", "", ""],
    "_": ["", "", "", "", "", "", "", "#####", ""],
    "`": ["#.", ".#", "", "", "", "", ""],
    "{": [".##", ".#.", ".#.", "#..", ".#.", ".#.", ".##"],
    "|": ["#", "#", "#", "#", "#", "#", "#"],
    "}": ["##.", ".#.", ".#.", "..#", ".#.", ".#.", "##."],
    "~": ["", "", ".#..#", "#.#.#", "#..#.", "", ""],
    "€": ["..###", ".#...", "####.", ".#...", "####.", ".#...", "..###"],
}

# Alternate letterforms: real bitmap faces disagree exactly on these glyphs
# (single- vs two-story a/g, pointed vs flat M/N/w, x-height proportions,
# open vs closed digit bowls). Training on ONE form per letter memorizes the
# face; sampling among forms per line forces the model to read the pixel-
# font STYLE. Each entry is a list of additional forms on the same grid
# (a held-out pixel face was misread precisely on w/g/N/y/c, each drawn
# differently there than in _G).
_G_ALT: dict[str, list[list[str]]] = {
    # taller x-height form (rows 1-6) + flat-bottom bowl form
    "a": [["", ".###.", "....#", ".####", "#...#", "#...#", ".####"],
          ["", "", ".##.", "..#.", ".##.", "#.#.", ".###"]],
    "e": [["", ".###.", "#...#", "#####", "#....", "#...#", ".###."],
          ["", "", ".##.", "#..#", "####", "#...", ".##."]],
    # two-story g with open hook / narrow g
    "g": [["", "", ".###.", "#...#", "#...#", ".####", "....#",
           "...#.", ".##.."],
          ["", "", ".####", "#..#.", ".##..", "#....", ".###.",
           "#...#", ".###."]],
    "s": [["", "", ".####", "#....", ".###.", "....#", "####."],
          ["", "", ".##", "#..", ".#.", "..#", "##."]],
    "r": [["", "", "#.#.", "##.#", "#...", "#...", "#..."],
          ["", "", "#.##", "##..", "#...", "#...", "#..."]],
    "t": ["#...", "#...", "###.", "#...", "#...", "#...", ".##."],
    "f": [[".##.", "#...", "###.", "#...", "#...", "#...", "#..."]],
    "y": [["", "", "#..#", "#..#", "#..#", ".###", "...#", ".##."],
          ["", "", "#...#", ".#.#.", "..#..", "..#..", ".#...",
           "#....", ""]],
    # pointed-centre w / narrow w
    "w": [["", "", "#...#", "#...#", "#.#.#", "##.##", "#...#"],
          ["", "", "#.#.#", "#.#.#", "#.#.#", "#.#.#", ".#.#."]],
    "u": [["", "", "#..#", "#..#", "#..#", "#..#", ".###"]],
    "m": [["", "", "##.##", "#.#.#", "#.#.#", "#.#.#", "#.#.#"]],
    "k": [["#...", "#...", "#.#.", "##..", "#.#.", "#.#.", "#..#"]],
    "c": [["", "", ".###.", "#....", "#....", "#....", ".###."]],
    "N": [["#...#", "##..#", "##..#", "#.#.#", "#..##", "#..##", "#...#"]],
    "M": [["#...#", "##.##", "#.#.#", "#...#", "#...#", "#...#", "#...#"]],
    "W": [["#...#", "#...#", "#...#", "#.#.#", "#.#.#", "#.#.#", ".#.#."]],
    "G": [[".####", "#....", "#....", "#..##", "#...#", "#...#", ".####"]],
    "I": [["#", "#", "#", "#", "#", "#", "#"]],
    "1": [[".#.", "##.", ".#.", ".#.", ".#.", ".#.", ".#."]],
    "3": [["####.", "....#", "...#.", "..##.", "....#", "#...#", ".###."]],
    "5": [["#####", "#....", "#....", "####.", "....#", "....#", "####."]],
    "9": [[".###.", "#...#", "#...#", ".####", "....#", "....#", ".###."]],
    "0": [[".###.", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."]],
}
# fmt: on


def _norm_alt(alt) -> list[list[str]]:
    """Accept a bare rows-list as a single alternate form."""
    return [alt] if alt and isinstance(alt[0], str) else alt


#: Vertical-metric families. "cap7" is the base design (7-row caps, 5-row
#: x-height, 3-row descenders). "cap6" programmatically squashes caps /
#: ascenders to 6 rows and descenders to 2 — the proportions of the other
#: major bitmap-font school (Minecraft-style faces have 6-block caps over a
#: 5-block x-height; the held-out eval face sat outside the cap7-only
#: distribution, VERDICT r4).
METRICS_VARIANTS = ("cap7", "cap6")


def _squash_band(band: np.ndarray, anchor_bottom: bool) -> np.ndarray:
    """Remove one row from a glyph band: prefer deleting a row identical to
    its neighbor (pure duplicate — shape preserved exactly); else OR-merge
    the middle pair. Returns band with one fewer row, re-anchored with a
    blank row at the top (anchor_bottom) or bottom."""
    n = band.shape[0]
    for r in range(1, n - 1):
        if (band[r] == band[r - 1]).all():
            kept = np.delete(band, r, axis=0)
            break
    else:
        mid = n // 2
        merged = band[mid - 1] | band[mid]
        kept = np.vstack([band[: mid - 1], merged[None], band[mid + 1 :]])
    blank = np.zeros((1, band.shape[1]), dtype=bool)
    return np.vstack([blank, kept]) if anchor_bottom else np.vstack([kept, blank])


def _apply_metrics(g: np.ndarray, metrics: str) -> np.ndarray:
    """Map a cap7 glyph bitmap to another metric family (see
    METRICS_VARIANTS)."""
    if metrics == "cap7":
        return g
    out = g.copy()
    cap = out[: BASELINE_ROW]  # rows 0..6
    if cap[0].any() or cap[1].any():  # cap-height or ascender glyph
        out[:BASELINE_ROW] = _squash_band(cap, anchor_bottom=True)
    desc = out[BASELINE_ROW:]  # rows 7..9
    if desc[-1].any():  # full-depth descender
        out[BASELINE_ROW:] = _squash_band(desc, anchor_bottom=False)
    return out


@lru_cache(maxsize=None)
def glyph_array(ch: str, form: int = 0, metrics: str = "cap7") -> np.ndarray:
    """[GRID_ROWS, w] bool bitmap for one character (space handled by the
    caller as pure advance). ``form``: 0 = the base _G shape, i >= 1 = the
    (i-1)-th _G_ALT alternate (clamped; characters without alternates
    always return the base form). ``metrics``: vertical-metric family
    (METRICS_VARIANTS)."""
    rows = _G[ch]
    if form > 0 and ch in _G_ALT:
        alts = _norm_alt(_G_ALT[ch])
        rows = alts[min(form - 1, len(alts) - 1)]
    w = max((len(r) for r in rows if r), default=3)
    out = np.zeros((GRID_ROWS, w), dtype=bool)
    for i, r in enumerate(rows):
        for j, c in enumerate(r):
            if c == "#":
                out[i, j] = True
    return _apply_metrics(out, metrics)


def n_forms(ch: str) -> int:
    """1 + number of alternate forms for ``ch``."""
    return 1 + (len(_norm_alt(_G_ALT[ch])) if ch in _G_ALT else 0)


def supported() -> str:
    """All drawable characters (the engine alphabet minus none)."""
    return "".join(_G.keys())


def _apply_weight(g: np.ndarray, weight: int) -> np.ndarray:
    """0 = regular; 1 = bold (dilate right); 2 = heavy (right + down)."""
    if weight >= 1:
        d = np.zeros_like(g)
        d[:, 1:] = g[:, :-1]
        g = g | d
    if weight >= 2:
        d = np.zeros_like(g)
        d[1:, :] = g[:-1, :]
        g = g | d
    return g


def text_bitmap(
    text: str,
    weight: int = 0,
    letter_space: int = 1,
    word_space: int = 3,
    forms: Optional[dict[str, int]] = None,
    metrics: str = "cap7",
) -> tuple[np.ndarray, list[tuple[str, int, int]]]:
    """Render ``text`` on the design grid.

    Returns (bitmap [GRID_ROWS, W] bool, word spans) where each span is
    (word, left_col, right_col) of the word's tight ink extent. Characters
    without a glyph are skipped. ``forms``: per-character letterform index
    (see :func:`glyph_array`) — one face uses one form per letter
    consistently, so the choice is per LINE, not per occurrence.
    """
    cols: list[np.ndarray] = []
    spans: list[tuple[str, int, int]] = []
    x = 0
    word = ""
    w_left = 0

    def flush_word(x_end: int) -> None:
        nonlocal word
        if word:
            spans.append((word, w_left, x_end))
            word = ""

    for ch in text:
        if ch == " ":
            flush_word(x)
            cols.append(np.zeros((GRID_ROWS, word_space), dtype=bool))
            x += word_space
            continue
        if ch not in _G:
            continue
        g = _apply_weight(
            glyph_array(ch, (forms or {}).get(ch, 0), metrics), weight
        )
        if not word:
            w_left = x
        word += ch
        cols.append(g)
        x += g.shape[1]
        cols.append(np.zeros((GRID_ROWS, letter_space), dtype=bool))
        x += letter_space
    flush_word(x)
    if not cols:
        return np.zeros((GRID_ROWS, 1), dtype=bool), []
    return np.concatenate(cols, axis=1), spans


def render_pixel_line(
    text: str,
    scale: float,
    weight: int = 0,
    letter_space: int = 1,
    word_space: int = 3,
    rng: Optional[np.random.Generator] = None,
    metrics: Optional[str] = None,
) -> tuple[np.ndarray, list[tuple[str, tuple[float, float, float, float]]]]:
    """Render ``text`` nearest-upscaled by a (possibly fractional) factor.

    Returns (mask [H, W] float in {0, 1}, word boxes) with boxes as
    (t, l, b, r) floats in output pixels — the same record shape the
    TrueType renderer's WordBox carries. Fractional scales mix k- and
    (k+1)-px blocks, like a real bitmap face drawn at a non-multiple size.

    ``rng``: when given, each character picks a random letterform for this
    line (uniform over its base + alternates, see _G_ALT) — a per-line
    "face" draw so training covers the letterform systems real bitmap
    fonts disagree on.
    """
    forms = None
    if rng is not None:
        forms = {
            ch: int(rng.integers(0, n_forms(ch)))
            for ch in set(text)
            if ch in _G_ALT
        }
        if metrics is None:
            metrics = str(rng.choice(METRICS_VARIANTS))
    grid, spans = text_bitmap(
        text, weight, letter_space, word_space, forms, metrics or "cap7"
    )
    gh, gw = grid.shape
    out_h = max(int(round(gh * scale)), 1)
    out_w = max(int(round(gw * scale)), 1)
    ys = np.minimum((np.arange(out_h) / scale).astype(np.int64), gh - 1)
    xs = np.minimum((np.arange(out_w) / scale).astype(np.int64), gw - 1)
    mask = grid[np.ix_(ys, xs)].astype(np.float32)

    boxes = []
    for word, l, r in spans:
        # Tight vertical extent of this word's ink.
        sub = grid[:, l:r]
        rows = np.nonzero(sub.any(axis=1))[0]
        if rows.size == 0:
            continue
        t, b = int(rows[0]), int(rows[-1]) + 1
        boxes.append(
            (word, (t * scale, l * scale, b * scale, r * scale))
        )
    return mask, boxes
