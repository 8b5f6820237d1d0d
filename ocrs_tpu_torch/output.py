"""Output formatters: plain text, HierText-style JSON, annotated PNG.

Port of ``ocrs_tpu.output`` (upstream ocrs-cli/src/output.rs):

  * text: recognized lines joined by newlines, `None` lines dropped
    (output.rs:88-95).
  * JSON: the HierText ground-truth shape ``{url, image_width, image_height,
    paragraphs: [{lines: [{text, vertices, words: [{text, vertices}]}]}]}``
    with vertices as rounded-int ``[x, y]`` corner lists and a single
    paragraph (output.rs:24-76); the same string as the JAX package's for
    the same lines.
  * PNG: line rects (light grey), per-line word detection rects
    (coral/seagreen/steelblue cycling) and recognized word rects
    (crimson/darkgreen/darkblue cycling) over the source image
    (output.rs:116-180), drawn with numpy: there is no imaging package on
    every machine the port runs on. Outlines are 1 px wide, those of
    recognized words 2 px (the second pixel inside the rect).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .geometry import RotatedRect, min_area_rect, point
from .text_items import TextLine


def _rounded_vertex_coords(rr: RotatedRect) -> list[list[int]]:
    """Corner coordinates as rounded-int [x, y] pairs (output.rs:20-27)."""
    return [[int(round(c[0])), int(round(c[1]))] for c in rr.corners()]


def format_text_output(text_lines: Sequence[Optional[TextLine]]) -> str:
    """Lines joined by newline; missing lines dropped (output.rs:88-95)."""
    return "\n".join(str(l) for l in text_lines if l is not None)


@dataclass
class FormatJsonArgs:
    """Inputs for :func:`format_json_output` (output.rs:80-93)."""

    input_path: str
    input_hw: tuple[int, int]
    text_lines: Sequence[Optional[TextLine]]


def format_json_output(args: FormatJsonArgs) -> str:
    """HierText-style JSON (output.rs:24-110)."""
    line_items = []
    for line in args.text_lines:
        if line is None:
            continue
        word_items = [
            {
                "text": str(word),
                "vertices": _rounded_vertex_coords(word.rotated_rect()),
            }
            for word in line.words()
        ]
        line_items.append(
            {
                "text": str(line),
                "words": word_items,
                "vertices": _rounded_vertex_coords(line.rotated_rect()),
            }
        )

    height, width = args.input_hw
    doc = {
        "url": args.input_path,
        "image_width": width,
        "image_height": height,
        # nb. Layout info is not available here; all lines go into a single
        # paragraph (output.rs:70-74).
        "paragraphs": [{"lines": line_items}],
    }
    return json.dumps(doc, sort_keys=True, indent=2)


# Annotation palettes (output.rs:116-146).
LINE_COLOR = (179, 179, 179)  # light grey
DETECTION_COLORS = [(255, 127, 80), (46, 139, 87), (70, 130, 180)]  # coral/seagreen/steelblue
RECOGNITION_COLORS = [(220, 20, 60), (0, 100, 0), (0, 0, 139)]  # crimson/darkgreen/darkblue


def _outline_pixels(corners: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) integer pixels of a closed polygon's outline: each edge between
    vertices rounded half away from zero, sampled once per pixel of its
    longer axis. With ``width=2`` each edge is drawn again one pixel further
    in, towards the polygon's centre."""
    pts = np.sign(corners) * np.floor(np.abs(corners) + 0.5)
    centre = pts.mean(axis=0)
    xs, ys = [], []
    for i in range(len(pts)):
        p0, p1 = pts[i], pts[(i + 1) % len(pts)]
        n = int(np.abs(p1 - p0).max()) + 1
        seg = np.rint(np.linspace(p0, p1, n))
        offsets = [np.zeros(2)]
        if width > 1:
            d = p1 - p0
            normal = np.array([-d[1], d[0]]) / max(float(np.hypot(*d)), 1e-9)
            if normal @ (centre - (p0 + p1) / 2) < 0:
                normal = -normal
            offsets += [np.rint(normal * k) for k in range(1, width)]
        for off in offsets:
            xs.append(seg[:, 0] + off[0])
            ys.append(seg[:, 1] + off[1])
    return np.concatenate(xs).astype(np.int64), np.concatenate(ys).astype(np.int64)


def generate_annotated_png(
    image_rgb: np.ndarray,
    detected_words_by_line: Sequence[Sequence[RotatedRect]],
    text_lines: Sequence[Optional[TextLine]],
) -> np.ndarray:
    """Draw layout + recognition annotations over an (H, W, 3) u8 image.

    Returns the annotated copy (the CLI writes it with :func:`png.write_png`).
    Matches the reference's three annotation layers (output.rs:116-180)."""
    out = np.array(image_rgb, dtype=np.uint8, copy=True)
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError(f"generate_annotated_png takes an (H, W, 3) image, not {out.shape}")
    h, w = out.shape[:2]

    def draw_rr(rr: RotatedRect, color, width=1):
        xs, ys = _outline_pixels(np.asarray(rr.corners(), dtype=np.float64), width)
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        out[ys[inside], xs[inside]] = color

    for line_idx, words in enumerate(detected_words_by_line):
        # Line bounding rotated rect in light grey.
        if words:
            line_rect = min_area_rect(np.concatenate([np.stack(wd.corners()) for wd in words]))
            if line_rect is not None:
                draw_rr(line_rect.orient_towards(point(0.0, -1.0)), LINE_COLOR)
        color = DETECTION_COLORS[line_idx % len(DETECTION_COLORS)]
        for wd in words:
            draw_rr(wd, color)

    for line_idx, line in enumerate(text_lines):
        if line is None:
            continue
        color = RECOGNITION_COLORS[line_idx % len(RECOGNITION_COLORS)]
        for word in line.words():
            draw_rr(word.rotated_rect(), color, width=2)

    return out
