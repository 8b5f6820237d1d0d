"""Accuracy on pages drawn by paths the training renderer never touches:
the port of ``tools/eval_independent.py``.

The training data comes from ``train/render.py`` (Pillow, a fixed font
bank); held-out pages from that renderer measure the renderer, not OCR. This
tool draws pages through three other paths and scores the engine on them
with word-multiset P/R/F1:

  * ``matplotlib``: the Agg backend's own text layout and FreeType
    rasterization (figure text, titles, annotations, axis labels, legend,
    a table);
  * ``pygame``: SDL_ttf rasterization of page-like text;
  * ``heldout-font``: Pillow pages set in Minecraft.ttf (a blocky pixel face
    shipped with the ``pettingzoo`` package), a full-alphabet face outside
    the training bank.

    python -m ocrs_tpu_torch.tools.eval_independent [--device cpu]
    python -m ocrs_tpu_torch.tools.eval_independent --pages-from test-data/eval/independent.npz
    python -m ocrs_tpu_torch.tools.eval_independent --save-dir DIR   # also write the pages as PNG
    python -m ocrs_tpu_torch.tools.eval_independent --min-f1 0.85    # exit 1 below it

The flags, defaults, JSON output and exit code are the JAX tool's; the
drawing code is a copy of it. Added: ``--device`` (CUDA by default; no
fallback to the CPU) and ``--pages-from`` (the pages, expected texts and
groups from a page file that ``tools/torch_eval_fixtures.py`` writes). A
renderer that is missing raises :class:`..train.render.RenderUnavailable`
(the JAX tool leaves the held-out group empty when the face is missing).
PNGs of ``--save-dir`` are written by :mod:`ocrs_tpu_torch.png`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from pathlib import Path

import numpy as np

from ..train.render import RenderUnavailable, _package_dir

#: The held-out face: a file of the installed package ``pettingzoo``.
MINECRAFT = ("pettingzoo", "classic/rps/font/Minecraft.ttf")

# Fixed prose: realistic mixed-case sentences, numbers and punctuation kept
# inside the default alphabet. Plain module constants so the ground truth is
# reviewable.
PARAGRAPHS = [
    "The quick brown fox jumps over the lazy dog while twelve boxers "
    "juggle bright vases.",
    "Machine learning systems convert large datasets into compact models "
    "that generalize to unseen inputs.",
    "In 1969 the crew of Apollo 11 landed on the Moon and returned safely "
    "to Earth after eight days.",
    "Compilers translate source code into machine instructions through "
    "parsing, optimization and code generation.",
    "A hash table offers constant time lookups on average but degrades "
    "when many keys collide in one bucket.",
    "The recipe calls for 250 grams of flour, two eggs, a pinch of salt "
    "and exactly 40 minutes in the oven.",
    "Networks route packets across links of varying bandwidth, latency "
    "and loss using shortest path algorithms.",
    "Glaciers carve deep valleys over thousands of years, leaving moraines "
    "and polished granite behind.",
]

TITLES = [
    "Quarterly Report 2024",
    "System Design Overview",
    "Field Notes and Observations",
    "Measurement Results",
]

#: The groups in the JAX tool's order, each with its renderer's seed.
GROUPS = (("matplotlib", 0), ("pygame", 1), ("heldout-font", 2))


def word_prf(pred: str, expected: str):
    pw, ew = pred.split(), expected.split()
    inter = sum((Counter(pw) & Counter(ew)).values())
    p = inter / len(pw) if pw else 0.0
    r = inter / len(ew) if ew else 0.0
    return p, r, (2 * p * r / (p + r) if p + r else 0.0)


def _wrap(text: str, width: int) -> list[str]:
    import textwrap

    return textwrap.wrap(text, width)


def _require(module: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RenderUnavailable(f"drawing the {module} pages needs {module}, which is not importable here ({e})") from e


def minecraft_path() -> str:
    """The held-out face's file, or RenderUnavailable naming what is
    missing."""
    package, rel = MINECRAFT
    base = _package_dir(package)
    path = None if base is None else os.path.join(base, rel)
    if path is None or not os.path.exists(path):
        raise RenderUnavailable(f"the held-out face {rel} of the package {package} is not installed here")
    return path


# ---------------------------------------------------------------------------
# Path 1: matplotlib (Agg) figures
# ---------------------------------------------------------------------------


def render_matplotlib(seed: int) -> list[tuple[np.ndarray, str]]:
    matplotlib = _require("matplotlib")
    matplotlib.use("Agg")
    plt = _require("matplotlib.pyplot")

    pages = []
    rng = np.random.default_rng(seed)

    # Page A: text-heavy "document" figure: title + wrapped paragraphs.
    fig = plt.figure(figsize=(8, 10), dpi=160)
    words = []
    title = TITLES[0]
    fig.text(0.08, 0.94, title, fontsize=19, fontweight="bold")
    words += title.split()
    y = 0.87
    for para in PARAGRAPHS[:4]:
        for line in _wrap(para, 54):
            fig.text(0.08, y, line, fontsize=12.5)
            words += line.split()
            y -= 0.033
        y -= 0.018
    canvas = fig.canvas
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    pages.append((buf, " ".join(words)))

    # Page B: a labelled plot — title, axis labels, legend, annotations.
    fig, ax = plt.subplots(figsize=(8, 6), dpi=160)
    x = np.linspace(0, 10, 50)
    ax.plot(x, np.sin(x), label="measured signal")
    ax.plot(x, np.cos(x), label="reference curve")
    ax.set_title("Sensor drift across the test window", fontsize=16)
    ax.set_xlabel("elapsed time in hours", fontsize=13)
    ax.set_ylabel("normalized amplitude", fontsize=13)
    ax.legend(fontsize=12)
    ax.annotate(
        "calibration point",
        xy=(5, 0),
        xytext=(6.0, 0.62),
        fontsize=12,
        arrowprops={"arrowstyle": "->"},
    )
    ax.set_xticks([])  # tick digits are below detectable size at this dpi
    ax.set_yticks([])
    words = (
        "Sensor drift across the test window".split()
        + "elapsed time in hours".split()
        + "normalized amplitude".split()
        + "measured signal".split()
        + "reference curve".split()
        + "calibration point".split()
    )
    canvas = fig.canvas
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    pages.append((buf, " ".join(words)))

    # Page C: two-column text figure with varied sizes/styles.
    fig = plt.figure(figsize=(10, 7), dpi=160)
    words = []
    fig.text(0.06, 0.92, TITLES[1], fontsize=18, fontweight="bold")
    words += TITLES[1].split()
    for col, x0 in enumerate((0.06, 0.54)):
        y = 0.83
        for para in PARAGRAPHS[4 + 2 * col : 6 + 2 * col]:
            for line in _wrap(para, 38):
                fig.text(x0, y, line, fontsize=11.5, style="italic" if col else "normal")
                words += line.split()
                y -= 0.04
            y -= 0.02
    del rng
    canvas = fig.canvas
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    pages.append((buf, " ".join(words)))

    # Page D: a simple table.
    fig, ax = plt.subplots(figsize=(8, 5), dpi=160)
    ax.axis("off")
    cells = [
        ["metric", "value", "unit"],
        ["throughput", "67", "pages"],
        ["latency", "260", "ms"],
        ["accuracy", "0.95", "F1"],
    ]
    table = ax.table(cellText=cells, loc="center", cellLoc="left")
    table.auto_set_font_size(False)
    table.set_fontsize(15)
    table.scale(1.0, 2.2)
    ax.set_title(TITLES[3], fontsize=16, pad=18)
    words = TITLES[3].split() + [w for row in cells for c in row for w in c.split()]
    canvas = fig.canvas
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    pages.append((buf, " ".join(words)))

    return pages


# ---------------------------------------------------------------------------
# Path 2: pygame (SDL_ttf)
# ---------------------------------------------------------------------------


def render_pygame(seed: int) -> list[tuple[np.ndarray, str]]:
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    pygame = _require("pygame")

    pygame.font.init()
    # SDL_ttf rasterization; the font FILES overlap the training bank for
    # two pages (rasterizer independence) and pages use distinct sizes.
    faces = [
        ("/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf", 26),
        ("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", 22),
        (None, 24),  # pygame default face (freesansbold)
    ]
    for face, _ in faces:
        if face is not None and not os.path.exists(face):
            raise RenderUnavailable(f"the pygame pages need the face {face}, which is not installed here")
    pages = []
    rng = np.random.default_rng(seed)
    for face, size in faces:
        font = pygame.font.Font(face, size)
        surf = pygame.Surface((1400, 1000))
        surf.fill((255, 255, 255))
        y = 40
        words = []
        paras = list(PARAGRAPHS)
        rng.shuffle(paras)
        for para in paras[:4]:
            for line in _wrap(para, 70):
                img = font.render(line, True, (10, 10, 10))
                surf.blit(img, (50, y))
                words += line.split()
                y += int(size * 1.6)
            y += int(size * 0.8)
        arr = np.transpose(pygame.surfarray.array3d(surf), (1, 0, 2)).copy()
        pages.append((arr, " ".join(words)))
    return pages


# ---------------------------------------------------------------------------
# Path 3: Pillow + held-out font (Minecraft.ttf)
# ---------------------------------------------------------------------------


def render_heldout_font(seed: int) -> list[tuple[np.ndarray, str]]:
    from ..train.render import pillow

    Image, ImageDraw, ImageFont = pillow("Image", "ImageDraw", "ImageFont")
    face = minecraft_path()
    pages = []
    rng = np.random.default_rng(seed)
    for k, size in enumerate((28, 36)):
        font = ImageFont.truetype(face, size)
        img = Image.new("RGB", (1500, 1100), (250, 250, 250))
        draw = ImageDraw.Draw(img)
        y = 50
        words = []
        paras = list(PARAGRAPHS)
        rng.shuffle(paras)
        for para in paras[: 3 + k]:
            for line in _wrap(para, 60):
                draw.text((60, y), line, fill=(15, 15, 15), font=font)
                words += line.split()
                y += int(size * 1.7)
            y += size
        pages.append((np.asarray(img).copy(), " ".join(words)))
    return pages


RENDERERS = {"matplotlib": render_matplotlib, "pygame": render_pygame, "heldout-font": render_heldout_font}


def draw_groups() -> dict[str, list[tuple[np.ndarray, str]]]:
    """Every group's pages and expected texts, drawn as the JAX tool draws
    them."""
    return {group: RENDERERS[group](seed) for group, seed in GROUPS}


def save_groups(path, groups) -> None:
    """Write :func:`draw_groups`' pages to a page file (compressed
    ``.npz``: ``page_i`` RGB uint8 in order, ``groups`` and ``expected``
    per page)."""
    flat = [(group, img, text) for group, pages in groups.items() for img, text in pages]
    arrays = {f"page_{i}": img for i, (_, img, _) in enumerate(flat)}
    arrays["groups"] = np.array([g for g, _, _ in flat], dtype=str)
    arrays["expected"] = np.array([t for _, _, t in flat], dtype=str)
    np.savez_compressed(path, **arrays)


def read_groups(path) -> dict[str, list[tuple[np.ndarray, str]]]:
    """The groups of a page file, in the file's order."""
    groups: dict[str, list[tuple[np.ndarray, str]]] = {}
    with np.load(path) as data:
        for i, (group, text) in enumerate(zip(data["groups"], data["expected"])):
            groups.setdefault(str(group), []).append((data[f"page_{i}"], str(text)))
    return groups


def build_engine(detect=None, rec=None, vertical=False, min_line_conf=None, device=None):
    """``tools/eval_reference.py::build_engine`` as far as this tool uses it:
    the shipped weights unless named, greedy decoding, vertical text and the
    line-confidence floor where asked for."""
    from ..engine import OcrEngine, OcrEngineParams
    from ..models.weights import load_detection_model, load_recognition_model
    from ..recognition import Greedy

    weights_dir = Path(__file__).resolve().parents[2] / "weights"
    det = load_detection_model(detect or str(weights_dir / "text-detection.npz"))
    rec = load_recognition_model(rec or str(weights_dir / "text-recognition.npz"))
    kwargs = {}
    if vertical:
        kwargs["vertical_text"] = True
    if min_line_conf is not None:
        kwargs["min_line_confidence"] = min_line_conf
    return OcrEngine(
        OcrEngineParams(detection_model=det, recognition_model=rec, decode_method=Greedy(), **kwargs),
        device=device,
    )


def score_groups(engine, groups, save_dir=None, show=False) -> tuple[dict, float]:
    """The tool's JSON result (each group's per-page scores and the overall
    word-multiset scores) and the overall F1 before rounding, which the
    gate reads."""
    from ..png import write_png
    from ..preprocess import DimOrder, ImageSource

    results = {}
    n_inter = n_pred = n_exp = 0
    for group, pages in groups.items():
        g_scores = []
        for i, (img, expected) in enumerate(pages):
            if save_dir:
                out = Path(save_dir)
                out.mkdir(parents=True, exist_ok=True)
                write_png(out / f"{group}-{i}.png", img)
            inp = engine.prepare_input(ImageSource.from_tensor(img, DimOrder.HWC))
            pred = engine.get_text(inp)
            if show:
                print(f"--- {group}-{i} ---\n{pred}\n---", file=sys.stderr)
            p, r, f1 = word_prf(pred, expected)
            inter = sum((Counter(pred.split()) & Counter(expected.split())).values())
            n_inter += inter
            n_pred += len(pred.split())
            n_exp += len(expected.split())
            g_scores.append({"precision": round(p, 4), "recall": round(r, 4), "f1": round(f1, 4)})
        results[group] = g_scores
    p = n_inter / n_pred if n_pred else 0.0
    r = n_inter / n_exp if n_exp else 0.0
    overall = 2 * p * r / (p + r) if p + r else 0.0
    results["overall"] = {
        "precision": round(p, 4),
        "recall": round(r, 4),
        "f1": round(overall, 4),
        "pages": sum(len(v) for k, v in results.items() if k != "overall"),
    }
    return results, overall


def main(argv=None) -> int:
    from ..cli import device_or_exit

    ap = argparse.ArgumentParser()
    ap.add_argument("--detect", default=None)
    ap.add_argument("--rec", default=None)
    ap.add_argument("--min-f1", type=float, default=0.0, help="gate on overall F1")
    ap.add_argument(
        "--min-line-conf",
        type=float,
        default=0.45,
        help="engine min_line_confidence (drops graphics-stroke glyph soup "
        "on the figure pages; 0 disables)",
    )
    ap.add_argument("--save-dir", default=None, help="dump rendered PNGs")
    ap.add_argument("--show", action="store_true", help="print predictions")
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    ap.add_argument("--pages-from", type=Path, default=None, help="page file of the groups (default: draw them)")
    args = ap.parse_args(argv)

    # vertical_text: figure pages carry 90°-rotated axis labels (the
    # matplotlib page's ylabel); the engine feature exists for exactly this.
    engine = build_engine(
        args.detect,
        args.rec,
        vertical=True,
        min_line_conf=args.min_line_conf or None,
        device=device_or_exit(args.device),
    )
    groups = draw_groups() if args.pages_from is None else read_groups(args.pages_from)
    results, overall = score_groups(engine, groups, save_dir=args.save_dir, show=args.show)
    print(json.dumps(results))
    return 0 if overall >= args.min_f1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
