"""Word-level precision/recall/F1 of the full OCR pipeline: the port of
``tools/eval_accuracy.py``.

Held-out styled pages (``train.render.render_native_page`` from ``--seed``)
go through the complete engine (detect -> layout -> recognize), and
predicted words are matched against the ground truth: a prediction is a true
positive when its rect overlaps a ground-truth word (IoU >= ``--iou``) and
its text is within ``--max-edit`` edits. The detector's own word rects are
scored the same way without the text.

    python -m ocrs_tpu_torch.tools.eval_accuracy --detect weights/text-detection.npz \\
        --rec weights/text-recognition.npz --pages 8 [--device cpu] \\
        [--pages-from test-data/eval/accuracy_s1234_p8.npz]

The flags, defaults and JSON output are the JAX tool's. ``--device`` picks
the engine's device (CUDA by default; no fallback to the CPU).
``--pages-from`` reads the pages that ``--seed`` draws from a page file
(``tools/torch_eval_fixtures.py`` writes them), for machines that cannot
draw; a file of another seed, or with fewer pages than asked for, is
refused.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _iou(a, b) -> float:
    t = max(a[0], b[0])
    l = max(a[1], b[1])
    bt = min(a[2], b[2])
    r = min(a[3], b[3])
    inter = max(bt - t, 0) * max(r - l, 0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def _edit_distance(a: str, b: str) -> int:
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev = dp[0]
        dp[0] = i
        for j, cb in enumerate(b, 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
            prev = cur
    return dp[-1]


def match_counts(preds, gt_words, iou_thresh: float, max_edit: int | None) -> tuple[int, int, int]:
    """(tp, fp, fn) of predictions ``(text, (t, l, b, r))`` against the
    ground-truth words, each prediction taking the unused ground-truth word
    of best IoU at or above `iou_thresh` (and, unless `max_edit` is None,
    within `max_edit` edits of its text)."""
    gt_used = [False] * len(gt_words)
    tp = fp = 0
    for ptext, pbox in preds:
        best, best_iou = None, iou_thresh
        for gi, (gtext, gbox) in enumerate(gt_words):
            v = _iou(pbox, gbox)
            if (
                not gt_used[gi]
                and v >= best_iou
                and (max_edit is None or _edit_distance(ptext, gtext) <= max_edit)
            ):
                best, best_iou = gi, v
        if best is None:
            fp += 1
        else:
            gt_used[best] = True
            tp += 1
    return tp, fp, gt_used.count(False)


def _prf(tp, fp, fn):
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return round(p, 4), round(r, 4), round(f, 4)


def draw_pages(pages: int, seed: int):
    """The pages the JAX tool draws: `pages` styled pages from `seed` as
    (uint8 [H, W], ground-truth words), a page without words drawn again."""
    from ..train.render import render_native_page

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pages):
        # Held-out STYLED pages (fonts/polarity/gray levels/degradations/
        # native sizes drawn fresh from the full style space, disjoint seed
        # stream from training).
        page01, gt_words = render_native_page(rng)
        while len(gt_words) == 0:  # skip the rare no-text page
            page01, gt_words = render_native_page(rng)
        out.append(((page01 * 255).astype(np.uint8), gt_words))
    return out


def save_pages(path, pages, seed: int) -> None:
    """Write :func:`draw_pages`' pages to a page file (compressed ``.npz``:
    ``page_i`` uint8, ``texts_i`` and ``boxes_i`` float64 [n, 4] (t, l, b,
    r) per page, and ``seed``)."""
    arrays = {"seed": np.int64(seed)}
    for i, (page, words) in enumerate(pages):
        arrays[f"page_{i}"] = page
        arrays[f"texts_{i}"] = np.array([t for t, _ in words], dtype=str)
        arrays[f"boxes_{i}"] = np.array([b for _, b in words], dtype=np.float64).reshape(-1, 4)
    np.savez_compressed(path, **arrays)


def read_pages(path, pages: int, seed: int):
    """The first `pages` pages of a page file, as :func:`draw_pages` gives
    them. Raises ValueError when the file was drawn from another seed or
    holds fewer pages."""
    with np.load(path) as data:
        have = sum(1 for k in data.files if k.startswith("page_"))
        file_seed = int(data["seed"])
        if file_seed != seed:
            raise ValueError(f"{path} holds pages of seed {file_seed}, not {seed}")
        if pages > have:
            raise ValueError(f"{path} holds {have} pages, fewer than the {pages} asked for")
        return [
            (
                data[f"page_{i}"],
                [(str(t), tuple(float(v) for v in b)) for t, b in zip(data[f"texts_{i}"], data[f"boxes_{i}"])],
            )
            for i in range(pages)
        ]


def score_pages(engine, pages, iou_thresh: float, max_edit: int, show: int = 0) -> dict:
    """The tool's scores over `pages` ((uint8 page, ground-truth words) in
    order); what :func:`evaluate` returns."""
    from ..preprocess import DimOrder, ImageSource

    tp = fp = fn = 0
    det_tp = det_fp = det_fn = 0
    for arr, gt_words in pages:
        inp = engine.prepare_input(ImageSource.from_tensor(arr[..., None], DimOrder.HWC))
        words = engine.detect_words(inp)
        lines = engine.find_text_lines(inp, words)
        recognized = engine.recognize_text(inp, lines)

        preds = []
        for line in recognized:
            if line is None:
                continue
            for word in line.words():
                br = word.bounding_rect()
                preds.append((str(word), (br.top, br.left, br.bottom, br.right)))

        if show > 0:
            for ptext, pbox in preds[:show]:
                best = max(gt_words, key=lambda g: _iou(pbox, g[1]))
                print(
                    f"  pred {ptext!r:18} gt {best[0]!r:14} iou "
                    f"{_iou(pbox, best[1]):.2f}",
                    file=sys.stderr,
                )
            show = 0

        # Detection-only matching: the DETECTOR's word rects (not the
        # recognized-word rects) against ground truth, best-IoU assignment.
        det_boxes = []
        for w in words:
            br = w.bounding_rect()
            det_boxes.append(("", (br.top, br.left, br.bottom, br.right)))
        counts = match_counts(det_boxes, gt_words, iou_thresh, None)
        det_tp, det_fp, det_fn = det_tp + counts[0], det_fp + counts[1], det_fn + counts[2]

        # End-to-end word matching (geometry + text), best-IoU assignment.
        counts = match_counts(preds, gt_words, iou_thresh, max_edit)
        tp, fp, fn = tp + counts[0], fp + counts[1], fn + counts[2]

    dp, dr, df = _prf(det_tp, det_fp, det_fn)
    ep, er, ef = _prf(tp, fp, fn)
    return {
        "pages": len(pages),
        "detection": {"precision": dp, "recall": dr, "f1": df},
        "end_to_end": {"precision": ep, "recall": er, "f1": ef},
    }


def evaluate(engine, pages: int, seed: int, iou_thresh: float, max_edit: int, show: int = 0, source=None):
    """Scores of `engine` on `pages` pages of `seed`: drawn, or read from
    the page file `source` when it is given."""
    page_list = draw_pages(pages, seed) if source is None else read_pages(source, pages, seed)
    return score_pages(engine, page_list, iou_thresh, max_edit, show=show)


def build_engine(detect, rec, device=None):
    """The JAX tool's engine (default parameters, the recognizer file's
    alphabet) on `device`."""
    from ..engine import OcrEngine, OcrEngineParams
    from ..models.weights import load_detection_model, load_params, load_recognition_model

    _, rec_meta = load_params(rec)
    return OcrEngine(
        OcrEngineParams(
            detection_model=load_detection_model(detect),
            recognition_model=load_recognition_model(rec),
            alphabet=rec_meta.get("alphabet"),
        ),
        device=device,
    )


def main(argv=None) -> int:
    from ..cli import device_or_exit

    parser = argparse.ArgumentParser()
    parser.add_argument("--detect", required=True, help="detection weights .npz")
    parser.add_argument("--rec", required=True, help="recognition weights .npz")
    parser.add_argument("--pages", type=int, default=8)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--iou", type=float, default=0.3)
    parser.add_argument("--max-edit", type=int, default=1)
    parser.add_argument("--show-samples", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    parser.add_argument(
        "--pages-from", type=Path, default=None, help="page file holding the pages of --seed (default: draw them)"
    )
    args = parser.parse_args(argv)

    engine = build_engine(args.detect, args.rec, device_or_exit(args.device))
    if args.pages_from is None:
        pages = draw_pages(args.pages, args.seed)
    else:
        try:
            pages = read_pages(args.pages_from, args.pages, args.seed)
        except ValueError as exc:
            parser.error(str(exc))
    result = score_pages(engine, pages, args.iou, args.max_edit, show=args.show_samples)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
