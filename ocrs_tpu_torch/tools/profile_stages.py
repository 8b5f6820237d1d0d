"""Fenced times of the page pipeline's sub-operations: the port of
``tools/profile_stages.py``.

Breaks the pipeline's two device stages (detect, recognize) into their
sub-operations, so that work on speed targets the real costs:

  normalize | det_pre resize | U-Net fwd | CCL | rects | pack | readback |
  FUSED detect | to_words | layout | rec prep (host) | rec dispatch |
  extract | rec fwd | argmax | label readback | ctc collapse |
  FULL recognize x2

    python -m ocrs_tpu_torch.tools.profile_stages [--pages 16] [--device cpu] \\
        [--pages-from test-data/eval/profile_p16.npz]

The rows are the JAX tool's, in its order, over the port's counterparts.
Each timed row is warmed once and run three times; the row prints the
minimum, as the JAX tool does, and the JSON line holds the minimum and the
median. On CUDA a device row (normalize, det_pre resize, U-Net fwd, CCL,
rects fit, pack, extract, rec fwd, argmax) is timed between CUDA events
after ``torch.cuda.synchronize()``; a row with host work is timed by the
host clock between two synchronizations. On the CPU every row takes the
host clock. The pages are the JAX tool's: ``train.data.render_page`` from
``np.random.default_rng(0)``, 30 lines at font size 65 on 3508 x 2480, or
the same pages read from ``--pages-from`` (a ``.npz`` whose ``pages`` is
[B, H, W] uint8; ``tools/torch_eval_fixtures.py`` writes it). The last line
printed is one JSON object of every row.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
PAGE_HW = (3508, 2480)


def draw_pages(n: int, page_hw=PAGE_HW) -> np.ndarray:
    """The JAX tool's pages: [n, H, W] uint8."""
    from ..train.data import render_page

    rng = np.random.default_rng(0)
    return np.stack(
        [
            ((render_page(rng, page_hw=page_hw, n_lines=30, font_size=65)[0][0] + 0.5) * 255).astype(np.uint8)
            for _ in range(n)
        ]
    )


def read_pages(path, n: int) -> np.ndarray:
    """The first `n` pages of a page file; ValueError when it holds fewer."""
    with np.load(path) as data:
        pages = data["pages"]
    if n > len(pages):
        raise ValueError(f"{path} holds {len(pages)} pages, fewer than the {n} asked for")
    return pages[:n]


class Profiler:
    """Rows of fenced times on one device."""

    def __init__(self, device: torch.device, out=print):
        self.device = device
        self.rows: dict[str, dict] = {}
        self._out = out

    def fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _once(self, fn, device_row: bool) -> float:
        self.fence()
        if device_row and self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        self.fence()
        return (time.perf_counter() - t0) * 1e3

    def row(self, name: str, ms: list[float], clock: str, note: str = "") -> None:
        self.rows[name] = {"ms": min(ms), "median_ms": statistics.median(ms), "runs": len(ms), "clock": clock}
        if note:
            self.rows[name]["note"] = note
        self._out(f"{name:<22} {min(ms):8.1f} ms" + (f"  ({note})" if note else ""))

    def timeit(self, name: str, fn, device_row: bool = False, note: str = "") -> None:
        """One warm-up run of fn, then three timed."""
        self._once(fn, device_row)
        ms = [self._once(fn, device_row) for _ in range(3)]
        clock = "cuda_events" if device_row and self.device.type == "cuda" else "host"
        self.row(name, ms, clock, note)

    def once(self, name: str, fn, note=lambda result: ""):
        """One fenced host-clock run of fn (no warm-up); returns its result."""
        self.fence()
        t0 = time.perf_counter()
        result = fn()
        self.fence()
        self.row(name, [(time.perf_counter() - t0) * 1e3], "host", note(result))
        return result


def profile(pipeline, pages: np.ndarray, out=print) -> dict:
    """Time every row over `pages` ([B, H, W] uint8) with `pipeline`'s
    models and options on its device; returns the rows, the counts of words
    and lines, and the endpoint statistics of the masks."""
    from ..layout import find_text_lines
    from ..ops.connected_components import label_components_multigrid
    from ..ops.ctc import collapse_greedy_batch, greedy_labels_u8
    from ..ops.rects import min_area_rects_device, pack_rect_table
    from ..ops.warp import extract_line_batch_packed, pad_chain
    from ..parallel.pipeline import _detect_pre_batch, _normalize_batch
    from ..recognition import MAX_CHAIN_V, _RecLine, line_polygons_batch, resized_line_width

    dev = pipeline.device
    prof = Profiler(dev, out)
    det, rec = pipeline._det, pipeline._rec
    b, page_h, page_w = pages.shape
    out(f"== {b} pages {page_h}x{page_w} on {dev} ==")

    pages_t = torch.from_numpy(np.ascontiguousarray(pages[..., None])).to(dev)
    prof.timeit("normalize", lambda: _normalize_batch(pages_t, True), device_row=True)
    pages_dev = _normalize_batch(pages_t, True)

    in_h, in_w = pipeline._det_hw
    pre = lambda: _detect_pre_batch(pages_dev, input_hw=(in_h, in_w), pads=(0, 0))  # noqa: E731
    prof.timeit("det_pre resize", pre, device_row=True)
    x = pre()

    prof.timeit("unet fwd", lambda: det.run(x), device_row=True)
    probs = det.run(x)

    masks = probs[:, 0] > pipeline._params.text_threshold
    ccl = lambda: [label_components_multigrid(m, solidify=True) for m in masks]  # noqa: E731
    prof.timeit("ccl multigrid", ccl, device_row=True)
    labels = ccl()

    lab_h = torch.stack(labels).cpu().numpy()
    npix = (lab_h >= 0).sum(axis=(1, 2))
    left = np.pad(lab_h[:, :, :-1], ((0, 0), (0, 0), (1, 0)), constant_values=-2)
    right = np.pad(lab_h[:, :, 1:], ((0, 0), (0, 0), (0, 1)), constant_values=-2)
    ep = (lab_h >= 0) & ((lab_h != left) | (lab_h != right))
    runs_per_row = ((lab_h >= 0) & (lab_h != left)).sum(axis=2)
    mask_stats = {
        "mask_px_per_page": float(npix.mean()),
        "endpoints_per_page": float(ep.sum(axis=(1, 2)).mean()),
        "max_runs_per_row": int(runs_per_row.max()),
        "mean_nonzero_runs_per_row": float(runs_per_row[runs_per_row > 0].mean()) if (runs_per_row > 0).any() else 0.0,
    }
    out(
        f"  mask px/page {mask_stats['mask_px_per_page']:.0f}; endpoints/page "
        f"{mask_stats['endpoints_per_page']:.0f}; max runs/row {mask_stats['max_runs_per_row']}; "
        f"mean nonzero runs/row {mask_stats['mean_nonzero_runs_per_row']:.1f}"
    )

    rects = lambda: [  # noqa: E731
        min_area_rects_device(l, max_components=pipeline._max_components, max_points=256, max_boundary=16384)
        for l in labels
    ]
    prof.timeit("rects fit", rects, device_row=True)
    tables = rects()

    pack = lambda: torch.stack([pack_rect_table(t) for t in tables])  # noqa: E731
    prof.timeit("pack", pack, device_row=True)
    packed = pack()

    prof.timeit(
        "table readback", lambda: packed.cpu().numpy(), note=f"{packed.numel() * packed.element_size() / 1024:.0f} KB"
    )

    prof.timeit("FUSED detect", lambda: pipeline._detect_tables(pages_dev)[0])
    fused, scale = pipeline._detect_tables(pages_dev)
    prof.fence()

    per_page_words = prof.once(
        "tables_to_words (host)",
        lambda: pipeline._tables_to_words_arrays(fused, scale)[0],
        note=lambda words: f"{sum(len(w) for w in words)} words",
    )
    per_page_lines = prof.once(
        "layout (host)",
        lambda: [find_text_lines(w) for w in per_page_words],
        note=lambda lines: f"{sum(len(l) for l in lines)} lines",
    )

    flat, flat_words = [], []
    for pg, lines in enumerate(per_page_lines):
        for li, words in enumerate(lines):
            flat.append((pg, li))
            flat_words.append(words)
    polys, rects_h = prof.once(
        "rec prep: polygons", lambda: line_polygons_batch(flat_words), note=lambda _: f"{len(flat)} lines"
    )
    n_words = sum(len(w) for w in per_page_words)
    n_lines = len(flat)
    result = {"rows": prof.rows, "words": n_words, "lines": n_lines, "mask": mask_stats}
    if not flat:
        return result

    pooled = [
        (
            pg,
            _RecLine(
                index=li, poly=poly, rect=lr, resized_width=resized_line_width(lr.width, lr.height, pipeline._rec_h)
            ),
        )
        for (pg, li), poly, lr in zip(flat, polys, rects_h)
    ]
    # One batch of the first max_lines lines at its trimmed width.
    chunk = pooled[: pipeline._max_lines]
    w_eff = max(-(-max(rl.resized_width for _, rl in chunk) // 128) * 128, 128)
    prof.once(
        "rec batch dispatch",
        lambda: pipeline._run_pooled_batch(pages_dev, chunk, w_eff, True, False),
        note=lambda _: f"width {w_eff}, n {len(chunk)}; incl 1st-call",
    )

    n = len(chunk)
    geom = np.empty((6, n), dtype=np.float32)
    chains = np.empty((n, 2, MAX_CHAIN_V, 2), dtype=np.float32)
    for col, (pg, rl) in enumerate(chunk):
        geom[:, col] = (rl.rect.top, rl.rect.left, rl.rect.height, rl.rect.width, rl.resized_width, pg)
        half = len(rl.poly) // 2
        chains[col, 0] = pad_chain(rl.poly[:half], MAX_CHAIN_V)
        chains[col, 1] = pad_chain(rl.poly[half:][::-1], MAX_CHAIN_V)
    geom_dev = torch.from_numpy(geom).to(dev)
    chains_dev = torch.from_numpy(chains).to(dev)

    ext = lambda: extract_line_batch_packed(  # noqa: E731
        pages_dev, geom_dev, chains_dev, out_h=pipeline._rec_h, out_w=w_eff
    )
    prof.timeit("extract alone", ext, device_row=True)
    crops = ext().to(torch.bfloat16)

    prof.timeit("rec fwd alone", lambda: rec.run(crops), device_row=True, note=f"batch {tuple(crops.shape)}")
    lp = rec.run(crops)

    argmax = lambda: greedy_labels_u8(lp.transpose(0, 1))  # noqa: E731
    prof.timeit("argmax (greedy u8)", argmax, device_row=True)
    labels_u8 = argmax()

    prof.timeit(
        "label readback",
        lambda: labels_u8.cpu().numpy(),
        note=f"{labels_u8.numel() * labels_u8.element_size() / 1024:.0f} KB",
    )
    host_labels = labels_u8.cpu().numpy()
    prof.once("ctc collapse (host)", lambda: collapse_greedy_batch(host_labels))

    # The whole recognize stage as the pipeline runs it.
    recognize = lambda: pipeline._collect_recognition(  # noqa: E731
        per_page_lines, pipeline._dispatch_recognition(pages_dev, per_page_lines)
    )
    prof.once("FULL recognize stage", recognize, note=lambda _: "warm")
    prof.once("FULL recognize stage 2", recognize, note=lambda _: "warm 2")
    return result


def main(argv=None) -> int:
    from ..cli import device_or_exit

    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    ap.add_argument("--pages-from", type=Path, default=None, help="page file of the pages (default: draw them)")
    args = ap.parse_args(argv)

    from ..engine import DEFAULT_ALPHABET
    from ..models.weights import load_detection_model, load_params, load_recognition_model
    from ..parallel.pipeline import PagePipeline

    device = device_or_exit(args.device)
    if args.pages_from is None:
        pages = draw_pages(args.pages)
    else:
        try:
            pages = read_pages(args.pages_from, args.pages)
        except ValueError as exc:
            ap.error(str(exc))

    wdir = REPO / "weights"
    _, rm = load_params(wdir / "text-recognition.npz")
    pipeline = PagePipeline(
        detection_model=load_detection_model(wdir / "text-detection.npz"),
        recognition_model=load_recognition_model(wdir / "text-recognition.npz"),
        alphabet=rm.get("alphabet", DEFAULT_ALPHABET),
        max_lines_per_batch=128,
        device=device,
    )
    result = profile(pipeline, pages)
    print(json.dumps({"tool": "profile_stages", "pages": list(pages.shape), "device": str(device), **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
