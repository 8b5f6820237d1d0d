#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ocrs_tpu_torch) on one NVIDIA GPU and check it.

Run from a checkout of the repository, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``), and it imports
nothing of JAX or of the JAX package. Each phase prints one JSON line:

  1. build: compile every kernel of the port from ``ocrs_tpu_torch/csrc``.
  2. kernel_vs_plain: each kernel against its plain PyTorch version on the
     card, at the largest shape the main path gives it: one direction
     (``gru_sequence``, forward and reverse) and both in one launch
     (``bigru_sequence``, strided operands as the layer passes them).
  3. engine: the CRNN path. ``OcrEngine(device="cuda").get_text`` on four
     pages (two from ``test-data``, a wide one tiled from them, and a page of
     real text drawn by this script) with the shipped detector, default engine parameters and a CRNN recognizer at
     full width (hidden 192, random weights from seed 0): two GRU launches
     per recognition batch, one per bidirectional layer. Kernel launch counts
     are zeroed just before this run and read just after it. The same engine
     then runs again with the GRU forced to its plain version: in bf16 the
     log-probs must agree within a stated bound, and frames whose label flips
     at a near-tie are counted; with the recognizer in float32 (on the
     small pages) both runs must decode the same text. The recognizer's
     float32 output on the card is held against the same network on the CPU
     on the first page's line batch.
  4. postprocess: on the pages' thresholded masks the integer
     post-processing functions (``label_components_multigrid``,
     ``label_components_device``, ``runs_tables``) on the card equal the same
     functions on the CPU exactly, and ``min_area_rects_device`` agrees within
     a stated tolerance; components, runs, edges, loop iterations and host
     reads are printed.
  5. engine_default: the default path. The shipped detector, the shipped
     ConvCTC recognizer and default ``OcrEngineParams`` on the same pages:
     words, lines and text on each, no GRU launch, finite log-probs of the
     expected shape, ConvCTC in float32 on the card against the CPU. The
     same engine on the CPU (asked for explicitly, as a yardstick) must read
     the text page as the card does, letter for letter as it was written,
     and decode the card's text on the small pages from the card's own
     lines; frames whose label differs on the same crops are counted with
     their margins, and must be near-ties.
  6. options: every ``OcrEngineParams`` option once on the card, its text held
     against the CPU engine's.
  7. times: CUDA-event medians of the kernel (one and both directions), its
     plain version, its two timing-only variants (the step-latency floor), the
     bidirectional layer ``bigru_apply`` beside cuDNN's
     ``torch.nn.GRU(bidirectional=True)`` on the same weights (a yardstick
     only: the port never calls it), the kernel's bound, the ConvCTC and CRNN
     forward at the largest batch, ``get_text`` and its stages per page on
     both paths, and ``detect_words`` under the three post-processing modes.

Then it prints the kernels line, the card's name and power limit, and, as
the last line, ``{"ok": true, "device": {...}}``. A failed check exits with
code 1 before that line; no CUDA device exits with code 2 and prints nothing
on standard output.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# GRU shape of the main path's largest recognition batch: hidden 192, width
# bucket 2432 / downsample 4 = 608 frames, max_lines_per_batch = 20.
GRU_T, GRU_N, GRU_H = 608, 20, 192
# Kernel vs plain version, both float32: the same math with the [N, H] x
# [H, 3H] sums taken in another order (split-TF32 tiles on the tensor cores,
# eight partial sums over k, against cuBLAS) and the gates' exponentials from
# __expf, compounded over 608 dependent steps.
GRU_ATOL = 1e-4
# Recognizer log-probs, bf16 activations, kernel vs plain GRU: the GRU outputs
# differ in float32 rounding only, but are rounded to bf16 (2**-8 relative)
# before the next layer, so a single flipped bf16 rounding moves downstream
# log-probs by up to a few 1e-2.
ENGINE_LOGPROB_ATOL = 0.1
# Recognizer log-probs in float32, card (kernel, cuDNN convs with TF32 off)
# against the CPU (plain GRU): summation order only.
REFERENCE_F32_ATOL = 1e-3

# ConvCTC log-probs in float32, card against CPU: summation order only.
CONVCTC_F32_ATOL = 1e-3
# min_area_rects_device, card against CPU, in pixels: float32 cos/sin differ in
# the last bit, so the argmin over near-equal areas may pick the neighbouring
# angle step (0.9 degrees), which moves a word's extents by under a pixel.
RECT_ATOL_PX = 1.0
# Default path, card against CPU: a frame whose label differs must be a
# near-tie, its top-2 margin on the card within this many nats (bf16 logits
# near -10 carry 2**-5 per ulp, and the two devices sum in different orders).
FLIP_MARGIN_MAX = 0.5

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# A page of real text for the default path: lines the shipped recognizer reads
# letter for letter, drawn with this script's own copy of the few glyphs it
# needs of the 5x7 bitmap face the recognizer was trained on (rows top to
# bottom, ten to a cell; "g" reaches below the baseline).
TEXT_LINES = ("Section 12 notes", "This line is longer")
GLYPHS = {
    "1": ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    "2": [".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"],
    "S": [".####", "#....", "#....", ".###.", "....#", "....#", "####."],
    "T": ["#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."],
    "c": ["", "", ".###", "#...", "#...", "#...", ".###"],
    "e": ["", "", ".###.", "#...#", "#####", "#....", ".###."],
    "g": ["", "", ".####", "#...#", "#...#", "#...#", ".####", "....#", ".###."],
    "h": ["#....", "#....", "####.", "#...#", "#...#", "#...#", "#...#"],
    "i": [".#.", "...", "##.", ".#.", ".#.", ".#.", "###"],
    "l": ["#.", "#.", "#.", "#.", "#.", "#.", "##"],
    "n": ["", "", "#.##.", "##..#", "#...#", "#...#", "#...#"],
    "o": ["", "", ".###.", "#...#", "#...#", "#...#", ".###."],
    "r": ["", "", "#.##", "##..", "#...", "#...", "#..."],
    "s": ["", "", ".###", "#...", ".##.", "...#", "###."],
    "t": [".#..", ".#..", "####", ".#..", ".#..", ".#..", "..##"],
}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over `reps` runs of fn's device time, each between its own
    pair of CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of fn, fenced by torch.cuda.synchronize()."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gru_inputs(generator, device="cuda"):
    import torch

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=generator)

    xr, xz, xn = (randn(GRU_T, GRU_N, GRU_H) for _ in range(3))
    wh = randn(GRU_H, 3 * GRU_H) * (2.0 / GRU_H) ** 0.5
    bh = randn(3 * GRU_H) * 0.1
    return xr, xz, xn, wh, bh


def bigru_inputs(generator, device="cuda"):
    """Operands of bigru_sequence as the layer passes them: the transposed
    views of two [N, T, 3H] projections, then wh, bh of each direction."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=generator)

    xps = [randn(GRU_N, GRU_T, 3 * GRU_H).transpose(0, 1) for _ in range(2)]
    rec = []
    for _ in range(2):
        rec += [randn(GRU_H, 3 * GRU_H) * (2.0 / GRU_H) ** 0.5, randn(3 * GRU_H) * 0.1]
    return (*xps, *rec)


def frame_flips(lp, lp_other):
    """Frames whose argmax differs between two [T, N, C] log-prob tensors,
    with the first one's top-2 margin at those frames."""
    flipped = lp.argmax(-1) != lp_other.argmax(-1)
    top2 = lp.topk(2, dim=-1).values
    return int(flipped.sum()), (top2[..., 0] - top2[..., 1])[flipped].tolist()


def text_page(lines=TEXT_LINES, hw=(160, 420), scale=3, left=30, top=24, gap=22):
    """Dark bold text on a light page -> (H, W, 1) uint8. One grid cell is
    `scale` pixels; letters are a column apart, words three."""
    import numpy as np

    ink = np.zeros(hw, bool)
    y = top
    for text in lines:
        cols = []
        for ch in text:
            if ch == " ":
                cols.append(np.zeros((10, 3), bool))
                continue
            rows = GLYPHS[ch]
            glyph = np.zeros((10, max(len(r) for r in rows)), bool)
            for i, r in enumerate(rows):
                glyph[i, : len(r)] = [c == "#" for c in r]
            glyph[:, 1:] |= glyph[:, :-1].copy()  # bold: every stroke a column wider
            cols += [glyph, np.zeros((10, 1), bool)]
        line = np.concatenate(cols, axis=1).repeat(scale, axis=0).repeat(scale, axis=1)
        ink[y : y + line.shape[0], left : left + line.shape[1]] = line
        y += line.shape[0] + gap
    return np.where(ink, 0, 255).astype(np.uint8)[..., None]


def option_pages(text, wide):
    """One page per option, made from the text page with numpy and scipy."""
    import numpy as np
    from scipy import ndimage

    ruled = text.copy()
    ruled[66:69, 30:330] = 0  # a rule under the first line
    return {
        "text": text,
        "rotated": ndimage.rotate(text[..., 0], 7.0, reshape=True, order=1, cval=255)[..., None].astype(np.uint8),
        "vertical": np.ascontiguousarray(np.rot90(text_page(TEXT_LINES[:1], hw=(78, 376), top=15))),
        "ruled": ruled,
        "wide": wide,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from ocrs_tpu_torch import cuda_build
        from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
        from ocrs_tpu_torch import detection
        from ocrs_tpu_torch.models.recognition_net import RecognitionModel
        from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
        from ocrs_tpu_torch.ops import connected_components as cc
        from ocrs_tpu_torch.ops import gru, rects
        from ocrs_tpu_torch.recognition import BeamSearch
        from ocrs_tpu_torch.png import read_png
        from ocrs_tpu_torch.preprocess import DimOrder, ImageSource
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32

    # 1. Build -----------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "libraries": {name: round(info["seconds"], 3) for name, info in built.items()},
            "ptxas": [
                line.strip()
                for info in built.values()
                for line in info["log"].splitlines()
                if "registers" in line or "spill" in line
            ],
        }
    )

    # 2. Kernel vs plain version at the main path's largest shape ----------------
    g = torch.Generator(device=dev).manual_seed(0)
    args = gru_inputs(g)
    errs = {}
    for reverse in (False, True):
        got = gru.gru_sequence(*args, reverse=reverse)
        want = gru.gru_sequence_reference(*args, reverse=reverse)
        torch.cuda.synchronize()
        errs["reverse" if reverse else "forward"] = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), "gru_sequence output is finite")
        check(tuple(got.shape) == (GRU_T, GRU_N, GRU_H), "gru_sequence output shape")
    bi_args = bigru_inputs(g)
    bi_out = torch.full((GRU_N, GRU_T, 2 * GRU_H), float("nan"), device=dev)
    gru.bigru_sequence(*bi_args, out=bi_out.transpose(0, 1))
    bi_want = gru.bigru_sequence_reference(*bi_args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(bi_out).all()), "bigru_sequence output is finite")
    for name, half in (("bigru_forward_half", slice(0, GRU_H)), ("bigru_reverse_half", slice(GRU_H, None))):
        errs[name] = float((bi_out.transpose(0, 1)[..., half] - bi_want[..., half]).abs().max())
    max_err = max(errs.values())
    check(max_err <= GRU_ATOL, f"GRU kernel vs plain: max |err| {max_err} <= {GRU_ATOL} ({errs})")
    emit(
        {
            "phase": "kernel_vs_plain",
            "kernel": "gru_sequence, bigru_sequence",
            "launch_plan": gru.launch_plan(GRU_N, GRU_H),
            "shape": {"T": GRU_T, "N": GRU_N, "H": GRU_H, "dtype": "float32"},
            "max_abs_err": errs,
            "atol": GRU_ATOL,
        }
    )

    # 3. Engine end to end ----------------------------------------------------------
    two = read_png(REPO / "test-data" / "two-lines.png")
    strip = read_png(REPO / "test-data" / "strip-line.png")
    pages = {
        "two-lines": two,
        "strip-line": strip,
        # 8 x 5 tiles of strip-line: 2560 x 800, lines wide enough for the
        # 2432 width bucket (608 GRU frames).
        "wide": np.tile(strip, (5, 8, 1)),
        # Real text (the other pages hold blobs, which decode to no word).
        "text": text_page(),
    }
    small = ("two-lines", "strip-line", "text")
    det = load_detection_model(REPO / "weights" / "text-detection.npz")
    rec = RecognitionModel.create(seed=0, arch="crnn")
    # Default parameters: multigrid post-processing on the card.
    engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=rec), device="cuda")
    inputs = {k: engine.prepare_input(ImageSource.from_tensor(v, DimOrder.HWC)) for k, v in pages.items()}
    captured: list[tuple[torch.Tensor, torch.Tensor]] = []
    hook = rec.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0], out.detach())))

    def run_pages(names=tuple(pages), engine=engine):
        texts, batches = {}, {}
        for name in names:
            captured.clear()
            texts[name] = engine.get_text(inputs[name])
            batches[name] = list(captured)
        torch.cuda.synchronize()
        return texts, batches

    def gru_launches():
        return gru.gru_sequence.launches + gru.bigru_sequence.launches

    gru.gru_sequence.launches = gru.bigru_sequence.launches = 0
    texts, batches = run_pages()
    launches = gru_launches()
    n_batches = sum(len(b) for b in batches.values())
    check(launches > 0, "the main path launched the GRU kernel")
    check(launches == 2 * n_batches, f"2 GRU launches per recognition batch ({launches} for {n_batches})")

    rec.net.plain_gru = True
    plain_texts, plain_batches = run_pages()
    # The recognizer in float32, kernel and plain GRU, on the small pages: no
    # bf16 rounding between the layers, so the decoded text must be identical.
    rec.dtype = torch.float32
    f32_plain_texts, _ = run_pages(small)
    rec.net.plain_gru = False
    f32_texts, _ = run_pages(small)
    rec.dtype = torch.bfloat16
    check(gru_launches() > launches, "the float32 run launched the kernel")

    page_report = {}
    max_lp_diff = 0.0
    for name, inp in inputs.items():
        words = engine.detect_words(inp)
        lines = engine.find_text_lines(inp, words)
        shapes, flips, flip_margins = [], 0, []
        for (x, lp), (_, lp_plain) in zip(batches[name], plain_batches[name]):
            n_pad, _, _, w_eff = x.shape
            shapes.append({"N": n_pad, "w_eff": w_eff, "T": lp.shape[0]})
            check(tuple(lp.shape) == (w_eff // 4, n_pad, 97), f"{name}: log-prob shape")
            check(bool(torch.isfinite(lp).all()), f"{name}: finite log-probs")
            max_lp_diff = max(max_lp_diff, float((lp - lp_plain).abs().max()))
            # bf16 near-ties: frames whose argmax differs between the runs,
            # with the kernel run's top-2 margin there.
            n_flipped, margins = frame_flips(lp, lp_plain)
            flips += n_flipped
            flip_margins += margins
        if name in small:
            check(f32_texts[name] == f32_plain_texts[name], f"{name}: float32 kernel and plain GRU decode the same text")
        check(len(words) > 0 and len(lines) > 0, f"{name}: words and lines found")
        page_report[name] = {
            "hw": list(pages[name].shape[:2]),
            "words": len(words),
            "lines": len(lines),
            "batches": shapes,
            "text": texts[name],
            "bf16_text_equal_kernel_vs_plain": texts[name] == plain_texts[name],
            "bf16_flipped_frames": flips,
            "bf16_max_top2_margin_at_flip": max(flip_margins, default=None),
            "f32_text_equal_kernel_vs_plain": f32_texts[name] == f32_plain_texts[name] if name in small else None,
        }
        if texts[name] != plain_texts[name]:
            page_report[name]["text_plain_gru"] = plain_texts[name]
    check(max_lp_diff <= ENGINE_LOGPROB_ATOL, f"log-probs kernel vs plain GRU {max_lp_diff} <= {ENGINE_LOGPROB_ATOL}")

    # The recognizer in float32 on the card against the same network on the CPU.
    crops = batches["two-lines"][0][0].float()
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        card = rec.net(crops, dtype=torch.float32).cpu()
        cpu = copy.deepcopy(rec.net).cpu()(crops.cpu(), dtype=torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    ref_err = float((card - cpu).abs().max())
    check(ref_err <= REFERENCE_F32_ATOL, f"f32 recognizer card vs CPU {ref_err} <= {REFERENCE_F32_ATOL}")
    emit(
        {
            "phase": "engine",
            "gru_launches": launches,
            "recognition_batches": n_batches,
            "pages": page_report,
            "max_abs_logprob_diff_kernel_vs_plain": max_lp_diff,
            "logprob_atol": ENGINE_LOGPROB_ATOL,
            "f32_recognizer_card_vs_cpu": ref_err,
            "f32_atol": REFERENCE_F32_ATOL,
        }
    )
    hook.remove()

    # 4. Post-processing: the card against the CPU on the pages' own masks ------------
    def unet_probs(inp):
        """The detector's pre-pass and forward, as detect_words runs them."""
        in_h, in_w = det_hw = tuple(det.input_shape()[2:])
        pads = (max(in_h - inp.image.shape[1], 0), max(in_w - inp.image.shape[2], 0))
        return det.run(detection._pre(inp.image, det_hw, pads)), (in_h - pads[0], in_w - pads[1])

    def page_mask(inp):
        probs, crop_hw = unet_probs(inp)
        return detection._threshold_crop(probs, crop_hw=crop_hw, threshold=engine.detection_threshold())

    post_report = {}
    with torch.inference_mode():
        for name, inp in inputs.items():
            mask = page_mask(inp)
            mask_cpu = mask.cpu()
            report = {"mask_hw": list(mask.shape), "mask_pixels": int(mask.sum())}
            for fn, kwargs in (
                (cc.label_components_multigrid, {}),
                (cc.label_components_device, {"solidify": True}),
                (rects.runs_tables, {}),
            ):
                cc.loop_counts.update(iterations=0, host_syncs=0)
                got = fn(mask, **kwargs)
                counts = dict(cc.loop_counts)
                equal = torch.equal(got.cpu(), fn(mask_cpu, **kwargs))
                check(equal, f"{name}: {fn.__name__} on the card equals the CPU")
                report[fn.__name__] = {"equals_cpu": equal, **counts}
            labels = cc.label_components_multigrid(mask)
            table = rects.unpack_rect_table(rects.pack_rect_table(rects.min_area_rects_device(labels)))
            table_cpu = rects.unpack_rect_table(rects.pack_rect_table(rects.min_area_rects_device(labels.cpu())))
            valid = table_cpu["valid"]
            ints_equal = all(np.array_equal(table[k], table_cpu[k]) for k in ("valid", "count", "dropped"))
            check(ints_equal, f"{name}: min_area_rects_device valid/count/dropped on the card equal the CPU")
            geom_err = max(
                (float(np.abs(table[k][valid] - table_cpu[k][valid]).max()) for k in ("cx", "cy", "w", "h") if valid.any()),
                default=0.0,
            )
            check(geom_err <= RECT_ATOL_PX, f"{name}: min_area_rects_device card vs CPU {geom_err} px <= {RECT_ATOL_PX}")
            half = cc._close3(cc._pool2_any(mask))
            runs, edges = cc._run_graph(half, 4096, 8192)[4].tolist()
            tables = rects.runs_tables(mask)
            report.update(
                components=int(valid.sum()),
                dropped_components=int(table_cpu["dropped"]),
                half_res_runs=runs,
                half_res_edges=edges,
                run_table_orig_runs=int((tables[0] >= 0).sum()),
                run_table_conn_runs=int((tables[3] >= 0).sum()),
                min_area_rects_max_abs_err_px=geom_err,
            )
            post_report[name] = report
    emit({"phase": "postprocess", "rect_atol_px": RECT_ATOL_PX, "pages": post_report})

    # 5. The default path: shipped ConvCTC, default parameters ------------------------
    conv = load_recognition_model(REPO / "weights" / "text-recognition.npz")
    # Copies for the CPU yardstick, made before the hook so that they carry none.
    det_cpu, conv_cpu = copy.deepcopy(det).cpu(), copy.deepcopy(conv).cpu()
    default_engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=conv), device="cuda")
    conv_hook = conv.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0], out.detach())))
    gru.gru_sequence.launches = gru.bigru_sequence.launches = 0
    d_texts, d_batches = run_pages(engine=default_engine)
    check(gru_launches() == 0, "the default path (ConvCTC) launches no GRU kernel")
    # The same engine on the CPU, asked for explicitly: a yardstick for the text.
    cpu_engine = OcrEngine(OcrEngineParams(detection_model=det_cpu, recognition_model=conv_cpu), device="cpu")
    cpu_inputs = {k: cpu_engine.prepare_input(ImageSource.from_tensor(v, DimOrder.HWC)) for k, v in pages.items()}
    default_report = {}
    for name, inp in inputs.items():
        cc.loop_counts.update(iterations=0, host_syncs=0)
        words = default_engine.detect_words(inp)
        counts = dict(cc.loop_counts)
        lines = default_engine.find_text_lines(inp, words)
        # The CPU engine end to end, and from the card's own lines on: the
        # second leaves out the U-Net, whose bf16 output can differ from the
        # card's by a mask pixel, which moves a rect and with it the crop.
        cpu_text = cpu_engine.get_text(cpu_inputs[name])
        cpu_words = cpu_engine.detect_words(cpu_inputs[name])
        cpu_text_card_lines = "\n".join(
            str(t) for t in cpu_engine.recognize_text(cpu_inputs[name], lines) if t is not None
        )
        shapes, flips, flip_margins = [], 0, []
        for x, lp in d_batches[name]:
            n_pad, _, _, w_eff = x.shape
            shapes.append({"N": n_pad, "w_eff": w_eff, "T": lp.shape[0]})
            check(tuple(lp.shape) == (w_eff // 4, n_pad, 97), f"{name}: ConvCTC log-prob shape")
            check(bool(torch.isfinite(lp).all()), f"{name}: finite ConvCTC log-probs")
            # The CPU network on the card's own crops, frame by frame.
            n_flipped, margins = frame_flips(lp.cpu(), conv_cpu.run(x.cpu()))
            flips += n_flipped
            flip_margins += margins
        check(len(words) > 0 and len(lines) > 0 and d_texts[name].strip() != "", f"{name}: words, lines and text")
        check(max(flip_margins, default=0.0) <= FLIP_MARGIN_MAX, f"{name}: label flips card vs CPU only at near-ties ({flip_margins})")
        if name in small:
            check(
                d_texts[name] == cpu_text_card_lines,
                f"{name}: the card and the CPU decode the same text from the same lines ({d_texts[name]!r} / {cpu_text_card_lines!r})",
            )
        if name == "text":
            check(d_texts[name] == cpu_text, f"text: the card and the CPU engine decode the same text ({d_texts[name]!r} / {cpu_text!r})")
            check(d_texts[name].splitlines() == list(TEXT_LINES), f"text: the page is read as written ({d_texts[name]!r})")
        default_report[name] = {
            "words": len(words),
            "words_cpu": len(cpu_words),
            "lines": len(lines),
            "batches": shapes,
            "detect_words_loop_iterations": counts["iterations"],
            "detect_words_host_syncs": counts["host_syncs"],
            "text": d_texts[name],
            "text_equal_card_vs_cpu": d_texts[name] == cpu_text,
            "text_equal_card_vs_cpu_from_card_lines": d_texts[name] == cpu_text_card_lines,
            "flipped_frames_card_vs_cpu": flips,
            "max_top2_margin_at_flip": max(flip_margins, default=None),
        }
        if d_texts[name] != cpu_text:
            default_report[name]["text_cpu"] = cpu_text
    crops = d_batches["two-lines"][0][0].float()
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        conv_err = float((conv.net(crops, dtype=torch.float32).cpu() - conv_cpu.net(crops.cpu(), dtype=torch.float32)).abs().max())
    torch.backends.cudnn.allow_tf32 = True
    check(conv_err <= CONVCTC_F32_ATOL, f"f32 ConvCTC card vs CPU {conv_err} <= {CONVCTC_F32_ATOL}")
    emit(
        {
            "phase": "engine_default",
            "gru_launches": gru_launches(),
            "pages": default_report,
            "flip_margin_max": FLIP_MARGIN_MAX,
            "f32_convctc_card_vs_cpu": conv_err,
            "f32_atol": CONVCTC_F32_ATOL,
        }
    )

    # 6. Every option once on the card, against the CPU engine -------------------------
    opt_pages = option_pages(pages["text"], pages["wide"])
    options = {
        "beam_search": ("text", {"decode_method": BeamSearch(100)}),
        "deskew": ("rotated", {"deskew": True}),
        "vertical_text": ("vertical", {"vertical_text": True}),
        "min_line_confidence": ("text", {"min_line_confidence": 0.5}),
        "rule_glyph": ("ruled", {"rule_glyph": "["}),
        "detection_word_spaces": ("text", {"detection_word_spaces": True}),
        "detection_tiled": ("wide", {"detection_tiled": True}),
        "detection_postprocess_host": ("text", {"detection_postprocess": "host"}),
        "detection_postprocess_device": ("text", {"detection_postprocess": "device"}),
    }
    options_report = {}
    for opt_name, (page, kwargs) in options.items():
        source = ImageSource.from_tensor(opt_pages[page], DimOrder.HWC)
        card = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=conv, **kwargs), device="cuda")
        on_cpu = OcrEngine(OcrEngineParams(detection_model=det_cpu, recognition_model=conv_cpu, **kwargs), device="cpu")
        captured.clear()
        inp = card.prepare_input(source)
        words = card.detect_words(inp)
        text = card.get_text(inp)
        cpu_text = on_cpu.get_text(on_cpu.prepare_input(source))
        flips, flip_margins = 0, []
        for x, lp in list(captured):
            n_flipped, margins = frame_flips(lp.cpu(), conv_cpu.run(x.cpu()))
            flips += n_flipped
            flip_margins += margins
        check(len(words) > 0, f"option {opt_name}: words found")
        check(max(flip_margins, default=0.0) <= FLIP_MARGIN_MAX, f"option {opt_name}: label flips card vs CPU only at near-ties ({flip_margins})")
        options_report[opt_name] = {
            "page": page,
            "hw": list(opt_pages[page].shape[:2]),
            "words": len(words),
            "rule_rects": sum(isinstance(w, detection.RuleRect) for w in words),
            "text": text,
            "text_equal_card_vs_cpu": text == cpu_text,
            "flipped_frames_card_vs_cpu": flips,
            "max_top2_margin_at_flip": max(flip_margins, default=None),
        }
        if text != cpu_text:
            options_report[opt_name]["text_cpu"] = cpu_text
    check(options_report["rule_glyph"]["rule_rects"] > 0 and "[" in options_report["rule_glyph"]["text"], "option rule_glyph: a rule was found and its glyph emitted")
    emit({"phase": "options", "options": options_report})
    conv_hook.remove()

    # 7. Times ------------------------------------------------------------------
    one_dir_ms = cuda_ms(lambda: gru.gru_sequence(*args), reps=20)
    kernel_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, out=bi_out.transpose(0, 1)), reps=20)
    # The dependent chain without arithmetic: the same launch without the
    # recurrent product, and with nothing but the exchange of h between the
    # blocks of a cluster and the wait for it.
    no_product_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, timing_mode=1), reps=20)
    sync_floor_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, timing_mode=2), reps=20)
    plain_ms = cuda_ms(lambda: gru.bigru_sequence_reference(*bi_args), reps=10)
    # Both directions: f32 operations of the recurrent products; each input
    # read once and the output written once.
    flops = 2 * 2.0 * GRU_N * GRU_H * 3 * GRU_H * GRU_T
    nbytes = 2 * 4.0 * (4 * GRU_T * GRU_N * GRU_H + 3 * GRU_H * GRU_H + 3 * GRU_H)
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"

    # Yardstick, like for like: cuDNN's bidirectional GRU on the same weights,
    # input projection included, beside the port's bigru_apply (two
    # projections + one launch) on the same float32 input.
    layer = rec.net.gru1
    x = torch.randn(GRU_N, GRU_T, GRU_H, device=dev, generator=g)
    cudnn_gru = torch.nn.GRU(GRU_H, GRU_H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for suffix, direction in (("", layer.fwd), ("_reverse", layer.bwd)):
            getattr(cudnn_gru, "weight_ih_l0" + suffix).copy_(direction.wx.T)
            getattr(cudnn_gru, "weight_hh_l0" + suffix).copy_(direction.wh.T)
            getattr(cudnn_gru, "bias_ih_l0" + suffix).copy_(direction.bx)
            getattr(cudnn_gru, "bias_hh_l0" + suffix).copy_(direction.bh)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        library_ms = cuda_ms(lambda: cudnn_gru(x), reps=20)
        apply_ms = cuda_ms(lambda: layer(x), reps=20)
        apply_bf16_ms = cuda_ms(lambda: layer(x.to(torch.bfloat16)), reps=20)
        library_diff = float((cudnn_gru(x)[0] - layer(x)).abs().max())
    torch.backends.cudnn.allow_tf32 = True
    check(library_diff <= 1e-3, f"bigru_apply vs torch.nn.GRU(bidirectional=True) {library_diff} <= 1e-3")

    def stage_ms(eng, inp):
        stages = {
            "get_text": wall_ms(lambda: eng.get_text(inp), reps=5),
            "detect_words": wall_ms(lambda: eng.detect_words(inp), reps=5),
        }
        words = eng.detect_words(inp)
        stages["find_text_lines"] = wall_ms(lambda: eng.find_text_lines(inp, words), reps=5)
        lines = eng.find_text_lines(inp, words)
        stages["recognize_text"] = wall_ms(lambda: eng.recognize_text(inp, lines), reps=5)
        return stages

    # Per page: the default path (ConvCTC), detect_words under each
    # post-processing mode side by side, and the CRNN path as before.
    mode_engines = {
        mode: OcrEngine(OcrEngineParams(detection_model=det, detection_postprocess=mode), device="cuda")
        for mode in ("host", "device", "multigrid")
    }
    default_ms, page_ms, detect_ms = {}, {}, {}
    with torch.inference_mode():
        for name, inp in inputs.items():
            default_ms[name] = stage_ms(default_engine, inp)
            detect_ms[name] = {}
            for mode, eng in mode_engines.items():
                cc.loop_counts.update(iterations=0, host_syncs=0)
                words = eng.detect_words(inp)
                detect_ms[name][mode] = {
                    "words": len(words),
                    "loop_iterations": cc.loop_counts["iterations"],
                    "host_syncs": cc.loop_counts["host_syncs"],
                    "ms": wall_ms(lambda: eng.detect_words(inp), reps=5),
                }
            # Inside detect_words under multigrid: the U-Net with its pre-pass,
            # labelling, rect fitting; the rest (table read-back, scaling the
            # rects to the page in Python) is what is left of its time.
            mask = page_mask(inp)
            labels = cc.label_components_multigrid(mask)
            parts = {
                "unet": wall_ms(lambda: unet_probs(inp), reps=5),
                "label_components_multigrid": wall_ms(lambda: cc.label_components_multigrid(mask), reps=5),
                "min_area_rects_device": wall_ms(lambda: rects.min_area_rects_device(labels), reps=5),
            }
            parts["rest"] = detect_ms[name]["multigrid"]["ms"] - sum(parts.values())
            detect_ms[name]["multigrid"]["parts_ms"] = parts
            page_ms[name] = stage_ms(engine, inp)
            rec.net.plain_gru = True
            page_ms[name]["get_text_plain_gru"] = wall_ms(lambda: engine.get_text(inp), reps=3)
            rec.net.plain_gru = False
        # Both recognizers' forward at the main path's largest batch.
        crops = torch.rand(20, 1, 64, 2432, device=dev, generator=g).to(torch.bfloat16) - 0.5
        convctc_forward_ms = cuda_ms(lambda: conv.run(crops), reps=10)
        crnn_forward_ms = cuda_ms(lambda: rec.run(crops), reps=10)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(
        {
            "phase": "times",
            "card": smi,
            "gru_shape": {"T": GRU_T, "N": GRU_N, "H": GRU_H},
            "bigru_sequence_ms": kernel_ms,
            "gru_sequence_ms": one_dir_ms,
            "bigru_sequence_reference_ms": plain_ms,
            "no_product_ms": no_product_ms,
            "sync_floor_ms": sync_floor_ms,
            "bigru_apply_ms": apply_ms,
            "bigru_apply_bf16_ms": apply_bf16_ms,
            "cudnn_bigru_ms": library_ms,
            "cudnn_bigru_vs_bigru_apply_max_abs_diff": library_diff,
            "bound_ms": bound_ms,
            "bound_flops": flops,
            "bound_bytes": nbytes,
            "bound_note": "both directions; f32 operations over 67 TFLOP/s (the kernel does them as "
            "3 TF32 tensor-core products); the 608 dependent steps are the real limit, see sync_floor_ms",
            "forward_shape": {"N": 20, "W": 2432, "dtype": "bfloat16"},
            "convctc_forward_ms": convctc_forward_ms,
            "crnn_forward_ms": crnn_forward_ms,
            "default_path_ms": default_ms,
            "detect_words_ms": detect_ms,
            "get_text_ms": page_ms,
        }
    )

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    emit(
        {
            "kernels": [
                {
                    "name": "bigru_sequence",
                    "route": "cuda",
                    "source": "ocrs_tpu_torch/csrc/gru_seq.cu",
                    "replaces": "ocrs_tpu/ops/gru_pallas.py:41",
                    "launches": launches,
                    "max_abs_err": max_err,
                    "ms": kernel_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                    "library_call": "torch.nn.GRU(192, 192, bidirectional=True), input projections "
                    "included; compare with layer_ms (bigru_apply: two projections + one launch)",
                    "layer_ms": apply_ms,
                    "one_direction_ms": one_dir_ms,
                    "sync_floor_ms": sync_floor_ms,
                }
            ]
        }
    )
    print(smi, flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
