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
  7. native: the host library (``native/ocrs_native.cpp``) is built with the
     C++ compiler and each of its entry points that the pipeline calls is
     held against the port's numpy or tensor route on seeded inputs.
  8. pipeline: the throughput path. ``PagePipeline`` with the shipped
     detector and ConvCTC and its defaults on a group of text pages: per page
     the text ``OcrEngine.get_text`` reads on the card; the low-bandwidth
     transport with and without 4-bit packing against the full-page one;
     ``process_stream`` over three groups against three ``process`` calls;
     every option once against the engine under the same option; the same
     pipeline on the CPU.
  9. pipeline_crnn: the CRNN at full width through ``PagePipeline.process``
     on pages dense enough to fill a batch of 128 lines: GRU launches counted
     (zeroed just before, read just after), log-probs against the run with
     the plain GRU, float32 texts equal.
  10. serve: ``serve(engine, port=0)`` over the shipped weights and default
     parameters: /healthz names the card; POST /ocr and /ocr/text of the text
     page (PNG from ``encode_png``) read what ``get_text`` reads on the same
     pixels; /ocr/detect has ``detect_words``'s words; the session lifecycle
     (create, detect, recognize line 0, text, delete, then 404). A
     ``BatchingOcrService(max_batch=8)`` given eight variants of the text
     page with its gate closed: one batch, one detection dispatch, each text
     the engine's. Then the CRNN behind a server with the service: eight
     concurrent POSTs made one batch; the GRU launches are counted by thread
     (zeroed just before, read just after) and must be the worker's; the
     recurrent layer's input captured on the worker holds the kernel against
     its plain version; line counts equal the engine's, and texts are close
     to the same batch's with the plain GRU (a random CRNN's text depends on
     the batch's padded width, so not the engine's). Last, the CRNN
     engine run by the server's handler threads (four concurrent requests):
     the kernel launched there. Any unexpected HTTP status fails the phase.
  11. cli: ``python -m ocrs_tpu_torch.cli`` in four subprocesses started
     together, on the text page: ``--json`` (on the card by default) reads
     the engine's text, ``--beam`` a beam engine's, ``--png -o out.png
     --text-map --text-mask --text-line-images`` (in a temporary directory
     under ``build/``) writes files that decode with the page's size, and
     ``--device cpu`` reads the card's text.
  12. times: CUDA-event medians of the kernel (one and both directions) at
     the engine's batch of 20 lines and the pipeline's of 128, its plain
     version, its two timing-only variants (the step-latency floor), the
     bidirectional layer ``bigru_apply`` beside cuDNN's
     ``torch.nn.GRU(bidirectional=True)`` on the same weights (a yardstick
     only: the port never calls it), the kernel's bound, the ConvCTC and CRNN
     forward at the largest batch, ``get_text`` and its stages per page on
     both paths, ``detect_words`` under the three post-processing modes, and
     the pipeline at full size: groups of 16 pages of 3508 x 2480 ``uint8``
     drawn by this script, pages per second of ``process_stream`` from host
     pages and from pages on the card, under both transports and with both
     recognizers, and the fenced stages of one ``process``. Serving:
     sequential POST /ocr of the text page beside ``get_text`` on it (the
     difference is the HTTP, PNG and JSON cost); the batching service
     (``max_batch=8``, ``max_wait_ms=15``) under SERVE_CLIENTS client
     threads (in a client process of their own) sending SERVE_REQUESTS_EACH
     requests each of A4 pages at 150 dpi
     (requests per second, p50 and p99 latency, the batch sizes), against
     the same requests one after the other to a server without the service;
     ``decode_png`` per row filter and ``encode_png`` on one such page.
  13. train: training on the card (``ocrs_tpu_torch.train``). The GRU kernel
     at hidden 384 and 512 (clusters of 16 blocks) against its plain
     version, timed beside cuDNN's layer; the gradients of one CRNN loss
     (hidden 192, batch 64 of pixel-face lines of width 768) through the
     kernel route against the plain route, in float32 and bf16; then, each
     on one fixed batch, the CRNN (``tools/train_models.py``'s chain at lr
     1e-3), ConvCTC warm-started from the shipped weights at the same batch
     and the U-Net warm-started from the shipped weights on 16 pixel-face
     pages of 800 x 608 with their word boxes as the target: the loss is
     finite and falls over 20 steps; ms a step (median of 10 after 3
     warm-ups, fenced) and peak memory; two GRU launches a CRNN step
     (counted from zero over the 20 steps). One BiGRU layer's forward and
     backward at the training shape, kernel route (backward recomputed
     through the plain loop) against the plain route and cuDNN's layer. A
     checkpoint saved and restored into a fresh state steps as the state it
     came from. Last, ``python -m ocrs_tpu_torch.train.demo`` (150 steps,
     hidden 192) in-process: its loss curve and held-out decodes.
  14. train_driver: the trainer (``ocrs_tpu_torch.train.train_models``) on
     the card. First a line of what this machine offers the renderer
     (Pillow, fontTools, matplotlib, pygame, each entry of the font bank);
     where it can draw, the first lines of the committed recognition cache
     are drawn again and must equal it. Then ``train_recognition`` and
     ``train_detection``, their arguments made by the trainer's own parser,
     from the committed caches of ``test-data/train``: ConvCTC warm-started
     from the shipped weights (batch 64, width 768, 40 steps), the CRNN at
     hidden 192 from random weights (10 steps) and the U-Net warm-started
     (batch 16, 30 steps); the recognizers validate on the held-out cache
     through ``val_batch``. Per run: the loss falls from step 1 to the last,
     ms a step (fenced, median after the first 3) and the host's share,
     peak memory, validation CER, GRU launches (zeroed just before, read
     just after: 2 a CRNN step and validation, none for ConvCTC). Each
     exported file has the keys, shapes and dtype of its kind (the shipped
     file's; the CRNN's are the port's CRNN at hidden 192), loads, and an
     engine on the card runs it over the text page; the warm-started ConvCTC
     reads that page as the shipped weights read it, and the fine-tuned
     U-Net still finds its lines.
  15. convert: the PyTorch twin of the CRNN (``ocrs_tpu_torch.testing``,
     hidden 192, 97 classes, seed 0) converted by
     ``convert_torch_state_dict`` into the port's CRNN; in float32 on the
     card the engine runs it over the text page (two GRU launches, counted)
     and its log-probs on that line batch are held against the twin's own
     forward (cuDNN's GRU, a yardstick only) within a stated bound, with
     the same greedy text.
  16. parallel: more than one device, on the one card. ``PagePipeline``
     with the shipped detector and ConvCTC on the 16 full-size pages under
     ``make_data_mesh()`` (one entry) and ``make_data_mesh(devices=["cuda:0",
     "cuda:0"])`` (two shards, each on its long-lived worker thread and its
     own CUDA stream): under one entry each page reads as the unsharded
     ``process`` reads it; under two, each shard's pages read exactly as the
     unsharded ``process`` reads that half of the group (the whole group in
     one call batches otherwise: its differences, crops moved and frames
     flipped are reported, not checked); ``process_stream`` over three
     groups under two shards equals three ``process`` calls; the CRNN at
     hidden 192 through two shards launches the GRU kernel on both shard
     threads (counted by thread, zeroed just before, read just after), each
     shard's own bf16 output of ``gru1`` is the plain version's on the
     operands it made (within ``GRU_ATOL`` and a bf16 spacing) and the
     kernel on those operands the plain version's within ``GRU_ATOL``, and
     the plain GRU reads close texts; pages per second of
     ``process_stream`` under one shard and two, and fenced ms of the group
     whole, in halves one after the other, and on two shards. Then
     ``dryrun_multichip(1)``; the CRNN (hidden 192, 97 classes) at the
     train phase's batch, two AdamW steps in bf16 and one in float32 (TF32
     off), over a one-rank NCCL group in this process (DDP) and over two
     spawned gloo ranks sharing the card (data 2 x model 1; NCCL refuses
     two ranks on one device), and the model split (data 1 x model 2 at
     n_classes 24, hidden 64; gloo gathers CUDA tensors), each against the
     one-process steps: bf16 by the bounds of
     tests/test_torch_parallel_train.py, half of each leaf's entries clear
     of noise held at least; float32 by the loss and every leaf's gradient
     within ``PARALLEL_F32_RTOL`` by relative norm (the half batch's
     gradients, measured, lie more than ten times outside); with ms a step,
     2 GRU launches a step on every rank, the kernel against the plain
     version on rank 0's own input to ``gru1``, and the spawned ranks
     loading the kernel the parent built (no ``nvcc``). Last, ``torchrun
     --nproc-per-node=1 -m ocrs_tpu_torch.train.train_models`` in a
     subprocess: ConvCTC warm-started from the shipped weights, 10 steps on
     the committed cache; the export has the shipped file's keys, shapes and
     dtype, its mean CTC loss over that cache is below the shipped
     weights', and an engine on the card reads the text page with it as the
     shipped weights read it.
  17. tools: the repository's tools, ported (``ocrs_tpu_torch/tools``), on
     the committed page sets of ``test-data/eval`` (this machine need not
     draw) with the shipped weights: ``eval_accuracy`` on the 8 styled
     pages of seed 1234 (its command, then each page alone) and
     ``eval_independent`` on its 9 pages, each F1 of the tool's result
     within ``TOOLS_F1_TOL`` of the JAX tools' on the CPU
     (``reference.json``; per-page differences are reported);
     ``eval_accuracy`` with a CRNN at hidden 192 (random, seed 0) on one
     page: GRU launches counted (zeroed just before, read just after) and
     the kernel on the recurrent layer's own input against the plain
     version; ``test_e2e``'s golden tier through the CLI on the card in a
     process of its own; ``imgrep`` over a directory holding the text page
     (a match exits 0 with its line, a word that is not there exits 1);
     ``soup`` of the shipped recognizer and ``weights/cand_r5.npz``, every
     leaf the float64 average made here, its engine reading the text page;
     ``profile_stages`` over the 16 committed pages of 3508 x 2480.
  18. bench: the port's benchmark (``bench_torch/bench.py``) on its
     committed inputs, each config once in short form: config 5 (one pass
     of three groups of the 16 pages of 3508 x 2480, the pages from the card,
     the fenced stages, a profiled group, and the same three groups with a
     ``TimelineRecorder``: every group has its ``card.stage``,
     ``card.detect`` and ``card.recognize`` intervals, the main thread's
     spans cover at least 95% of the window, and the texts are the timed
     pass's; its figures print on a line of their own, phase
     ``bench_timeline``), config 1 (20 timed calls on the
     1280 x 720 page), config 4 (greedy and beam over the 64 lines), config
     6 (the models' roofline; the CRNN row's GRU launches counted, zeroed
     just before it and read just after, and the kernel held against its
     plain version on the CRNN's own input at N=64, T=608) and config 7;
     each config's word-F1 gate must pass. Then config 5's pipeline, warm,
     takes one more group through the steps of ``process_stream`` between
     its explicit waits (``_stage_pages``, ``_detect_tables`` with the
     tables' copy started, ``_dispatch_recognition``) under
     ``torch.cuda.set_sync_debug_mode("error")``: none may make the host
     wait for the card (an error stops the run; ``launch_path_syncs: 0``
     when none did), and the group's texts must be those of ``process``.
     A traced pass of six groups on the same pipeline then prints
     ``detect_net``'s self ms a group (windows 1-3).

Then it prints the kernels line, the card's name and power limit, and, as
the last line, ``{"ok": true, "device": {...}}``. A failed check exits with
code 1 before that line; no CUDA device exits with code 2 and prints nothing
on standard output.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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

# The pipeline's largest recognition batch: max_lines_per_batch = 128 lines.
PIPE_N = 128
# u8 crops and detector inputs made on the host against the tensor route:
# u8 rounding of the same float sample, in grey levels.
U8_ATOL = 0.75
# Full-size pages for the pipeline's times: A4 at 300 dpi, lines of 5 to 9
# words of the text page's vocabulary, four pixels to a grid cell.
PAGE_HW = (3508, 2480)
PAGE_LINES, PAGE_PITCH, PAGE_SCALE, PAGE_LEFT, PAGE_SPACE_COLS = 56, 60, 4, 200, 6
GROUP_PAGES = 16
BENCH_WORDS = ("Section", "12", "notes", "This", "line", "is", "longer")
# Pages a server is sent: A4 at 150 dpi, drawn as the full-size pages are at
# half their scale, pitch and margin.
A4_150_HW, A4_150_SCALE, A4_150_PITCH, A4_150_LEFT = (1754, 1240), 2, 30, 100
# The service's load: client threads, each sending its requests one after
# the other.
SERVE_CLIENTS, SERVE_REQUESTS_EACH = 8, 8

# The load generator of the serving times: a client process of its own, so
# that its threads do not share the server's interpreter lock. Arguments: the
# server's URL, the number of client threads, the requests each sends one
# after the other, and the PNG files they cycle through (thread c starts at
# file c). Prints {"seconds", "latencies_ms", "texts" by file, "errors"}.
LOAD_CLIENT = r"""
import json, sys, threading, time, urllib.request
base, clients, each = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
bodies = [open(p, "rb").read() for p in sys.argv[4:]]
latencies, texts, errors = [], {}, []
lock = threading.Lock()

def client(c):
    for k in range(each):
        i = (c + k) % len(bodies)
        t0 = time.perf_counter()
        try:
            req = urllib.request.Request(base + "/ocr/text", data=bodies[i], method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                status, text = r.status, r.read().decode()
        except Exception as e:
            status, text = repr(e), ""
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            latencies.append(ms)
            texts[i] = text
            if status != 200:
                errors.append(status)

threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"seconds": time.perf_counter() - t0, "latencies_ms": latencies, "texts": texts, "errors": errors}))
"""

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


def bigru_inputs(generator, device="cuda", n=GRU_N):
    """Operands of bigru_sequence as the layer passes them: the transposed
    views of two [N, T, 3H] projections, then wh, bh of each direction."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=generator)

    xps = [randn(n, GRU_T, 3 * GRU_H).transpose(0, 1) for _ in range(2)]
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


def render_line(text, scale, space_cols=3):
    """One line of bold text as a bool ink mask, ten grid rows high. One grid
    cell is `scale` pixels; letters are a column apart, words `space_cols`."""
    import numpy as np

    cols = []
    for ch in text:
        if ch == " ":
            cols.append(np.zeros((10, space_cols), bool))
            continue
        rows = GLYPHS[ch]
        glyph = np.zeros((10, max(len(r) for r in rows)), bool)
        for i, r in enumerate(rows):
            glyph[i, : len(r)] = [c == "#" for c in r]
        glyph[:, 1:] |= glyph[:, :-1].copy()  # bold: every stroke a column wider
        cols += [glyph, np.zeros((10, 1), bool)]
    return np.concatenate(cols, axis=1).repeat(scale, axis=0).repeat(scale, axis=1)


def text_page(lines=TEXT_LINES, hw=(160, 420), scale=3, left=30, top=24, gap=22):
    """Dark bold text on a light page -> (H, W, 1) uint8."""
    import numpy as np

    ink = np.zeros(hw, bool)
    y = top
    for text in lines:
        line = render_line(text, scale)
        ink[y : y + line.shape[0], left : left + line.shape[1]] = line
        y += line.shape[0] + gap
    return np.where(ink, 0, 255).astype(np.uint8)[..., None]


def full_page(seed, hw=PAGE_HW, scale=PAGE_SCALE, pitch=PAGE_PITCH, left=PAGE_LEFT):
    """A page of PAGE_LINES lines of 5 to 9 random words at a pitch of
    `pitch` pixels, `scale` pixels to a grid cell -> ((H, W) uint8, the
    lines as drawn)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ink = np.zeros(hw, bool)
    top = (hw[0] - PAGE_LINES * pitch) // 2
    texts = []
    for li in range(PAGE_LINES):
        words = [BENCH_WORDS[i] for i in rng.integers(0, len(BENCH_WORDS), rng.integers(5, 10))]
        text = " ".join(words)
        line = render_line(text, scale, PAGE_SPACE_COLS)
        y = top + li * pitch
        ink[y : y + line.shape[0], left : left + line.shape[1]] = line
        texts.append(text)
    return np.where(ink, 0, 255).astype(np.uint8), texts


def native_checks(dev):
    """Each entry point of the native library that the pipeline calls, against
    the port's numpy or tensor route on seeded inputs. Returns the report."""
    import numpy as np
    import torch

    from ocrs_tpu_torch import layout, native
    from ocrs_tpu_torch.geometry import Rect, RotatedRect
    from ocrs_tpu_torch.ops import ctc, rects, resize, warp
    from ocrs_tpu_torch.preprocess import BLACK_VALUE

    rng = np.random.default_rng(0)
    report = {}

    # find_text_lines: the whole layout in one call, from rect arrays.
    words = []
    for col_x in (20, 620):
        for r in range(12):
            x = col_x + int(rng.integers(0, 8))
            for _ in range(int(rng.integers(2, 6))):
                w = int(rng.integers(20, 90))
                y = 40 * r + int(rng.integers(0, 4))
                words.append(RotatedRect.from_rect(Rect.from_tlbr(y, x, y + 20, x + w)))
                x += w + int(rng.integers(6, 24))
    words = [words[i] for i in rng.permutation(len(words))]
    cols = [np.array(c) for c in zip(*[(w.center[0], w.center[1], w.up[0], w.up[1], w.width, w.height) for w in words])]
    got = layout.find_text_lines_idx_arrays(*cols)
    with native.disabled():
        want = layout.find_text_lines(words)
    same = got is not None and [[tuple(words[i].center) for i in li] for li in got] == [[tuple(w.center) for w in l] for l in want]
    check(same, "native find_text_lines equals the numpy layout")
    report["find_text_lines"] = {"words": len(words), "lines": len(want), "equal": same}

    # runs_to_rects on run tables the card made of seeded masks.
    masks = np.zeros((2, 120, 160), bool)
    for m in masks:
        for _ in range(14):
            y, x = rng.integers(0, 110), rng.integers(0, 130)
            m[y : y + rng.integers(3, 8), x : x + rng.integers(6, 30)] = True
    runs = rects.runs_tables(torch.from_numpy(masks).to(dev)).cpu().numpy()
    got = native.runs_to_rects(np.ascontiguousarray(runs[:, :6]), 2, 64)
    want = rects._runs_to_rects_numpy(runs[:, :6], 2, 64)
    err = float(np.abs(got - want).max())
    check(err <= 1e-9, f"native runs_to_rects equals the numpy route ({err})")
    report["runs_to_rects"] = {"components": int((want[:, 0] > 0.5).sum()), "max_abs_err": err}

    # ctc_collapse_batch and ctc_beam_topk.
    labels = rng.integers(0, 4, (16, 200)).astype(np.uint8)
    got = ctc.collapse_greedy_batch_arrays(labels)
    logits = rng.standard_normal((4, 30, 12)) * 4.0
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    vals, idx = ctc.unpack_topk(ctc.beam_topk_packed(torch.from_numpy(lp).to(dev), k=8).cpu().numpy(), 8)
    got_beam = ctc.beam_decode_topk(vals, idx, 10, 12)
    with native.disabled():
        want = ctc.collapse_greedy_batch_arrays(labels)
        want_beam = ctc.beam_decode_topk(vals, idx, 10, 12)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, want))
    check(same, "native ctc_collapse_batch equals the numpy collapse")
    check(got_beam == want_beam, "native ctc_beam_topk equals the Python beam")
    report["ctc_collapse_batch"] = {"steps": int(sum(len(p) for p, _ in want)), "equal": same}
    report["ctc_beam_topk"] = {"steps": sum(len(x) for x in want_beam), "equal": got_beam == want_beam}

    # resize_pages against the float32 resize on the card.
    pages = rng.integers(0, 256, (2, 351, 248), np.uint8)
    got = native.resize_pages(pages, (80, 61)).astype(np.float32)
    want = resize.resize_bilinear(torch.from_numpy(pages).to(dev).to(torch.float32), (80, 61)).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(err <= U8_ATOL, f"native resize_pages against resize_bilinear: {err} <= {U8_ATOL} grey levels")
    report["resize_pages"] = {"max_abs_err_grey_levels": err}

    # extract_lines_strip against the page-stack extraction on the card (the
    # chains mask nothing: a band far above and below every line).
    n = 6
    geom = np.zeros((6, n), np.float32)
    geom[0], geom[1] = rng.integers(0, 300, n), rng.integers(0, 60, n)
    geom[2], geom[3] = rng.integers(12, 30, n), rng.integers(80, 180, n)
    geom[4], geom[5] = rng.integers(60, 129, n), rng.integers(0, 2, n)
    chains = np.zeros((n, 2, 4, 2), np.float32)
    chains[:, :, :, 0] = np.linspace(-10, 400, 4)
    chains[:, 0, :, 1], chains[:, 1, :, 1] = -100.0, 900.0
    segs = ((geom[4].astype(np.int64) + 1) // 2) * 2
    offs = np.concatenate([[0], np.cumsum(segs[:-1])]).astype(np.int32)
    strip = native.extract_lines_strip(pages, geom, offs, out_h=64, total_w=1024)
    norm = torch.from_numpy(pages).to(dev).to(torch.float32) / 255.0 + BLACK_VALUE
    want = warp.extract_line_batch_packed(
        norm, torch.from_numpy(geom).to(dev), torch.from_numpy(chains).to(dev), out_h=64, out_w=128
    )
    want = ((want[:, 0] - BLACK_VALUE) * 255.0).cpu().numpy()
    err = max(
        float(np.abs(strip[:, o : o + int(w)].astype(np.float32) - want[i, :, : int(w)]).max())
        for i, (o, w) in enumerate(zip(offs, geom[4]))
    )
    check(err <= U8_ATOL, f"native extract_lines_strip against extract_line_batch_packed: {err} <= {U8_ATOL}")
    report["extract_lines_strip"] = {"lines": n, "max_abs_err_grey_levels": err}

    # extract_lines_rotated against the rotated extraction on the card.
    rgeom = np.zeros((10, 2), np.float32)
    for col, (deg, origin, page) in enumerate(((12.0, (18.0, 40.0), 1.0), (-20.0, (15.0, 240.0), 0.0))):
        theta = np.radians(deg)
        rgeom[0:2, col] = origin
        rgeom[2:4, col] = (np.cos(theta), np.sin(theta))
        rgeom[4:6, col] = (-np.sin(theta), np.cos(theta))
        rgeom[6:10, col] = (160.0, 30.0, 100.0, page)
    got = native.extract_lines_rotated(pages, rgeom, out_h=64, out_w=128).astype(np.float32)
    want = warp.extract_line_batch_rotated(norm, torch.from_numpy(rgeom).to(dev), out_h=64, out_w=128)
    want = ((want[:, 0] - BLACK_VALUE) * 255.0).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(err <= U8_ATOL, f"native extract_lines_rotated against extract_line_batch_rotated: {err} <= {U8_ATOL}")
    report["extract_lines_rotated"] = {"lines": 2, "max_abs_err_grey_levels": err}
    return report


def close_texts(got, want, ratio=0.9):
    """Page by page the same number of lines, and texts that differ in at
    most a tenth of their characters."""
    import difflib

    return len(got) == len(want) and all(
        len(a.splitlines()) == len(b.splitlines()) and difflib.SequenceMatcher(None, a, b).ratio() >= ratio
        for a, b in zip(got, want)
    )


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


def http(base, path, data=None, method=None, expect=200):
    """One request to the server at `base`; an answer other than `expect`
    fails the phase. Returns the body."""
    import urllib.error
    import urllib.request

    method = method or ("POST" if data is not None else "GET")
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    check(status == expect, f"serve: {method} {path} answered {status}, not {expect} ({body[:200]!r})")
    return body


def ocr_text(doc):
    """The text of a /ocr JSON document, lines joined as get_text joins them."""
    return "\n".join(line["text"] for line in doc["paragraphs"][0]["lines"])


def text_variants():
    """Eight variants of the text page, all (160, 420, 1): the lines in both
    orders, each at four offsets."""
    return [
        text_page(lines, left=left, top=top)
        for lines in (TEXT_LINES, TEXT_LINES[::-1])
        for left, top in ((30, 24), (44, 30), (60, 20), (36, 28))
    ]


def bigru_operands(layer, x):
    """The operands bigru_apply passes bigru_sequence for the BiGRU `layer`
    on its input `x` [N, T, C]."""
    import torch

    f32 = torch.float32
    dirs = (layer.fwd, layer.bwd)
    xps = [((x @ d.wx.to(x.dtype)).to(f32) + d.bx.to(f32)).transpose(0, 1) for d in dirs]
    return (*xps, *(t for d in dirs for t in (d.wh.to(f32).contiguous(), d.bh.to(f32).contiguous())))


def reset_gru_counts():
    from ocrs_tpu_torch.ops import gru

    for wrapper in (gru.gru_sequence, gru.bigru_sequence):
        wrapper.launches = 0
        wrapper.launches_by_thread.clear()


def serve_phase(det, conv, rec, default_engine, crnn_engine):
    """The serving path on the card: the HTTP server over the default engine,
    the batching service with ConvCTC and with the CRNN (whose GRU kernel is
    then launched on the service's worker thread), and the server's handler
    threads running the CRNN engine themselves. Returns (report, launches by
    site, the kernel's max |err| on the worker's own GRU input)."""
    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.png import decode_image, encode_png
    from ocrs_tpu_torch.preprocess import DimOrder, ImageSource
    from ocrs_tpu_torch.serve import BatchingOcrService, serve

    def engine_text(eng, img):
        return eng.get_text(eng.prepare_input(ImageSource.from_tensor(img, DimOrder.HWC)))

    report = {}
    body = encode_png(text_page())
    rgb = decode_image(body)
    want = engine_text(default_engine, rgb)
    server = serve(default_engine, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(http(base, "/healthz"))
        card = torch.cuda.get_device_name(0)
        check(health.get("status") == "ok" and any(card in d for d in health.get("devices", [])), f"serve: /healthz names the card ({health})")
        doc = json.loads(http(base, "/ocr", body))
        check(ocr_text(doc) == want, f"serve: POST /ocr reads what get_text reads ({ocr_text(doc)!r} / {want!r})")
        check((doc["image_height"], doc["image_width"]) == rgb.shape[:2], "serve: POST /ocr gives the image's size")
        text = http(base, "/ocr/text", body).decode()
        check(text == want, f"serve: POST /ocr/text reads what get_text reads ({text!r})")
        detected = json.loads(http(base, "/ocr/detect", body))["lines"]
        n_words = sum(len(line["words"]) for line in detected)
        want_words = len(default_engine.detect_words(default_engine.prepare_input(ImageSource.from_tensor(rgb, DimOrder.HWC))))
        check(n_words == want_words, f"serve: /ocr/detect has the words detect_words finds ({n_words} / {want_words})")
        sid = json.loads(http(base, "/session", body))["id"]
        lines = json.loads(http(base, f"/session/{sid}/detect", b""))["lines"]
        first = json.loads(http(base, f"/session/{sid}/recognize", json.dumps({"lines": [0]}).encode()))["lines"]
        check(len(first) == 1 and first[0]["text"] == want.splitlines()[0], f"serve: session recognizes line 0 ({first})")
        session_text = http(base, f"/session/{sid}/text").decode()
        check(session_text == want, f"serve: session text ({session_text!r})")
        deleted = json.loads(http(base, f"/session/{sid}", method="DELETE"))
        check(deleted == {"deleted": True}, f"serve: DELETE /session ({deleted})")
        http(base, f"/session/{sid}/detect", b"", expect=404)
        http(base, "/ocr", b"not an image", expect=400)
        report["http"] = {
            "healthz": health,
            "text": want,
            "ocr_equals_get_text": ocr_text(doc) == want,
            "detect_words": n_words,
            "session_lines": len(lines),
        }
    finally:
        server.shutdown()
        server.server_close()

    # The batching service with ConvCTC: eight gated submissions, one batch,
    # one detection dispatch, each text the engine's.
    variants = text_variants()
    service = BatchingOcrService(default_engine, det, conv, DEFAULT_ALPHABET, max_batch=8)
    detect_calls = []
    inner = service._pipeline._detect_tables
    service._pipeline._detect_tables = lambda pages, *trace: (
        detect_calls.append(int(pages.shape[0])), inner(pages, *trace)
    )[1]
    service._gate.clear()
    futs = [service.submit(v) for v in variants]
    time.sleep(0.2)
    service._gate.set()
    got = ["\n".join(str(l) for l in f.result(timeout=600) if l is not None) for f in futs]
    want_texts = [engine_text(default_engine, v) for v in variants]
    check(service.batch_sizes == [8] and detect_calls == [8], f"serve: one batch of 8, one detection dispatch ({service.batch_sizes}, {detect_calls})")
    check(got == want_texts, f"serve: the service reads what the engine reads ({got} / {want_texts})")
    report["service_convctc"] = {"batch_sizes": service.batch_sizes, "detect_calls": detect_calls, "equals_engine": got == want_texts}

    # The CRNN behind a server with the service: eight concurrent POSTs, held
    # at the gate until all are queued, so that they make one batch. The GRU
    # kernel runs on the service's worker thread; its input there is captured
    # and the kernel held against the plain version on it. A recognizer with
    # random weights decodes padding frames too, and a bidirectional GRU
    # carries them into every frame: its text depends on the batch's padded
    # width, so the engine (one page a batch) is the yardstick for the lines
    # only, and the texts are held against the same batch with the plain GRU.
    crnn_service = BatchingOcrService(crnn_engine, det, rec, DEFAULT_ALPHABET, max_batch=8, max_wait_ms=50.0)
    worker = crnn_service._thread.name
    worker_inputs = []
    hook = rec.net.gru1.register_forward_hook(
        lambda m, inp, out: worker_inputs.append(inp[0].detach()) if threading.current_thread().name == worker else None
    )
    bodies = [encode_png(v) for v in variants]
    server = serve(crnn_engine, port=0, service=crnn_service)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def served_texts():
        docs = [None] * len(bodies)

        def post(i):
            docs[i] = json.loads(http(base, "/ocr", bodies[i]))

        crnn_service._gate.clear()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        time.sleep(0.5)
        crnn_service._gate.set()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "serve: every request was answered")
        return [ocr_text(d) if d else "" for d in docs]

    try:
        reset_gru_counts()
        served = served_texts()
        torch.cuda.synchronize()
        by_thread = dict(gru.bigru_sequence.launches_by_thread)
        worker_launches = by_thread.get(worker, 0) + gru.gru_sequence.launches_by_thread.get(worker, 0)
        rec.net.plain_gru = True
        served_plain = served_texts()
        rec.net.plain_gru = False
    finally:
        server.shutdown()
        server.server_close()
        hook.remove()
    check(worker_launches >= 2, f"serve: the GRU kernel was launched on the service's worker thread ({by_thread})")
    check(set(by_thread) == {worker}, f"serve: with the service every launch is the worker's ({by_thread})")
    check(crnn_service.batch_sizes == [8, 8], f"serve: the eight requests made one batch ({crnn_service.batch_sizes})")
    want_crnn = [engine_text(crnn_engine, decode_image(b)) for b in bodies]
    same_lines = [len(a.splitlines()) for a in served] == [len(b.splitlines()) for b in want_crnn]
    check(same_lines, f"serve: the CRNN service finds the engine's lines ({served} / {want_crnn})")
    check(close_texts(served, served_plain), f"serve: kernel and plain GRU read close texts through the service ({served} / {served_plain})")
    check(bool(worker_inputs), "serve: the worker's GRU input was captured")
    ops = bigru_operands(rec.net.gru1, worker_inputs[0])
    kernel_out = gru.bigru_sequence(*ops)
    worker_err = float((kernel_out - gru.bigru_sequence_reference(*ops)).abs().max())
    check(worker_err <= GRU_ATOL, f"serve: the kernel on the worker's GRU input vs plain {worker_err} <= {GRU_ATOL}")
    report["service_crnn"] = {
        "batch_sizes": crnn_service.batch_sizes,
        "gru_launches_by_thread": by_thread,
        "worker_gru_input_shape": list(worker_inputs[0].shape),
        "kernel_vs_plain_on_worker_input": worker_err,
        "lines_equal_engine": same_lines,
        "texts_equal_engine": sum(a == b for a, b in zip(served, want_crnn)),
        "texts_equal_plain_gru": sum(a == b for a, b in zip(served, served_plain)),
    }

    # The CRNN engine run by the server's handler threads themselves.
    server = serve(crnn_engine, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    handler_texts = [None] * 4

    def post_text(i):
        handler_texts[i] = http(base, "/ocr/text", bodies[i]).decode()

    try:
        threads = [threading.Thread(target=post_text, args=(i,)) for i in range(4)]
        reset_gru_counts()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        by_thread = dict(gru.bigru_sequence.launches_by_thread)
    finally:
        server.shutdown()
        server.server_close()
    handler_launches = sum(by_thread.values())
    check(handler_launches >= 8 and "MainThread" not in by_thread, f"serve: handler threads launched the GRU kernel ({by_thread})")
    check(close_texts(handler_texts, want_crnn[:4]), f"serve: handler threads read the engine's lines ({handler_texts})")
    report["handlers_crnn"] = {"gru_launches_by_thread": by_thread, "threads": len(by_thread)}
    return report, {"serve_worker": worker_launches, "serve_handlers": handler_launches}, worker_err


def cli_phase(default_engine, det, conv):
    """``python -m ocrs_tpu_torch.cli`` in subprocesses, all started
    together, on the text page written with encode_png: --json on the card
    by default, --beam, --png with the maps and line images, and --device
    cpu. Returns the report."""
    import shutil
    import tempfile

    import numpy as np

    from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.png import decode_image, read_png, write_png
    from ocrs_tpu_torch.preprocess import DimOrder, ImageSource
    from ocrs_tpu_torch.recognition import BeamSearch

    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=REPO / "build"))
    try:
        page = work / "text.png"
        write_png(page, text_page())
        rgb = decode_image(page.read_bytes())

        def engine_text(eng):
            return eng.get_text(eng.prepare_input(ImageSource.from_tensor(rgb, DimOrder.HWC)))

        want = engine_text(default_engine)
        want_beam = engine_text(
            OcrEngine(OcrEngineParams(detection_model=det, recognition_model=conv, decode_method=BeamSearch(100)), device="cuda")
        )
        runs = {
            "json": ["--json"],
            "beam": ["--beam"],
            "png_maps": ["--png", "-o", "out.png", "--text-map", "--text-mask", "--text-line-images"],
            "device_cpu": ["--device", "cpu"],
        }
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        t0 = time.perf_counter()
        procs = {}
        for name, flags in runs.items():
            cwd = work / name
            cwd.mkdir()
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "ocrs_tpu_torch.cli", str(page), *flags],
                cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        out = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"cli {name}: exit code {proc.returncode} ({stderr[-2000:]})")
            out[name] = stdout
        seconds = time.perf_counter() - t0
        try:
            text = ocr_text(json.loads(out["json"]))
        except (ValueError, KeyError, IndexError):
            text = None
        check(text == want, f"cli --json reads what the engine reads on the card ({text!r} / {want!r})")
        check(out["beam"].rstrip("\n") == want_beam, f"cli --beam reads what a beam engine reads ({out['beam']!r} / {want_beam!r})")
        check(out["device_cpu"].rstrip("\n") == want, f"cli --device cpu reads what the card reads ({out['device_cpu']!r})")
        pm = work / "png_maps"
        annotated = read_png(pm / "out.png")
        check(annotated.shape == rgb.shape and bool((annotated != rgb).any()), f"cli --png: an annotated page of the page's shape ({annotated.shape})")
        maps = {name: read_png(pm / name).shape for name in ("text-map.png", "text-mask.png")}
        check(all(sh == (*rgb.shape[:2], 1) for sh in maps.values()), f"cli --text-map/--text-mask: pages of the page's size ({maps})")
        line_images = sorted((pm / "lines").glob("line-*.png"))
        check(len(line_images) == len(want.splitlines()) and all(read_png(p).shape[0] == 64 for p in line_images), f"cli --text-line-images ({line_images})")
        return {
            "runs": {name: " ".join(flags) for name, flags in runs.items()},
            "seconds_all_four_together": seconds,
            "json_text": text,
            "json_equals_engine": text == want,
            "beam_equals_engine": out["beam"].rstrip("\n") == want_beam,
            "cpu_equals_card": out["device_cpu"].rstrip("\n") == want,
            "annotated_shape": list(annotated.shape),
            "maps": {k: list(v) for k, v in maps.items()},
            "line_images": len(line_images),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def png_with_filter(img, ftype):
    """PNG bytes of `img` (H, W, C uint8) with every row's filter type set to
    `ftype` over the raw rows: the decoder's work for that filter (the
    decoded pixels are `img` only for type 0)."""
    import struct
    import zlib

    import numpy as np

    h, w, c = img.shape
    rows = np.concatenate([np.full((h, 1), ftype, np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    colour = {1: 0, 3: 2, 4: 6}[c]
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def png_times(page):
    """Host milliseconds of decode_png per filter type, and of encode_png, on
    one RGB page."""
    import numpy as np

    from ocrs_tpu_torch.png import decode_png, encode_png

    rgb = np.repeat(page[..., None], 3, axis=2)
    report = {"hw": list(rgb.shape)}
    for ftype, name in enumerate(("none", "sub", "up", "average", "paeth")):
        data = png_with_filter(rgb, ftype)
        reps = 3 if ftype < 3 else 1
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = decode_png(data)
            times.append((time.perf_counter() - t0) * 1e3)
        check(out.shape == rgb.shape, f"png: decode_png of the {name}-filtered page has its shape")
        report[f"decode_{name}_ms"] = statistics.median(times)
    t0 = time.perf_counter()
    encoded = encode_png(rgb)
    report["encode_ms"] = (time.perf_counter() - t0) * 1e3
    report["encoded_bytes"] = len(encoded)
    check(np.array_equal(decode_png(encoded), rgb), "png: encode_png round-trips the page")
    return report


def serve_times(det, conv, default_engine):
    """POST /ocr of the text page beside get_text on the same pixels; the
    batching service under SERVE_CLIENTS client threads of A4 pages at 150
    dpi, against the same requests one after the other to a server without
    it; the PNG codec on one such page."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.png import decode_image, encode_png
    from ocrs_tpu_torch.preprocess import DimOrder, ImageSource
    from ocrs_tpu_torch.serve import BatchingOcrService, serve

    report = {}
    body = encode_png(text_page())
    text_input = default_engine.prepare_input(ImageSource.from_tensor(decode_image(body), DimOrder.HWC))
    server = serve(default_engine, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        http(base, "/ocr", body)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            http(base, "/ocr", body)
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
    report["post_ocr_ms"] = statistics.median(times)
    report["get_text_ms"] = wall_ms(lambda: default_engine.get_text(text_input), reps=20)
    report["post_ocr_minus_get_text_ms"] = report["post_ocr_ms"] - report["get_text_ms"]

    pages = [
        full_page(seed, hw=A4_150_HW, scale=A4_150_SCALE, pitch=A4_150_PITCH, left=A4_150_LEFT)
        for seed in range(SERVE_CLIENTS)
    ]
    bodies = [encode_png(p) for p, _ in pages]
    drawn = [texts for _, texts in pages]
    n_requests = SERVE_CLIENTS * SERVE_REQUESTS_EACH

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=REPO / "build"))
    paths = []
    for i, b in enumerate(bodies):
        paths.append(work / f"page-{i}.png")
        paths[-1].write_bytes(b)

    def load(base, clients):
        """`clients` threads of a client process of their own (LOAD_CLIENT),
        each sending its share of the requests one after the other ->
        (seconds, latencies in ms, texts by page)."""
        out = subprocess.run(
            [sys.executable, "-c", LOAD_CLIENT, base, str(clients), str(n_requests // clients), *map(str, paths)],
            capture_output=True, text=True, timeout=900,
        )
        check(out.returncode == 0, f"times: the load client ran ({out.stderr[-2000:]})")
        res = json.loads(out.stdout or '{"seconds": 1, "latencies_ms": [], "texts": {}, "errors": ["no output"]}')
        check(not res["errors"], f"times: every request was answered with 200 ({res['errors'][:5]})")
        return res["seconds"], res["latencies_ms"], {int(k): v for k, v in res["texts"].items()}

    def summary(seconds, latencies):
        q = np.percentile(latencies, [50, 99])
        return {
            "requests": len(latencies),
            "seconds": seconds,
            "requests_per_s": len(latencies) / seconds,
            "p50_ms": float(q[0]),
            "p99_ms": float(q[1]),
        }

    service = BatchingOcrService(default_engine, det, conv, DEFAULT_ALPHABET, max_batch=8, max_wait_ms=15.0)
    server = serve(default_engine, port=0, service=service)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        load(base, SERVE_CLIENTS)  # warm-up: the batch shapes' first runs
        service.batch_sizes.clear()
        service.batch_ms.clear()
        seconds, latencies, texts = load(base, SERVE_CLIENTS)
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.server_close()
    sizes = service.batch_sizes
    report["service"] = {
        "page_hw": list(A4_150_HW),
        "clients": SERVE_CLIENTS,
        "requests_each": SERVE_REQUESTS_EACH,
        "max_batch": 8,
        "max_wait_ms": 15.0,
        **summary(seconds, latencies),
        "batch_size_histogram": {str(b): sizes.count(b) for b in sorted(set(sizes))},
        "batch_ms_median_by_size": {
            str(b): statistics.median(ms for n, ms in zip(sizes, service.batch_ms) if n == b) for b in sorted(set(sizes))
        },
        "lines_read_as_drawn": sum(line in drawn[i] for i, t in texts.items() for line in t.splitlines()),
        "lines_drawn": sum(len(drawn[i]) for i in texts),
    }
    lines_found = sum(len(t.splitlines()) for t in texts.values())
    check(len(latencies) == n_requests, f"times: the service answered every request ({len(latencies)} of {n_requests})")
    check(lines_found >= 0.95 * report["service"]["lines_drawn"], f"times: the service finds the lines drawn ({lines_found})")

    server = serve(default_engine, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        http(base, "/ocr/text", bodies[0])  # warm-up
        seconds, latencies, seq_texts = load(base, 1)
    finally:
        server.shutdown()
        server.server_close()
    report["sequential_without_service"] = {**summary(seconds, latencies)}
    shutil.rmtree(work, ignore_errors=True)
    report["sequential_without_service"]["lines_read_as_drawn"] = sum(
        line in drawn[i] for i, t in seq_texts.items() for line in t.splitlines()
    )
    report["service_texts_equal_sequential"] = sum(texts.get(i) == seq_texts.get(i) for i in range(len(bodies)))
    report["png_a4_150dpi"] = png_times(pages[0][0])
    return report


# The train phase: the recognizers' and the detector's training steps at
# full width. CRNN and ConvCTC: batch 64 of pixel-face lines of width 768
# (192 frames), the CRNN at hidden 192 (tools/train_models.py's defaults);
# the U-Net: 16 pages of 800 x 608.
TRAIN_BATCH, TRAIN_WIDTH, TRAIN_HIDDEN, TRAIN_LR = 64, 768, 192, 1e-3
DET_BATCH = 16
# Steps on one fixed batch over which the loss must fall; then 3 warm-up
# steps and 10 timed ones.
TRAIN_FALL_STEPS, TRAIN_WARMUP, TRAIN_TIMED = 20, 3, 10
# Gradients of one CRNN loss, kernel route against the plain route, by
# relative norm of the difference per parameter. Float32 activations: the
# routes differ only in the recurrence's f32 rounding (~1e-6), carried
# through the backward. bf16 activations (as trained): a GRU output whose
# bf16 rounding flips moves the layers after it by a bf16 ulp (2**-8).
TRAIN_GRAD_RTOL_F32, TRAIN_GRAD_RTOL_BF16 = 1e-3, 5e-2
# Hidden sizes above 256: the kernel's non-portable clusters of 16 blocks.
LARGE_HIDDEN = (384, 512)
# The held-out decodes of a short demo run (python -m ocrs_tpu_torch.train.demo).
DEMO_ARGS = ["--steps", "150", "--hidden", "192"]


def train_pages(rng, n, hw=(800, 608)):
    """`n` pages of pixel-face lines (uint8, dark on light) and their word
    boxes as a {0, 1} target mask, [n, 1, H, W] each."""
    import numpy as np

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
    from ocrs_tpu_torch.train import pixelfont
    from ocrs_tpu_torch.train.data import random_text

    pages = np.full((n, 1, *hw), 255, np.uint8)
    targets = np.zeros((n, 1, *hw), np.uint8)
    for i in range(n):
        y = int(rng.integers(20, 60))
        while True:
            scale = float(rng.uniform(2.0, 4.0))
            mask, boxes = pixelfont.render_pixel_line(random_text(rng, DEFAULT_ALPHABET), scale, rng=rng)
            h, w = mask.shape
            x = int(rng.integers(10, 120))
            if y + h > hw[0] - 20:
                break
            w = min(w, hw[1] - x)
            pages[i, 0, y : y + h, x : x + w] = np.where(mask[:, :w] > 0, 0, 255)
            for _, (t, l, b, r) in boxes:
                t, l, b, r = int(t), int(l), int(np.ceil(b)), int(np.ceil(r))
                targets[i, 0, y + t : y + b, x + l : min(x + r, hw[1])] = 1
            y += h + int(rng.integers(int(0.5 * h), 2 * h))
    return pages, targets


def train_phase(dev):
    """Returns (report, GRU launches of the training run, large-hidden kernel
    numbers)."""
    import numpy as np
    import torch

    from ocrs_tpu_torch.models.nn import BiGRU
    from ocrs_tpu_torch.models.weights import load_params
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.train import checkpoint, demo, optim, train

    t_phase = time.perf_counter()
    report = {}
    g = torch.Generator(device=dev).manual_seed(6)

    # Kernel at hidden 384 and 512 against its plain version, and its times.
    large = {}
    for hidden in LARGE_HIDDEN:
        xps = [torch.randn(GRU_N, GRU_T, 3 * hidden, device=dev, generator=g).transpose(0, 1) for _ in range(2)]
        rec = []
        for _ in range(2):
            rec += [torch.randn(hidden, 3 * hidden, device=dev, generator=g) * (2.0 / hidden) ** 0.5,
                    torch.randn(3 * hidden, device=dev, generator=g) * 0.1]
        out = torch.full((GRU_N, GRU_T, 2 * hidden), float("nan"), device=dev)
        gru.bigru_sequence(*xps, *rec, out=out.transpose(0, 1))
        want = gru.bigru_sequence_reference(*xps, *rec)
        torch.cuda.synchronize()
        err = float((out.transpose(0, 1) - want).abs().max())
        check(bool(torch.isfinite(out).all()) and err <= GRU_ATOL, f"GRU kernel at hidden {hidden}: max |err| {err} <= {GRU_ATOL}")
        flops = 2 * 2.0 * GRU_N * hidden * 3 * hidden * GRU_T
        nbytes = 2 * 4.0 * (4 * GRU_T * GRU_N * hidden + 3 * hidden * hidden + 3 * hidden)
        by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        cudnn_gru = torch.nn.GRU(hidden, hidden, batch_first=True, bidirectional=True).to(dev)
        x = torch.randn(GRU_N, GRU_T, hidden, device=dev, generator=g)
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: cudnn_gru(x), reps=10)
        torch.backends.cudnn.allow_tf32 = True
        large[hidden] = {
            "shape": {"T": GRU_T, "N": GRU_N, "H": hidden},
            "launch_plan": gru.launch_plan(GRU_N, hidden),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gru.bigru_sequence(*xps, *rec, out=out.transpose(0, 1)), reps=10),
            "plain_ms": cuda_ms(lambda: gru.bigru_sequence_reference(*xps, *rec), reps=2, warmup=1),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": library_ms,
            "library_call": f"torch.nn.GRU({hidden}, {hidden}, bidirectional=True), input projections included",
        }
        del xps, rec, out, want
    report["large_hidden"] = {str(h): v for h, v in large.items()}

    rng = np.random.default_rng(6)
    lines = demo.make_batch(rng, TRAIN_BATCH, TRAIN_WIDTH)
    total = TRAIN_FALL_STEPS + TRAIN_WARMUP + TRAIN_TIMED

    def recipe():
        # tools/train_models.py's optimizer, its cosine decaying over twice
        # the steps a model takes here: the checkpoint's extra step (after
        # 36) still moves the weights by about 0.6 * lr.
        schedule = optim.warmup_cosine_decay_schedule(
            0.0, TRAIN_LR, warmup_steps=min(300, total // 2 + 1), decay_steps=2 * total
        )
        return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(schedule, weight_decay=1e-4))

    # Gradients of one CRNN loss through the kernel route and the plain route.
    opt = recipe()
    state = train.init_recognition_state(opt, n_classes=97, hidden=TRAIN_HIDDEN, seed=0, arch="crnn")
    params = dict(state.model.net.named_parameters())
    grad_report = {}
    for name, dtype, bound in (("float32", torch.float32, TRAIN_GRAD_RTOL_F32), ("bfloat16", torch.bfloat16, TRAIN_GRAD_RTOL_BF16)):
        grads = {}
        for plain in (False, True):
            state.model.net.plain_gru = plain
            loss = train.recognition_loss(state.model, *lines, dtype=dtype)
            grads[plain] = torch.autograd.grad(loss, list(params.values()))
        state.model.net.plain_gru = False
        rel = {
            k: float((a - b).norm() / b.norm().clamp_min(1e-30))
            for k, a, b in zip(params, grads[False], grads[True])
        }
        worst = max(rel, key=rel.get)
        check(rel[worst] <= bound, f"train: {name} gradients, kernel vs plain route: {worst} {rel[worst]} <= {bound}")
        grad_report[name] = {"max_rel_norm_diff": rel[worst], "at": worst, "bound": bound,
                             "gru1.fwd.wh": rel["gru1.fwd.wh"], "gru2.bwd.wh": rel["gru2.bwd.wh"]}
    report["crnn_gradients_kernel_vs_plain"] = grad_report

    def run_steps(label, state, step, batch, launches_per_step=0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_gru_counts()
        losses = []
        for _ in range(TRAIN_FALL_STEPS):
            state, loss = step(state, *batch)
            losses.append(float(loss))
        launches = gru.bigru_sequence.launches + gru.gru_sequence.launches
        for _ in range(TRAIN_WARMUP):
            step(state, *batch)
        times = [wall_ms(lambda: step(state, *batch), reps=1) for _ in range(TRAIN_TIMED)]
        check(all(np.isfinite(losses)), f"train {label}: finite losses")
        check(losses[-1] < losses[0], f"train {label}: the loss falls over {TRAIN_FALL_STEPS} steps ({losses[0]} -> {losses[-1]})")
        if launches_per_step:
            check(launches == launches_per_step * TRAIN_FALL_STEPS,
                  f"train {label}: {launches_per_step} GRU launches a step ({launches} in {TRAIN_FALL_STEPS})")
        return state, {
            "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "step_ms": statistics.median(times), "step_ms_all": times,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "gru_launches": launches, "steps": state.step,
        }

    # CRNN at hidden 192, batch 64, width 768, the train_models.py chain.
    crnn_step = train.make_recognition_train_step(opt)
    state, report["crnn"] = run_steps("crnn", state, crnn_step, lines, launches_per_step=2)
    train_launches = report["crnn"]["gru_launches"]

    # The share of a CRNN step spent in its two BiGRU layers' backward (the
    # recompute through the plain loop), timed inside the steps: CUDA events
    # around BiGRUSequence.backward on the stream it runs on, against events
    # around each whole step.
    spans, step_spans = [], []
    backward = vars(gru.BiGRUSequence)["backward"]

    def timed_backward(ctx, grad):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = backward.__func__(ctx, grad)
        end.record()
        spans.append((start, end))
        return out

    gru.BiGRUSequence.backward = staticmethod(timed_backward)
    try:
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            crnn_step(state, *lines)
            end.record()
            step_spans.append((start, end))
        torch.cuda.synchronize()
    finally:
        gru.BiGRUSequence.backward = backward
    check(len(spans) == 2 * len(step_spans), f"train: two BiGRU backwards a CRNN step ({len(spans)} in {len(step_spans)})")
    bwd_ms = [a.elapsed_time(b) for a, b in spans]
    steps_ms = [a.elapsed_time(b) for a, b in step_spans]
    report["crnn"]["bigru_backward_ms_in_step"] = bwd_ms
    report["crnn"]["step_ms_with_backward_timed"] = steps_ms
    report["crnn"]["bigru_backward_share_of_step"] = sum(bwd_ms) / sum(steps_ms)

    # One BiGRU layer at the training shape: forward, forward + backward, on
    # the kernel route (backward recomputed through the plain loop), the
    # plain route and cuDNN's layer (a yardstick the port never calls).
    layer = BiGRU(TRAIN_HIDDEN, TRAIN_HIDDEN, generator=torch.Generator().manual_seed(1)).to(dev).requires_grad_(True)
    xb = torch.randn(TRAIN_BATCH, TRAIN_WIDTH // 4, TRAIN_HIDDEN, device=dev, generator=g).to(torch.bfloat16)

    def fwd_bwd(plain):
        layer(xb, plain=plain).float().sum().backward()

    cudnn_gru = torch.nn.GRU(TRAIN_HIDDEN, TRAIN_HIDDEN, batch_first=True, bidirectional=True).to(dev)
    xf = xb.float().requires_grad_()
    torch.backends.cudnn.allow_tf32 = False
    layer_ms = {
        "shape": {"T": TRAIN_WIDTH // 4, "N": TRAIN_BATCH, "H": TRAIN_HIDDEN},
        "kernel_forward_ms": cuda_ms(lambda: layer(xb), reps=10),
        "kernel_forward_backward_ms": cuda_ms(lambda: fwd_bwd(False), reps=3, warmup=1),
        "plain_forward_ms": cuda_ms(lambda: layer(xb, plain=True), reps=3, warmup=1),
        "plain_forward_backward_ms": cuda_ms(lambda: fwd_bwd(True), reps=3, warmup=1),
        "cudnn_forward_ms": cuda_ms(lambda: cudnn_gru(xf), reps=10),
        "cudnn_forward_backward_ms": cuda_ms(lambda: cudnn_gru(xf)[0].sum().backward(), reps=10),
    }
    torch.backends.cudnn.allow_tf32 = True
    layer_ms["kernel_backward_ms"] = layer_ms["kernel_forward_backward_ms"] - layer_ms["kernel_forward_ms"]
    kernel_args = [t.detach() for t in (layer.fwd.wx, layer.bwd.wx)]
    xps = [((xb @ w.to(xb.dtype)).float()).transpose(0, 1) for w in kernel_args]
    rec = [t.detach().float().contiguous() for d in (layer.fwd, layer.bwd) for t in (d.wh, d.bh)]
    layer_ms["bigru_sequence_ms"] = cuda_ms(lambda: gru.bigru_sequence(*xps, *rec), reps=10)
    t_steps, n_rows = TRAIN_WIDTH // 4, TRAIN_BATCH
    flops = 2 * 2.0 * n_rows * TRAIN_HIDDEN * 3 * TRAIN_HIDDEN * t_steps
    nbytes = 2 * 4.0 * (4 * t_steps * n_rows * TRAIN_HIDDEN + 3 * TRAIN_HIDDEN * TRAIN_HIDDEN + 3 * TRAIN_HIDDEN)
    by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    layer_ms["bigru_sequence_bound_ms"] = max(by_ops, by_bytes) * 1e3
    layer_ms["bigru_sequence_bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    layer_ms["bigru_sequence_plain_ms"] = cuda_ms(lambda: gru.bigru_sequence_reference(*xps, *rec), reps=3, warmup=1)
    report["bigru_layer_training_shape"] = layer_ms
    del layer, xb, xf, xps, rec

    # Checkpoint: save, restore into a fresh state, which must then hold the
    # saved parameters, Adam count and moments exactly; one more step on each.
    # cuDNN's convolution backward and the CTC backward sum in an order of
    # their choosing: a gradient near 0 can change sign between two runs, and
    # Adam then moves that weight by up to 2 * lr the other way (lr the rate
    # of this step; f32 rounding adds 1e-6).
    ckpt_dir = REPO / "build" / "chip_smoke_checkpoints"
    path = checkpoint.save_checkpoint(ckpt_dir, state)
    fresh = train.init_recognition_state(opt, n_classes=97, hidden=TRAIN_HIDDEN, seed=1, arch="crnn")
    fresh = checkpoint.restore_checkpoint(path, fresh)
    with torch.no_grad():
        restored = [bool(torch.equal(a, b)) for a, b in zip(state.model.net.parameters(), fresh.model.net.parameters())]
        for p, q in zip(state.optimizer.named_params.values(), fresh.optimizer.named_params.values()):
            restored += [bool(torch.equal(state.optimizer.torch.state[p][k], fresh.optimizer.torch.state[q][k]))
                         for k in ("exp_avg", "exp_avg_sq")]
    check(fresh.optimizer.count == state.optimizer.count and all(restored),
          f"train: a restored checkpoint holds the saved parameters, count and moments ({restored.count(False)} differ)")
    lr = state.optimizer.learning_rate()
    step = train.make_recognition_train_step(opt)
    before = [p.detach().clone() for p in state.model.net.parameters()]
    state, _ = step(state, *lines)
    fresh, _ = step(fresh, *lines)
    with torch.no_grad():
        pairs = list(zip(state.model.net.parameters(), fresh.model.net.parameters()))
        diffs = [float((a - b).abs().max()) for a, b in pairs]
        moved = sum(int(((a - b).abs() > 1e-6).sum()) for a, b in pairs)
        step_size = max(float((a - b).abs().max()) for a, b in zip(state.model.net.parameters(), before))
    bound = 2 * lr + 1e-6
    check(fresh.step == state.step and max(diffs) <= bound,
          f"train: a step after a checkpoint round trip equals one without it (max |diff| {max(diffs)} <= {bound})")
    report["checkpoint"] = {"file": path.name, "bytes": path.stat().st_size, "step": fresh.step,
                            "learning_rate_of_the_step": lr, "largest_move_of_the_step": step_size,
                            "max_abs_param_diff_after_one_step": max(diffs), "bound": bound,
                            "params_off_by_more_than_1e-6": moved}
    del state, fresh

    # ConvCTC warm-started from the shipped weights, at the same batch.
    params, _ = load_params(REPO / "weights" / "text-recognition.npz")
    opt = recipe()
    state = train.init_recognition_state(opt, arch="convctc", init_params=params)
    _, report["convctc"] = run_steps("convctc", state, train.make_recognition_train_step(opt, arch="convctc"), lines)
    del state

    # The U-Net warm-started from the shipped weights: 16 pages of 800 x 608.
    pages = train_pages(rng, DET_BATCH)
    params, _ = load_params(REPO / "weights" / "text-detection.npz")
    opt = recipe()
    state = train.init_detection_state(opt, init_params=params)
    _, report["unet"] = run_steps("unet", state, train.make_detection_train_step(opt), pages)
    report["unet"]["target_share"] = float(pages[1].mean())
    del state

    # The demo, short: its loss curve and held-out decodes.
    reset_gru_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = demo.main(DEMO_ARGS)
    report["demo"] = {"args": DEMO_ARGS, **result, "printed": printed.getvalue().splitlines(),
                      "gru_launches": gru.bigru_sequence.launches}
    train_launches += gru.bigru_sequence.launches
    check(all(np.isfinite(v) for _, v in result["loss_curve"]), "train: demo losses are finite")
    report["seconds"] = time.perf_counter() - t_phase
    return report, train_launches, large


# The trainer (python -m ocrs_tpu_torch.train.train_models) on the card, from
# the committed caches (test-data/train/): the card's machine may have no
# Pillow and no faces, and a cache draws nothing.
TRAIN_CACHES = REPO / "test-data" / "train"
REC_CACHE, VAL_CACHE, DET_CACHE = "rec_64_768_s0.npz", "rec_32_768_s7919.npz", "det_8_s0.npz"
# ConvCTC warm-started from the shipped weights at a fine-tuning rate (the
# text page must still read as the shipped weights read it), the CRNN at
# full width from random weights, and the U-Net warm-started, both at the
# trainer's default rate (the U-Net's batches of 16 of the 8 cached pages
# differ in loss by up to 3x, so it needs the larger rate and 30 steps to
# fall past that spread); each recognizer validates at its end.
TRAINER_RUNS = ("convctc", "crnn", "unet")


def trainer_args(name):
    """The trainer's arguments of run `name` (output path not included)."""
    rec, det = str(TRAIN_CACHES / REC_CACHE), str(TRAIN_CACHES / DET_CACHE)
    weights = REPO / "weights"
    return {
        "convctc": ["recognition", "--arch", "convctc", "--init-from", str(weights / "text-recognition.npz"),
                    "--batch", "64", "--width", "768", "--steps", "40", "--val-every", "20", "--lr", "1e-4",
                    "--cache", rec],
        "crnn": ["recognition", "--arch", "crnn", "--hidden", "192", "--batch", "64", "--width", "768",
                 "--steps", "10", "--val-every", "10", "--cache", rec],
        "unet": ["detection", "--init-from", str(weights / "text-detection.npz"), "--batch", "16", "--steps", "30",
                 "--cache", det],
    }[name]


# Steps left out of a run's median step time (the first calls pick cuDNN's
# and cuBLAS's plans).
TRAINER_WARMUP = 3
# Lines of the recognition cache drawn again where Pillow and a face exist.
REDRAWN_LINES = 4
# The converted CRNN twin in float32 on the card (the GRU kernel; 3xTF32
# products) against the twin's own forward (cuDNN's GRU, TF32 off): the
# summation orders differ through two BiGRU layers of hidden 192.
CONVERT_HIDDEN, CONVERT_LOGPROB_ATOL = 192, 1e-3


def rasterizers():
    """What this machine offers the renderer: Pillow, fontTools,
    matplotlib, pygame, and each entry of the font bank beside its file."""
    import importlib.util

    from ocrs_tpu_torch.train import render

    report = {name: importlib.util.find_spec(name) is not None for name in ("PIL", "fontTools", "matplotlib", "pygame")}
    report["font_candidates"] = [
        {"candidate": cand, "path": path, "exists": bool(path and os.path.exists(path))}
        for cand, path in render.candidate_paths()
    ]
    try:
        report["font_bank"] = list(render.font_paths())
    except render.RenderUnavailable as e:
        report["font_bank"] = []
        report["font_bank_error"] = str(e)
    report["can_draw"] = report["PIL"] and bool(report["font_bank"])
    return report


def weight_tree_report(path, like):
    """Keys and shapes of the weight file `path` against the tree `like`
    (a flat {key: array} mapping)."""
    from ocrs_tpu_torch.models.weights import load_flat

    flat, meta = load_flat(path)
    shapes = {k: tuple(v.shape) for k, v in flat.items()}
    want = {k: tuple(v.shape) for k, v in like.items()}
    return shapes == want and all(v.dtype.name == "float32" for v in flat.values()), meta


def trainer_phase(dev, det, conv, text_input, shipped_text):
    """The trainer on the card from the committed caches; returns (report,
    GRU launches of its runs)."""
    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models import convert
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.models.weights import load_detection_model, load_flat, load_recognition_model, params_to_jax
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.train import train_models
    from ocrs_tpu_torch.train.data import RecognitionDataset

    t_phase = time.perf_counter()
    raster = rasterizers()
    emit({"phase": "train_driver_rasterizers", **raster})
    report, launches_total = {"rasterizers_can_draw": raster["can_draw"]}, 0
    missing = [n for n in (REC_CACHE, VAL_CACHE, DET_CACHE) if not (TRAIN_CACHES / n).exists()]
    check(not missing, f"train_driver: committed caches present ({missing} missing)")
    if missing:
        return report, 0
    val_ds = RecognitionDataset(0, cache_path=TRAIN_CACHES / VAL_CACHE)
    val_batch = train_models.validation_batch(val_ds)

    # Where this machine can draw, the renderer remakes the cache's first lines.
    if raster["can_draw"]:
        drawn = RecognitionDataset(REDRAWN_LINES, width=768, seed=0)
        cached = RecognitionDataset(0, cache_path=TRAIN_CACHES / REC_CACHE)
        same = all(
            np.array_equal(drawn.get(i)[0], cached.get(i)[0]) and drawn.get(i)[1] == cached.get(i)[1]
            for i in range(REDRAWN_LINES)
        )
        check(same, f"train_driver: the renderer on this machine remakes the cache's first {REDRAWN_LINES} lines")
        report["redrawn_lines_equal_cache"] = same
    else:
        report["redrawn_lines_equal_cache"] = "not drawn: " + ("no face of the font bank" if raster["PIL"] else "no Pillow") + " here"

    out_dir = REPO / "build" / "chip_smoke_trainer"
    shipped_rec = load_flat(REPO / "weights" / "text-recognition.npz")[0]
    shipped_det = load_flat(REPO / "weights" / "text-detection.npz")[0]
    crnn_like = dict(convert._flatten_with_paths(
        params_to_jax(RecognitionModel.create(seed=0, hidden=CONVERT_HIDDEN, arch="crnn").net.state_dict())))
    for name in TRAINER_RUNS:
        argv = trainer_args(name)
        args = train_models.parse_args([*argv, "-o", str(out_dir / f"{name}.npz")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_gru_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            if args.model == "recognition":
                record = train_models.train_recognition(args, val_batch=val_batch)
            else:
                record = train_models.train_detection(args)
        torch.cuda.synchronize()
        launches = gru.bigru_sequence.launches + gru.gru_sequence.launches
        launches_total += launches
        losses = record["losses"]
        steps_ms = [1e3 * t for t in record["step_seconds"]]
        run = {
            "args": argv,
            "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "step_ms": statistics.median(steps_ms[TRAINER_WARMUP:]), "step_ms_all": steps_ms,
            "batch_ms_median": 1e3 * statistics.median(record["batch_seconds"][TRAINER_WARMUP:]),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "gru_launches": launches,
            "printed": printed.getvalue().splitlines(),
        }
        check(all(np.isfinite(losses)), f"train_driver {name}: finite losses")
        check(losses[-1] < losses[0], f"train_driver {name}: the loss falls from step 1 to {len(losses)} ({losses[0]} -> {losses[-1]})")
        path = Path(record["output"])
        if args.model == "recognition":
            validations = len(record["val_cer"])
            run["val_cer"] = record["val_cer"]
            run["validation"] = f"{VAL_CACHE} through val_batch ({record['val_size']} lines)"
            per_step = 2 if args.arch == "crnn" else 0
            want = per_step * (args.steps + validations)
            check(launches == want, f"train_driver {name}: {per_step} GRU launches a step and a validation ({launches}, want {want})")
            ok, meta = weight_tree_report(path, shipped_rec if args.arch == "convctc" else crnn_like)
            check(ok, f"train_driver {name}: the exported file has the keys, shapes and dtype of its kind")
            check(meta.get("kind") == "recognition" and meta.get("arch") == args.arch and meta.get("steps") == args.steps,
                  f"train_driver {name}: the exported meta ({meta})")
            model = load_recognition_model(path)
            engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=model), device="cuda")
        else:
            check(launches == 0, f"train_driver {name}: no GRU launch ({launches})")
            ok, meta = weight_tree_report(path, shipped_det)
            check(ok and meta.get("kind") == "detection" and meta.get("input_hw") == [800, 608],
                  f"train_driver {name}: the exported file has the shipped detector's keys, shapes, dtype and meta")
            engine = OcrEngine(OcrEngineParams(detection_model=load_detection_model(path), recognition_model=conv), device="cuda")
        text = engine.get_text(text_input)
        run.update(exported=path.name, exported_bytes=path.stat().st_size, meta=meta, text_page=text)
        check(isinstance(text, str), f"train_driver {name}: an engine on the card runs the exported file")
        if name == "unet":
            check(text.strip() != "", f"train_driver unet: the fine-tuned detector still finds the text page's lines ({text!r})")
        if name == "convctc":
            check(text == shipped_text, f"train_driver convctc: the warm-started ConvCTC reads the text page as the "
                                        f"shipped weights do ({text!r} / {shipped_text!r})")
        report[name] = run
        del record, engine
        torch.cuda.empty_cache()
    report["gru_launches"] = launches_total
    report["seconds"] = time.perf_counter() - t_phase
    return report, launches_total


def convert_phase(dev, det, text_input):
    """The PyTorch twin of the CRNN (hidden 192, 97 classes, seed 0)
    converted into the port's CRNN; both on the card in float32 on the text
    page's line batch. Returns (report, GRU launches of the converted
    model's run)."""
    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET, OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models import convert
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.ops.ctc import collapse_greedy_batch
    from ocrs_tpu_torch.testing import torch_crnn_twin

    t_phase = time.perf_counter()
    twin = torch_crnn_twin(CONVERT_HIDDEN, 97, seed=0)
    state = {k: v.numpy() for k, v in twin.state_dict().items()}
    params = convert.convert_torch_state_dict(state, convert.target_params("recognition", "crnn", 97, CONVERT_HIDDEN))
    model = convert.load_converted_model(params, "recognition", arch="crnn")
    model.dtype = torch.float32
    engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=model), device="cuda")
    twin = twin.to(dev)
    captured = []
    hook = model.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0], out.detach())))
    reset_gru_counts()
    text = engine.get_text(text_input)
    torch.cuda.synchronize()
    launches = gru.bigru_sequence.launches + gru.gru_sequence.launches
    hook.remove()
    check(len(captured) == 1 and launches == 2, f"convert: one line batch, two GRU launches ({len(captured)}, {launches})")
    x, lp = captured[0]
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        want = twin(x.float())
    torch.backends.cudnn.allow_tf32 = True
    err = float((lp - want).abs().max())

    def greedy(logprobs):
        labels = logprobs.argmax(dim=-1).T.cpu().numpy()
        return ["".join(DEFAULT_ALPHABET[s.label - 1] for s in steps) for steps in collapse_greedy_batch(labels)]

    got_text, want_text = greedy(lp), greedy(want)
    check(tuple(lp.shape) == tuple(want.shape) and bool(torch.isfinite(lp).all()), "convert: finite log-probs of the twin's shape")
    check(err <= CONVERT_LOGPROB_ATOL, f"convert: max |log-prob diff| against the twin {err} <= {CONVERT_LOGPROB_ATOL}")
    check(got_text == want_text, f"convert: the converted model's greedy text is the twin's ({got_text} / {want_text})")
    report = {
        "twin": f"ocrs_tpu_torch.testing.TorchCRNN(hidden={CONVERT_HIDDEN}, n_classes=97), seed 0, torch.nn.GRU (cuDNN)",
        "line_batch": list(x.shape), "logprobs": list(lp.shape), "max_abs_logprob_diff": err,
        "atol": CONVERT_LOGPROB_ATOL, "greedy_equal": got_text == want_text, "greedy_text": got_text,
        "frames_differing": int((lp.argmax(-1) != want.argmax(-1)).sum()), "engine_text": text,
        "gru_launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    del twin, engine, model
    return report, launches


# The parallel phase: more than one device, on the one card. The pipeline
# sharded over a mesh of one entry and of two entries on the same card
# (each shard its own thread and CUDA stream); the train steps over process
# groups: one NCCL rank, and two gloo ranks sharing the card (NCCL refuses
# two ranks on one device); the trainer under torchrun.
# Groups of process_stream timed per mesh: warm-up, then timed.
PARALLEL_WARM, PARALLEL_TIMED = 1, 4
# The model split at the JAX package's even shapes (dryrun_multichip's): a
# 97-class head does not split in two, in either package.
SPLIT_CLASSES, SPLIT_HIDDEN = 24, 64
# The model split runs under gloo on the card: gloo takes its all-gather of
# CUDA tensors (float32 and bf16), as tools/torch_parallel_probe.py found on
# the card (PyTorch 2.11, H100), though PyTorch's table of collectives lists
# no all-gather on GPU tensors for gloo (see PERF.md).
# The sharded steps against the one-process step, both bf16 on the card:
# tests/test_torch_train_step.py's bounds (loss 1e-2 relative; parameters
# within 2 * the summed rates + 1e-6).
PARALLEL_LR, PARALLEL_STEPS = 1e-3, 2
# One float32 step (TF32 off) of each sharded run against one process's:
# the loss, and every leaf's gathered gradient by the relative norm of the
# whole leaf. Both sides sum in float32 in other orders (a batch split in
# two, cuDNN free to pick other algorithms at the half batch); the CPU tests
# hold 1e-5 at a batch of 4. A gradient of half the batch, or one not
# reduced over the model group, is far outside: the phase measures the
# half-batch gradient's distance and requires it above ten times this.
PARALLEL_F32_RTOL = 1e-3
# A shard thread's bf16 GRU output against the plain version's, rounded to
# bf16: GRU_ATOL and one bf16 spacing below 1 (|h| < 1), where the two
# round to neighbours.
SHARD_GRU_BF16_ATOL = GRU_ATOL + 2.0**-8
# The trainer under torchrun: ConvCTC warm-started from the shipped weights
# at the train_driver phase's fine-tuning rate, 10 steps.
TORCHRUN_STEPS = 10


def line_logprobs(captured):
    """{line key: its frames' log-probs [T, C]} of captured recognizer
    batches (crops [N, 1, 64, W], log-probs [W / 4, N, C]). A line is keyed
    by its crop up to its last column that is not padding (BLACK_VALUE),
    which is the same in any batch; padding rows repeat a line and key to
    it."""
    from ocrs_tpu_torch.preprocess import BLACK_VALUE

    out = {}
    for x, lp in captured:
        holds = (x != BLACK_VALUE).flatten(1, 2).any(dim=1).cpu()  # [N, W]: columns of the line
        for i in range(x.shape[0]):
            cols = holds[i].nonzero()
            if cols.numel() == 0:
                continue
            last = int(cols[-1])
            key = x[i, ..., : last + 1].float().cpu().numpy().tobytes()
            out[key] = lp[: -(-(last + 1) // 4), i].float().cpu()
    return out


def text_edits(a, b):
    """Characters inserted, deleted or replaced between texts `a` and `b`."""
    import difflib

    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")


def bf16_step_report(got, want, lr_total, what):
    """A sharded run's losses and whole parameters against the one-process
    run's by tests/test_torch_parallel_train.py's bf16 rule: the step-1 loss
    within 1e-2, the parameters within 2 * the summed rates + 1e-6, and,
    where the one-process run's gradients of both updates are clear of bf16
    noise (above a tenth of their leaf's root mean square) and agree in
    sign, and the sharded run's are within half of them, each update is
    held: moved by the one-process run more than a quarter of the rates, it
    takes the one-process update's sign and lies within half the rates of
    it (a zero, doubled or flipped update fails). Every leaf has entries
    clear of noise, and at least half of them are held: how many are clear
    of noise is the one-process gradient's own structure (a tenth or fewer
    of a GRU's input projection at small shapes), so the floor is a share
    of those. Returns the worst parameter difference and the least share
    of a leaf's clear entries held."""
    import numpy as np

    check(abs(got["losses"][0] - want["losses"][0]) <= 1e-2 * abs(want["losses"][0]),
          f"parallel {what}: step-1 loss {got['losses'][0]} within 1e-2 of one process's {want['losses'][0]}")
    check(got["params"].keys() == want["params"].keys(), f"parallel {what}: the gathered parameters' keys")
    worst = max(float(np.abs(got["params"][k] - want["params"][k]).max()) for k in want["params"])
    check(worst <= 2 * lr_total + 1e-6, f"parallel {what}: parameters within {2 * lr_total + 1e-6} ({worst})")
    p0, counts, bad = want["p0"], {}, []
    for k in want["params"]:
        ws, gs = [g[k] for g in want["grads"]], [g[k] for g in got["grads"]]
        clear = np.sign(ws[0]) == np.sign(ws[-1])
        for w in ws:
            clear &= np.abs(w) > 0.1 * np.sqrt(np.mean(np.square(w, dtype=np.float64)))
        held = clear.copy()
        for w, g in zip(ws, gs):
            held &= np.abs(g - w) < 0.5 * np.abs(w)
        dt, dw = (got["params"][k] - p0[k])[held], (want["params"][k] - p0[k])[held]
        counts[k] = (int(held.sum()), int(clear.sum()))
        if (np.any(np.abs(dw) <= 0.25 * lr_total) or np.any(np.sign(dt) != np.sign(dw))
                or np.any(np.abs(dt - dw) > lr_total / 2)):
            bad.append(k)
    few = {k: f"{h} of {c}" for k, (h, c) in counts.items() if c == 0 or h < 0.5 * c}
    check(not few, f"parallel {what}: leaves with under half their entries clear of bf16 noise held: {few}")
    check(not bad, f"parallel {what}: updates that leave the one-process update's sign or size: {bad}")
    return worst, min(h / c for h, c in counts.values() if c)


def grad_rel_diffs(got, want):
    """{leaf: |got - want| / |want|} of the first update's gradients, each
    leaf whole."""
    import numpy as np

    return {k: float(np.linalg.norm(got["grads"][0][k] - w) / np.linalg.norm(w)) for k, w in want["grads"][0].items()}


def f32_step_report(got, want, what):
    """A sharded run's float32 step against one process's: the loss within
    PARALLEL_F32_RTOL, and every leaf's gathered gradient within
    PARALLEL_F32_RTOL of the one-process gradient by relative norm. Returns
    the worst leaf's relative difference."""
    check(abs(got["losses"][0] - want["losses"][0]) <= PARALLEL_F32_RTOL * abs(want["losses"][0]),
          f"parallel {what}: float32 loss {got['losses'][0]} within {PARALLEL_F32_RTOL} of one process's {want['losses'][0]}")
    check(got["grads"][0].keys() == want["grads"][0].keys(), f"parallel {what}: the gathered gradients' keys")
    rel = grad_rel_diffs(got, want)
    worst = max(rel, key=rel.get)
    check(rel[worst] <= PARALLEL_F32_RTOL,
          f"parallel {what}: float32 gradients within {PARALLEL_F32_RTOL} of one process's by relative norm "
          f"(worst {worst}: {rel[worst]})")
    return rel[worst]


def parallel_phase(dev, det, conv, rec, bench_group, host_groups, text_input, shipped_text, train_crnn_ms):
    """Returns (report, GRU launches of the phase's main runs)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from ocrs_tpu_torch import PagePipeline
    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET, OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.models.weights import load_flat, load_recognition_model, params_to_jax
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.parallel import distributed
    from ocrs_tpu_torch.parallel.dryrun import TrainCase, dryrun_multichip, flat_params, run_train_case, run_train_cases
    from ocrs_tpu_torch.parallel.sharding import make_data_mesh
    from ocrs_tpu_torch.train import demo
    from ocrs_tpu_torch.train.data import RecognitionDataset
    from ocrs_tpu_torch.train.train import recognition_loss
    from ocrs_tpu_torch.train.train_models import validation_batch

    t_phase = time.perf_counter()
    report, launches_total = {}, 0

    def texts_of(results):
        return [r.text for r in results]

    # 1. The pipeline: one entry, two entries on the one card. Each shard
    # runs the unsharded pipeline on its slice (its U-Net batch, its pooled
    # line batches), so two shards must read exactly what the unsharded
    # pipeline reads on each half; the whole group in one unsharded call
    # differs in batches, and is compared for the report only.
    one, two = make_data_mesh(), make_data_mesh(devices=["cuda:0", "cuda:0"])
    plain = PagePipeline(det, conv, DEFAULT_ALPHABET, device="cuda")
    half = len(bench_group) // 2
    halves = texts_of(plain.process(bench_group[:half])) + texts_of(plain.process(bench_group[half:]))
    captured = []
    hook = conv.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0], out.detach())))
    plain_res = plain.process(bench_group)
    want = texts_of(plain_res)
    plain_lp = line_logprobs(captured)
    pipes = {"one_shard": PagePipeline(det, conv, DEFAULT_ALPHABET, mesh=one),
             "two_shards": PagePipeline(det, conv, DEFAULT_ALPHABET, mesh=two)}
    pipe_report = {"pages": len(bench_group), "hw": list(bench_group.shape[1:]), "lines": sum(len(t.splitlines()) for t in want)}
    for name, p in pipes.items():
        captured.clear()
        res = p.process(bench_group)
        got = texts_of(res)
        torch.cuda.synchronize()
        lp = line_logprobs(captured)
        flips, margins = 0, []
        for key, a in lp.items():
            b = plain_lp.get(key)
            if b is None:
                continue
            t = min(len(a), len(b))
            f = a[:t].argmax(-1) != b[:t].argmax(-1)
            top2 = b[:t].topk(2, dim=-1).values
            flips += int(f.sum())
            margins += (top2[:, 0] - top2[:, 1])[f].tolist()
        moved = len(lp) - sum(k in plain_lp for k in lp)
        check(len(got) == len(want) and len(lp) > 0, f"parallel pipeline {name}: a result per page")
        if name == "one_shard":
            check(got == want and moved == 0, f"parallel pipeline one_shard: the unsharded run's text ({moved} crops moved)")
        else:
            check(got == halves, "parallel pipeline two_shards: each shard's text is the unsharded pipeline's on its "
                  f"half ({sum(x != y for x, y in zip(got, halves))} pages differ)")
        pipe_report[name] = {
            "texts_equal_unsharded_per_shard": got == (want if name == "one_shard" else halves),
            # Against one unsharded call over the whole group: a report.
            "whole_group": {
                "texts_equal": got == want, "pages_differing": sum(x != y for x, y in zip(got, want)),
                "chars_differing": sum(text_edits(x, y) for x, y in zip(got, want)), "frames_flipped": flips,
                "flip_margins": margins[:32], "crops_moved": moved, "crops": len(lp),
                "lines_differing": [(i, a, b) for i, (x, y) in enumerate(zip(got, want))
                                    for a, b in zip(x.splitlines(), y.splitlines()) if a != b][:12],
                "words_lines_equal": [(len(a.words), len(a.lines)) for a in res] == [(len(b.words), len(b.lines)) for b in plain_res],
            },
        }
    hook.remove()
    # process_stream over 3 groups under two shards against 3 process calls.
    groups = host_groups[:3]
    serial = [texts_of(pipes["two_shards"].process(g)) for g in groups]
    streamed = [texts_of(r) for r in pipes["two_shards"].process_stream(groups)]
    check(streamed == serial, "parallel pipeline: process_stream under two shards equals three process calls")
    pipe_report["two_shards_stream_equals_process"] = streamed == serial
    # The CRNN at hidden 192 through two shards: both shard threads launch
    # the kernel, each on its own stream, and each launch gives the plain
    # version's result: the shard's own bf16 output of gru1 against the
    # plain version on the operands gru1 made of its input, and the kernel
    # against the plain version on those operands in float32.
    crnn_two = PagePipeline(det, rec, DEFAULT_ALPHABET, mesh=two)
    check(all(s._rec is rec for s in crnn_two._shards), "parallel pipeline: the two shards share the CRNN")
    gru_io = {}

    def keep_gru_io(module, inp, out):
        gru_io.setdefault(threading.current_thread().name, (inp[0].detach(), out.detach()))

    gru_hook = rec.net.gru1.register_forward_hook(keep_gru_io)
    try:
        reset_gru_counts()
        crnn_texts = texts_of(crnn_two.process(bench_group[:4]))
        torch.cuda.synchronize()
        by_thread = dict(gru.bigru_sequence.launches_by_thread)
        crnn_launches = gru.bigru_sequence.launches + gru.gru_sequence.launches
    finally:
        gru_hook.remove()
    launches_total += crnn_launches
    check(by_thread.get("ocrs-shard-0", 0) > 0 and by_thread.get("ocrs-shard-1", 0) > 0,
          f"parallel pipeline: the GRU kernel launched on both shard threads ({by_thread})")
    check(set(gru_io) == {"ocrs-shard-0", "ocrs-shard-1"}, f"parallel pipeline: gru1 ran on both shard threads ({list(gru_io)})")
    shard_gru = {}
    for thread, (x, y) in sorted(gru_io.items()):
        ops = bigru_operands(rec.net.gru1, x)
        ref = gru.bigru_sequence_reference(*ops)
        own = float((y.float() - ref.transpose(0, 1).to(y.dtype).float()).abs().max())
        kernel = float((gru.bigru_sequence(*ops) - ref).abs().max())
        check(own <= SHARD_GRU_BF16_ATOL and kernel <= GRU_ATOL,
              f"parallel pipeline: on {thread} the GRU kernel gives the plain version's result "
              f"(its own bf16 output {own} <= {SHARD_GRU_BF16_ATOL}; float32 {kernel} <= {GRU_ATOL})")
        shard_gru[thread] = {"input_shape": list(x.shape), "own_output_vs_plain": own, "kernel_vs_plain_f32": kernel}
    rec.net.plain_gru = True
    try:
        crnn_plain = texts_of(crnn_two.process(bench_group[:4]))
    finally:
        rec.net.plain_gru = False
    check(close_texts(crnn_texts, crnn_plain),
          f"parallel pipeline: two shards read close texts with the kernel and the plain GRU ({crnn_texts} / {crnn_plain})")
    pipe_report["crnn_two_shards"] = {
        "gru_launches_by_thread": by_thread, "kernel_vs_plain_by_thread": shard_gru,
        "texts_equal_plain_gru": sum(a == b for a, b in zip(crnn_texts, crnn_plain)), "pages": len(crnn_texts),
    }
    # Pages per second of process_stream: one shard, two shards (a
    # measurement: the pipeline is host-bound, so this is how much host
    # work the two threads overlap), with the process's CPU seconds per
    # second of wall time while it ran.
    for name in ("one_shard", "two_shards"):
        p = pipes[name]
        p.process_stream(host_groups[:PARALLEL_WARM])
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        res = p.process_stream(host_groups[PARALLEL_WARM : PARALLEL_WARM + PARALLEL_TIMED])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe_report[name]["stream_pages_per_s"] = sum(len(r) for r in res) / wall
        pipe_report[name]["stream_host_cpu_s_per_s"] = (time.process_time() - c0) / wall
    # Where two shards' time goes, by process over the group (fenced ms,
    # median of PARALLEL_TIMED): the group in one unsharded call, its two
    # halves one after the other, and the halves on the two shard threads.
    pipe_report["process_ms"] = {
        "unsharded_whole": wall_ms(lambda: plain.process(bench_group), PARALLEL_TIMED),
        "unsharded_halves_in_turn": wall_ms(
            lambda: (plain.process(bench_group[:half]), plain.process(bench_group[half:])), PARALLEL_TIMED),
        "two_shards": wall_ms(lambda: pipes["two_shards"].process(bench_group), PARALLEL_TIMED),
    }
    report["pipeline"] = pipe_report
    del pipes, plain, crnn_two

    # 2. Training: dryrun_multichip(1), then the CRNN at hidden 192 over one
    # NCCL rank against one process.
    dry = dryrun_multichip(1)
    report["dryrun_multichip_1"] = {k: dry[k] for k in ("train", "fake_pages", "real_pages", "real_nonempty", "real_texts")}
    launches_total += dry["train"]["gru_launches_rank0"]
    check(dry["train"]["gru_launches_rank0"] == 2, f"parallel dryrun: 2 GRU launches on the rank ({dry['train']['gru_launches_rank0']})")

    images, labels, lengths = demo.make_batch(np.random.default_rng(6), TRAIN_BATCH, TRAIN_WIDTH)
    lr_total = PARALLEL_STEPS * PARALLEL_LR

    def crnn_case(name, n_classes, hidden, split=1):
        tree = params_to_jax(RecognitionModel.create(seed=0, n_classes=n_classes, hidden=hidden, arch="crnn").net.state_dict())
        # The batch's labels folded into the head's classes (1 .. n_classes - 1).
        folded = np.where(labels > 0, (labels - 1) % (n_classes - 1) + 1, 0).astype(labels.dtype)
        steps = [(images, folded, lengths)] * PARALLEL_STEPS
        return TrainCase(name, "recognition", tree, steps, ("adamw", PARALLEL_LR), "crnn", split)

    def f32(case, rows=None):
        """One float32 step of `case` on its first batch (its first `rows`
        rows)."""
        batch = tuple(x[:rows] for x in case.batches[0])
        return replace(case, name=f"{case.name}_f32" if rows is None else f"{case.name}_f32_rows{rows}",
                       batches=[batch], dtype="float32", gru_check=False)

    full = crnn_case("crnn", 97, TRAIN_HIDDEN)
    small = crnn_case("crnn_split", SPLIT_CLASSES, SPLIT_HIDDEN, split=2)
    single = {}
    for case in (full, f32(full), small, f32(small), f32(full, rows=TRAIN_BATCH // 2)):
        single[case.name] = run_train_case(case, None, device=dev)
        single[case.name]["p0"] = flat_params(case.params)
        launches_total += single[case.name]["gru_launches"]
    # What the float32 check would see of a data split that trained each
    # rank on its half of the batch: the half batch's gradients.
    half_rel = grad_rel_diffs(single[f"crnn_f32_rows{TRAIN_BATCH // 2}"], single["crnn_f32"])
    check(max(half_rel.values()) > 10 * PARALLEL_F32_RTOL,
          f"parallel: the half batch's float32 gradients lie far outside {PARALLEL_F32_RTOL} ({max(half_rel.values())})")
    train_report = {
        "single_process": {"losses": single["crnn"]["losses"], "step_ms": single["crnn"]["step_ms"],
                           "f32_loss": single["crnn_f32"]["losses"][0], "f32_step_ms": single["crnn_f32"]["step_ms"]},
        "f32_rtol": PARALLEL_F32_RTOL,
        "half_batch_f32_grad_rel_diff": {"max": max(half_rel.values()), "min": min(half_rel.values())},
    }
    # A one-rank NCCL group in this process: DDP over it, beside the
    # one-process step in the same process.
    store = Path(tempfile.mkdtemp(dir=REPO / "build"))
    distributed.init_process_group(dev, init_method=f"file://{store / 'store'}", rank=0, world_size=1,
                                   timeout=datetime.timedelta(seconds=120))
    try:
        backend = torch.distributed.get_backend()
        r = run_train_case(full, distributed.make_mesh())
        r32 = run_train_case(f32(full), distributed.make_mesh())
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    worst, held = bf16_step_report(r, single["crnn"], lr_total, "nccl one rank")
    f32_worst = f32_step_report(r32, single["crnn_f32"], "nccl one rank")
    check(backend == "nccl" and r["gru_launches"] == 2 * PARALLEL_STEPS,
          f"parallel nccl: 2 GRU launches a step on the {backend} rank ({r['gru_launches']})")
    launches_total += r["gru_launches"] + r32["gru_launches"]
    train_report["nccl_one_rank"] = {"backend": backend, "losses": r["losses"], "step_ms": r["step_ms"],
                                     "train_phase_crnn_step_ms": train_crnn_ms, "max_abs_param_diff": worst,
                                     "least_leaf_share_of_clear_held": held, "f32_worst_grad_rel_diff": f32_worst,
                                     "gru_launches": r["gru_launches"]}

    # 3. Two gloo ranks on the one card: the data split of the same step,
    # and the model split at even shapes. Each rank holds the GRU kernel
    # against its plain version on its own input to gru1 (N = 32 rows a
    # rank under the data split; hidden 64 under the model split).
    gloo = run_train_cases([replace(full, gru_check=True), f32(full), replace(small, gru_check=True), f32(small)],
                           2, device="cuda:0", backend="gloo")
    check(gloo.get("built_in_rank") == [] and gloo.get("library_existed"), "parallel gloo: the ranks loaded the built kernel")
    for case, what, key in ((full, "gloo data split", "gloo_data_split"), (small, "gloo model split", "gloo_model_split")):
        r, r32 = gloo[case.name], gloo[f"{case.name}_f32"]
        worst, held = bf16_step_report(r, single[case.name], lr_total, what)
        f32_worst = f32_step_report(r32, single[f"{case.name}_f32"], what)
        check(r["gru_launches_by_rank"] == [2 * PARALLEL_STEPS] * 2,
              f"parallel {what}: 2 GRU launches a step on each rank ({r['gru_launches_by_rank']})")
        check(r["gru_check"]["max_abs_err"] <= GRU_ATOL,
              f"parallel {what}: the GRU kernel on rank 0's input vs plain {r['gru_check']} <= {GRU_ATOL}")
        launches_total += sum(r["gru_launches_by_rank"]) + sum(r32["gru_launches_by_rank"])
        train_report[key] = {"mesh": r["mesh"], "split": r["split"], "losses": r["losses"], "step_ms": r["step_ms"],
                             "max_abs_param_diff": worst, "least_leaf_share_of_clear_held": held,
                             "f32_loss": r32["losses"][0], "f32_step_ms": r32["step_ms"],
                             "f32_worst_grad_rel_diff": f32_worst, "gru_launches_by_rank": r["gru_launches_by_rank"],
                             "gru_kernel_vs_plain_rank0": r["gru_check"]}
    report["train"] = train_report

    # 4. The trainer under torchrun, one rank.
    out = REPO / "build" / "chip_smoke_torchrun" / "convctc.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    argv = ["recognition", "--arch", "convctc", "--init-from", str(REPO / "weights" / "text-recognition.npz"),
            "--cache", str(TRAIN_CACHES / REC_CACHE), "--batch", "64", "--width", "768",
            "--steps", str(TORCHRUN_STEPS), "--lr", "1e-4", "--val-size", "0", "--val-every", str(TORCHRUN_STEPS),
            "-o", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
                           "-m", "ocrs_tpu_torch.train.train_models", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"parallel torchrun: the trainer exits 0 ({proc.returncode}: {proc.stderr[-1500:]})")
    trainer = {"args": argv, "seconds": seconds, "rc": proc.returncode,
               "printed": [l for l in proc.stdout.splitlines() if "loss" in l or "saved" in l]}
    if proc.returncode == 0:
        ok, meta = weight_tree_report(out, load_flat(REPO / "weights" / "text-recognition.npz")[0])
        check(ok and meta.get("arch") == "convctc" and meta.get("steps") == TORCHRUN_STEPS,
              f"parallel torchrun: the export has the shipped file's keys, shapes and dtype ({meta})")
        # The trainer prints the loss at step 1 only over 10 steps: the loss
        # falls where the exported weights' mean CTC loss over the whole
        # cache it trained on is below the shipped weights'.
        cache = validation_batch(RecognitionDataset(0, cache_path=TRAIN_CACHES / REC_CACHE))
        exported = load_recognition_model(out).to(dev)
        before, after = (float(recognition_loss(m.to(dev), *cache)) for m in (conv, exported))
        check(after < before, f"parallel torchrun: the loss over the cache falls ({before} -> {after})")
        engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=exported), device="cuda")
        text = engine.get_text(text_input)
        check(text == shipped_text, f"parallel torchrun: the export reads the text page as the shipped weights do ({text!r})")
        trainer.update(exported_meta=meta, text_page=text, cache_loss_shipped=before, cache_loss_exported=after)
    report["torchrun_trainer"] = trainer
    report["seconds"] = time.perf_counter() - t_phase
    return report, launches_total


# The tools phase: the repository's tools, ported (ocrs_tpu_torch/tools), on
# the card at full width from the committed page sets of test-data/eval (the
# card's machine cannot draw them) and the shipped weights.
EVAL_DATA = REPO / "test-data" / "eval"
# F1 of the tools' results on the card against the JAX tools' on the CPU
# (reference.json), on the same pages and weights. On the CPU the port
# matched them exactly on all 17 pages (tests/test_torch_tools_*.py hold
# 0.02); on the card the bf16 U-Net and recognizer sum in other orders
# (single mask pixels, near-tie frames), which may move a word in fifty.
TOOLS_F1_TOL = 0.02


def tool_json(fn, argv):
    """A tool's `main(argv)` in this process: (exit code, the JSON object of
    its last line of standard output, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue().strip()
    # The object starts on the last line that opens with "{" (eval_accuracy
    # prints it indented over several lines).
    return rc, json.loads(text[text.rfind("\n{") + 1 :]), seconds


def f1_deltas(got, want):
    """|F1 difference| of each page of eval_independent's results, by group."""
    return {
        g: [abs(a["f1"] - b["f1"]) for a, b in zip(got[g], want[g])] for g in want if g != "overall"
    }


def tools_phase(dev, det, text_input, shipped_text):
    """The ported tools on the card. Returns (report, GRU launches, the
    kernel's max |err| on the tool's own GRU input)."""
    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import DEFAULT_ALPHABET, OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models import weights
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.ops import gru
    from ocrs_tpu_torch.png import write_png
    from ocrs_tpu_torch.tools import eval_accuracy, eval_independent, imgrep, profile_stages, soup

    t_phase = time.perf_counter()
    report = {}
    ref = json.loads((EVAL_DATA / "reference.json").read_text())
    det_path, rec_path = str(REPO / "weights" / "text-detection.npz"), str(REPO / "weights" / "text-recognition.npz")
    accuracy_file = str(EVAL_DATA / "accuracy_s1234_p8.npz")
    # The golden CLI tier runs in a process of its own (two CLI processes in
    # turn) while this one works.
    e2e = subprocess.Popen(
        [sys.executable, "-m", "ocrs_tpu_torch.tools.test_e2e"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        # eval_accuracy: the tool's command, then each page alone.
        rc, acc, seconds = tool_json(
            eval_accuracy.main, ["--detect", det_path, "--rec", rec_path, "--pages-from", accuracy_file]
        )
        want = ref["eval_accuracy"]["result"]
        engine = eval_accuracy.build_engine(det_path, rec_path, dev)
        pages = eval_accuracy.read_pages(accuracy_file, 8, 1234)
        per_page = [eval_accuracy.score_pages(engine, [p], 0.3, 1) for p in pages]
        deltas = {
            kind: [abs(a[kind]["f1"] - b[kind]["f1"]) for a, b in zip(per_page, ref["eval_accuracy"]["per_page"])]
            for kind in ("detection", "end_to_end")
        }
        for kind in ("detection", "end_to_end"):
            check(
                rc == 0 and abs(acc[kind]["f1"] - want[kind]["f1"]) <= TOOLS_F1_TOL,
                f"tools: eval_accuracy {kind} F1 {acc[kind]['f1']} within {TOOLS_F1_TOL} of the JAX tool's {want[kind]['f1']}",
            )
        report["eval_accuracy"] = {
            "result": acc, "reference": want, "seconds": seconds, "words": sum(len(w) for _, w in pages),
            "per_page_f1": {kind: [p[kind]["f1"] for p in per_page] for kind in ("detection", "end_to_end")},
            "per_page_abs_f1_diff": deltas, "atol": TOOLS_F1_TOL,
        }

        # eval_independent with its defaults on the committed groups.
        rc, ind, seconds = tool_json(eval_independent.main, ["--pages-from", str(EVAL_DATA / "independent.npz")])
        want = ref["eval_independent"]["result"]
        check(
            rc == 0 and ind["overall"]["pages"] == want["overall"]["pages"]
            and abs(ind["overall"]["f1"] - want["overall"]["f1"]) <= TOOLS_F1_TOL,
            f"tools: eval_independent overall F1 {ind['overall']['f1']} within {TOOLS_F1_TOL} of the JAX tool's {want['overall']['f1']}",
        )
        report["eval_independent"] = {
            "result": ind, "reference_overall": want["overall"], "seconds": seconds,
            "per_page_abs_f1_diff": f1_deltas(ind, want), "atol": TOOLS_F1_TOL,
        }

        # eval_accuracy with a CRNN at hidden 192 (random, seed 0), on one
        # page: the tool reaches the GRU kernel. The launches are counted
        # from zero; the recurrent layer's input is kept.
        crnn = RecognitionModel.create(0, arch="crnn")
        crnn_path = REPO / "build" / "tools_crnn_h192.npz"
        crnn_path.parent.mkdir(exist_ok=True)
        weights.save_params(
            crnn_path, weights.params_to_jax(crnn.net.state_dict()),
            meta={"kind": "recognition", "arch": "crnn", "hidden": 192, "n_classes": 97, "alphabet": DEFAULT_ALPHABET},
        )
        gru_inputs = []
        load_recognition_model = weights.load_recognition_model

        def load_with_hook(source):
            model = load_recognition_model(source)
            model.net.gru1.register_forward_hook(lambda m, inp, out: gru_inputs.append(inp[0].detach()))
            return model

        weights.load_recognition_model = load_with_hook
        try:
            reset_gru_counts()
            rc, crnn_acc, seconds = tool_json(
                eval_accuracy.main,
                ["--detect", det_path, "--rec", str(crnn_path), "--pages", "1", "--pages-from", accuracy_file],
            )
            torch.cuda.synchronize()
            launches = gru.bigru_sequence.launches + gru.gru_sequence.launches
        finally:
            weights.load_recognition_model = load_recognition_model
        check(rc == 0 and launches >= 2, f"tools: eval_accuracy with a CRNN launches the GRU kernel ({launches})")
        check(bool(gru_inputs), "tools: the CRNN's GRU input was captured")
        model = weights.load_recognition_model(crnn_path).to(dev)
        ops = bigru_operands(model.net.gru1, gru_inputs[0])
        kernel_err = float((gru.bigru_sequence(*ops) - gru.bigru_sequence_reference(*ops)).abs().max())
        check(kernel_err <= GRU_ATOL, f"tools: the kernel on the tool's GRU input vs plain {kernel_err} <= {GRU_ATOL}")
        report["eval_accuracy_crnn"] = {
            "result": crnn_acc, "seconds": seconds, "gru_launches": launches,
            "gru_input_shape": list(gru_inputs[0].shape), "kernel_vs_plain": kernel_err,
        }
        del model, crnn, gru_inputs

        # imgrep over a directory holding the text page.
        grep_dir = Path(tempfile.mkdtemp(prefix="imgrep-", dir=REPO / "build"))
        write_png(grep_dir / "text.png", text_page())
        grep = {}
        for pattern, want_rc in (("Section 12 notes", 0), ("zebra", 1)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = imgrep.main([pattern, str(grep_dir)])
            grep[pattern] = {"exit": rc, "lines": out.getvalue().splitlines()}
            check(rc == want_rc, f"tools: imgrep {pattern!r} exits {want_rc} ({rc})")
        check(
            grep["Section 12 notes"]["lines"] == [f"{grep_dir / 'text.png'}:1: Section 12 notes"],
            f"tools: imgrep prints the matching line ({grep['Section 12 notes']['lines']})",
        )
        report["imgrep"] = grep
        shutil.rmtree(grep_dir, ignore_errors=True)

        # soup of the shipped recognizer and its round-5 fine-tune.
        soup_path = REPO / "build" / "tools_soup.npz"
        parents = [rec_path, str(REPO / "weights" / "cand_r5.npz")]
        with contextlib.redirect_stdout(io.StringIO()):
            soup.main([*parents, "-o", str(soup_path)])
        flat, meta = weights.load_flat(soup_path)
        a, b = (weights.load_flat(p)[0] for p in parents)
        leaves_equal = flat.keys() == a.keys() and all(
            np.array_equal(flat[k], (0 + 0.5 * a[k].astype(np.float64) + 0.5 * b[k].astype(np.float64)).astype(a[k].dtype))
            for k in a
        )
        check(leaves_equal, "tools: every soup leaf is the float64 average of its parents' leaves")
        soup_engine = OcrEngine(
            OcrEngineParams(detection_model=det, recognition_model=weights.load_recognition_model(soup_path)), device=dev
        )
        soup_text = soup_engine.get_text(text_input)
        check(soup_text == shipped_text, f"tools: the soup reads the text page ({soup_text!r})")
        report["soup"] = {"leaves": len(flat), "leaves_equal": leaves_equal, "soup_weights": meta.get("soup_weights"), "text": soup_text}

        # profile_stages over the 16 committed pages of 3508 x 2480.
        rc, prof, seconds = tool_json(profile_stages.main, ["--pages-from", str(EVAL_DATA / "profile_p16.npz")])
        check(rc == 0 and prof["pages"] == [16, 3508, 2480] and len(prof["rows"]) == 19,
              f"tools: profile_stages timed its 19 rows on 16 full-size pages ({prof['pages']}, {len(prof['rows'])})")
        report["profile_stages"] = {**prof, "seconds": seconds}
    finally:
        e2e_out, e2e_err = e2e.communicate(timeout=600)
    check(e2e.returncode == 0 and "all golden tests passed" in e2e_out,
          f"tools: test_e2e's golden tier passes on the card ({e2e.returncode}: {e2e_out[-300:]} {e2e_err[-500:]})")
    report["test_e2e"] = {"exit": e2e.returncode, "stdout": e2e_out.splitlines()}
    report["seconds"] = time.perf_counter() - t_phase
    return report, launches, kernel_err


def bench_phase(dev):
    """The benchmark's configs once each in short form. Returns (report,
    GRU launches of config 6's CRNN row, the kernel's max |err| there)."""
    from bench_torch import bench

    t_phase = time.perf_counter()
    # The graph cache's counts over config 5's traced pass, read from its
    # pipeline just before and just after the pass.
    traced_graphs, timeline_pass = {}, bench.timeline_pass

    def counted_timeline_pass(pipe, *args, **kwargs):
        before = pipe.graph_stats()
        try:
            return timeline_pass(pipe, *args, **kwargs)
        finally:
            after = pipe.graph_stats()
            traced_graphs.update({k: after[k] - before[k] for k in ("graph_captures", "graph_replays", "eager_batches")})
            traced_graphs.update({k: after[k] for k in ("graphs", "input_buffer_bytes", "pool_bytes")})

    bench.timeline_pass = counted_timeline_pass
    try:
        config5 = bench.config5(dev, warmup_groups=1, passes=1, groups_per_pass=3, compute_passes=1, profile_groups=1)
    finally:
        bench.timeline_pass = timeline_pass
    print(f"config5 traced pass graphs: {json.dumps(traced_graphs)}", flush=True)
    check(traced_graphs.get("graph_replays", 0) >= 4 * 3, f"bench: config 5's traced pass replays graphs ({traced_graphs})")
    config5["traced_pass_graphs"] = traced_graphs
    report = {
        "config5": config5,
        "config1": bench.config1(dev, calls=20, stage_calls=3),
        "config4": bench.config4(dev, n_iter=2, n_rep=1),
    }
    reset_gru_counts()
    report["config6"] = bench.config6(dev, reps=3)
    report["config7"] = bench.config7(dev)
    for name, result in report.items():
        check(result["correct"], f"bench: {name} passes its correctness check ({ {k: v for k, v in result.items() if 'f1' in k} })")
    timeline = report["config5"]["timeline"]
    for name in ("card.stage", "card.detect", "card.recognize"):
        per_group = (timeline["card_intervals_per_group"] or {}).get(name, [])
        check(len(per_group) == 3 and min(per_group) >= 1,
              f"bench: every traced group has a {name} interval ({per_group})")
    check(timeline["unattributed_ms"] <= 0.05 * timeline["window_ms"],
          f"bench: the main thread's spans cover >= 95% of the traced window "
          f"({timeline['unattributed_ms']:.3f} of {timeline['window_ms']:.3f} ms unattributed)")
    check(timeline["texts_equal_timed_pass"], "bench: the traced pass reads the timed pass's texts")
    report["launch_path"] = launch_path_syncs(dev, bench)
    launch = report["config6"]["detail"]["gru_seq_launch"]
    check(launch["crnn_row_launches"] >= 2, f"bench: config 6's CRNN row launched the GRU kernel ({launch['crnn_row_launches']})")
    check(launch["max_abs_err"] <= GRU_ATOL, f"bench: the kernel at N=64, T=608 vs plain {launch['max_abs_err']} <= {GRU_ATOL}")
    report["seconds"] = time.perf_counter() - t_phase
    return report, launch["crnn_row_launches"], launch["max_abs_err"]


def launch_path_syncs(dev, bench) -> dict:
    """Config 5's pipeline, warm, takes one group through the steps that
    ``process_stream`` runs between its explicit waits, each under
    ``torch.cuda.set_sync_debug_mode("error")``: an operation there that
    makes the host wait for the card raises, and the run stops. Returns
    each step's host ms."""
    import torch

    from ocrs_tpu_torch import PagePipeline

    det, rec, alphabet = bench.load_models()
    pages, _ = bench.load_pages()
    pipe = PagePipeline(det, rec, alphabet, max_lines_per_batch=bench.PIPELINE_MAX_LINES, device=dev)
    want = [r.text for r in pipe.process(pages)]  # eager: process does not graph
    pipe.process_stream([pages] * 2)  # each key's first sight eager, its second captured
    check(pipe.graph_stats()["graph_captures"] >= 2, f"bench: the warm-up captured the graphs ({pipe.graph_stats()})")
    torch.cuda.synchronize()
    host_ms = {}

    def no_wait(name, fn):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            host_ms[name] = (time.perf_counter() - t0) * 1e3

    staged = no_wait("stage_pages", lambda: pipe._stage_pages(pages))
    before = pipe.graph_stats()
    copies, scale = no_wait("detect_launch", lambda: pipe._detect_tables(staged, graphs=True))
    lines = pipe._layout_group(*pipe._tables_to_words_arrays(copies, scale))
    inflight = no_wait("dispatch_recognition", lambda: pipe._dispatch_recognition(staged, lines, graphs=True))
    texts = ["\n".join(str(t) for t in page if t is not None) for page in pipe._collect_recognition(lines, inflight)]
    print("launch_path_syncs: 0", flush=True)  # a wait would have raised above
    after = pipe.graph_stats()
    check(texts == want, "bench: the group taken step by step reads what process reads")
    check(after["graph_captures"] == before["graph_captures"]
          and after["graph_replays"] - before["graph_replays"] == 1 + len(inflight),
          f"bench: the error-mode window replays warm graphs and captures none ({before} -> {after})")

    # The U-Net's self time in a traced pass long enough for steady windows.
    groups = [pages] * 6
    t0 = time.perf_counter()
    results = pipe.process_stream(groups)
    torch.cuda.synchronize()
    pages_per_sec = len(groups) * len(pages) / (time.perf_counter() - t0)
    check([r.text for group in results for r in group] == want * len(groups),
          "bench: a graphed process_stream reads the eager path's texts")
    timeline = bench.timeline_pass(pipe, groups, dev, results, [pages_per_sec])
    detect_net = timeline["host_ms_per_group"][threading.current_thread().name]["detect_net"]
    print(f"detect_net self ms a group (traced pass, windows 1-3 of 6): {detect_net}", flush=True)
    check(timeline["texts_equal_timed_pass"], "bench: the launch-path pipeline's traced pass reads its untraced pass's texts")
    return {"host_ms": host_ms, "syncs": 0, "graphs_in_window": {k: after[k] - before[k] for k in ("graph_captures", "graph_replays")},
            "detect_net_self_ms": detect_net, "pages_per_sec_untimed": pages_per_sec, "graph_stats": pipe.graph_stats()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from ocrs_tpu_torch import PagePipeline, cuda_build, native
        from ocrs_tpu_torch.engine import DEFAULT_ALPHABET, OcrEngine, OcrEngineParams
        from ocrs_tpu_torch import detection
        from ocrs_tpu_torch.models.recognition_net import RecognitionModel
        from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
        from ocrs_tpu_torch.ops import connected_components as cc
        from ocrs_tpu_torch.ops import gru, rects
        from ocrs_tpu_torch.recognition import BeamSearch
        from ocrs_tpu_torch.png import read_png
        from ocrs_tpu_torch.parallel.pipeline import probe_h2d_mbps
        from ocrs_tpu_torch.preprocess import DimOrder, ImageSource
        from ocrs_tpu_torch.utils.tracing import StageTimer
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32

    # 1. Build -----------------------------------------------------------------
    # The C++ compiler builds the host library while nvcc builds the kernels.
    t0 = time.perf_counter()
    native_build = threading.Thread(target=native.available)
    native_build.start()
    built = cuda_build.build()
    native_build.join()
    native.require()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "native_library": sorted(p.name for p in (REPO / "build" / "native").glob("*.so")),
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
    # The pipeline's batch: 128 lines, 8 row tiles of 16 side by side.
    big_args = bigru_inputs(g, n=PIPE_N)
    big_out = torch.full((PIPE_N, GRU_T, 2 * GRU_H), float("nan"), device=dev)
    gru.bigru_sequence(*big_args, out=big_out.transpose(0, 1))
    big_want = gru.bigru_sequence_reference(*big_args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(big_out).all()), f"bigru_sequence output at N={PIPE_N} is finite")
    errs[f"bigru_n{PIPE_N}"] = float((big_out.transpose(0, 1) - big_want).abs().max())
    del big_want
    max_err = max(errs.values())
    check(max_err <= GRU_ATOL, f"GRU kernel vs plain: max |err| {max_err} <= {GRU_ATOL} ({errs})")
    plan_big = gru.launch_plan(PIPE_N, GRU_H)
    emit(
        {
            "phase": "kernel_vs_plain",
            "kernel": "gru_sequence, bigru_sequence",
            "launch_plan": gru.launch_plan(GRU_N, GRU_H),
            f"launch_plan_n{PIPE_N}": {**plan_big, "blocks": 2 * plan_big["tiles"] * plan_big["cluster"]},
            "shape": {"T": GRU_T, "N": GRU_N, "H": GRU_H, "dtype": "float32"},
            "pipeline_shape": {"T": GRU_T, "N": PIPE_N, "H": GRU_H, "dtype": "float32"},
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

    # 7. The native host library against the port's other routes -------------------
    emit({"phase": "native", "u8_atol_grey_levels": U8_ATOL, "entry_points": native_checks(dev)})

    # 8. The page pipeline: shipped detector and ConvCTC, defaults -------------------
    def texts_of(results):
        return [r.text for r in results]

    def engine_texts(eng, group):
        return [eng.get_text(eng.prepare_input(ImageSource.from_tensor(p[..., None], DimOrder.HWC))) for p in group]

    def make_pipe(device="cuda", models=None, **kwargs):
        d, r = models or ((det, conv) if device == "cuda" else (det_cpu, conv_cpu))
        return PagePipeline(d, r, DEFAULT_ALPHABET, device=device, **kwargs)

    text = pages["text"][..., 0]
    text_group = np.stack(
        [text, text_page(TEXT_LINES[::-1])[..., 0], text_page(left=44, top=30)[..., 0], text_page(TEXT_LINES[:1])[..., 0]]
    )
    pipe = make_pipe()
    hbm = pipe.process(text_group)
    pipe_report = {"transport_auto": pipe._transport, "h2d_mbps": probe_h2d_mbps(dev)}
    want = engine_texts(default_engine, text_group)
    check(texts_of(hbm) == want, f"pipeline: process reads what the engine reads ({texts_of(hbm)} / {want})")
    check(hbm[0].text.splitlines() == list(TEXT_LINES), f"pipeline: the text page is read as written ({hbm[0].text!r})")
    pipe_report["text_group"] = {
        "texts": texts_of(hbm),
        "words": [len(r.words) for r in hbm],
        "lines": [len(r.lines) for r in hbm],
        "equals_engine": texts_of(hbm) == want,
    }
    # (b) The low-bandwidth transport: the same words, lines and text as the
    # full-page one. With 4-bit packing the pixels are quantized to 16 grey
    # levels, which may turn a weak letter: the words, the lines and the text
    # page must hold, the other pages' text is compared loosely and reported.
    for pack4 in (False, True):
        low = make_pipe(transport="lowbw", transport_pack4=pack4).process(text_group)
        same_counts = [len(r.words) for r in low] == [len(r.words) for r in hbm] and [len(r.lines) for r in low] == [
            len(r.lines) for r in hbm
        ]
        same_text = texts_of(low) == texts_of(hbm)
        ok = same_counts and (close_texts(texts_of(low), texts_of(hbm)) and low[0].text == hbm[0].text if pack4 else same_text)
        check(ok, f"pipeline: lowbw (pack4={pack4}) reads the words, lines and text of hbm ({texts_of(low)})")
        pipe_report[f"lowbw_pack4_{pack4}"] = {"texts": texts_of(low), "same_counts": same_counts, "equals_hbm": same_text}
    # (c) process_stream over three groups against three process calls.
    groups = [text_group, text_group[::-1].copy(), text_group[[2, 0, 3, 1]]]
    serial = [texts_of(pipe.process(grp)) for grp in groups]
    streamed = [texts_of(res) for res in pipe.process_stream(groups)]
    check(streamed == serial, f"pipeline: process_stream equals process, group by group ({streamed} / {serial})")
    pipe_report["process_stream_equals_process"] = streamed == serial
    # (d) Every option once, against the engine under the same option. The
    # engine fits word rects by an angle scan on the card, the pipeline by
    # exact calipers on the host: a rect that differs by a fraction of a pixel
    # moves a crop, and where an option makes the reading hang on weak letters
    # (slanted or turned crops, letters masked out of the alphabet) one of them
    # may turn. There the lines must be the same and the texts close, and
    # equality is reported; the other options must read the engine's text.
    loose = ("deskew", "vertical_text", "allowed_chars")
    big = np.full((700, 1000), 255, np.uint8)
    big[40:200, 60:480] = text
    big[400:560, 520:940] = text
    pipe_options = {
        "deskew": (opt_pages["rotated"][None, ..., 0], {"deskew": True}, {"deskew": True}),
        "vertical_text": (opt_pages["vertical"][None, ..., 0], {"vertical_text": True}, {"vertical_text": True}),
        "min_line_confidence": (text_group, {"min_line_confidence": 0.5}, {"min_line_confidence": 0.5}),
        "beam_search": (text_group, {"decode_method": BeamSearch(100)}, {"decode_method": BeamSearch(100)}),
        "allowed_chars": (
            text_group,
            {"allowed_chars": "abcdefghijklmnopqrstuvwxyz "},
            {"allowed_chars": "abcdefghijklmnopqrstuvwxyz "},
        ),
        "tiled_detection": (big[None], {"tiled_detection": True}, {"detection_tiled": True}),
        "run_table_geometry_false": (text_group, {"run_table_geometry": False}, {}),
    }
    pipe_report["options"] = {}
    for opt_name, (group, pipe_kwargs, engine_kwargs) in pipe_options.items():
        got = texts_of(make_pipe(**pipe_kwargs).process(group))
        eng = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=conv, **engine_kwargs), device="cuda")
        want = engine_texts(eng, group)
        same = close_texts(got, want) if opt_name in loose else got == want
        check(same, f"pipeline option {opt_name}: reads what the engine reads under it ({got} / {want})")
        check(any(t.strip() for t in got), f"pipeline option {opt_name}: text found")
        if opt_name == "allowed_chars":
            allowed = set(pipe_kwargs["allowed_chars"] + "\n")
            check(all(set(t) <= allowed for t in got), f"pipeline option allowed_chars: only allowed characters are read ({got})")
        pipe_report["options"][opt_name] = {"hw": list(group.shape[1:]), "texts": got, "equals_engine": got == want}
    # (e) The same pipeline on the CPU, asked for explicitly.
    on_cpu = texts_of(make_pipe(device="cpu").process(text_group))
    check(on_cpu == texts_of(hbm), f"pipeline: device='cpu' reads the text pages as the card does ({on_cpu})")
    pipe_report["cpu_equals_card"] = on_cpu == texts_of(hbm)
    emit({"phase": "pipeline", **pipe_report})

    # 9. The CRNN through the pipeline: batches of 128 lines -------------------------
    bench_pages, bench_texts = zip(*(full_page(seed) for seed in range(GROUP_PAGES)))
    bench_group = np.stack(bench_pages)
    dense = bench_group[:3]  # 168 lines: a batch of 128 and one of 40
    crnn_pipe = make_pipe(models=(det, rec))
    hook = rec.net.register_forward_hook(lambda m, inp, out: captured.append((inp[0].shape, out.detach())))

    def crnn_run(group):
        captured.clear()
        res = crnn_pipe.process(group)
        torch.cuda.synchronize()
        return texts_of(res), [len(r.lines) for r in res], list(captured)

    gru.gru_sequence.launches = gru.bigru_sequence.launches = 0
    crnn_texts, crnn_lines, crnn_batches = crnn_run(dense)
    pipe_launches = gru_launches()
    check(pipe_launches > 0, "the pipeline launched the GRU kernel")
    check(
        pipe_launches == 2 * len(crnn_batches),
        f"2 GRU launches per recognition batch of the pipeline ({pipe_launches} for {len(crnn_batches)})",
    )
    check(any(shape[0] == PIPE_N for shape, _ in crnn_batches), f"a batch of {PIPE_N} lines was run ({[tuple(sh) for sh, _ in crnn_batches]})")
    rec.net.plain_gru = True
    _, _, plain_batches = crnn_run(dense)
    crnn_lp_diff, crnn_flips = 0.0, 0
    for (shape, lp), (_, lp_plain) in zip(crnn_batches, plain_batches):
        check(tuple(lp.shape) == (shape[3] // 4, shape[0], 97) and bool(torch.isfinite(lp).all()), "pipeline_crnn: finite log-probs of the expected shape")
        crnn_lp_diff = max(crnn_lp_diff, float((lp - lp_plain).abs().max()))
        crnn_flips += frame_flips(lp, lp_plain)[0]
    check(crnn_lp_diff <= ENGINE_LOGPROB_ATOL, f"pipeline_crnn: log-probs kernel vs plain GRU {crnn_lp_diff} <= {ENGINE_LOGPROB_ATOL}")
    # In float32, kernel and plain GRU: equal text on the text pages; on the
    # dense pages, ~60,000 frames of a recognizer with random weights, a frame
    # within 1e-4 of a tie may flip, so equality there is reported.
    rec.dtype = torch.float32
    f32_plain_small, _, _ = crnn_run(text_group)
    f32_plain_dense, _, _ = crnn_run(dense)
    rec.net.plain_gru = False
    f32_small, _, _ = crnn_run(text_group)
    f32_dense, _, _ = crnn_run(dense)
    rec.dtype = torch.bfloat16
    check(f32_small == f32_plain_small, f"pipeline_crnn: float32 kernel and plain GRU decode the same text ({f32_small} / {f32_plain_small})")
    hook.remove()
    emit(
        {
            "phase": "pipeline_crnn",
            "pages": len(dense),
            "lines": crnn_lines,
            "batches": [{"N": sh[0], "w_eff": sh[3], "T": sh[3] // 4} for sh, _ in crnn_batches],
            "gru_launches": pipe_launches,
            "max_abs_logprob_diff_kernel_vs_plain": crnn_lp_diff,
            "logprob_atol": ENGINE_LOGPROB_ATOL,
            "bf16_flipped_frames": crnn_flips,
            "f32_text_equal_kernel_vs_plain_text_pages": f32_small == f32_plain_small,
            "f32_lines_equal_kernel_vs_plain_dense_pages": sum(
                a == b for ta, tb in zip(f32_dense, f32_plain_dense) for a, b in zip(ta.splitlines(), tb.splitlines())
            ),
        }
    )

    # 10. Serving: the HTTP server, the batching service, the CRNN on the
    # service's worker and on the handler threads -----------------------------
    serve_report, serve_launches, worker_err = serve_phase(det, conv, rec, default_engine, engine)
    emit({"phase": "serve", **serve_report})

    # 11. The CLI in subprocesses ------------------------------------------------
    emit({"phase": "cli", **cli_phase(default_engine, det, conv)})

    # 12. Times -----------------------------------------------------------------
    one_dir_ms = cuda_ms(lambda: gru.gru_sequence(*args), reps=20)
    kernel_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, out=bi_out.transpose(0, 1)), reps=20)
    # The dependent chain without arithmetic: the same launch without the
    # recurrent product, and with nothing but the exchange of h between the
    # blocks of a cluster and the wait for it.
    no_product_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, timing_mode=1), reps=20)
    sync_floor_ms = cuda_ms(lambda: gru.bigru_sequence(*bi_args, timing_mode=2), reps=20)
    plain_ms = cuda_ms(lambda: gru.bigru_sequence_reference(*bi_args), reps=10)

    def gru_bound(n):
        """Both directions: f32 operations of the recurrent products; each
        input read once and the output written once."""
        flops = 2 * 2.0 * n * GRU_H * 3 * GRU_H * GRU_T
        nbytes = 2 * 4.0 * (4 * GRU_T * n * GRU_H + 3 * GRU_H * GRU_H + 3 * GRU_H)
        by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        return flops, nbytes, max(by_ops, by_bytes) * 1e3, "operations" if by_ops >= by_bytes else "bytes"

    flops, nbytes, bound_ms, bound_by = gru_bound(GRU_N)
    # The same at the pipeline's batch of 128 lines.
    big_ms = cuda_ms(lambda: gru.bigru_sequence(*big_args, out=big_out.transpose(0, 1)), reps=20)
    big_sync_floor_ms = cuda_ms(lambda: gru.bigru_sequence(*big_args, timing_mode=2), reps=20)
    big_plain_ms = cuda_ms(lambda: gru.bigru_sequence_reference(*big_args), reps=3, warmup=1)
    big_flops, big_nbytes, big_bound_ms, big_bound_by = gru_bound(PIPE_N)

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
        x_big = torch.randn(PIPE_N, GRU_T, GRU_H, device=dev, generator=g)
        big_library_ms = cuda_ms(lambda: cudnn_gru(x_big), reps=20)
        big_apply_ms = cuda_ms(lambda: layer(x_big), reps=20)
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
        del crops

    # The pipeline at full size: groups of 16 pages of 3508 x 2480 uint8, each
    # group the same pages in another order (arrays of their own).
    host_groups = [np.roll(bench_group, k, axis=0) for k in range(8)]
    drawn = sum(len(t) for t in bench_texts)

    def stream_rate(p, groups, warm=2):
        """Pages per second of process_stream over groups[warm:], after a
        stream over the first `warm` groups; and the timed stream's results."""
        p.process_stream(groups[:warm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = p.process_stream(groups[warm:])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return sum(len(r) for r in res) / seconds, res

    def fenced_stages(p, group, reps=3):
        """Median ms of staging and of each stage of one process call, each
        ending with a synchronization of the card."""
        runs = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = p._stage_pages(group)
            torch.cuda.synchronize()
            timer = StageTimer(fence_device=dev)
            timer.timings["stage_pages"] = time.perf_counter() - t0
            p.process_normalized(staged, timer=timer)
            runs.append(timer.timings)
        return {k: statistics.median(r[k] for r in runs[1:]) * 1e3 for k in runs[0]}

    def read_as_drawn(results, shift):
        """Lines of a group's pages that read exactly as they were drawn."""
        return sum(
            line in bench_texts[(i - shift) % GROUP_PAGES]
            for i, r in enumerate(results)
            for line in r.text.splitlines()
        )

    pipe_times = {
        "group": {"pages": GROUP_PAGES, "hw": list(PAGE_HW), "dtype": "uint8", "lines_drawn": drawn},
        "timed_groups": len(host_groups) - 2,
        "warmup_groups": 2,
        "h2d_mbps": probe_h2d_mbps(dev),
    }
    auto_pipe = make_pipe()
    first = auto_pipe.process(bench_group)
    pipe_times["transport_auto"] = auto_pipe._transport
    pipe_times["words_per_group"] = sum(len(r.words) for r in first)
    pipe_times["lines_per_group"] = sum(len(r.lines) for r in first)
    pipe_times["lines_read_as_drawn"] = read_as_drawn(first, 0)
    check(
        0.95 * drawn <= pipe_times["lines_per_group"] <= 1.05 * drawn,
        f"times: the pipeline finds the lines drawn on the full-size pages ({pipe_times['lines_per_group']} of {drawn})",
    )
    check(pipe_times["lines_read_as_drawn"] >= 0.2 * drawn, f"times: lines read as drawn ({pipe_times['lines_read_as_drawn']} of {drawn})")
    on_card = auto_pipe._stage_pages(bench_group)
    for label, p, groups in (
        ("hbm_from_host", make_pipe(transport="hbm"), host_groups),
        ("hbm_from_card", make_pipe(transport="hbm"), [on_card] * len(host_groups)),
        ("lowbw_from_host", make_pipe(transport="lowbw"), host_groups),
    ):
        rate, res = stream_rate(p, groups)
        pipe_times[label] = {
            "pages_per_s": rate,
            "lines_read_as_drawn_first_timed_group": read_as_drawn(res[0], 2 if groups is host_groups else 0),
            "stages_ms": fenced_stages(p, bench_group),
        }
        check(all(len(r) == GROUP_PAGES for r in res), f"times: {label} returns every page of every group")
    # Does the stream (the last one, low-bandwidth) return what process
    # returns on the same group?
    pipe_times["stream_equals_process_full_size"] = texts_of(res[0]) == texts_of(
        make_pipe(transport="lowbw").process(host_groups[2])
    )
    del on_card
    gru.gru_sequence.launches = gru.bigru_sequence.launches = 0
    rate, res = stream_rate(crnn_pipe, host_groups)
    pipe_times["crnn_hbm_from_host"] = {
        "pages_per_s": rate,
        "gru_launches_per_group": gru_launches() / len(host_groups),
        "stages_ms": fenced_stages(crnn_pipe, bench_group),
    }

    serve_ms = serve_times(det, conv, default_engine)

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
            "pipeline_gru_shape": {"T": GRU_T, "N": PIPE_N, "H": GRU_H},
            f"bigru_sequence_n{PIPE_N}_ms": big_ms,
            f"bigru_sequence_reference_n{PIPE_N}_ms": big_plain_ms,
            f"sync_floor_n{PIPE_N}_ms": big_sync_floor_ms,
            f"bigru_apply_n{PIPE_N}_ms": big_apply_ms,
            f"cudnn_bigru_n{PIPE_N}_ms": big_library_ms,
            f"bound_n{PIPE_N}_ms": big_bound_ms,
            f"bound_n{PIPE_N}_flops": big_flops,
            f"bound_n{PIPE_N}_bytes": big_nbytes,
            "pipeline": pipe_times,
            "serve": serve_ms,
        }
    )

    # 13. Training on the card ------------------------------------------------------
    train_report, train_launches, large = train_phase(dev)
    emit({"phase": "train", "card": smi, **train_report})

    # 14. The trainer from the committed caches ---------------------------------------
    trainer_report, trainer_launches = trainer_phase(dev, det, conv, inputs["text"], d_texts["text"])
    emit({"phase": "train_driver", "card": smi, **trainer_report})

    # 15. A PyTorch CRNN converted into the port ---------------------------------------
    convert_report, convert_launches = convert_phase(dev, det, inputs["text"])
    emit({"phase": "convert", **convert_report})

    # 16. More than one device, on the one card ----------------------------------------
    parallel_report, parallel_launches = parallel_phase(
        dev, det, conv, rec, bench_group, host_groups, inputs["text"], d_texts["text"], train_report["crnn"]["step_ms"]
    )
    emit({"phase": "parallel", "card": smi, **parallel_report})

    # 17. The repository's tools, ported ---------------------------------------------
    tools_report, tools_launches, tools_err = tools_phase(dev, det, inputs["text"], d_texts["text"])
    emit({"phase": "tools", "card": smi, **tools_report})

    # 18. The port's benchmark, each config in short form ----------------------------
    bench_report, bench_launches, bench_err = bench_phase(dev)
    timeline = bench_report["config5"].pop("timeline")
    emit({"phase": "bench", "card": smi, **bench_report})
    emit({"phase": "bench_timeline", "card": smi, **timeline})

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
                    "launches": launches + pipe_launches + sum(serve_launches.values()) + train_launches
                    + trainer_launches + convert_launches + parallel_launches + tools_launches + bench_launches,
                    "launches_by_path": {
                        "engine": launches, "pipeline_crnn": pipe_launches, **serve_launches, "train": train_launches,
                        "train_driver": trainer_launches, "convert": convert_launches, "parallel": parallel_launches,
                        "tools": tools_launches, "bench": bench_launches,
                    },
                    "launch_sites": "the caller's thread (engine, pipeline, tools, bench), the batching service's worker "
                    "thread (serve_worker), the HTTP server's handler threads (serve_handlers), the shard "
                    "threads of PagePipeline(mesh=) and spawned training ranks (parallel)",
                    "max_abs_err": max(max_err, worker_err, tools_err, bench_err, *(v["max_abs_err"] for v in large.values())),
                    "max_abs_err_on_serve_worker_input": worker_err,
                    "max_abs_err_on_tools_input": tools_err,
                    "max_abs_err_on_bench_crnn_input": bench_err,
                    "shape": {"T": GRU_T, "N": GRU_N, "H": GRU_H},
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
                    # The same keys at the pipeline's batch of 128 lines.
                    "pipeline_shape": {
                        "shape": {"T": GRU_T, "N": PIPE_N, "H": GRU_H},
                        "launches": pipe_launches,
                        "max_abs_err": errs[f"bigru_n{PIPE_N}"],
                        "ms": big_ms,
                        "plain_ms": big_plain_ms,
                        "bound_ms": big_bound_ms,
                        "bound_by": big_bound_by,
                        "library_ms": big_library_ms,
                        "layer_ms": big_apply_ms,
                        "sync_floor_ms": big_sync_floor_ms,
                    },
                    # Hidden sizes 384 and 512 (clusters of 16 blocks) at T=608, N=20.
                    "large_hidden": {
                        str(h): {k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                        for h, v in large.items()
                    },
                    # The benchmark's config 6: the CRNN's launch at N=64, T=608, H=192.
                    "bench_shape": {
                        k: bench_report["config6"]["detail"]["gru_seq_launch"][k]
                        for k in ("shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "max_abs_err")
                    },
                    # The training shape (T=192, N=64, H=192): the forward launch.
                    "training_shape": {
                        k: train_report["bigru_layer_training_shape"][k]
                        for k in ("shape", "bigru_sequence_ms", "bigru_sequence_plain_ms", "bigru_sequence_bound_ms",
                                  "kernel_forward_ms", "kernel_backward_ms", "cudnn_forward_ms",
                                  "cudnn_forward_backward_ms")
                    },
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
