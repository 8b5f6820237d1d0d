"""Train the detection and recognition models on styled synthetic data and
export deployable ``.npz`` weights: the port of ``tools/train_models.py``.

    python -m ocrs_tpu_torch.train.train_models recognition --arch convctc \
        --steps 16000 --samples 60000 -o weights/text-recognition.npz
    python -m ocrs_tpu_torch.train.train_models detection --steps 4000 \
        --samples 4000 -o weights/text-detection.npz

The flags and defaults are the JAX script's, plus ``--device`` (CUDA unless
it says ``cpu``). Data comes from :mod:`.render`, rendered once into a
RAM/disk cache (``_build/datacache`` by default, the JAX script's names and
format; ``--render-only`` renders it and stops). Drawing needs Pillow and the
font bank; loading a cache does not, so a machine without them trains from
caches rendered elsewhere (``--cache``). Validation: greedy-decode CER on a
held-out styled set (recognition), printed during training, with a
checkpoint of the weights at every validation.

Steps, schedule and chain are the JAX script's (:mod:`.optim`), on one
device: no mesh and no batch sharding. The exported file has the JAX
script's keys, shapes, dtypes and ``meta`` (``trained_on`` names this
package's renderer) and loads in either package.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..engine import DEFAULT_ALPHABET
from ..models.detection_net import DEFAULT_INPUT_HW
from ..models.weights import load_params, params_to_jax, save_params
from ..ops.ctc import collapse_greedy_batch
from ..preprocess import BLACK_VALUE
from . import optim
from .data import DetectionDataset, RecognitionDataset, _place_sample, recognition_batches
from .train import (
    init_detection_state,
    init_recognition_state,
    make_detection_train_step,
    make_recognition_train_step,
)

REPO = Path(__file__).resolve().parents[2]
CACHE_DIR = REPO / "_build" / "datacache"


def _greedy_cer(logprobs_tnc: torch.Tensor, labels, lengths, alphabet) -> float:
    """Character error rate of greedy CTC decode vs labels."""
    lab = logprobs_tnc.argmax(dim=-1).T.cpu().numpy()  # [N, T]
    decoded = collapse_greedy_batch(lab)
    total = err = 0
    for steps, ref_lab, ref_len in zip(decoded, labels, lengths):
        hyp = [s.label for s in steps]
        ref = list(ref_lab[: int(ref_len)])
        # Levenshtein distance.
        dp = list(range(len(ref) + 1))
        for i, h in enumerate(hyp, 1):
            prev = dp[0]
            dp[0] = i
            for j, r in enumerate(ref, 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (h != r))
                prev = cur
        err += dp[-1]
        total += max(len(ref), 1)
    return err / max(total, 1)


def _render_kwargs(args) -> dict | None:
    """Renderer regime-share overrides from CLI flags (None = renderer
    defaults)."""
    kw = {}
    for name in ("blockify_prob", "pixelfont_prob", "graphics_prob", "empty_prob"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    return kw or None


def recipe(args, warmup_cap: int) -> optim.Recipe:
    """The JAX script's optimizer: global-norm clip 1.0, then AdamW (weight
    decay 1e-4) on a warmup-cosine schedule to ``args.lr`` over
    ``args.steps``."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(warmup_cap, args.steps // 2 + 1), decay_steps=args.steps + 1
    )
    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(schedule, weight_decay=1e-4))


def validation_batch(ds: RecognitionDataset) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every line of a cached set, in order and without noise, as one
    (images [N, 1, 64, width], labels, lengths) batch: a held-out set for
    :func:`train_recognition`'s ``val_batch`` where nothing can be drawn.
    Labels follow ``data.recognition_batches``' rule."""
    n = len(ds)
    images = np.full((n, 1, 64, ds.width), BLACK_VALUE, np.float32)
    labels = np.zeros((n, ds.max_label_len), np.int32)
    lengths = np.zeros((n,), np.int32)
    for i in range(n):
        crop, text = ds.get(i)
        _place_sample(images, labels, lengths, i, crop, text, ds.alphabet)
        if lengths[i] == 0 and text != "":
            images[i] = BLACK_VALUE
            labels[i, 0] = 1
            lengths[i] = 1
    return images, labels, lengths


def _run(args, state, step_fn, batches, label: str, print_every: int, on_step=None) -> dict:
    """``args.steps`` steps of `step_fn` on `batches`; each loss is read (so
    each step is fenced) and kept, with the step's wall time."""
    losses, step_s, batch_s = [], [], []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        ts = time.perf_counter()
        batch = next(batches)
        tb = time.perf_counter()
        state, loss = step_fn(state, *batch)
        losses.append(float(loss))
        te = time.perf_counter()
        step_s.append(te - ts)
        batch_s.append(tb - ts)
        if step % print_every == 0 or step == 1:
            print(f"[{label}] step {step:6d}  loss {losses[-1]:8.3f}  ({time.time() - t0:.0f}s)", flush=True)
        if on_step is not None:
            on_step(state, step)
    return {"losses": losses, "step_seconds": step_s, "batch_seconds": batch_s}


def train_recognition(args, val_batch: Optional[tuple] = None) -> dict:
    """Train a recognizer as ``args`` say. `val_batch` (images, labels,
    lengths) replaces the held-out set the JAX script draws with the
    streaming renderer (seed ``data_seed + 7919``, ``val_size`` lines).
    Returns the run's record: losses, step times, validation CERs, the
    exported file."""
    n_classes = len(DEFAULT_ALPHABET) + 1
    cache = (
        Path(args.cache)
        if args.cache
        else CACHE_DIR / f"rec_{args.samples}_{args.width}_s{args.data_seed}.npz"
    )
    print(f"dataset: {args.samples} lines (cache {cache})", flush=True)
    t0 = time.time()
    ds = RecognitionDataset(
        args.samples,
        width=args.width,
        alphabet=DEFAULT_ALPHABET,
        max_label_len=args.max_label_len,
        seed=args.data_seed,
        cache_path=cache,
        log_every=5000,
        extra_caches=args.extra_cache or None,
        render_kwargs=_render_kwargs(args),
    )
    print(f"dataset ready in {time.time() - t0:.0f}s ({len(ds)} lines)", flush=True)
    if args.render_only:
        return {"cache": str(cache), "samples": len(ds)}

    if val_batch is None:
        # Held-out validation set (different seed, streaming renderer).
        val_batch = next(
            recognition_batches(
                args.val_size,
                width=args.width,
                max_label_len=args.max_label_len,
                seed=args.data_seed + 7919,
                render_kwargs=_render_kwargs(args),
            )
        )
    val_imgs, val_labels, val_lengths = val_batch

    optimizer = recipe(args, 300)
    step_fn = make_recognition_train_step(optimizer, arch=args.arch)

    init_params = None
    if args.init_from:
        init_params, init_meta = load_params(args.init_from)
        print(f"warm start from {args.init_from} (meta {init_meta.get('arch')})", flush=True)

    def _save(state, step):
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        save_params(
            out,
            params_to_jax(state.model.net.state_dict()),
            meta={
                "kind": "recognition",
                "arch": args.arch,
                "hidden": args.hidden,
                "n_classes": n_classes,
                "alphabet": DEFAULT_ALPHABET,
                "trained_on": "styled synthetic rendered text (ocrs_tpu_torch.train.render)",
                "steps": step,
            },
        )

    state = init_recognition_state(
        optimizer,
        n_classes=n_classes,
        hidden=args.hidden,
        arch=args.arch,
        init_params=init_params,
        device=args.device,
    )
    val_on_device = torch.from_numpy(np.asarray(val_imgs, np.float32)).to(state.device)
    cers = []

    def validate(state, step):
        if step % args.val_every == 0 or step == args.steps:
            cer = _greedy_cer(state.model.run(val_on_device), val_labels, val_lengths, DEFAULT_ALPHABET)
            cers.append((step, cer))
            print(f"[recognition/{args.arch}] step {step:6d}  val CER {cer:.4f}", flush=True)
            # Checkpoint at every validation: long fine-tunes stay
            # resumable/harvestable if the run is cut short.
            _save(state, step)

    # u8 batches: crops cross to the device raw and normalize there.
    batches = ds.batches(args.batch, seed=args.data_seed + 1, as_u8=True)
    record = _run(args, state, step_fn, batches, f"recognition/{args.arch}", 200, validate)
    _save(state, args.steps)
    print(f"saved {args.output}")
    return {**record, "val_cer": cers, "val_size": len(val_labels), "output": str(args.output), "state": state}


def train_detection(args) -> dict:
    """Train the U-Net detector as ``args`` say; returns the run's record."""
    cache = (
        Path(args.cache)
        if args.cache
        else CACHE_DIR / f"det_{args.samples}_s{args.data_seed}.npz"
    )
    print(f"dataset: {args.samples} pages (cache {cache})", flush=True)
    t0 = time.time()
    kw = _render_kwargs(args) or {}
    det_kw = {
        k: v
        for k, v in {
            "figure_prob": args.figure_prob,
            "pixelfont_prob": kw.get("pixelfont_prob"),
        }.items()
        if v is not None
    }
    ds = DetectionDataset(
        args.samples, page_hw=DEFAULT_INPUT_HW, seed=args.data_seed, cache_path=cache,
        log_every=500, extra_caches=args.extra_cache or None,
        render_kwargs=det_kw or None,
    )
    print(f"dataset ready in {time.time() - t0:.0f}s ({len(ds)} pages)", flush=True)
    if args.render_only:
        return {"cache": str(cache), "samples": len(ds)}

    optimizer = recipe(args, 150)
    step_fn = make_detection_train_step(optimizer)

    init_params = None
    if args.init_from:
        init_params, _ = load_params(args.init_from)
        print(f"warm start from {args.init_from}", flush=True)

    state = init_detection_state(optimizer, init_params=init_params, device=args.device)
    # u8 batches: images/masks cross to the device raw and normalize there.
    batches = ds.batches(args.batch, seed=args.data_seed + 1, as_u8=True)
    record = _run(args, state, step_fn, batches, "detection", 100)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_params(
        out,
        params_to_jax(state.model.net.state_dict()),
        meta={
            "kind": "detection",
            "input_hw": list(DEFAULT_INPUT_HW),
            "trained_on": "styled synthetic rendered pages (ocrs_tpu_torch.train.render)",
            "steps": args.steps,
        },
    )
    print(f"saved {out}")
    return {**record, "output": str(out), "state": state}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("model", choices=["recognition", "detection"])
    parser.add_argument("--arch", default="convctc", choices=["crnn", "convctc"])
    parser.add_argument("--steps", type=int, default=16000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--width", type=int, default=768)
    parser.add_argument("--hidden", type=int, default=192)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--samples", type=int, default=60000)
    parser.add_argument("--max-label-len", type=int, default=40)
    parser.add_argument("--val-size", type=int, default=256)
    parser.add_argument("--val-every", type=int, default=2000)
    parser.add_argument("--data-seed", type=int, default=0)
    parser.add_argument(
        "--blockify-prob",
        type=float,
        default=None,
        help="override the renderer's bitmap-font regime share when "
        "rendering a fresh recognition cache (default: renderer's 0.10)",
    )
    parser.add_argument(
        "--pixelfont-prob",
        type=float,
        default=None,
        help="share of recognition samples set in the procedural pixel "
        "face (train.pixelfont; renderer default 0.0)",
    )
    parser.add_argument(
        "--graphics-prob",
        type=float,
        default=None,
        help="share of recognition crops with unlabeled legend strokes / "
        "arrows crossing the line (renderer default 0.0)",
    )
    parser.add_argument(
        "--empty-prob",
        type=float,
        default=None,
        help="share of graphics-only crops with EMPTY labels (renderer "
        "default 0.0)",
    )
    parser.add_argument(
        "--figure-prob",
        type=float,
        default=None,
        help="share of plot-like figure pages when rendering a detection "
        "cache (renderer default 0.18)",
    )
    parser.add_argument(
        "--render-only",
        action="store_true",
        help="render/cache the dataset and exit without training",
    )
    parser.add_argument("--cache", default=None, help="dataset cache .npz path")
    parser.add_argument(
        "--extra-cache",
        action="append",
        default=[],
        help="additional pre-rendered cache(s) to concatenate (recognition)",
    )
    parser.add_argument(
        "--init-from",
        default=None,
        help="warm-start from an existing .npz checkpoint (fine-tuning; "
        "arch/hidden must match)",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("-o", "--output", required=True)
    return parser


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    """The CLI's arguments, with the detector's batch capped at 16 as the
    JAX script caps it."""
    args = build_parser().parse_args(argv)
    if args.model == "detection":
        args.batch = min(args.batch, 16)
    return args


def main(argv: Optional[list[str]] = None) -> dict[str, Any]:
    args = parse_args(argv)
    return train_recognition(args) if args.model == "recognition" else train_detection(args)


if __name__ == "__main__":
    main()
