"""Command-line interface of the port.

Port of ``ocrs_tpu.cli``, flag for flag with the reference CLI
(ocrs-cli/src/main.rs:127-302):

  ``python -m ocrs_tpu_torch.cli <image> [--json] [--png] [-o PATH] [--beam]
  [--alphabet A] [--allowed-chars C] [--detect-model PATH] [--rec-model PATH]
  [--text-map] [--text-mask] [--text-line-images] [--debug] [--device DEV]
  [--version]``

Every flag of the JAX CLI keeps its meaning and default. One is added:
``--device`` (default: CUDA, the engine's default). The CPU is reached only
by asking for it; without CUDA a run that did not ask fails with the
engine's message. Differences, documented rather than hidden:

  * images are read and written by :mod:`ocrs_tpu_torch.png`: PNG needs no
    imaging package; other input formats need Pillow.
  * model files are the JAX package's ``.npz`` weights; remote URLs are
    cached under ``~/.cache/ocrs-tpu`` as models.rs:17-64 does.
  * ``--random-weights`` runs the real architectures with fresh random
    parameters (the CRNN recognizer, as in the JAX CLI).
  * ``--clipboard`` needs Pillow's clipboard reader and errors gracefully
    in headless environments (main.rs:312-364 uses arboard).
  * ``--debug`` also prints the stages' times (``StageTimer``, fenced on
    the device) to standard error.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .png import decode_image, write_png


def _read_image(path: str) -> np.ndarray:
    """Decode an image file (or stdin when path is '-') to HWC u8 RGB."""
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        try:
            data = Path(path).read_bytes()
        except OSError as exc:
            raise SystemExit(f"error: cannot read {path}: {exc}") from exc
    return decode_image(data)


def _read_clipboard_image() -> np.ndarray:
    """Read an image from the system clipboard (main.rs:312-364). Errors
    gracefully in headless environments."""
    try:
        from PIL import ImageGrab

        img = ImageGrab.grabclipboard()
    except Exception as exc:  # noqa: BLE001 - any failure means no clipboard
        raise SystemExit(f"error: clipboard unavailable: {exc}")
    if img is None:
        raise SystemExit("error: no image in clipboard")
    return np.asarray(img.convert("RGB"))


def _save_grey_png(path: Path, arr01: np.ndarray) -> None:
    write_png(path, (np.clip(arr01, 0.0, 1.0) * 255).astype(np.uint8))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocrs-tpu-torch",
        description="Extract text from images (PyTorch/CUDA port of ocrs-tpu).",
    )
    p.add_argument("image", nargs="?", default=None, help="Image path; omit or use '-' to read from stdin")
    p.add_argument("-j", "--json", action="store_true", help="Output JSON (HierText-style)")
    p.add_argument("-p", "--png", action="store_true", help="Output annotated PNG")
    p.add_argument("-o", "--output", default=None, help="Output file (default stdout)")
    p.add_argument("--beam", action="store_true", help="Use beam search decoding (width 100)")
    p.add_argument("-c", "--clipboard", action="store_true", help="Read image from system clipboard")
    p.add_argument("-a", "--alphabet", default=None, help="Override recognition alphabet")
    p.add_argument("--allowed-chars", default=None, help="Restrict recognized output to these characters")
    p.add_argument("--detect-model", default=None, help="Detection model (.npz path or URL)")
    p.add_argument("--rec-model", default=None, help="Recognition model (.npz path or URL)")
    p.add_argument("--text-map", action="store_true", help="Save text probability map PNG")
    p.add_argument("--text-mask", action="store_true", help="Save binary text mask PNG")
    p.add_argument("--text-line-images", action="store_true", help="Save extracted line images to lines/")
    p.add_argument("--debug", action="store_true", help="Print per-stage timings and counts")
    p.add_argument(
        "--random-weights",
        action="store_true",
        help="Use randomly-initialized models (pipeline smoke test)",
    )
    p.add_argument(
        "--fake-models",
        action="store_true",
        help=argparse.SUPPRESS,  # deterministic test models for golden E2E tests
    )
    p.add_argument(
        "--serve",
        metavar="PORT",
        type=int,
        default=None,
        help="Start the HTTP serving API on PORT instead of processing an "
        "image (see ocrs_tpu_torch.serve; the js/ client targets this)",
    )
    p.add_argument(
        "--deskew",
        action="store_true",
        help="Deskew rotated text lines before recognition (affine line warp; no reference counterpart)",
    )
    p.add_argument(
        "--vertical-text",
        action="store_true",
        help="Read 90-degree-rotated text lines (e.g. chart y-axis labels): "
        "layout assembles vertical word stacks and recognition decodes both "
        "reading directions, keeping the higher-confidence one (no "
        "reference counterpart)",
    )
    p.add_argument(
        "--min-line-conf",
        type=float,
        default=None,
        metavar="P",
        help="Drop decoded lines whose character-frame confidence is below "
        "P in (0, 1] — suppresses graphics strokes (plot curves, table "
        "rules) decoded as glyph soup; ~0.45 keeps real text (no reference "
        "counterpart)",
    )
    p.add_argument(
        "--rule-glyph",
        default=None,
        metavar="CH",
        help="Reference-parity mode for ink rules (heading underlines, "
        "horizontal separators): emit CH for each rule the text detector "
        "ignored — the reference's pipeline detects such rules and decodes "
        "them as '[' (its why-rust golden). Default: skip rules",
    )
    p.add_argument(
        "--device",
        default=None,
        help="Device to run on, e.g. cuda, cuda:1 or cpu (default: cuda; there is no fallback to the CPU)",
    )
    p.add_argument("--version", action="version", version="ocrs-tpu-torch 0.1.0")
    return p


def _load_models(args):
    from .models.detection_net import DetectionModel
    from .models.recognition_net import RecognitionModel

    if args.fake_models:
        from .engine import DEFAULT_ALPHABET
        from .models.fakes import FakeDetectionModel, FakeRecognitionModel

        if args.alphabet is None:
            # The fake recognizer has 64 classes = blank + 63 alphabet chars.
            args.alphabet = DEFAULT_ALPHABET[:63]
        return FakeDetectionModel(), FakeRecognitionModel()
    if args.random_weights:
        return DetectionModel.create(0), RecognitionModel.create(0)

    # Default weights: the checkpoints shipped in <repo>/weights (the
    # reference CLI's default-model behaviour, models.rs:100-107, minus the
    # network download).
    if not args.detect_model or not args.rec_model:
        weights_dir = Path(__file__).resolve().parent.parent / "weights"
        det_default = weights_dir / "text-detection.npz"
        rec_default = weights_dir / "text-recognition.npz"
        if det_default.exists() and rec_default.exists():
            args.detect_model = args.detect_model or str(det_default)
            args.rec_model = args.rec_model or str(rec_default)
        else:
            raise SystemExit(
                "error: --detect-model and --rec-model are required (ocrs-tpu "
                "uses .npz weights; train them with tools/train_models.py, or "
                "pass --random-weights for a smoke test with untrained models)"
            )
    from .models.weights import load_detection_model, load_recognition_model

    return load_detection_model(args.detect_model), load_recognition_model(args.rec_model)


def _device(args):
    """The engine's device: --device, CUDA by default. Without CUDA a run on
    CUDA ends with the engine's message; there is no fallback to the CPU."""
    from .engine import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (on the command line: --device cpu)") from exc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .engine import OcrEngine, OcrEngineParams
    from .output import FormatJsonArgs, format_json_output, format_text_output, generate_annotated_png
    from .preprocess import DimOrder, ImageSource
    from .recognition import BeamSearch, Greedy
    from .utils.tracing import StageTimer

    det, rec = _load_models(args)

    if args.serve is not None:
        from .serve import serve

        engine = OcrEngine(
            OcrEngineParams(
                detection_model=det,
                recognition_model=rec,
                debug=args.debug,
                decode_method=BeamSearch(width=100) if args.beam else Greedy(),
                alphabet=args.alphabet,
                allowed_chars=args.allowed_chars,
            ),
            device=_device(args),
        )
        server = serve(engine, host="0.0.0.0", port=args.serve)
        print(
            f"serving OCR API on :{server.server_address[1]} "
            "(POST /ocr, /ocr/text, /ocr/detect, /session; GET /healthz)",
            file=sys.stderr,
        )
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            server.shutdown()
            server.server_close()
        return 0

    if args.clipboard:
        if args.image is not None:
            raise SystemExit("error: cannot use both --clipboard and an image path")
        image = _read_clipboard_image()
    else:
        src = args.image if args.image is not None else "-"
        if src == "-" and sys.stdin.isatty():
            raise SystemExit("error: no image path given and stdin is not a pipe")
        image = _read_image(src)
    h, w = image.shape[:2]
    engine = OcrEngine(
        OcrEngineParams(
            detection_model=det,
            recognition_model=rec,
            debug=args.debug,
            decode_method=BeamSearch(width=100) if args.beam else Greedy(),
            alphabet=args.alphabet,
            allowed_chars=args.allowed_chars,
            deskew=args.deskew,
            vertical_text=args.vertical_text,
            min_line_confidence=args.min_line_conf,
            rule_glyph=args.rule_glyph,
        ),
        device=_device(args),
    )

    inp = engine.prepare_input(ImageSource.from_tensor(image, DimOrder.HWC))

    if args.text_map or args.text_mask:
        probs = engine.detect_text_pixels(inp).float().cpu().numpy()
        if args.text_map:
            _save_grey_png(Path("text-map.png"), probs)
            print("Wrote text-map.png", file=sys.stderr)
        if args.text_mask:
            _save_grey_png(Path("text-mask.png"), (probs > engine.detection_threshold()).astype(np.float32))
            print("Wrote text-mask.png", file=sys.stderr)

    # Stage times end with a fence on the engine's device, so that each holds
    # its device work; they are printed under --debug.
    timer = StageTimer(fence_device=engine.device)
    with timer.stage("detect_words"):
        words = engine.detect_words(inp)
    with timer.stage("find_text_lines"):
        lines = engine.find_text_lines(inp, words)

    if args.text_line_images:
        out_dir = Path("lines")
        out_dir.mkdir(exist_ok=True)
        for i, line in enumerate(lines):
            crop = engine.prepare_recognition_input(inp, line)
            _save_grey_png(out_dir / f"line-{i}.png", crop + 0.5)
        print(f"Wrote {len(lines)} line images to lines/", file=sys.stderr)

    with timer.stage("recognize_text"):
        text_lines = engine.recognize_text(inp, lines)

    if args.png:
        annotated = generate_annotated_png(image, lines, text_lines)
        out_path = args.output or "ocr-annotated.png"
        write_png(out_path, annotated)
        print(f"Wrote {out_path}", file=sys.stderr)
        content = None
    elif args.json:
        content = format_json_output(FormatJsonArgs(input_path=args.image, input_hw=(h, w), text_lines=text_lines))
    else:
        content = format_text_output(text_lines)

    if content is not None:
        if args.output:
            Path(args.output).write_text(content + "\n")
        else:
            print(content)

    if args.debug:
        n_recognized = sum(1 for l in text_lines if l is not None)
        print(f"Found {len(words)} words, {len(lines)} lines, recognized {n_recognized} lines", file=sys.stderr)
        print(f"Stage times: {timer.summary()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
