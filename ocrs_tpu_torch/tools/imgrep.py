"""imgrep: search for text in images: the port of ``tools/imgrep.py``.

OCR every image given, and every image under each directory given, and
print each line that holds PATTERN (case-insensitive) as ``path:line: text``.

    python -m ocrs_tpu_torch.tools.imgrep PATTERN file1.png dir2/ ... [--device cpu]

The weights come from the OCRS_TPU_DETECT_MODEL / OCRS_TPU_REC_MODEL
environment variables, else from the repository's ``weights/``, else random
weights (noise output, with a warning). Exit code 0 when a line matched, 1
when none did, 2 on a usage error. ``--device`` (anywhere after PATTERN)
picks the engine's device: CUDA by default, with no fallback to the CPU.

Images are decoded by :func:`ocrs_tpu_torch.png.decode_image`: PNG needs no
imaging package, other formats need Pillow. An image that cannot be decoded
or read prints ``path: error: ...`` to standard error and the search goes on
(the JAX tool stops at an image it cannot decode).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif"}

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"


def iter_images(paths):
    for p in map(Path, paths):
        if p.is_dir():
            yield from (f for f in sorted(p.rglob("*")) if f.suffix.lower() in IMAGE_EXTS)
        elif p.suffix.lower() in IMAGE_EXTS:
            yield p


def _split_device(argv: list[str]) -> tuple[list[str], str | None]:
    """`argv` without ``--device DEV`` / ``--device=DEV``, and DEV."""
    rest, device, i = [], None, 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
        i += 1
    return rest, device


def main(argv=None) -> int:
    argv, device = _split_device(list(sys.argv[1:] if argv is None else argv))
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    pattern = argv[0].lower()

    from ..engine import OcrEngine, OcrEngineParams
    from ..models.detection_net import DetectionModel
    from ..models.recognition_net import RecognitionModel
    from ..models.weights import load_detection_model, load_params, load_recognition_model
    from ..png import decode_image
    from ..preprocess import DimOrder, ImageSource
    from ..cli import device_or_exit

    det_src = os.environ.get("OCRS_TPU_DETECT_MODEL") or (
        str(WEIGHTS_DIR / "text-detection.npz") if (WEIGHTS_DIR / "text-detection.npz").exists() else None
    )
    rec_src = os.environ.get("OCRS_TPU_REC_MODEL") or (
        str(WEIGHTS_DIR / "text-recognition.npz") if (WEIGHTS_DIR / "text-recognition.npz").exists() else None
    )
    alphabet = None
    if det_src and rec_src:
        det = load_detection_model(det_src)
        rec = load_recognition_model(rec_src)
        _, rec_meta = load_params(rec_src)
        alphabet = rec_meta.get("alphabet")
    else:
        print("warning: no weights found; using random weights", file=sys.stderr)
        det, rec = DetectionModel.create(0), RecognitionModel.create(0)

    engine = OcrEngine(
        OcrEngineParams(detection_model=det, recognition_model=rec, alphabet=alphabet),
        device=device_or_exit(device),
    )

    found = 0
    for image_path in iter_images(argv[1:]):
        try:
            img = decode_image(image_path.read_bytes())
            inp = engine.prepare_input(ImageSource.from_tensor(img, DimOrder.HWC))
            text = engine.get_text(inp)
        except Exception as exc:  # noqa: BLE001
            print(f"{image_path}: error: {exc}", file=sys.stderr)
            continue
        for line_no, line in enumerate(text.splitlines(), 1):
            if pattern in line.lower():
                print(f"{image_path}:{line_no}: {line}")
                found += 1
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
