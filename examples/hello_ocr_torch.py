"""Library usage example of the PyTorch/CUDA port (counterpart of
examples/hello_ocr.py and ocrs/examples/hello_ocr.rs:1-96).

Loads models, prepares an image, and prints each recognized line with its
bounding box. PNG images are read by ``ocrs_tpu_torch.png``, so no imaging
package is needed. With the shipped weights, on the GPU:

    python examples/hello_ocr_torch.py image.png weights/text-detection.npz weights/text-recognition.npz

on the CPU (the kernels' plain versions): add ``--device cpu``. Without
weights the real architectures run with random weights (the output is noise):

    python examples/hello_ocr_torch.py image.png --device cpu
"""

import argparse
import sys
from pathlib import Path

# Self-locating: runnable as `python examples/hello_ocr_torch.py` from anywhere.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
from ocrs_tpu_torch.models.detection_net import DetectionModel
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
from ocrs_tpu_torch.png import decode_image
from ocrs_tpu_torch.preprocess import DimOrder, ImageSource


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("image")
    parser.add_argument("models", nargs="*", help="detect.npz rec.npz")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()

    if len(args.models) >= 2:
        detection_model = load_detection_model(args.models[0])
        recognition_model = load_recognition_model(args.models[1])
    else:
        print("(no weights given: using random weights — output will be noise)")
        detection_model = DetectionModel.create(0)
        recognition_model = RecognitionModel.create(0)

    engine = OcrEngine(
        OcrEngineParams(detection_model=detection_model, recognition_model=recognition_model),
        device=args.device,
    )

    img = decode_image(Path(args.image).read_bytes())
    ocr_input = engine.prepare_input(ImageSource.from_tensor(img, DimOrder.HWC))

    word_rects = engine.detect_words(ocr_input)
    line_rects = engine.find_text_lines(ocr_input, word_rects)
    line_texts = engine.recognize_text(ocr_input, line_rects)

    for line in line_texts:
        if line is None:
            continue
        br = line.bounding_rect()
        print(f"[{br.left:.0f},{br.top:.0f} {br.width:.0f}x{br.height:.0f}] {line}")


if __name__ == "__main__":
    main()
