"""ocrs_tpu_torch: the PyTorch and CUDA port of ``ocrs_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module names. Plain tensor
code is PyTorch; each kernel that ``ocrs_tpu`` wrote in Pallas for the TPU is
a hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` at first use.
The engine (one image at a time) and the page pipeline (groups of pages, the
throughput path) run on CUDA unless the caller passes ``device="cpu"``, where
every kernel's plain PyTorch version runs instead.

Public API mirrors the upstream engine surface (ocrs/src/lib.rs:130-301).
"""

from .engine import DEFAULT_ALPHABET, OcrEngine, OcrEngineParams, OcrInput
from .errors import (
    ImageSourceError,
    ModelNotLoadedError,
    ModelRunError,
    OcrError,
    WrongOutputError,
)
from .geometry import Line, Rect, RotatedRect, min_area_rect
from .parallel.pipeline import PagePipeline, PageResult
from .preprocess import BLACK_VALUE, DimOrder, ImageSource, prepare_image

__version__ = "0.1.0"

__all__ = [
    "BLACK_VALUE",
    "DEFAULT_ALPHABET",
    "DimOrder",
    "ImageSource",
    "ImageSourceError",
    "Line",
    "ModelNotLoadedError",
    "ModelRunError",
    "OcrEngine",
    "OcrEngineParams",
    "OcrError",
    "OcrInput",
    "PagePipeline",
    "PageResult",
    "Rect",
    "RotatedRect",
    "WrongOutputError",
    "min_area_rect",
    "prepare_image",
]
