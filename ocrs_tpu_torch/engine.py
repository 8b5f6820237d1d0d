"""OcrEngine: the public pipeline facade of the port.

Port of ``ocrs_tpu.engine`` (upstream ocrs/src/lib.rs:130-301):
``prepare_input``, ``detect_words``, ``detect_text_pixels``,
``find_text_lines``, ``recognize_text``, ``prepare_recognition_input``,
``detection_threshold`` and ``get_text``, with the same configuration surface
(``OcrEngineParams``).

The engine runs on one ``torch.device``, CUDA unless the caller asks for
another; asking for CUDA where there is none raises instead of falling back
to the CPU. ``OcrEngineParams`` has the JAX engine's fields and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Literal, Optional, Sequence

import numpy as np
import torch

from .detection import RuleRect, TextDetector, TextDetectorParams, find_ink_rules
from .errors import ModelNotLoadedError
from .geometry import RotatedRect
from .layout import find_text_lines, is_vertical_line, merge_vertical_chains
from .models.protocol import Model
from .preprocess import ImageSource, prepare_image
from .recognition import (
    DecodeMethod,
    Greedy,
    RecognitionOpt,
    TextRecognizer,
    arbitrate_word_gaps,
    single_bucket,
)
from .text_items import TextChar, TextLine
from .utils.tracing import StageTimer

#: Characters the recognition model was trained on; label i (>=1) maps to
#: DEFAULT_ALPHABET[i-1], label 0 is the CTC blank (lib.rs:33-34).
DEFAULT_ALPHABET = (
    " 0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~€"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The engine's device: CUDA when `device` is None. Raises when CUDA is
    asked for and not available; there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ocrs_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


@dataclass
class OcrEngineParams:
    """Engine configuration (lib.rs:38-71) plus the JAX engine's extensions."""

    detection_model: Optional[Model] = None
    recognition_model: Optional[Model] = None
    debug: bool = False
    decode_method: DecodeMethod = field(default_factory=Greedy)
    alphabet: Optional[str] = None
    allowed_chars: Optional[str] = None

    detector_params: TextDetectorParams = field(default_factory=TextDetectorParams)
    #: "host": exact scipy connected components + rotating calipers.
    #: "device": labelling by pixel sweeps + segmented rect fitting on the
    #: engine's device. "multigrid": the same with connectivity solved at half
    #: resolution on the run graph.
    detection_postprocess: Literal["host", "device", "multigrid"] = "multigrid"
    #: "model": post-process the model-resolution mask and scale the rects.
    #: "page": threshold the page-resolution probability map (upstream shape).
    detection_postprocess_resolution: Literal["page", "model"] = "model"
    #: Run the detector on overlapping native-resolution tiles instead of
    #: downscaling (keeps small text on very large pages).
    detection_tiled: bool = False
    detection_tile_overlap: int = 64
    #: Maps a resized line width to its padded bucket width; None = one
    #: bucket (one recognition batch per image). ``recognition.WIDTH_LADDER``
    #: with ``ladder_bucket`` suits throughput batching and
    #: ``recognition.reference_bucket`` gives upstream's multiples of 50.
    recognition_width_bucket: Optional[Callable[[int], int]] = None
    max_lines_per_batch: int = 20
    #: Crop each line along its min-area ROTATED rect
    #: (:func:`ops.warp.extract_line_batch_rotated`) so slanted text reaches
    #: the recognizer upright. Char rects are the bounding boxes of the
    #: slanted char slices. No upstream counterpart.
    deskew: bool = False
    #: Vertical text (90-degree-rotated lines, e.g. a plot's y-axis label).
    #: Layout assembles vertically stacked word fragments into vertical lines
    #: (:func:`layout.merge_vertical_chains`); recognition crops them along
    #: the rotated rect in BOTH reading directions and keeps the
    #: higher-confidence decode.
    vertical_text: bool = False
    #: Drop decoded lines whose character-frame confidence
    #: (:func:`ops.ctc.text_confidence`) is below this, in (0, 1]; None = off.
    min_line_confidence: Optional[float] = None
    #: Emit this glyph for ink rules (heading underlines, horizontal
    #: separators) that the detector ignores, as upstream's pipeline decodes
    #: them (:func:`detection.find_ink_rules`); None = off.
    rule_glyph: Optional[str] = None
    #: Insert missing spaces at DETECTED word boundaries
    #: (:func:`recognition.arbitrate_word_gaps`).
    detection_word_spaces: bool = False


class OcrInput:
    """A prepared input image (lib.rs:121-126): (1, H, W) float32 in
    [-0.5, 0.5] on the engine's device."""

    def __init__(self, image: torch.Tensor):
        self.image = image


class OcrEngine:
    """Detects and recognizes text in images (lib.rs:108-301)."""

    def __init__(self, params: OcrEngineParams | None = None, *, device: torch.device | str | None = None):
        params = params or OcrEngineParams()
        self.device = resolve_device(device)
        for model in (params.detection_model, params.recognition_model):
            if isinstance(model, torch.nn.Module):
                model.to(self.device)
        self._detector = (
            TextDetector(
                params.detection_model,
                params.detector_params,
                postprocess=params.detection_postprocess,
                postprocess_resolution=params.detection_postprocess_resolution,
                tiled=params.detection_tiled,
                tile_overlap=params.detection_tile_overlap,
            )
            if params.detection_model is not None
            else None
        )
        self._recognizer = (
            TextRecognizer(
                params.recognition_model,
                width_bucket=params.recognition_width_bucket or single_bucket,
                max_lines_per_batch=params.max_lines_per_batch,
                deskew=params.deskew,
            )
            if params.recognition_model is not None
            else None
        )
        self._debug = params.debug
        self._rule_glyph = params.rule_glyph
        self._detection_word_spaces = params.detection_word_spaces
        self._vertical_text = params.vertical_text
        self._min_line_confidence = params.min_line_confidence
        self._decode_method = params.decode_method
        self._alphabet = params.alphabet or DEFAULT_ALPHABET
        # Label i (>=1) maps to alphabet[i-1] (lib.rs:153-170).
        self._excluded_char_labels: Optional[list[int]] = None
        if params.allowed_chars is not None:
            allowed = set(params.allowed_chars)
            self._excluded_char_labels = [
                i + 1 for i, ch in enumerate(self._alphabet) if ch not in allowed
            ]

    def prepare_input(self, image: ImageSource) -> OcrInput:
        """Normalize an image for the other engine methods (lib.rs:183-188)."""
        return OcrInput(prepare_image(image, self.device))

    def detect_words(self, input: OcrInput) -> list[RotatedRect]:
        """Unordered oriented bounding rects of words (lib.rs:190-199).

        With ``rule_glyph`` set, ink rules the detector ignored are appended
        as :class:`~.detection.RuleRect` entries, so layout orders them with
        the text and recognition emits the configured glyph."""
        if self._detector is None:
            raise ModelNotLoadedError("Detection model not loaded")
        words = self._detector.detect_words(input.image)
        if self._rule_glyph is not None:
            words = words + find_ink_rules(input.image, words)
        return words

    def detect_text_pixels(self, input: OcrInput) -> torch.Tensor:
        """(H, W) per-pixel text probability map (lib.rs:201-214)."""
        if self._detector is None:
            raise ModelNotLoadedError("Detection model not loaded")
        return self._detector.detect_text_pixels(input.image)

    def find_text_lines(
        self, input: OcrInput, words: Sequence[RotatedRect]
    ) -> list[list[RotatedRect]]:
        """Group words into reading-order lines (lib.rs:216-229)."""
        del input  # kept for API parity
        lines = find_text_lines(words)
        if self._vertical_text:
            lines, _ = merge_vertical_chains(lines)
        return lines

    def recognize_text(
        self, input: OcrInput, lines: Sequence[Sequence[RotatedRect]]
    ) -> list[Optional[TextLine]]:
        """Recognize text lines; entries are None when nothing was decoded
        (lib.rs:231-254)."""
        if self._recognizer is None:
            raise ModelNotLoadedError("Recognition model not loaded")
        # Lines made of ink rules take the configured glyph instead of a
        # model pass.
        rule_lines: dict[int, TextLine] = {}
        if self._rule_glyph is not None:
            rule_lines = {
                i: TextLine([TextChar(self._rule_glyph, r.bounding_rect()) for r in ws])
                for i, ws in enumerate(lines)
                if ws and all(isinstance(r, RuleRect) for r in ws)
            }
        model_lines = [(i, ws) for i, ws in enumerate(lines) if i not in rule_lines]
        lines_to_run = [ws for _, ws in model_lines]
        vertical = None
        if self._vertical_text:
            vertical = [is_vertical_line(ws) for ws in lines_to_run]
        recognized = self._recognizer.recognize_text_lines(
            input.image,
            lines_to_run,
            RecognitionOpt(
                debug=self._debug,
                decode_method=self._decode_method,
                alphabet=self._alphabet,
                excluded_char_labels=self._excluded_char_labels,
                min_line_confidence=self._min_line_confidence,
            ),
            vertical=vertical,
        )
        if self._detection_word_spaces:
            recognized = [
                tl if (vertical is not None and vertical[i]) else arbitrate_word_gaps(lines_to_run[i], tl)
                for i, tl in enumerate(recognized)
            ]
        if not rule_lines:
            return recognized
        out: list[Optional[TextLine]] = [None] * len(lines)
        for (i, _), tl in zip(model_lines, recognized):
            out[i] = tl
        for i, tl in rule_lines.items():
            out[i] = tl
        return out

    def prepare_recognition_input(
        self, input: OcrInput, line: Sequence[RotatedRect]
    ) -> np.ndarray:
        """Debug API exposing recognition preprocessing (lib.rs:256-276)."""
        if self._recognizer is None:
            raise ModelNotLoadedError("Recognition model not loaded")
        return self._recognizer.prepare_input(input.image, line)

    def detection_threshold(self) -> float:
        """Pixel-probability threshold used by detection (lib.rs:278-286)."""
        if self._detector is not None:
            return self._detector.threshold
        return TextDetectorParams().text_threshold

    def get_text(self, input: OcrInput) -> str:
        """Full pipeline: all text in the image as one string (lib.rs:288-300).

        With ``debug=True`` prints each stage's wall time, fenced on the
        engine's device so that it holds the stage's device work, and a
        summary (the reference's per-op timing dump, detection.rs:177-182)."""
        timer = StageTimer(debug=self._debug, fence_device=self.device if self._debug else None)
        with timer.stage("detect_words"):
            words = self.detect_words(input)
        with timer.stage("find_text_lines"):
            lines = self.find_text_lines(input, words)
        with timer.stage("recognize_text"):
            recognized = self.recognize_text(input, lines)
        if self._debug:
            print(f"[ocrs_tpu_torch] {len(words)} words, {len(lines)} lines; " + timer.summary())
        return "\n".join(str(line) for line in recognized if line is not None)
