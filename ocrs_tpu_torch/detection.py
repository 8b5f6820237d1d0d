"""Text detection: the U-Net pass plus mask post-processing.

Port of ``ocrs_tpu.detection`` (upstream ocrs/src/detection.rs:104-200):

  1. Pad the greyscale page bottom/right with ``BLACK_VALUE`` up to the
     model's fixed input size (small images are padded, not upscaled).
  2. Bilinear-resize to the model input size (:func:`ops.resize.resize_bilinear`).
  3. Run the segmentation model -> per-pixel text probability map.
  4. Threshold (default 0.2) -> binary mask -> connected components ->
     min-area rotated rects, expanded by 3 px per side, filtered by min
     area 100.

Step 4 runs either on the host (``postprocess="host"``: scipy labelling +
rotating calipers) or on the model's device (``"device"``, ``"multigrid"``:
:mod:`.ops.connected_components` and :mod:`.ops.rects`, only the rect table
crosses to the host), on the model-resolution mask with the rects scaled to
page coordinates (``postprocess_resolution="model"``, the engine default) or
on the page-resolution map (``"page"``). Pages larger than the model input
can be run as overlapping native-resolution tiles (``tiled``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import RotatedRect, min_area_rect
from .models.protocol import Model, fixed_hw
from .ops import rects as device_rects
from .ops.connected_components import component_boundary_points, label_components_host
from .ops.resize import resize_bilinear
from .preprocess import BLACK_VALUE


@dataclass(frozen=True)
class TextDetectorParams:
    """Post-processing knobs (detection.rs:12-37)."""

    min_area: float = 100.0
    text_threshold: float = 0.2


#: Distance (px) to expand each detected word rect per side; the model is
#: trained to under-segment to separate adjacent words (detection.rs:108-117).
EXPAND_DIST = 3.0


def rects_from_mask_host(
    mask: np.ndarray, expand_dist: float, min_area: float
) -> list[RotatedRect]:
    """Connected components -> min-area rects (``find_connected_component_rects``,
    detection.rs:41-62): fit the min-area rect of each component's boundary,
    grow width/height by ``2 * expand_dist`` and drop rects below
    ``min_area``."""
    labels, count = label_components_host(mask)
    out: list[RotatedRect] = []
    for pts in component_boundary_points(labels, count):
        rect = min_area_rect(pts)
        if rect is None:
            continue
        rect.resize(rect.width + 2.0 * expand_dist, rect.height + 2.0 * expand_dist)
        if rect.area() >= min_area:
            out.append(rect)
    return out


class TextDetector:
    """Finds oriented bounding boxes of words in an image."""

    def __init__(
        self,
        model: Model,
        params: TextDetectorParams = TextDetectorParams(),
        postprocess: Literal["host", "device", "multigrid"] = "multigrid",
        postprocess_resolution: Literal["page", "model"] = "model",
        tiled: bool = False,
        tile_overlap: int = 64,
    ):
        if postprocess not in ("host", "device", "multigrid"):
            raise ValueError(f"unknown postprocess {postprocess!r}")
        if postprocess_resolution not in ("page", "model"):
            raise ValueError(f"unknown postprocess_resolution {postprocess_resolution!r}")
        self._model = model
        self._params = params
        self._input_hw = fixed_hw(model.input_shape())
        self._postprocess = postprocess
        self._post_res = postprocess_resolution
        self._tiled = tiled
        self._tile_overlap = tile_overlap

    @property
    def threshold(self) -> float:
        return self._params.text_threshold

    @property
    def input_hw(self) -> tuple[int, int]:
        return self._input_hw

    def _pads(self, image: torch.Tensor) -> tuple[int, int]:
        if image.dim() != 3 or image.shape[0] != 1:
            raise ValueError(f"expected (1, H, W) image, got {tuple(image.shape)}")
        in_h, in_w = self._input_hw
        return max(in_h - image.shape[1], 0), max(in_w - image.shape[2], 0)

    def _runs_tiled(self, image: torch.Tensor) -> bool:
        in_h, in_w = self._input_hw
        return self._tiled and (image.shape[1] > in_h or image.shape[2] > in_w)

    def detect_text_pixels(self, image: torch.Tensor) -> torch.Tensor:
        """(1, H, W) normalized greyscale -> (H, W) text probability map."""
        pads = self._pads(image)
        in_h, in_w = self._input_hw
        if self._runs_tiled(image):
            # Overlapping native-resolution tiles, max-blended: keeps small
            # text detectable on very large pages, which the single pass
            # would downscale.
            offsets = _tile_offsets(tuple(image.shape[1:]), self._input_hw, self._tile_overlap)
            return _tiled_probs(image, model=self._model, input_hw=self._input_hw, offsets=offsets)
        probs = self._model.run(_pre(image, self._input_hw, pads))
        return _post(probs, out_hw=tuple(image.shape[1:]), crop_hw=(in_h - pads[0], in_w - pads[1]))

    def detect_words(self, image: torch.Tensor) -> list[RotatedRect]:
        """(1, H, W) normalized greyscale -> unordered word rects."""
        # Tiled detection already gives a page-resolution map at native scale;
        # "model" resolution only applies to the single-pass squeeze.
        if self._post_res == "model" and not self._runs_tiled(image):
            return self._detect_words_model_res(image)
        probs = self.detect_text_pixels(image)
        if self._postprocess in ("device", "multigrid"):
            return device_rects.rects_from_mask_device(
                probs > self._params.text_threshold,
                expand_dist=EXPAND_DIST,
                min_area=self._params.min_area,
                multigrid=self._postprocess == "multigrid",
            )
        mask = probs.cpu().numpy() > self._params.text_threshold
        return rects_from_mask_host(mask, expand_dist=EXPAND_DIST, min_area=self._params.min_area)

    def _detect_words_model_res(self, image: torch.Tensor) -> list[RotatedRect]:
        """Post-process at model resolution, then scale rects to page
        coordinates. Expansion and area filtering happen in page space so
        the thresholds keep their upstream meaning."""
        _, img_h, img_w = image.shape
        pad_bottom, pad_right = self._pads(image)
        in_h, in_w = self._input_hw
        crop_h, crop_w = in_h - pad_bottom, in_w - pad_right
        probs = self._model.run(_pre(image, self._input_hw, (pad_bottom, pad_right)))
        if self._postprocess in ("device", "multigrid"):
            mask = _threshold_crop(probs, crop_hw=(crop_h, crop_w), threshold=self._params.text_threshold)
            raw = device_rects.rects_from_mask_device(
                mask, expand_dist=0.0, min_area=0.0, multigrid=self._postprocess == "multigrid"
            )
        else:
            p = probs.reshape(in_h, in_w)[:crop_h, :crop_w].cpu().numpy()
            raw = rects_from_mask_host(p > self._params.text_threshold, expand_dist=0.0, min_area=0.0)

        # The expansion compensates the model's trained under-segmentation, a
        # model-resolution quantity, so in page coordinates it scales with the
        # resize factor.
        sx, sy = img_w / crop_w, img_h / crop_h
        ex, ey = EXPAND_DIST * sx, EXPAND_DIST * sy
        scale = np.array([sx, sy])
        out: list[RotatedRect] = []
        for rect in raw:
            scaled = min_area_rect(np.stack(rect.corners()) * scale[None, :])
            assert scaled is not None
            scaled.resize(scaled.width + 2.0 * ex, scaled.height + 2.0 * ey)
            if scaled.area() >= self._params.min_area:
                out.append(scaled)
        return out


def _pre(image: torch.Tensor, input_hw: tuple[int, int], pads: tuple[int, int]) -> torch.Tensor:
    """Pad bottom/right with BLACK_VALUE, then resize to the model input size
    (detection.rs:155-171). (1, H, W) -> [1, 1, in_h, in_w]."""
    pad_bottom, pad_right = pads
    x = image[None]
    if pad_bottom or pad_right:
        x = F.pad(x, (0, pad_right, 0, pad_bottom), value=BLACK_VALUE)
    if tuple(x.shape[-2:]) != tuple(input_hw):
        x = resize_bilinear(x, input_hw)
    return x


def _tile_offsets(
    page_hw: tuple[int, int], tile_hw: tuple[int, int], overlap: int
) -> tuple[tuple[int, int], ...]:
    """Top-left offsets of overlapping tiles covering the page; the final
    row/column is clamped so tiles never run past the edge."""
    ph, pw = page_hw
    th, tw = tile_hw
    step_y = max(th - overlap, 1)
    step_x = max(tw - overlap, 1)
    ys = list(range(0, max(ph - th, 0) + 1, step_y))
    xs = list(range(0, max(pw - tw, 0) + 1, step_x))
    if ys[-1] + th < ph:
        ys.append(ph - th)
    if xs[-1] + tw < pw:
        xs.append(pw - tw)
    ys = [min(y, max(ph - th, 0)) for y in ys]
    xs = [min(x, max(pw - tw, 0)) for x in xs]
    return tuple((y, x) for y in dict.fromkeys(ys) for x in dict.fromkeys(xs))


def _extract_tiles(
    image: torch.Tensor, *, input_hw: tuple[int, int], offsets: tuple[tuple[int, int], ...]
) -> torch.Tensor:
    """[1, H, W] page -> [T, 1, th, tw] batch of overlapping tiles."""
    _, img_h, img_w = image.shape
    th, tw = input_hw
    pad_b, pad_r = max(th - img_h, 0), max(tw - img_w, 0)
    page = image[0]
    if pad_b or pad_r:
        page = F.pad(page, (0, pad_r, 0, pad_b), value=BLACK_VALUE)
    return torch.stack([page[y : y + th, x : x + tw] for (y, x) in offsets])[:, None]


def _stitch_tiles(
    probs: torch.Tensor, *, page_hw: tuple[int, int], offsets: tuple[tuple[int, int], ...]
) -> torch.Tensor:
    """Max-blend [T, 1, th, tw] tile probabilities back onto the page."""
    img_h, img_w = page_hw
    _, _, th, tw = probs.shape
    out = probs.new_zeros(
        (max(img_h, th + max(y for y, _ in offsets)), max(img_w, tw + max(x for _, x in offsets)))
    )
    for i, (y, x) in enumerate(offsets):
        region = out[y : y + th, x : x + tw]
        torch.maximum(region, probs[i, 0], out=region)
    return out[:img_h, :img_w]


def _tiled_probs(
    image: torch.Tensor, *, model: Model, input_hw: tuple[int, int], offsets: tuple[tuple[int, int], ...]
) -> torch.Tensor:
    """Batch overlapping tiles through the model; stitch with max-blend."""
    probs = model.run(_extract_tiles(image, input_hw=input_hw, offsets=offsets))
    return _stitch_tiles(probs, page_hw=(image.shape[1], image.shape[2]), offsets=offsets)


def _threshold_crop(probs: torch.Tensor, *, crop_hw: tuple[int, int], threshold: float) -> torch.Tensor:
    """Model-resolution output -> cropped binary mask, on the device."""
    p = probs.reshape(probs.shape[-2], probs.shape[-1])
    return p[: crop_hw[0], : crop_hw[1]] > threshold


def _post(probs: torch.Tensor, *, out_hw: tuple[int, int], crop_hw: tuple[int, int]) -> torch.Tensor:
    """Crop the padding off the probability map and resize it back to
    input-image coordinates (detection.rs:187-198) -> (H, W)."""
    probs = probs[..., : crop_hw[0], : crop_hw[1]]
    return resize_bilinear(probs, out_hw).reshape(out_hw)


class RuleRect(RotatedRect):
    """An ink rule (solid horizontal bar: heading underline, table/section
    separator) found by :func:`find_ink_rules`. A distinct type so the tag
    travels with the rect through layout: recognition substitutes
    ``OcrEngineParams.rule_glyph`` for lines made of these instead of
    running the model."""


def find_ink_rules(
    image: torch.Tensor,
    words: list[RotatedRect],
    *,
    ink_threshold: float = 0.15,
    min_width: float = 40.0,
    min_aspect: float = 5.0,
    max_height_frac: float = 0.06,
    min_fill: float = 0.55,
) -> list[RuleRect]:
    """Solid horizontal ink bars on the page that the text detector did not
    claim (heading underlines, horizontal separators).

    Upstream has no such stage, but its detector fires on heading underlines
    and its recognizer decodes them as ``[``; this engine's detector ignores
    rules, and ``OcrEngineParams.rule_glyph`` re-creates upstream's
    observable output.

    Host-side numpy analysis (runs only when the opt-in mode is on):
    deviation-from-median ink mask, minus the detected word regions,
    connected components, filtered to wide/flat/solid bars."""
    from scipy import ndimage

    img = image.cpu().numpy()[0]  # (H, W) in [-0.5, 0.5]
    h, w = img.shape
    bg = float(np.median(img))
    ink = np.abs(img - bg) > ink_threshold
    # Carve out everything the text detector claimed (with a small margin).
    for r in words:
        br = r.bounding_rect()
        t = max(int(br.top) - 2, 0)
        b = min(int(br.bottom) + 3, h)
        lf = max(int(br.left) - 2, 0)
        rt = min(int(br.right) + 3, w)
        ink[t:b, lf:rt] = False
    labels, count = ndimage.label(ink)
    if not count:
        return []
    rules: list[RuleRect] = []
    for sl in ndimage.find_objects(labels):
        bh = sl[0].stop - sl[0].start
        bw = sl[1].stop - sl[1].start
        if bw < min_width or bw < min_aspect * bh or bh > max_height_frac * h:
            continue
        if float(ink[sl].mean()) < min_fill:
            continue
        rules.append(
            RuleRect(
                ((sl[1].start + sl[1].stop) / 2.0, (sl[0].start + sl[0].stop) / 2.0),
                (0.0, -1.0),
                float(bw),
                float(bh),
            )
        )
    return rules
