"""Batched text-line extraction on the engine's device.

Port of ``ocrs_tpu.ops.warp`` as plain tensor code. A whole batch of lines is
cut from one page, or from a stack of pages with a page index per line, at
once:

  * separable bilinear resampling: a row-gather pass (vertical), then a
    column-gather pass (horizontal), with the half-pixel law of
    :func:`_sample_coords`;
  * polygon masking through the line polygon's top/bottom chains: line
    polygons are x-monotone ribbons, so the even-odd fill reduces to a
    per-column [ytop(x), ybot(x)] band.

:func:`extract_line_batch_rotated` instead samples along a rotated rect's
own axes (deskew, vertical text), four taps per output pixel.

:func:`mask_normalize_crops` and :func:`strip_mask_normalize_crops` finish
crops that the host extracted as ``uint8`` (the page pipeline's low-bandwidth
transport, :func:`ocrs_tpu_torch.native.extract_lines_strip`): they normalize
and apply the identical band, in-page and width mask from the geometry alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..preprocess import BLACK_VALUE


def pad_chain(points: np.ndarray, max_v: int) -> np.ndarray:
    """Pad an (K, 2) [x, y] chain to (max_v, 2) with monotone
    (non-decreasing) x; word rects may overlap by a few px, and
    ``chain_eval`` in :func:`_band_mask` resolves equal-x runs by taking the
    last vertex, so no strictness epsilon is needed."""
    pts = np.asarray(points, dtype=np.float64)
    xs = np.maximum.accumulate(pts[:, 0])
    ys = pts[:, 1]
    if len(pts) > max_v:
        # Downsample long chains (rare: >max_v/2 words in one line).
        idx = np.linspace(0, len(pts) - 1, max_v).round().astype(int)
        xs, ys = xs[idx], ys[idx]
    pad = max_v - len(xs)
    if pad:
        xs = np.concatenate([xs, np.full(pad, xs[-1])])
        ys = np.concatenate([ys, np.full(pad, ys[-1])])
    return np.stack([xs, ys], axis=1).astype(np.float32)


def extract_line_batch_packed(
    page: torch.Tensor,  # [H, W] or [P, H, W] normalized greyscale page(s)
    geom: torch.Tensor,  # [6, N] f32: top, left, height, width, rwidth, page_idx
    chains: torch.Tensor,  # [N, 2, V, 2] f32: top and bottom polygon chains
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """:func:`extract_line_batch` with the per-line geometry packed into two
    tensors, so that a batch costs two uploads (the page index rides as
    float32, exact below 2^24 pages)."""
    page_idx = geom[5].to(torch.int64) if page.dim() == 3 else None
    return _extract_impl(
        page, geom[0], geom[1], geom[2], geom[3], geom[4],
        chains[:, 0], chains[:, 1], page_idx, out_h=out_h, out_w=out_w,
    )


def extract_line_batch(
    page: torch.Tensor,  # [H, W] or [P, H, W] normalized greyscale page(s)
    tops: torch.Tensor,  # [N] f32 line-rect top
    lefts: torch.Tensor,  # [N] f32 line-rect left
    heights: torch.Tensor,  # [N] f32 line-rect height
    line_widths: torch.Tensor,  # [N] f32 line-rect width
    resized_widths: torch.Tensor,  # [N] f32 per-line resized width (<= out_w)
    top_chain: torch.Tensor,  # [N, V, 2] upper polygon chain (x, y)
    bot_chain: torch.Tensor,  # [N, V, 2] lower polygon chain (x, y)
    page_idx: torch.Tensor | None = None,  # [N] integer, required when page is 3-D
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Extract, mask and resize a batch of line regions -> [N, 1, out_h, out_w].

    Output column x of line n samples page position
    ``left + (x + 0.5) * line_width / resized_width - 0.5``, rows likewise;
    columns beyond ``resized_width`` are BLACK padding.

    When `page` is a [P, H, W] stack, `page_idx` maps each line to its page:
    one pooled batch can span a whole group of pages."""
    return _extract_impl(
        page, tops, lefts, heights, line_widths, resized_widths,
        top_chain, bot_chain, page_idx, out_h=out_h, out_w=out_w,
    )


def _sample_coords(tops, lefts, heights, line_widths, resized_widths, out_h, out_w):
    """The half-pixel sample-position law shared by the extraction and the
    band mask: [N, out_h] page rows and [N, out_w] page cols."""
    ys = torch.arange(out_h, dtype=torch.float32, device=tops.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=tops.device)
    sy = (ys[None, :] + 0.5) * (heights[:, None] / out_h) - 0.5
    sy = torch.minimum(sy.clamp_min(0.0), (heights[:, None] - 1.0).clamp_min(0.0))
    in_y = tops[:, None] + sy
    sx = (xs[None, :] + 0.5) * (
        line_widths[:, None] / resized_widths[:, None].clamp_min(1.0)
    ) - 0.5
    sx = torch.minimum(sx.clamp_min(0.0), (line_widths[:, None] - 1.0).clamp_min(0.0))
    in_x = lefts[:, None] + sx
    return in_y, in_x


def _chain_eval(q: torch.Tensor, chain: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear y(x) of a [N, V, 2] chain at [N, W] query columns.
    The segment index is a comparison count over the vertex axis, so an
    equal-x run resolves to its LAST vertex."""
    cx, cy = chain[..., 0], chain[..., 1]  # [N, V]
    v = cx.shape[-1]
    idx = ((cx[:, None, :] <= q[:, :, None]).sum(dim=-1) - 1).clamp(0, v - 2)
    x0 = torch.gather(cx, 1, idx)
    x1 = torch.gather(cx, 1, idx + 1)
    y0 = torch.gather(cy, 1, idx)
    y1 = torch.gather(cy, 1, idx + 1)
    t = ((q - x0) / (x1 - x0).clamp_min(1e-9)).clamp(0.0, 1.0)
    out = y0 + t * (y1 - y0)
    out = torch.where(q < cx[:, :1], cy[:, :1], out)
    return torch.where(q > cx[:, -1:], cy[:, -1:], out)


def _band_mask(
    tops, lefts, heights, line_widths, resized_widths,
    top_chain, bot_chain, ph, pw, out_h, out_w,
):
    """Polygon band & in-page & valid-column mask [N, out_h, out_w]."""
    in_y, in_x = _sample_coords(
        tops, lefts, heights, line_widths, resized_widths, out_h, out_w
    )
    xs = torch.arange(out_w, dtype=torch.float32, device=tops.device)
    ytop = _chain_eval(in_x, top_chain)  # [N, out_w]
    ybot = _chain_eval(in_x, bot_chain)
    band = (in_y[:, :, None] >= ytop[:, None, :] - 0.5) & (
        in_y[:, :, None] <= ybot[:, None, :] + 0.5
    )
    in_page = (
        (in_y[:, :, None] >= 0.0)
        & (in_y[:, :, None] <= ph - 1.0)
        & (in_x[:, None, :] >= 0.0)
        & (in_x[:, None, :] <= pw - 1.0)
    )
    valid_col = xs[None, None, :] < resized_widths[:, None, None]
    return band & in_page & valid_col


def _extract_impl(
    page, tops, lefts, heights, line_widths, resized_widths,
    top_chain, bot_chain, page_idx=None, *, out_h: int, out_w: int,
) -> torch.Tensor:
    ph, pw = page.shape[-2], page.shape[-1]
    n = tops.shape[0]
    in_y, in_x = _sample_coords(
        tops, lefts, heights, line_widths, resized_widths, out_h, out_w
    )

    # Vertical pass: two page rows per output row.
    y0 = torch.floor(in_y)
    wy = (in_y - y0)[..., None]  # [N, out_h, 1]
    y0i = y0.to(torch.int64).clamp(0, ph - 1)
    y1i = (y0i + 1).clamp(0, ph - 1)
    if page.dim() == 3:
        if page_idx is None:
            raise ValueError("page_idx is required for a page stack")
        pi = page_idx.to(torch.int64)[:, None]
        rows0, rows1 = page[pi, y0i], page[pi, y1i]
    else:
        rows0, rows1 = page[y0i], page[y1i]
    vert = rows0 * (1.0 - wy) + rows1 * wy  # [N, out_h, pw]

    # Horizontal pass: two columns per output column.
    x0 = torch.floor(in_x)
    wx = (in_x - x0)[:, None, :]  # [N, 1, out_w]
    x0i = x0.to(torch.int64).clamp(0, pw - 1)
    x1i = (x0i + 1).clamp(0, pw - 1)
    g0 = torch.gather(vert, 2, x0i[:, None, :].expand(n, out_h, out_w))
    g1 = torch.gather(vert, 2, x1i[:, None, :].expand(n, out_h, out_w))
    samples = g0 * (1.0 - wx) + g1 * wx  # [N, out_h, out_w]

    mask = _band_mask(
        tops, lefts, heights, line_widths, resized_widths,
        top_chain, bot_chain, ph, pw, out_h, out_w,
    )
    out = torch.where(mask, samples, torch.full_like(samples, BLACK_VALUE))
    return out[:, None, :, :]


def extract_line_batch_rotated(
    page: torch.Tensor,  # [H, W] or [P, H, W] normalized greyscale page(s)
    geom: torch.Tensor,  # [10, N] f32: ox, oy, rx, ry, dx, dy, w, h, rwidth, page
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Deskewing line extraction: sample along a ROTATED rect's own axes so
    slanted text lands axis-aligned in the crop -> [N, 1, out_h, out_w].

    Per line the geometry columns are: ``(ox, oy)`` the page coordinates of
    the rect's top-left corner, ``(rx, ry)`` the unit axis along the text
    direction, ``(dx, dy)`` the unit axis down the glyphs, ``(w, h)`` the
    rect extents along those axes, ``rwidth`` the resized content width
    (columns beyond it are BLACK padding), and the page index for stacks.
    Output pixel (r, c) samples page position

        (ox, oy) + lx * (rx, ry) + ly * (dx, dy),
        lx = (c + 0.5) * w / rwidth - 0.5,   ly = (r + 0.5) * h / out_h - 0.5

    (the half-pixel bilinear law of the axis-aligned path). Samples outside
    the page are BLACK. There is no polygon band mask: the rotated rect
    itself is the tight region."""
    ox, oy, rx, ry, dx, dy, w, h, rwidth, pidx_f = (geom[i] for i in range(10))
    ph, pw = page.shape[-2], page.shape[-1]

    ys = torch.arange(out_h, dtype=torch.float32, device=geom.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=geom.device)
    lx = (xs[None, :] + 0.5) * (w[:, None] / rwidth[:, None].clamp_min(1.0)) - 0.5
    lx = torch.minimum(lx.clamp_min(0.0), (w[:, None] - 1.0).clamp_min(0.0))  # [N, out_w]
    ly = (ys[None, :] + 0.5) * (h[:, None] / out_h) - 0.5
    ly = torch.minimum(ly.clamp_min(0.0), (h[:, None] - 1.0).clamp_min(0.0))  # [N, out_h]

    # Page sample positions [N, out_h, out_w].
    px = ox[:, None, None] + lx[:, None, :] * rx[:, None, None] + ly[:, :, None] * dx[:, None, None]
    py = oy[:, None, None] + lx[:, None, :] * ry[:, None, None] + ly[:, :, None] * dy[:, None, None]

    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.to(torch.int64).clamp(0, pw - 1)
    x1i = (x0i + 1).clamp(0, pw - 1)
    y0i = y0.to(torch.int64).clamp(0, ph - 1)
    y1i = (y0i + 1).clamp(0, ph - 1)

    flat = page.reshape(-1)
    base = (pidx_f.to(torch.int64) * (ph * pw))[:, None, None] if page.dim() == 3 else 0
    v00 = flat[base + y0i * pw + x0i]
    v01 = flat[base + y0i * pw + x1i]
    v10 = flat[base + y1i * pw + x0i]
    v11 = flat[base + y1i * pw + x1i]
    samples = (
        v00 * (1.0 - fy) * (1.0 - fx)
        + v01 * (1.0 - fy) * fx
        + v10 * fy * (1.0 - fx)
        + v11 * fy * fx
    )

    in_page = (px >= 0.0) & (px <= pw - 1.0) & (py >= 0.0) & (py <= ph - 1.0)
    valid_col = xs[None, None, :] < rwidth[:, None, None]
    out = torch.where(in_page & valid_col, samples, torch.full_like(samples, BLACK_VALUE))
    return out[:, None, :, :]


def _unpack4(x: torch.Tensor) -> torch.Tensor:
    """[..., W/2] uint8 holding two 4-bit pixels per byte (high nibble = even
    column) -> [..., W] uint8, dequantized as nibble * 17 (0..15 -> 0..255)."""
    return torch.stack([x >> 4, x & 0xF], dim=-1).reshape(*x.shape[:-1], x.shape[-1] * 2) * 17


def _mask_normalize(crops_u8: torch.Tensor, geom: torch.Tensor, chains: torch.Tensor, page_hw) -> torch.Tensor:
    """[N, out_h, out_w] uint8 crops -> normalized, masked [N, 1, out_h, out_w]."""
    out_h, out_w = crops_u8.shape[1], crops_u8.shape[2]
    crops = crops_u8.to(torch.float32) / 255.0 + BLACK_VALUE
    mask = _band_mask(
        geom[0], geom[1], geom[2], geom[3], geom[4],
        chains[:, 0], chains[:, 1], page_hw[0], page_hw[1], out_h, out_w,
    )
    return torch.where(mask, crops, torch.full_like(crops, BLACK_VALUE))[:, None, :, :]


def mask_normalize_crops(
    crops_u8: torch.Tensor,  # [N, out_h, out_w] u8 (pack4: [N, out_h, ceil(w/2)])
    geom: torch.Tensor,  # [6, N] f32 (extract_line_batch_packed layout)
    chains: torch.Tensor,  # [N, 2, V, 2] f32 top/bottom polygon chains
    *,
    page_hw: tuple[int, int],
    pack4: bool = False,
) -> torch.Tensor:
    """Finish host-extracted line crops on the device -> [N, 1, out_h, out_w].

    The crops were bilinear-resized on the host with this module's sampling
    law (:func:`ocrs_tpu_torch.native.extract_lines`); what remains is the
    normalization and the polygon band / in-page / width mask, which depend
    on the geometry alone. So the mask is bit-identical to that of
    :func:`extract_line_batch`, and the pixels differ only by the uint8
    rounding of the host's resize.

    ``pack4``: crops carry two 4-bit pixels per byte (high nibble = even
    column), dequantized as nibble * 17."""
    if pack4:
        crops_u8 = _unpack4(crops_u8)
    return _mask_normalize(crops_u8, geom, chains, page_hw)


def strip_mask_normalize_crops(
    strip_u8: torch.Tensor,  # [out_h, total_w] u8 (pack4: [out_h, total_w//2])
    offs: torch.Tensor,  # [N] integer strip column offset of each line's segment
    geom: torch.Tensor,  # [6, N] f32 (extract_line_batch_packed layout)
    chains: torch.Tensor,  # [N, 2, V, 2] f32 top/bottom polygon chains
    *,
    page_hw: tuple[int, int],
    pack4: bool = False,
    out_w: int,
) -> torch.Tensor:
    """Finish STRIP-packed host crops on the device -> [N, 1, out_h, out_w].

    :func:`ocrs_tpu_torch.native.extract_lines_strip` lays every line at its
    own resized width side by side along the column axis, without the
    padding to the batch's widest line. Each line's ``out_w``-wide window is
    gathered back out of the strip; columns past a line's segment read the
    neighbouring segment, which is harmless because the mask of
    :func:`mask_normalize_crops` blacks every column >= resized_width."""
    if pack4:
        strip_u8 = _unpack4(strip_u8)
    total_w = strip_u8.shape[1]
    cols = torch.arange(out_w, dtype=torch.int64, device=strip_u8.device)
    idx = (offs.to(torch.int64)[:, None] + cols[None, :]).clamp(0, total_w - 1)  # [N, out_w]
    crops_u8 = strip_u8[:, idx].permute(1, 0, 2)  # [N, out_h, out_w]
    return _mask_normalize(crops_u8, geom, chains, page_hw)
