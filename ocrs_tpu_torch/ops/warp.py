"""Batched text-line extraction on the engine's device.

Port of ``ocrs_tpu.ops.warp`` as plain tensor code (``pad_chain``,
``extract_line_batch_packed``, ``_extract_impl``, ``_sample_coords``,
``_band_mask``, ``extract_line_batch_rotated``). A whole batch of lines is cut
from the page at once:

  * separable bilinear resampling: a row-gather pass (vertical), then a
    column-gather pass (horizontal), with the half-pixel law of
    :func:`_sample_coords`;
  * polygon masking through the line polygon's top/bottom chains: line
    polygons are x-monotone ribbons, so the even-odd fill reduces to a
    per-column [ytop(x), ybot(x)] band.

:func:`extract_line_batch_rotated` instead samples along a rotated rect's
own axes (deskew, vertical text), four taps per output pixel. The page-stack
form of the axis-aligned path arrives with the page pipeline.
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
    page: torch.Tensor,  # [H, W] normalized greyscale page
    geom: torch.Tensor,  # [6, N] f32: top, left, height, width, rwidth, page_idx
    chains: torch.Tensor,  # [N, 2, V, 2] f32: top and bottom polygon chains
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Extract, mask and resize a batch of line regions -> [N, 1, out_h, out_w].

    Output column x of line n samples page position
    ``left + (x + 0.5) * line_width / resized_width - 0.5``, rows likewise;
    columns beyond ``resized_width`` are BLACK padding."""
    if page.dim() != 2:
        raise NotImplementedError("page stacks arrive with the page pipeline; pass one [H, W] page")
    tops, lefts, heights, line_widths, resized_widths = (geom[i] for i in range(5))
    return _extract_impl(
        page, tops, lefts, heights, line_widths, resized_widths,
        chains[:, 0], chains[:, 1], out_h=out_h, out_w=out_w,
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
    top_chain, bot_chain, *, out_h: int, out_w: int,
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
    vert = page[y0i] * (1.0 - wy) + page[y1i] * wy  # [N, out_h, pw]

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
