"""PNG codec on the standard library + numpy, and the one way images enter the port.

The engine takes pixels, not files. The CLI, the server and the scripts that
drive the port read and write PNG through this module, on machines with or
without an imaging package:

  * :func:`decode_png` / :func:`read_png`: non-interlaced PNG of bit depth 1,
    2, 4 or 8, grey, RGB, palette, grey+alpha and RGBA. Rows filtered None,
    Sub and Up are undone a run of rows at a time; Average and Paeth depend
    on the byte to their left as it comes out, and are undone one byte at a
    time in Python (seconds for a large page).
  * :func:`encode_png` / :func:`write_png`: grey, RGB and RGBA, 8 bit, each
    row filtered None or Up (whichever leaves the smaller residuals),
    ``zlib`` level 6.
  * :func:`decode_image`: any image file's bytes -> (H, W, 3) RGB ``uint8``,
    as Pillow's ``convert("RGB")`` gives it. PNG goes through this module;
    other formats through Pillow, imported inside the call, where it is
    installed, and raise :class:`~.errors.ImageSourceError` where it is not.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np

from .errors import ImageSourceError

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> samples per pixel (grey, RGB, palette, grey+alpha, RGBA).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: Channel count of an encoded array -> PNG colour type.
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}
#: zlib level of :func:`encode_png`.
ZLIB_LEVEL = 6


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for x in range(len(cur)):
        left = cur[x - bpp] if x >= bpp else 0
        cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for x in range(len(cur)):
        if x >= bpp:
            a, b, c = cur[x - bpp], prev[x], prev[x - bpp]
        else:
            a, b, c = 0, prev[x], 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return cur


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters of decompressed scanlines: `raw` is
    [H, 1 + stride] uint8 (each row's filter type, then its bytes), `bpp`
    the bytes per pixel (at least 1). Returns [H, stride] uint8.

    Rows are taken in runs of one filter type. A run of None rows is one
    copy, a run of Sub rows one running sum along the rows per byte of the
    pixel, and Up rows one numpy addition each, all modulo 256: a page costs
    milliseconds, so a server's handler threads decode beside its batching
    worker without holding the interpreter lock for long. Average and Paeth
    rows take a Python step per byte."""
    height, stride = raw.shape[0], raw.shape[1] - 1
    ftypes, data = raw[:, 0], raw[:, 1:]
    bad = np.flatnonzero(ftypes > 4)
    if bad.size:
        raise ImageSourceError(f"PNG: bad filter type {ftypes[bad[0]]} in row {bad[0]}")
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(ftypes)) + 1, [height]])
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        ftype, rows = int(ftypes[a]), data[a:b]
        if ftype == 0:
            out[a:b] = rows
        elif ftype == 1:  # Sub
            out[a:b] = np.cumsum(rows.reshape(b - a, -1, bpp), axis=1, dtype=np.uint8).reshape(b - a, stride)
        elif ftype == 2:  # Up (numpy's running sum down axis 0 is the slower way)
            for y in range(a, b):
                np.add(prev, data[y], out=out[y])
                prev = out[y]
        else:
            step = _unfilter_average if ftype == 3 else _unfilter_paeth
            for y in range(a, b):
                out[y] = np.frombuffer(step(data[y].tobytes(), prev.tobytes(), bpp), np.uint8)
                prev = out[y]
        prev = out[b - 1]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes into an (H, W, C) uint8 array: C = 1 for grey (and
    grey+alpha, whose alpha is dropped), 3 for RGB and palette images, 4 for
    RGBA. Samples of 1, 2 or 4 bits are scaled to 0..255 as Pillow scales
    them. Raises :class:`~.errors.ImageSourceError` for bytes that are not
    such a PNG (16-bit samples and interlaced images included)."""
    if data[:8] != _SIGNATURE:
        raise ImageSourceError("not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    try:
        while pos + 8 <= len(data):
            (length,) = struct.unpack(">I", data[pos : pos + 4])
            kind = data[pos + 4 : pos + 8]
            body = data[pos + 8 : pos + 8 + length]
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
            pos += 12 + length
    except (struct.error, ValueError) as exc:
        raise ImageSourceError(f"PNG: corrupt chunk at byte {pos} ({exc})") from exc
    if header is None:
        raise ImageSourceError("PNG: missing IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0 or depth not in (1, 2, 4, 8) or (depth < 8 and ctype not in (0, 3)):
        raise ImageSourceError(
            f"PNG: colour type {ctype}, bit depth {depth}, interlace {interlace} is not supported "
            "(non-interlaced 8-bit grey/RGB/grey+alpha/RGBA, and grey or palette of 1-8 bits)"
        )
    if ctype == 3 and palette is None:
        raise ImageSourceError("PNG: palette image without PLTE")
    ch = _CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
        raw = raw[: height * (stride + 1)].reshape(height, stride + 1)
    except (zlib.error, ValueError) as exc:
        raise ImageSourceError(f"PNG: corrupt image data ({exc})") from exc
    rows = _unfilter(raw, max(1, ch * depth // 8))
    if depth < 8:  # unpack the samples of each row, most significant bits first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        rows = samples.reshape(height, stride * per_byte)[:, :width]
        if ctype == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    img = rows.reshape(height, width, ch)
    if ctype == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ImageSourceError("PNG: palette index out of range")
        return palette[img[..., 0]]
    return img[..., :1] if ch == 2 else img


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG file: :func:`decode_png` of its bytes."""
    return decode_png(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(array: np.ndarray) -> bytes:
    """Encode an 8-bit image, (H, W) or (H, W, C) with C = 1, 3 or 4
    (grey, RGB, RGBA), as PNG bytes. Each row is filtered None or Up,
    whichever leaves the smaller sum of residuals (read as signed bytes)."""
    img = np.asarray(array)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE or 0 in img.shape[:2]:
        raise ValueError(f"encode_png takes a non-empty (H, W[, 1|3|4]) uint8 array, not {img.dtype} {img.shape}")
    height, width, ch = img.shape
    rows = np.ascontiguousarray(img).reshape(height, width * ch)
    up = rows.copy()
    up[1:] -= rows[:-1]

    def cost(r):
        return np.minimum(r, 256 - r.astype(np.int32)).sum(axis=1, dtype=np.int64)

    use_up = cost(up) < cost(rows)
    filtered = np.empty((height, width * ch + 1), np.uint8)
    filtered[:, 0] = np.where(use_up, 2, 0)
    filtered[:, 1:] = np.where(use_up[:, None], up, rows)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return b"".join(
        (
            _SIGNATURE,
            _chunk(b"IHDR", header),
            _chunk(b"IDAT", zlib.compress(filtered.tobytes(), ZLIB_LEVEL)),
            _chunk(b"IEND", b""),
        )
    )


def write_png(path: str | Path, array: np.ndarray) -> None:
    """Write :func:`encode_png` of `array` to `path`."""
    Path(path).write_bytes(encode_png(array))


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> (H, W, 3) RGB uint8, as Pillow's
    ``Image.open(...).convert("RGB")`` gives it (grey repeated, alpha
    dropped). PNG is decoded here; other formats need Pillow."""
    if data[:8] == _SIGNATURE:
        img = decode_png(data)
        return np.concatenate([img] * 3, axis=2) if img.shape[2] == 1 else np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise ImageSourceError(
            "not a PNG file, and Pillow, which reads the other image formats, is not installed"
        ) from None
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (UnidentifiedImageError, OSError) as exc:
        raise ImageSourceError(f"cannot decode the image: {exc}") from exc
