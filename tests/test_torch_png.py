"""The port's PNG codec (ocrs_tpu_torch/png.py) against Pillow, which the JAX
package reads and writes images with.

Decoding is exact: every case must equal Pillow's pixels. Rows filtered with
each of the five PNG filters are built here with a plain loop, because
Pillow chooses its own filters when it saves.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from ocrs_tpu_torch import png
from ocrs_tpu_torch.errors import ImageSourceError

MODES = {"L": (1, 0), "RGB": (3, 2), "RGBA": (4, 6)}  # mode -> (channels, PNG colour type)


def _image(mode, hw=(13, 17), seed=0):
    ch = MODES[mode][0]
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, ch), dtype=np.uint8)
    img[:, :5] = 7  # flat runs as well as noise
    img[4:6] = img[3]
    return img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(img, ftype):
    """Scanlines of `img` all filtered with `ftype`, one byte at a time."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(int).tolist()
    prev = [0] * (w * ch)
    out = bytearray()
    for row in rows:
        out.append(ftype)
        for x, v in enumerate(row):
            a = row[x - ch] if x >= ch else 0
            b = prev[x]
            c = prev[x - ch] if x >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((v - pred) & 0xFF)
        prev = row
    return bytes(out)


def _png_bytes(img, ftype):
    h, w, ch = img.shape
    colour = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    idat = zlib.compress(_filtered(img, ftype))
    # Split the data over two IDAT chunks, as encoders may.
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + chunk(b"IDAT", idat[:7])
        + chunk(b"IDAT", idat[7:])
        + chunk(b"IEND", b"")
    )


def _pillow(data, mode=None):
    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert(mode) if mode else img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_equals_pillow_for_every_filter(mode, ftype):
    img = _image(mode, seed=ftype)
    data = _png_bytes(img, ftype)
    want = _pillow(data)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want.reshape(img.shape))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.decode_image(data), _pillow(data, "RGB"))


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_png_equals_pillow_on_pillows_own_files(mode, tmp_path):
    img = _image(mode, hw=(40, 33), seed=5)
    path = tmp_path / "p.png"
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path, optimize=True)
    np.testing.assert_array_equal(png.read_png(path), _pillow(path.read_bytes()).reshape(img.shape))


@pytest.mark.parametrize("kind", ["bilevel", "palette8", "palette4", "grey_alpha"])
def test_decode_image_of_other_png_kinds_equals_pillows_rgb(kind):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (11, 23, 3), dtype=np.uint8)
    buf = io.BytesIO()
    if kind == "bilevel":
        Image.fromarray(rgb[..., 0] > 127).save(buf, format="PNG")
    elif kind == "grey_alpha":
        Image.fromarray(rgb[..., :2], "LA").save(buf, format="PNG")
    else:
        Image.fromarray(rgb).quantize(16).save(buf, format="PNG", bits=4 if kind == "palette4" else 8)
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode_image(data), _pillow(data, "RGB"))


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 1), (9, 14, 3), (9, 14, 4), (1, 1, 3)])
def test_encode_png_round_trips_and_pillow_reads_it(shape, tmp_path):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    img[3:5] = img[2:3]  # rows for the Up filter (where there are rows)
    data = png.encode_png(img)
    np.testing.assert_array_equal(png.decode_png(data).reshape(shape), img)
    np.testing.assert_array_equal(_pillow(data).reshape(shape), img)
    # Rows are filtered None or Up only.
    raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4 : data.index(b"IEND") - 8]), np.uint8)
    ch = shape[2] if len(shape) == 3 else 1
    assert set(raw.reshape(shape[0], -1)[:, 0].tolist()) <= {0, 2}
    assert raw.size == shape[0] * (shape[1] * ch + 1)
    png.write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png").reshape(shape), img)


def test_encode_png_picks_up_rows_for_repeated_rows_and_refuses_other_arrays():
    img = np.tile(np.arange(60, dtype=np.uint8)[None, :, None], (20, 1, 3))
    raw = zlib.decompress(png.encode_png(img)[41:-12 - 4])
    assert raw[0] == 0 and all(raw[y * (60 * 3 + 1)] == 2 for y in range(1, 20))
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.uint8), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.encode_png(bad)


def test_non_png_bodies(monkeypatch):
    buf = io.BytesIO()
    rgb = np.random.default_rng(3).integers(0, 256, (8, 12, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(buf, format="BMP")
    bmp = buf.getvalue()
    # With Pillow, other formats decode as Pillow decodes them; garbage raises.
    np.testing.assert_array_equal(png.decode_image(bmp), rgb)
    with pytest.raises(ImageSourceError, match="cannot decode"):
        png.decode_image(b"not an image")
    # A PNG that is cut short, or one of an unsupported kind, raises.
    good = png.encode_png(rgb)
    for cut in (9, 20, 40, 60):  # before IHDR ends, inside IDAT, ...
        with pytest.raises(ImageSourceError):
            png.decode_png(good[:cut])
    with pytest.raises(ImageSourceError, match="not a PNG"):
        png.decode_png(bmp)
    buf16 = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(buf16, format="PNG")
    np.testing.assert_array_equal(png.decode_image(buf16.getvalue()), _pillow(buf16.getvalue(), "RGB"))
    bad_depth = bytearray(good)
    bad_depth[24] = 4  # IHDR's bit depth: RGB has no 4-bit kind
    with pytest.raises(ImageSourceError, match="bit depth 4"):
        png.decode_png(bytes(bad_depth))
    # Without Pillow: PNG still decodes, anything else says what is missing.
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(png.decode_image(good), rgb)
    with pytest.raises(ImageSourceError, match="Pillow"):
        png.decode_image(bmp)


def test_sub_filter_runs_per_channel_modulo_256():
    # A row whose running sums wrap past 255 in every channel.
    img = np.full((2, 300, 3), 200, np.uint8)
    img[:, ::7] = 13
    np.testing.assert_array_equal(png.decode_png(_png_bytes(img, 1)), img)


# Every colour type at every bit depth, plain and Adam7-interlaced, with and
# without tRNS, written here (Pillow writes neither interlaced nor most of
# these kinds) and held against Pillow's Image.open(...).convert("RGB").
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(3, d) for d in (1, 2, 4, 8)] + [(c, d) for c in (2, 4, 6) for d in (8, 16)]


def _pack(samples, depth):
    """[h, n] sample values -> [h, stride] bytes of one pass."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    pad = (-samples.shape[1]) % per
    s = np.concatenate([samples, np.zeros((h, pad), samples.dtype)], 1).reshape(h, -1, per).astype(np.uint8)
    return (s << np.arange(8 - depth, -1, -depth, dtype=np.uint8)).sum(-1, dtype=np.uint8)


def _filter_rows(rows, bpp, first_type):
    """Filter each row with the next of the five types in turn."""
    out, prev = bytearray(), [0] * rows.shape[1]
    for i, row in enumerate(rows.astype(int).tolist()):
        ftype = (first_type + i) % 5
        out.append(ftype)
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            out.append((v - (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]) & 0xFF)
        prev = row
    return bytes(out)


def _kind_png(ctype, depth, interlace, hw, trns=False, seed=0):
    ch = png._CHANNELS[ctype]
    rng = np.random.default_rng(seed)
    top = (1 << depth) if ctype != 3 else min(1 << depth, 7)
    samples = rng.integers(0, top, size=(*hw, ch)).astype(np.int64)
    if depth == 16:  # values at the clip and high-byte edges
        samples.reshape(-1)[:6] = [0, 100, 255, 256, 0xFF00, 65535]
    h, w = hw
    raw = b""
    for i, (y0, x0, dy, dx) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth), max(1, ch * depth // 8), i)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if ctype == 3:
        out += chunk(b"PLTE", rng.integers(0, 256, size=(7, 3), dtype=np.uint8).tobytes())
    if trns:
        # A transparent grey or RGB value (the first pixel's), or palette alphas.
        body = bytes([0, 128, 255]) if ctype == 3 else struct.pack(f">{ch}H", *map(int, samples[0, 0]))
        out += chunk(b"tRNS", body)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("hw", [(13, 11), (3, 2)], ids=["13x11", "3x2"])
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype, depth", KINDS, ids=[f"type{c}-{d}bit" for c, d in KINDS])
def test_decode_image_of_every_kind_equals_pillows_rgb(ctype, depth, interlace, hw):
    data = _kind_png(ctype, depth, interlace, hw, seed=depth + ctype)
    np.testing.assert_array_equal(png.decode_image(data), _pillow(data, "RGB"))


@pytest.mark.parametrize("ctype, depth", [(0, 8), (0, 16), (2, 8), (2, 16), (3, 4)])
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
def test_trns_changes_no_sample(ctype, depth, interlace):
    data = _kind_png(ctype, depth, interlace, (9, 10), trns=True, seed=3)
    np.testing.assert_array_equal(png.decode_image(data), _pillow(data, "RGB"))


def test_sixteen_bit_rules_as_pillow_reads_them():
    grey = _kind_png(0, 16, 0, (1, 6))
    np.testing.assert_array_equal(png.decode_png(grey)[0, :, 0], [0, 100, 255, 255, 255, 255])
    rgb = _kind_png(2, 16, 0, (1, 2))  # the six values over two RGB pixels
    np.testing.assert_array_equal(png.decode_png(rgb)[0].reshape(-1), [0, 0, 0, 1, 255, 255])
