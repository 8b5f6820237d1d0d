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
    with pytest.raises(ImageSourceError, match="bit depth 16"):
        png.decode_png(buf16.getvalue())
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
