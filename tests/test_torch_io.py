"""The port's image and HDR I/O against the JAX package's and Pillow.

- ``write_png`` / ``read_png`` round trip, 8-bit greyscale, RGB and RGBA;
  ``read_png`` equals Pillow's decoding of PNGs written with each of the
  five row filters (None, Sub, Up, Average, Paeth) and of PNGs that Pillow
  wrote itself;
- ``read_hdr`` / ``write_hdr`` bit-equal to the JAX package's on the same
  bytes (flat and adaptive-RLE scanlines), ``rmse`` bit-equal.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vulkanraytracing_torch.app import hdr as thdr
from vulkanraytracing_torch.app import image_io as tio
from vulkanraytracing_tpu.app import hdr as jhdr
from vulkanraytracing_tpu.app import image_io as jio


def _image(h, w, c, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _filtered_png(img, kinds):
    """A PNG of ``img`` whose row y is written with filter kinds[y % len]."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    color = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_read_png_equals_pillow_for_each_filter(kind, channels):
    img = _image(13, 11, channels, seed=kind)
    data = _filtered_png(img, [kind, (kind + 2) % 5, kind])
    got = tio.decode_png(data)
    want = _pil(data).reshape(got.shape)
    assert np.array_equal(got, want) and np.array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_reads_what_pillow_writes(mode, tmp_path):
    """Pillow chooses its own filters row by row."""
    channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = _image(40, 33, channels, seed=7)
    img[:, :10] = 200  # flat runs, where the encoder's filters differ
    path = tmp_path / "pil.png"
    Image.fromarray(img if channels > 1 else img[..., 0], mode).save(path)
    assert np.array_equal(tio.read_png(path), img)


def test_write_png_round_trip_and_pillow(tmp_path):
    rgb = _image(9, 17, 3, seed=1)
    path = tmp_path / "rgb.png"
    tio.write_png(path, rgb)
    assert np.array_equal(tio.read_png(path), rgb)
    assert np.array_equal(np.asarray(Image.open(path)), rgb)
    # float [0, 1] input as the JAX package quantizes it, grey as RGB
    f = np.random.default_rng(2).uniform(-0.2, 1.2, (5, 6, 3)).astype(np.float32)
    tio.write_png(path, f)
    assert np.array_equal(tio.read_png(path), (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))
    tio.write_png(path, rgb[..., 0])
    assert np.array_equal(tio.read_png(path), np.repeat(rgb[..., :1], 3, axis=-1))
    rgba = _image(6, 5, 4, seed=3)
    assert np.array_equal(tio.decode_png(tio.encode_png(rgba)), rgba)
    # what the JAX package writes reads back the same
    jio.write_png(path, rgb)
    assert np.array_equal(tio.read_png(path), rgb)


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a")
    buf = io.BytesIO()
    Image.fromarray(_image(4, 4, 3)[..., 0], "L").convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        tio.decode_png(buf.getvalue())


def _hdr_bytes(h, w, seed, rle):
    """A Radiance file: flat scanlines, or adaptive RLE with runs and
    literals in every component."""
    rng = np.random.default_rng(seed)
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (h, w), dtype=np.uint8)
    rgbe[:, : w // 2, 1] = 77  # a run
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            x, comp = 0, rgbe[y, :, c]
            while x < w:
                run = 1
                while x + run < w and run < 127 and comp[x + run] == comp[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, comp[x]])
                    x += run
                else:
                    n = min(w - x, 8)
                    out += bytes([n]) + comp[x:x + n].tobytes()
                    x += n
    return out, rgbe


@pytest.mark.parametrize("rle", [False, True])
def test_read_hdr_bit_equal_to_jax(rle, tmp_path):
    data, rgbe = _hdr_bytes(7, 40, seed=int(rle), rle=rle)
    path = tmp_path / "x.hdr"
    path.write_bytes(data)
    got, want = thdr.read_hdr(path), jhdr.read_hdr(path)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, thdr.rgbe_to_float(rgbe))


def test_write_hdr_bit_equal_to_jax(tmp_path):
    rgb = np.random.default_rng(4).uniform(0.0, 50.0, (12, 24, 3)).astype(np.float32)
    rgb[0, 0] = 0.0
    thdr.write_hdr(tmp_path / "t.hdr", rgb)
    jhdr.write_hdr(tmp_path / "j.hdr", rgb)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = thdr.read_hdr(tmp_path / "t.hdr")
    assert np.array_equal(back, jhdr.read_hdr(tmp_path / "t.hdr"))
    # RGBE keeps 8 bits of mantissa below the pixel's largest channel
    assert (np.abs(back - rgb) <= rgb.max(axis=-1, keepdims=True) / 128).all()


def test_rmse_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(size=(8, 8, 3)), rng.uniform(size=(8, 8, 3)).astype(np.float32)
    assert tio.rmse(a, b) == jio.rmse(a, b) and tio.rmse(a, a) == 0.0
