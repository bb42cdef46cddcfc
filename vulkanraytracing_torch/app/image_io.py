"""Image output and PNG input, on numpy and zlib alone.

Counterpart of ``vulkanraytracing_tpu/app/image_io.py``: PNG output of a
display image (already tone-mapped), float32 ``.npy`` radiance dumps and
the image RMSE of the parity checks.  The JAX package encodes and decodes
PNG through Pillow where it can; here both directions are numpy and zlib
only, so that the .glb round trip and ``compare`` run where Pillow is not
installed.  ``read_png`` reads 8-bit, non-interlaced greyscale, RGB and
RGBA images with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (greyscale, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    c = tag + data
    return len(data).to_bytes(4, "big") + c + (zlib.crc32(c) & 0xFFFFFFFF).to_bytes(4, "big")


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W), (H, W, 3) or (H, W, 4) uint8 or float [0, 1] image as
    PNG bytes (filter 0 on every row, zlib level 6)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    h, w, c = image.shape
    color_type = {3: 2, 4: 6}[c]
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, color_type, 0, 0, 0])
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * c)], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 or float [0, 1] image as PNG."""
    Path(path).write_bytes(encode_png(image))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of
    ``h`` rows of ``stride`` bytes with ``bpp`` bytes a pixel."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, expected {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:  # Sub: a running sum over the pixels, per byte of a pixel
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF)
            cur = cur.astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one left of it
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C the file's channels (1, 3 or 4).
    Only 8-bit, non-interlaced greyscale, RGB and RGBA images are read;
    anything else raises ``ValueError``."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color_type}, "
                         f"interlace {interlace} (8-bit grey, RGB or RGBA, not interlaced)")
    c = _CHANNELS[color_type]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return rows.reshape(h, w, c)


def read_png(path: str | Path) -> np.ndarray:
    """Read a PNG file -> (H, W, C) uint8 (see ``decode_png``)."""
    return decode_png(Path(path).read_bytes())


def write_radiance_npy(path: str | Path, image: np.ndarray) -> None:
    """Float32 HDR dump (the parity-comparison currency)."""
    np.save(str(path), np.asarray(image, np.float32))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Image RMSE, the parity metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
