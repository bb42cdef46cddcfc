"""Radiance .hdr (RGBE) reader and writer.

Counterpart of ``vulkanraytracing_tpu/app/hdr.py``, the same numpy codec:
the ``32-bit_rle_rgbe`` format with adaptive-RLE and flat scanlines in,
flat scanlines out.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vulkanraytracing_torch.utils.profiling import span


@span("vrt.setup.read_hdr")
def read_hdr(path: str | Path) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear radiance."""
    data = Path(path).read_bytes()
    # --- header ---
    pos = 0

    def readline() -> bytes:
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        return line

    magic = readline()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {magic!r}")
    fmt = b""
    while True:
        line = readline()
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1]
        if line == b"":
            break
    if fmt not in (b"32-bit_rle_rgbe", b""):
        raise ValueError(f"unsupported HDR format: {fmt!r}")
    dims = readline().split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {dims!r}")
    height = int(dims[1])
    width = int(dims[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and p + 4 <= raw.size
            and raw[p] == 2
            and raw[p + 1] == 2
            and (int(raw[p + 2]) << 8 | int(raw[p + 3])) == width
        ):
            # adaptive RLE: 4 components stored separately
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[p])
                    p += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[p : p + count]
                        p += count
                        x += count
        else:
            # flat scanline (possibly old-style RLE, unsupported markers rare)
            row = raw[p : p + width * 4].reshape(width, 4)
            rgbe[y] = row
            p += width * 4
    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float32)
    maxc = rgb.max(axis=-1)
    exp = np.zeros(maxc.shape, np.int32)
    mant = np.zeros(maxc.shape, np.float32)
    nz = maxc > 1e-32
    mant_nz, exp_nz = np.frexp(maxc[nz])
    mant[nz] = mant_nz
    exp[nz] = exp_nz
    scale = np.zeros_like(maxc)
    scale[nz] = mant[nz] * 256.0 / maxc[nz]
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return rgbe


def write_hdr(path: str | Path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) float32 as an uncompressed .hdr file."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    header = (
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        + f"-Y {h} +X {w}\n".encode()
    )
    Path(path).write_bytes(header + float_to_rgbe(rgb).tobytes())
