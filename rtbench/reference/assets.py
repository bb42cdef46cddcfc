"""The reference's own reading of the scene files.

The .glb (accessors, materials, the embedded PNGs, the point lights) and
the .hdr are parsed here with numpy and zlib, the shading attributes are
derived as a glTF importer derives them (vertex normals renormalized in
float64, tangents from the uv gradients where the file has none), and the
textures get their mip chains from the images: Pillow's bilinear
reduction, written out in numpy.  Nothing of the program is imported.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_DTYPES = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


class Geometry(NamedTuple):
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: tuple          # three (T, 3) corner normals
    t: tuple          # three (T, 3) corner tangents
    uv: tuple         # three (T, 2) corner uvs
    material: torch.Tensor  # (T,) int64
    double_sided: torch.Tensor  # (T,) bool
    cutout: torch.Tensor        # (T,) bool


class Materials(NamedTuple):
    base_color: torch.Tensor  # (M, 4)
    roughness: torch.Tensor
    metallic: torch.Tensor
    cutoff: torch.Tensor
    texture: torch.Tensor     # (M,) int64, -1 none


class Pool(NamedTuple):
    """Every texture's mip chain in one flat RGBA8 array."""

    texels: torch.Tensor  # (N, 4) uint8
    offset: torch.Tensor  # (K, L) int64
    width: torch.Tensor   # (K, L) int64
    height: torch.Tensor  # (K, L) int64


class RefScene(NamedTuple):
    geometry: Geometry
    materials: Materials
    lights_pos: torch.Tensor    # (L, 3)
    lights_color: torch.Tensor  # (L, 3)
    sun_dir: torch.Tensor       # (3,) the direction the light travels
    sun_color: torch.Tensor     # (3,)
    panorama: torch.Tensor      # (H, W, 3)
    pool: Pool | None


def _read_glb(path: Path) -> tuple[dict, bytes]:
    data = Path(path).read_bytes()
    magic, version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError(f"{path}: not a glTF 2 binary")
    pos, doc, blob = 12, None, b""
    while pos < len(data):
        length, kind = struct.unpack_from("<II", data, pos)
        chunk = data[pos + 8:pos + 8 + length]
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            blob = chunk
        pos += 8 + length
    return doc, blob


def _accessor(doc: dict, blob: bytes, index: int) -> np.ndarray:
    acc = doc["accessors"][index]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _DTYPES[acc["componentType"]]
    n = _COUNTS[acc["type"]]
    if view.get("byteStride", 0) not in (0, n * np.dtype(dtype).itemsize):
        raise ValueError("strided accessors are not written by the benchmark")
    off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    return np.frombuffer(blob, dtype, count=acc["count"] * n, offset=off).reshape(-1, n)


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB / RGBA PNG whose rows use filter 0 (None), Sub or Up."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
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
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError("only 8-bit RGB/RGBA non-interlaced PNGs are read")
    c = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * c + 1)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = (np.cumsum(row.reshape(-1, c), axis=0, dtype=np.uint64) & 0xFF)
            cur = cur.astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        else:
            raise ValueError(f"PNG row filter {kind} is not written by the benchmark")
        out[y] = cur
        prev = out[y]
    img = out.reshape(h, w, c)
    if c == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return img


def read_hdr(path: Path) -> np.ndarray:
    """Radiance .hdr with flat RGBE scanlines -> (H, W, 3) float32."""
    data = Path(path).read_bytes()
    end = data.index(b"\n\n") + 2
    dims_end = data.index(b"\n", end)
    dims = data[end:dims_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data, np.uint8, offset=dims_end + 1, count=h * w * 4)
    rgbe = rgbe.reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _tangents(p: np.ndarray, uv: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-vertex tangents from the uv gradients of the faces around it,
    a unit x where they cancel (float32, as a glTF importer computes them
    where a file has no TANGENT)."""
    tangents = np.zeros_like(p)
    p0 = p[idx[:, 0]]
    e1 = p[idx[:, 1]] - p0
    e2 = p[idx[:, 2]] - p0
    t0 = uv[idx[:, 0]]
    d1 = uv[idx[:, 1]] - t0
    d2 = uv[idx[:, 2]] - t0
    d = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    d = np.where(d == 0.0, 1.0, d)
    ft = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / d[:, None]
    for k in range(3):
        np.add.at(tangents, idx[:, k], ft)
    lengths = np.linalg.norm(tangents, axis=-1)
    zero = lengths <= 0.0
    tangents[~zero] /= lengths[~zero, None]
    tangents[zero] = [1.0, 0.0, 0.0]
    return tangents


def _unit64(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float64)
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


# --- textures: Pillow's bilinear reduction in numpy ------------------------

_BITS = 22


def _coeffs(n_in: int, n_out: int):
    scale = n_in / n_out
    fs = max(scale, 1.0)
    ksize = int(np.ceil(fs)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    first = np.maximum(np.trunc(center - fs + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + fs + 0.5).astype(np.int64), n_in) - first
    weights = np.zeros((n_out, ksize))
    total = np.zeros(n_out)
    for x in range(ksize):
        w = np.abs(((x + first) - center + 0.5) * (1.0 / fs))
        w = np.where((w < 1.0) & (x < count), 1.0 - w, 0.0)
        weights[:, x] = w
        total += w
    weights = np.where(total[:, None] != 0.0,
                       weights / np.where(total == 0.0, 1.0, total)[:, None], weights)
    return first, np.trunc(0.5 + weights * (1 << _BITS)).astype(np.int64)


def _pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = img.shape[axis]
    first, kk = _coeffs(n_in, n_out)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_BITS - 1), np.int64)
    lanes = (-1,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        acc += src[np.minimum(first + x, n_in - 1)] * kk[:, x].reshape(lanes)
    return np.moveaxis(np.clip(acc >> _BITS, 0, 255).astype(np.uint8), 0, axis)


def resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """RGBA8 bilinear resize with premultiplied alpha, in Pillow's fixed
    point."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    alpha = img[..., 3:].astype(np.uint32)
    t = img[..., :3].astype(np.uint32) * alpha + 128
    out = np.concatenate([((t >> 8) + t) >> 8, alpha], axis=-1).astype(np.uint8)
    if out.shape[1] != w:
        out = _pass(out, w, 1)
    if out.shape[0] != h:
        out = _pass(out, h, 0)
    alpha = out[..., 3:].astype(np.uint32)
    color = out[..., :3].astype(np.uint32)
    straight = np.minimum(255 * color // np.maximum(alpha, 1), 255)
    color = np.where((alpha == 0) | (alpha == 255), color, straight).astype(np.uint8)
    return np.concatenate([color, out[..., 3:]], axis=-1)


def build_pool(images: list[np.ndarray], device, max_size: int = 2048) -> Pool:
    chains = []
    for img in images:
        h, w = img.shape[:2]
        if max(h, w) > max_size:
            s = max_size / max(h, w)
            w, h = max(1, int(round(w * s))), max(1, int(round(h * s)))
            img = resize(img, w, h)
        chain = [img]
        while w > 1 or h > 1:
            w, h = max(1, w // 2), max(1, h // 2)
            chain.append(resize(chain[-1], w, h))
        chains.append(chain)
    levels = max(len(c) for c in chains)
    offset = np.zeros((len(chains), levels), np.int64)
    width = np.ones_like(offset)
    height = np.ones_like(offset)
    flat, base = [], 0
    for i, chain in enumerate(chains):
        for lv in range(levels):
            mip = chain[min(lv, len(chain) - 1)]
            if lv < len(chain):
                flat.append(mip.reshape(-1, 4))
                offset[i, lv] = base
                base += mip.shape[0] * mip.shape[1]
            else:
                offset[i, lv] = offset[i, lv - 1]
            height[i, lv], width[i, lv] = mip.shape[:2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Pool(t(np.concatenate(flat)), t(offset), t(width), t(height))


def _geometry(doc: dict, blob: bytes, device) -> Geometry:
    """Every primitive of the file's first mesh, each triangle's corners
    with their attributes and its material's flags."""
    parts = []
    for prim in doc["meshes"][0]["primitives"]:
        attrs = prim["attributes"]
        pos = _accessor(doc, blob, attrs["POSITION"]).astype(np.float32)
        nrm = _accessor(doc, blob, attrs["NORMAL"]).astype(np.float32)
        uvs = _accessor(doc, blob, attrs["TEXCOORD_0"]).astype(np.float32)
        idx = _accessor(doc, blob, prim["indices"]).reshape(-1, 3).astype(np.int64)
        mat = doc["materials"][prim["material"]]
        cutout = mat.get("alphaMode", "OPAQUE") == "MASK"
        parts.append(dict(pos=pos, nrm=_unit64(nrm).astype(np.float32),
                          tan=_unit64(_tangents(pos, uvs, idx)).astype(np.float32),
                          uv=uvs, idx=idx, material=prim["material"],
                          double_sided=bool(mat.get("doubleSided", False)), cutout=cutout))
    base = np.cumsum([0] + [p["pos"].shape[0] for p in parts[:-1]])
    cat = {k: np.concatenate([p[k] for p in parts]) for k in ("pos", "nrm", "tan", "uv")}
    idx = np.concatenate([p["idx"] + b for p, b in zip(parts, base)])
    per_tri = {k: np.concatenate([np.full(p["idx"].shape[0], p[k]) for p in parts])
               for k in ("material", "double_sided", "cutout")}
    p0, p1, p2 = (cat["pos"][idx[:, k]] for k in range(3))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa
    return Geometry(
        v0=f(p0), e1=f(p1 - p0), e2=f(p2 - p0),
        n=tuple(f(cat["nrm"][idx[:, k]]) for k in range(3)),
        t=tuple(f(cat["tan"][idx[:, k]]) for k in range(3)),
        uv=tuple(f(cat["uv"][idx[:, k]]) for k in range(3)),
        material=torch.from_numpy(per_tri["material"].astype(np.int64)).to(device),
        double_sided=torch.from_numpy(per_tri["double_sided"]).to(device),
        cutout=torch.from_numpy(per_tri["cutout"]).to(device),
    )


def load_mesh(glb: Path, device) -> Geometry:
    """A moving configuration's mesh in object space (its own material
    ids, which ``place`` replaces)."""
    return _geometry(*_read_glb(glb), device)


def place(scene: RefScene, mesh: Geometry, transforms: np.ndarray,
          materials: list[int]) -> RefScene:
    """The scene of one frame: the hall under ``transforms[0]`` and instance
    i under ``transforms[i]`` with material ``materials[i - 1]``.  Each
    triangle's corners (v0, v0 + e1, v0 + e2) go to world space in float32,
    the configuration's precision, each coordinate m[r, 0] x + m[r, 1] y +
    m[r, 2] z + m[r, 3] from left to right; normals and tangents by the
    upper 3x3 (as glTF nodes carry them), divided by their length; a
    mirroring transform swaps corners 1 and 2."""
    parts = [(scene.geometry, transforms[0], None)]
    parts += [(mesh, m, k) for m, k in zip(transforms[1:], materials)]
    out = [_transform(g, m, k) for g, m, k in parts]
    cat = lambda field: torch.cat([getattr(g, field) for g in out])  # noqa: E731
    corners = lambda field: tuple(torch.cat([getattr(g, field)[k] for g in out])  # noqa: E731
                                  for k in range(3))
    geometry = Geometry(v0=cat("v0"), e1=cat("e1"), e2=cat("e2"), n=corners("n"),
                        t=corners("t"), uv=corners("uv"), material=cat("material"),
                        double_sided=cat("double_sided"), cutout=cat("cutout"))
    return scene._replace(geometry=geometry)


def _transform(g: Geometry, m: np.ndarray, material: int | None) -> Geometry:
    m32 = np.asarray(m, np.float32)
    rows = [[float(x) for x in row] for row in m32]

    def point(v):
        return torch.stack([v[:, 0] * r[0] + v[:, 1] * r[1] + v[:, 2] * r[2] + r[3]
                            for r in rows[:3]], dim=-1)

    def direction(v):
        w = torch.stack([v[:, 0] * r[0] + v[:, 1] * r[1] + v[:, 2] * r[2] for r in rows[:3]],
                        dim=-1)
        length = torch.sqrt(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1] + w[:, 2] * w[:, 2])
        return w / torch.clamp_min(length, 1e-20)[:, None]

    p0, p1, p2 = point(g.v0), point(g.v0 + g.e1), point(g.v0 + g.e2)
    n, t, uv = [direction(x) for x in g.n], [direction(x) for x in g.t], list(g.uv)
    if np.linalg.det(m32[:3, :3].astype(np.float64)) < 0.0:
        p1, p2 = p2, p1
        for corner in (n, t, uv):
            corner[1], corner[2] = corner[2], corner[1]
    mat = g.material if material is None else torch.full_like(g.material, material)
    return Geometry(v0=p0, e1=p1 - p0, e2=p2 - p0, n=tuple(n), t=tuple(t), uv=tuple(uv),
                    material=mat, double_sided=g.double_sided, cutout=g.cutout)


def load(glb: Path, hdr: Path, sun_dir, sun_color, device) -> RefScene:
    """The scene as the reference sees it, on ``device``."""
    doc, blob = _read_glb(glb)
    geometry = _geometry(doc, blob, device)
    mats = doc["materials"]
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa
    pbr = [m.get("pbrMetallicRoughness", {}) for m in mats]
    materials = Materials(
        base_color=f([p.get("baseColorFactor", [1, 1, 1, 1]) for p in pbr]),
        roughness=f([p.get("roughnessFactor", 1.0) for p in pbr]),
        metallic=f([p.get("metallicFactor", 1.0) for p in pbr]),
        cutoff=f([m.get("alphaCutoff", 0.5) for m in mats]),
        texture=torch.tensor([p.get("baseColorTexture", {}).get("index", -1) for p in pbr],
                             dtype=torch.int64, device=device),
    )
    pool = None
    if doc.get("textures"):
        images = []
        for tex in doc["textures"]:
            view = doc["bufferViews"][doc["images"][tex["source"]]["bufferView"]]
            off = view.get("byteOffset", 0)
            images.append(decode_png(blob[off:off + view["byteLength"]]))
        pool = build_pool(images, device)
    lights = doc["extensions"]["KHR_lights_punctual"]["lights"]
    l_pos, l_col = [], []
    for node in doc["nodes"]:
        ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if ext is not None:
            light = lights[ext["light"]]
            l_pos.append(node["translation"])
            l_col.append(np.asarray(light["color"], np.float32) * light.get("intensity", 1.0))
    return RefScene(
        geometry=geometry, materials=materials, lights_pos=f(l_pos), lights_color=f(l_col),
        sun_dir=f(sun_dir), sun_color=f(sun_color), panorama=f(read_hdr(hdr)), pool=pool)
