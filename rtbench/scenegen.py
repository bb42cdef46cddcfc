"""The benchmark's scenes: a frozen copy of the Sponza-like generator and
the writers of the files it hands the program.

The arrays are those of ``vulkanraytracing_torch.scene.procedural``'s
``sponza_like_scene`` (``workload="v1"`` and ``"real"``) as it stood when
the benchmark was written: numpy on the host, ``default_rng(seed)`` in the
same call order, the same per-triangle corners, flat normals, uvs and
flags, textures and sky.  They are kept here, and not imported, so that a
change to the program's generator cannot change what the benchmark
measures; ``rtbench/tests/test_rtbench_scenegen.py`` holds the two equal
at the program's default seed.

A scene is written once per (configuration, seed) as ``scene.glb`` (the
layout of the program's ``scene/gltf_export.py``: one primitive and one
material per (material, double-sided, cutout) group, each triangle's
corners written out, the textures as embedded PNGs, the point lights as
``KHR_lights_punctual``) and ``sky.hdr`` (flat RGBE scanlines).  The sun
is not part of glTF; the configuration file states it.

A configuration whose scene moves (``motion.py``) also has its mesh written
once per (radius, lat, lon) as ``mesh.glb``: the UV sphere in the same
layout, with one plain single-sided opaque material and no lights.  Neither
side shades with that material: an instance takes the hall's material that
the configuration names (``material_indices``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

HALL = (20.0, 8.0, 10.0)
SUN_DIR = (0.3, -1.0, 0.2)
SUN_COLOR = (8.0, 7.5, 7.0, 1.0)
LIGHT_POSITIONS = ((-8.0, 2.0, 0.0, 1.0), (8.0, 2.0, 0.0, 1.0),
                   (0.0, 3.0, -4.0, 1.0), (0.0, 3.0, 4.0, 1.0))
LIGHT_COLORS = ((30.0, 25.0, 20.0, 1.0), (20.0, 25.0, 30.0, 1.0),
                (25.0, 25.0, 25.0, 1.0), (28.0, 22.0, 18.0, 1.0))
V1_SKY = (2.0, 2.2, 2.5)


class Part:
    """Triangles of one generator call: corners, flat or given normals,
    uvs, and the per-triangle flags."""

    def __init__(self, verts, idx, uvs=None, material=0, double_sided=False,
                 cutout=False):
        verts = np.asarray(verts, np.float32)
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        p0, p1, p2 = (verts[idx[:, k]] for k in range(3))
        self.v0 = p0
        self.e1 = p1 - p0
        self.e2 = p2 - p0
        gn = np.cross(self.e1, self.e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        self.normal = gn
        t = idx.shape[0]
        if uvs is None:
            self.uv = [np.zeros((t, 2), np.float32)] * 3
        else:
            uvs = np.asarray(uvs, np.float32)
            self.uv = [uvs[idx[:, k]] for k in range(3)]
        self.material = np.full(t, material, np.int32)
        self.double_sided = np.full(t, double_sided, bool)
        self.cutout = np.full(t, cutout, bool)

    @property
    def count(self) -> int:
        return self.v0.shape[0]


class SceneData:
    """A generated scene on the host: per-triangle arrays, materials,
    lights, texture images and the sky panorama."""

    def __init__(self, parts, materials, images, sky):
        self.v0 = np.concatenate([p.v0 for p in parts])
        self.e1 = np.concatenate([p.e1 for p in parts])
        self.e2 = np.concatenate([p.e2 for p in parts])
        self.normal = np.concatenate([p.normal for p in parts])
        self.uv = [np.concatenate([p.uv[k] for p in parts]) for k in range(3)]
        self.material = np.concatenate([p.material for p in parts])
        self.double_sided = np.concatenate([p.double_sided for p in parts])
        self.cutout = np.concatenate([p.cutout for p in parts])
        self.materials = materials  # dict of per-material lists
        self.images = images        # list of (H, W, 4) uint8, or []
        self.sky = sky              # (H, 2H, 3) float32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def generate_sphere(radius: float = 1.0, lat: int = 16, lon: int = 32):
    """UV sphere (positions, indices), front faces out."""
    phis = np.linspace(0.0, np.pi, lat + 1)
    thetas = np.linspace(0.0, 2.0 * np.pi, lon, endpoint=False)
    verts = []
    for phi in phis:
        for theta in thetas:
            verts.append(
                [
                    radius * np.sin(phi) * np.cos(theta),
                    radius * np.cos(phi),
                    radius * np.sin(phi) * np.sin(theta),
                ]
            )
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            idx.append([a, b, c])
            idx.append([b, d, c])
    return verts, np.asarray(idx, np.int32)


def _quad(p0, p1, p2, p3):
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def _value_noise(size: int, rng, octaves: int = 5) -> np.ndarray:
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = 4 << o
        if cells > size:
            break
        grid = rng.random((cells, cells)).astype(np.float32)
        gx = np.linspace(0, cells, size, endpoint=False)
        x0 = np.floor(gx).astype(int) % cells
        x1 = (x0 + 1) % cells
        fx = (gx - np.floor(gx)).astype(np.float32)
        fx = fx * fx * (3 - 2 * fx)
        row = grid[:, x0] * (1 - fx) + grid[:, x1] * fx
        col = row[x0, :] * (1 - fx[:, None]) + row[x1, :] * fx[:, None]
        out += amp * col
        total += amp
        amp *= 0.5
    return out / total


def _stone_texture(size: int, rng, base, veins) -> np.ndarray:
    n = _value_noise(size, rng)
    v = _value_noise(size, rng, octaves=7)
    vein = 0.5 + 0.5 * np.sin(8.0 * np.pi * (v + 0.35 * n))
    base = np.asarray(base, np.float32)
    veins = np.asarray(veins, np.float32)
    rgb = base[None, None] * (0.75 + 0.5 * n[..., None]) \
        + veins[None, None] * (0.25 * vein[..., None])
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = 255
    return img


def _checker_texture(size: int, rng, a, b, cells: int = 16) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size + yy * cells // size) % 2).astype(bool)
    n = _value_noise(size, rng)
    img = np.zeros((size, size, 4), np.uint8)
    rgb = np.where(mask[..., None], np.asarray(a, np.float32),
                   np.asarray(b, np.float32)) * (0.8 + 0.4 * n[..., None])
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = 255
    return img


def _foliage_texture(size: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alpha = np.zeros((size, size), np.float32)
    rgb = np.zeros((size, size, 3), np.float32)
    for _ in range(60):
        cx, cy = rng.random(2)
        rx = rng.uniform(0.02, 0.09)
        ry = rx * rng.uniform(0.4, 0.9)
        ang = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        d = (u / rx) ** 2 + (v / ry) ** 2
        leaf = d < 1.0
        alpha[leaf] = 1.0
        shade = rng.uniform(0.5, 1.0)
        col = np.array([0.12 * shade, 0.45 * shade, 0.10 * shade], np.float32)
        rgb[leaf] = col
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = (alpha * 255 + 0.5).astype(np.uint8)
    return img


def sky_panorama(height: int = 512, seed: int = 11, sun_dir=SUN_DIR) -> np.ndarray:
    """HDR equirectangular sky (height x 2*height x 3 float32): a horizon
    gradient, a sun disc along the scene's sun and low-frequency clouds."""
    rng = np.random.default_rng(seed)
    h, w = height, height * 2
    phi = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    theta = (np.arange(w, dtype=np.float32) + 0.5) / w * 2 * np.pi
    sp = np.sin(phi)[:, None]
    dirs = np.stack(
        [sp * np.cos(theta)[None, :],
         np.broadcast_to(np.cos(phi)[:, None], (h, w)),
         sp * np.sin(theta)[None, :]], axis=-1)
    up = dirs[..., 1]
    horizon = np.clip(1.0 - np.abs(up), 0.0, 1.0) ** 3
    sky = (np.array([0.25, 0.45, 0.9], np.float32)[None, None]
           * (0.6 + 0.8 * np.clip(up, 0, 1))[..., None]
           + np.array([0.9, 0.7, 0.5], np.float32)[None, None]
           * horizon[..., None] * 0.8)
    ground = np.array([0.18, 0.14, 0.10], np.float32)[None, None] \
        * (0.4 + 0.3 * np.clip(-up, 0, 1))[..., None]
    img = np.where(up[..., None] >= 0, sky, ground).astype(np.float32)
    clouds = _value_noise(h, rng, octaves=4)
    clouds = np.concatenate([clouds, clouds], axis=1)[:, :w]
    img += (np.clip(clouds - 0.55, 0, 1) * 4.0 * np.clip(up, 0, 1))[..., None] \
        * np.array([1.0, 1.0, 1.0], np.float32)
    s = -np.asarray(sun_dir, np.float32)
    s /= np.linalg.norm(s)
    cosang = np.clip(np.einsum("hwc,c->hw", dirs, s), -1, 1)
    img += (np.exp((cosang - 1.0) * 4000.0) * 800.0)[..., None] \
        * np.array([1.0, 0.95, 0.85], np.float32)
    img += (np.exp((cosang - 1.0) * 40.0) * 1.5)[..., None] \
        * np.array([1.0, 0.9, 0.7], np.float32)
    return img.astype(np.float32)


def _sphere_uvs(verts: np.ndarray, center: np.ndarray) -> np.ndarray:
    d = verts - center[None, :]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    u = (np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5).astype(np.float32)
    v = (np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi).astype(np.float32)
    return np.stack([u, v], axis=-1)


def real_images(seed: int) -> list[np.ndarray]:
    """The real scene's texture images in pool order."""
    tex_rng = np.random.default_rng(seed + 100)
    return [
        _checker_texture(1024, tex_rng, (0.75, 0.72, 0.66), (0.45, 0.42, 0.4), cells=24),
        _stone_texture(1024, tex_rng, (0.55, 0.5, 0.44), (0.3, 0.26, 0.22)),
        _stone_texture(1024, tex_rng, (0.72, 0.7, 0.62), (0.5, 0.46, 0.4)),
        _foliage_texture(512, tex_rng),
    ]


def _shell(parts: list, textured: bool) -> None:
    """Floor, ceiling and four walls (uv tiles on the real scene)."""
    h = HALL

    def add(p0, p1, p2, p3, mat, uv_scale):
        v, i = _quad(p0, p1, p2, p3)
        uvs = None
        if textured:
            su, sv = uv_scale
            uvs = np.array([[0, 0], [su, 0], [su, sv], [0, sv]], np.float32)
        parts.append(Part(v, i, uvs, mat, double_sided=True))

    add([-h[0], 0, -h[2]], [-h[0], 0, h[2]], [h[0], 0, h[2]], [h[0], 0, -h[2]], 0, (8, 4))
    add([-h[0], h[1], -h[2]], [h[0], h[1], -h[2]], [h[0], h[1], h[2]],
        [-h[0], h[1], h[2]], 0, (8, 4))
    add([-h[0], 0, -h[2]], [h[0], 0, -h[2]], [h[0], h[1], -h[2]],
        [-h[0], h[1], -h[2]], 1, (8, 2))
    add([-h[0], 0, h[2]], [-h[0], h[1], h[2]], [h[0], h[1], h[2]], [h[0], 0, h[2]], 1, (8, 2))
    add([-h[0], 0, -h[2]], [-h[0], h[1], -h[2]], [-h[0], h[1], h[2]],
        [-h[0], 0, h[2]], 1, (4, 2))
    add([h[0], 0, -h[2]], [h[0], 0, h[2]], [h[0], h[1], h[2]], [h[0], h[1], -h[2]], 1, (4, 2))


def _columns(parts: list, textured: bool) -> None:
    n_cols = 16
    for k in range(n_cols):
        x = -HALL[0] + (k % (n_cols // 2) + 0.5) * (2 * HALL[0] / (n_cols // 2))
        z = -HALL[2] * 0.5 if k < n_cols // 2 else HALL[2] * 0.5
        sv, si = generate_sphere(0.8, lat=24, lon=48)
        sv = sv * np.array([1.0, 5.0, 1.0], np.float32)
        center = np.array([x, 4.0, z], np.float32)
        sv = sv + center
        uvs = _sphere_uvs(sv, center) * np.array([4.0, 4.0], np.float32) if textured else None
        parts.append(Part(sv, si, uvs, 2))


def _clutter(parts: list, rng, target: int, textured: bool) -> None:
    remaining = max(target - sum(p.count for p in parts), 0)
    lat, lon = 8, 16
    for _ in range(remaining // (2 * lat * lon)):
        sv, si = generate_sphere(float(rng.uniform(0.1, 0.5)), lat=lat, lon=lon)
        pos = np.array([rng.uniform(-HALL[0], HALL[0]), rng.uniform(0.2, HALL[1] - 0.5),
                        rng.uniform(-HALL[2], HALL[2])], np.float32)
        mat = int(rng.integers(0, 5))
        uvs = _sphere_uvs(sv + pos, pos) if textured else None
        parts.append(Part(sv + pos, si, uvs, mat))


def _foliage(parts: list, rng, target: int) -> None:
    """Bushes of crossed cutout quads on a jittered grid along the walls."""
    quads_per_bush = 10
    n_bush = max((target // 25) // (quads_per_bush * 2), 1)
    uvs_leaf = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    slots = []
    for side in (-1.0, 1.0):
        x = -HALL[0] + 1.0
        while x < HALL[0] - 1.0:
            slots.append((x, side * (HALL[2] - 1.1)))
            x += 1.6
    rng.shuffle(slots)
    for b in range(n_bush):
        bx, bz = slots[b % len(slots)]
        bx += rng.uniform(-0.3, 0.3)
        bz += rng.uniform(-0.2, 0.2)
        by = rng.uniform(0.5, 0.9)
        for _ in range(quads_per_bush):
            s = rng.uniform(0.25, 0.5)
            ang = rng.uniform(0, np.pi)
            tilt = rng.uniform(-0.3, 0.3)
            ox = rng.uniform(-0.35, 0.35)
            oy = rng.uniform(-0.3, 0.5)
            oz = rng.uniform(-0.35, 0.35)
            ca, sa = np.cos(ang) * s, np.sin(ang) * s
            cx, cy, cz = bx + ox, by + oy, bz + oz
            v, i = _quad([cx - ca, cy - s + tilt, cz - sa], [cx + ca, cy - s - tilt, cz + sa],
                         [cx + ca, cy + s - tilt, cz + sa], [cx - ca, cy + s + tilt, cz - sa])
            parts.append(Part(v, i, uvs_leaf, 5, double_sided=True, cutout=True))


def sponza(kind: str, triangles: int, seed: int) -> SceneData:
    """The hall of ``kind`` "v1" (factor-only materials, a constant sky)
    or "real" (mipped textures, alpha-tested foliage, an HDR sky)."""
    rng = np.random.default_rng(seed)
    parts: list[Part] = []
    if kind == "v1":
        _shell(parts, textured=False)
        _columns(parts, textured=False)
        _clutter(parts, rng, triangles, textured=False)
        materials = dict(
            base_color=[(0.65, 0.62, 0.58, 1.0), (0.55, 0.5, 0.45, 1.0), (0.7, 0.68, 0.6, 1.0),
                        (0.6, 0.3, 0.2, 1.0), (0.3, 0.4, 0.6, 1.0)],
            roughness=[0.9, 0.85, 0.7, 0.5, 0.3], metallic=[0.0, 0.0, 0.0, 0.0, 0.8],
            cutoff=[0.5] * 5, base_color_texture=[-1] * 5)
        sky = np.broadcast_to(np.asarray(V1_SKY, np.float32), (16, 32, 3)).copy()
        return SceneData(parts, materials, [], sky)
    if kind != "real":
        raise ValueError(f"scene kind must be 'v1' or 'real', got {kind!r}")
    images = real_images(seed)
    _shell(parts, textured=True)
    _columns(parts, textured=True)
    _foliage(parts, rng, triangles)
    _clutter(parts, rng, triangles, textured=True)
    materials = dict(
        base_color=[(1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0),
                    (0.6, 0.3, 0.2, 1.0), (0.3, 0.4, 0.6, 1.0), (1.0, 1.0, 1.0, 1.0)],
        roughness=[0.9, 0.85, 0.7, 0.5, 0.3, 0.8], metallic=[0.0, 0.0, 0.0, 0.0, 0.8, 0.0],
        cutoff=[0.5] * 6, base_color_texture=[0, 1, 2, -1, -1, 3])
    return SceneData(parts, materials, images, sky_panorama(512, seed=seed + 200))


# --- writers ---------------------------------------------------------------

def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes (filter 0 on every row, zlib 6)."""
    h, w, c = image.shape
    def chunk(tag, data):
        body = tag + data
        return (len(data).to_bytes(4, "big") + body
                + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big"))
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, {3: 2, 4: 6}[c], 0, 0, 0])
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_glb(scene: SceneData, path: Path, lights: bool = True) -> None:
    """The scene as a .glb in the program's export layout, with the point
    lights where ``lights``."""
    v0 = scene.v0
    p1 = v0 + scene.e1
    p2 = v0 + scene.e2
    mats = scene.materials
    groups = sorted({(int(m), bool(c), bool(a)) for m, c, a
                     in zip(scene.material, scene.double_sided, scene.cutout)})
    blob = bytearray()
    views: list[dict] = []
    accessors: list[dict] = []

    def push(data: np.ndarray, target: int | None) -> int:
        start = len(blob)
        raw = np.ascontiguousarray(data).tobytes()
        blob.extend(raw)
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": start, "byteLength": len(raw)}
        if target is not None:
            view["target"] = target
        views.append(view)
        return len(views) - 1

    def accessor(view: int, comp: int, count: int, kind: str, minmax=None) -> int:
        acc = {"bufferView": view, "componentType": comp, "count": count, "type": kind}
        if minmax is not None:
            acc["min"] = [float(x) for x in minmax.min(axis=0)]
            acc["max"] = [float(x) for x in minmax.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    materials_json, primitives = [], []
    for gmat, gcull, gcut in groups:
        sel = np.nonzero((scene.material == gmat) & (scene.double_sided == gcull)
                         & (scene.cutout == gcut))[0]
        t = sel.size
        pos = np.empty((3 * t, 3), np.float32)
        pos[0::3], pos[1::3], pos[2::3] = v0[sel], p1[sel], p2[sel]
        nrm = np.empty((3 * t, 3), np.float32)
        nrm[0::3] = nrm[1::3] = nrm[2::3] = scene.normal[sel]
        uv = np.empty((3 * t, 2), np.float32)
        uv[0::3], uv[1::3], uv[2::3] = (u[sel] for u in scene.uv)
        attr = {
            "POSITION": accessor(push(pos, 34962), 5126, 3 * t, "VEC3", minmax=pos),
            "NORMAL": accessor(push(nrm, 34962), 5126, 3 * t, "VEC3"),
            "TEXCOORD_0": accessor(push(uv, 34962), 5126, 3 * t, "VEC2"),
        }
        indices = accessor(push(np.arange(3 * t, dtype=np.uint32), 34963), 5125, 3 * t,
                           "SCALAR")
        primitives.append({"attributes": attr, "indices": indices,
                           "material": len(materials_json)})
        pbr = {"baseColorFactor": [float(np.float32(x)) for x in mats["base_color"][gmat]],
               "roughnessFactor": float(np.float32(mats["roughness"][gmat])),
               "metallicFactor": float(np.float32(mats["metallic"][gmat]))}
        tex = mats["base_color_texture"][gmat]
        if scene.images and 0 <= tex < len(scene.images):
            pbr["baseColorTexture"] = {"index": tex}
        mat = {"name": f"mat{gmat}" + ("_ds" if gcull else "") + ("_cut" if gcut else ""),
               "pbrMetallicRoughness": pbr}
        if gcull:
            mat["doubleSided"] = True
        if gcut:
            mat["alphaMode"] = "MASK"
            mat["alphaCutoff"] = float(np.float32(mats["cutoff"][gmat]))
        materials_json.append(mat)

    doc: dict = {
        "asset": {"version": "2.0", "generator": "rtbench"},
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "flattened"}],
        "meshes": [{"primitives": primitives}],
        "materials": materials_json,
    }
    if scene.images:
        images_json = []
        for img in scene.images:
            view = push(np.frombuffer(encode_png(img), np.uint8), None)
            images_json.append({"bufferView": view, "mimeType": "image/png"})
        doc["textures"] = [{"source": i, "sampler": 0} for i in range(len(images_json))]
        doc["images"] = images_json
        doc["samplers"] = [{"magFilter": 9729, "minFilter": 9987,
                            "wrapS": 10497, "wrapT": 10497}]
    if lights:
        points = []
        for i, (pos, col) in enumerate(zip(LIGHT_POSITIONS, LIGHT_COLORS)):
            points.append({"type": "point", "intensity": 1.0,
                           "color": [float(c) for c in col[:3]]})
            doc["nodes"].append({"name": f"light{i}", "translation": [float(x) for x in pos[:3]],
                                 "extensions": {"KHR_lights_punctual": {"light": i}}})
            doc["scenes"][0]["nodes"].append(len(doc["nodes"]) - 1)
        doc["extensions"] = {"KHR_lights_punctual": {"lights": points}}
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
    doc["accessors"] = accessors
    doc["bufferViews"] = views
    doc["buffers"] = [{"byteLength": len(blob)}]

    js = json.dumps(doc, separators=(",", ":")).encode()
    while len(js) % 4:
        js += b" "
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(bytes(blob))


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


def write_hdr(path: Path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    Path(path).write_bytes(header + float_to_rgbe(rgb).tobytes())


def _write_once(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def scene_files(cache_dir: Path, kind: str, triangles: int, seed: int) -> tuple[Path, Path]:
    """(scene.glb, sky.hdr) of (kind, triangles, seed) in ``cache_dir``,
    written once: a later run with the same key finds them."""
    d = Path(cache_dir) / f"{kind}-{triangles}-{seed}"
    glb, hdr = d / "scene.glb", d / "sky.hdr"
    if glb.exists() and hdr.exists():
        return glb, hdr
    d.mkdir(parents=True, exist_ok=True)
    scene = sponza(kind, triangles, seed)
    _write_once(glb, lambda p: write_glb(scene, p))
    _write_once(hdr, lambda p: write_hdr(p, scene.sky))
    return glb, hdr


def mesh_file(cache_dir: Path, mesh: dict) -> Path:
    """``mesh.glb`` of a moving configuration's UV sphere (its ``radius``,
    ``lat`` and ``lon``) in ``cache_dir``, written once."""
    radius, lat, lon = float(mesh["radius"]), int(mesh["lat"]), int(mesh["lon"])
    path = Path(cache_dir) / f"sphere-{radius!r}-{lat}-{lon}" / "mesh.glb"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    verts, idx = generate_sphere(radius, lat=lat, lon=lon)
    plain = dict(base_color=[(1.0, 1.0, 1.0, 1.0)], roughness=[1.0], metallic=[0.0],
                 cutoff=[0.5], base_color_texture=[-1])
    scene = SceneData([Part(verts, idx)], plain, [], None)
    _write_once(path, lambda p: write_glb(scene, p, lights=False))
    return path


def material_indices(glb: Path, materials: list[int]) -> list[int]:
    """The glTF index, in the hall's ``glb``, of each configuration
    material in ``materials``: its single-sided opaque group (``mat<k>``),
    which ``write_glb`` names."""
    with open(glb, "rb") as f:
        length = struct.unpack("<I", f.read(20)[12:16])[0]
        names = [m["name"] for m in json.loads(f.read(length))["materials"]]
    missing = sorted({k for k in materials if f"mat{k}" not in names})
    if missing:
        raise ValueError(f"{glb}: no single-sided opaque material {missing}")
    return [names.index(f"mat{k}") for k in materials]
