"""glTF 2.0 scene importer.

Counterpart of ``vulkanraytracing_tpu/scene/gltf.py``, the same numpy
work: .gltf (JSON) and .glb containers, accessors (strided, sparse,
normalized), the node hierarchy with accumulated transforms, instances
flattened to world space, TRIANGLES primitives only, normals and tangents
generated where missing, shading normals and tangents transformed by the
node matrix itself, instance flags from the material (OPAQUE commits,
doubleSided disables culling, MASK with a base color texture is
alpha-tested), KHR_lights_punctual point lights (colour times intensity),
the first perspective camera, and textures with their samplers' wrap
modes.  Every primitive is assembled on the host and the scene moves to
``device`` once, at the end (the card unless the caller names the CPU).
Images are decoded without Pillow where they are 8-bit greyscale, RGB or
RGBA PNGs.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from vulkanraytracing_torch.app.image_io import decode_png
from vulkanraytracing_torch.config import CameraConfig
from vulkanraytracing_torch.ops.texture import (
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
    TexturePool,
    build_texture_pool,
)
from vulkanraytracing_torch.scene.types import (
    PointLights,
    Scene,
    constant_environment,
    make_materials,
    make_trace_geometry,
    no_direct_light,
)
from vulkanraytracing_torch.utils.profiling import span

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}
_WRAP_MODES = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}


class GltfModel:
    """Parsed glTF document + binary buffers (the tinygltf::Model analog)."""

    def __init__(self, doc: dict, buffers: list[bytes], base_dir: Path):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @staticmethod
    def load(path: str | Path) -> "GltfModel":
        path = Path(path)
        data = path.read_bytes()
        if data[:4] == b"glTF":
            return GltfModel._load_glb(data, path.parent)
        doc = json.loads(data)
        buffers = [
            _load_buffer(b, path.parent) for b in doc.get("buffers", [])
        ]
        return GltfModel(doc, buffers, path.parent)

    @staticmethod
    def _load_glb(data: bytes, base_dir: Path) -> "GltfModel":
        magic, version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67 and version == 2, "bad GLB header"
        pos = 12
        doc: dict = {}
        bin_chunk = b""
        while pos < len(data):
            clen, ctype = struct.unpack_from("<II", data, pos)
            chunk = data[pos + 8 : pos + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                bin_chunk = chunk
            pos += 8 + clen
        buffers = []
        for i, b in enumerate(doc.get("buffers", [])):
            if i == 0 and "uri" not in b:
                buffers.append(bin_chunk)
            else:
                buffers.append(_load_buffer(b, base_dir))
        return GltfModel(doc, buffers, base_dir)

    # --- accessors ---

    def accessor(self, index: int) -> np.ndarray:
        """Accessor -> (count, components) float32/int array (zero-copy when
        tightly packed)."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or ncomp * itemsize
            if stride == ncomp * itemsize:
                out = np.frombuffer(
                    buf, dtype, count=count * ncomp, offset=offset
                ).reshape(count, ncomp)
            else:
                raw = np.frombuffer(
                    buf, np.uint8, count=stride * count, offset=offset
                ).reshape(count, stride)
                out = raw[:, : ncomp * itemsize].copy().view(dtype)

        if acc.get("sparse"):
            out = _apply_sparse(self, acc, out.copy())
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return out

    def image_bytes(self, image_index: int) -> tuple[bytes, str]:
        """An image's encoded bytes (file uri, data uri or bufferView) and
        where they came from, for error messages."""
        img = self.doc["images"][image_index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                return base64.b64decode(uri.split(",", 1)[1]), f"image {image_index} (data uri)"
            from urllib.parse import unquote

            path = self.base_dir / unquote(uri)
            return path.read_bytes(), str(path)
        bv = self.doc["bufferViews"][img["bufferView"]]
        buf = self.buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        return (bytes(buf[off: off + bv["byteLength"]]),
                f"image {image_index} (bufferView {img['bufferView']})")

    def image_pixels(self, image_index: int) -> np.ndarray:
        """Decode an image to (H, W, 4) uint8 RGBA.  8-bit greyscale, RGB
        and RGBA PNGs are decoded by ``app.image_io.decode_png`` (numpy and
        zlib); any other image (a JPEG, a palette PNG) needs Pillow, and
        without it the load fails naming the image."""
        data, where = self.image_bytes(image_index)
        try:
            pixels = decode_png(data)
        except ValueError as png_error:
            try:
                from PIL import Image
            except ImportError:
                raise ValueError(
                    f"cannot decode {where}: {png_error}, and Pillow, which other "
                    "image formats need, is not installed") from None
            from io import BytesIO

            return np.asarray(Image.open(BytesIO(data)).convert("RGBA"))
        if pixels.shape[-1] == 1:
            pixels = np.repeat(pixels, 3, axis=-1)
        if pixels.shape[-1] == 3:
            pixels = np.concatenate(
                [pixels, np.full(pixels.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        return pixels


def _load_buffer(buf: dict, base_dir: Path) -> bytes:
    uri = buf.get("uri", "")
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    from urllib.parse import unquote

    return (base_dir / unquote(uri)).read_bytes()


def _apply_sparse(model: GltfModel, acc: dict, out: np.ndarray) -> np.ndarray:
    sp = acc["sparse"]
    idx_acc = sp["indices"]
    idx_bv = model.doc["bufferViews"][idx_acc["bufferView"]]
    idx_dtype = _COMPONENT_DTYPES[idx_acc["componentType"]]
    idx = np.frombuffer(
        model.buffers[idx_bv["buffer"]], idx_dtype, count=sp["count"],
        offset=idx_bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0),
    )
    val_acc = sp["values"]
    val_bv = model.doc["bufferViews"][val_acc["bufferView"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    vals = np.frombuffer(
        model.buffers[val_bv["buffer"]], dtype, count=sp["count"] * ncomp,
        offset=val_bv.get("byteOffset", 0) + val_acc.get("byteOffset", 0),
    ).reshape(sp["count"], ncomp)
    out[idx] = vals
    return out


# ----------------------------------------------------------------------------
# node hierarchy


def _node_matrix(node: dict) -> np.ndarray:
    """TRS or matrix -> 4x4 (row convention M @ v)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m = _quat_matrix(x, y, z, w) @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _quat_matrix(x, y, z, w) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
    return m


def enumerate_nodes(model: GltfModel):
    """Yield (node_index, world_transform) in hierarchy order
    (depth first, as the reference renderer enumerates them)."""
    doc = model.doc
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{}])
    roots = scenes[scene_idx].get("nodes", []) if scenes else []

    def walk(index: int, parent: np.ndarray):
        node = doc["nodes"][index]
        world = parent @ _node_matrix(node)
        yield index, world
        for child in node.get("children", []):
            yield from walk(child, world)

    for root in roots:
        yield from walk(root, np.eye(4))


# ----------------------------------------------------------------------------
# attribute generation


def calculate_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    normals = np.zeros_like(positions)
    p0 = positions[indices[:, 0]]
    e1 = positions[indices[:, 1]] - p0
    e2 = positions[indices[:, 2]] - p0
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    return normals


def calculate_tangents(
    positions: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    tangents = np.zeros_like(positions)
    p0 = positions[indices[:, 0]]
    e1 = positions[indices[:, 1]] - p0
    e2 = positions[indices[:, 2]] - p0
    t0 = uvs[indices[:, 0]]
    d1 = uvs[indices[:, 1]] - t0
    d2 = uvs[indices[:, 2]] - t0
    d = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    d = np.where(d == 0.0, 1.0, d)  # the d == 0 guard
    ft = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / d[:, None]
    for k in range(3):
        np.add.at(tangents, indices[:, k], ft)
    lengths = np.linalg.norm(tangents, axis=-1)
    zero = lengths <= 0.0
    tangents[~zero] /= lengths[~zero, None]
    tangents[zero] = [1.0, 0.0, 0.0]  # the fallback for a zero tangent
    return tangents


# ----------------------------------------------------------------------------
# scene assembly


@span("vrt.setup.load_scene")
def load_scene(
    path: str | Path,
    texture_size: int = 2048,
    load_textures: bool = True,
    device: torch.device | str = "cuda",
) -> tuple[Scene, Optional[CameraConfig], Optional[TexturePool]]:
    """Load a glTF file into a renderable Scene (world-space flattened) on
    ``device``.

    Returns (scene, camera_config_or_None, texture_pool_or_None).  The
    environment and sun are not part of glTF: callers attach them."""
    model = GltfModel.load(path)
    doc = model.doc
    mat_meta = doc.get("materials", [{}]) or [{}]

    parts: list[dict] = []
    for node_index, world in enumerate_nodes(model):
        node = doc["nodes"][node_index]
        if node.get("mesh") is None:
            continue
        mesh = doc["meshes"][node["mesh"]]
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:
                raise ValueError("only TRIANGLES primitives are supported")
            parts.append(_convert_primitive(model, prim, world, mat_meta))

    if not parts:
        raise ValueError(f"no triangle geometry in {path}")
    geometry = make_trace_geometry(**_concat_primitives(parts), device=device)

    pool = None
    if load_textures and doc.get("textures"):
        pool = _convert_textures(model, texture_size, device)

    scene = Scene(
        geometry=geometry,
        materials=_convert_materials(doc, device),
        environment=constant_environment((0.0, 0.0, 0.0), device=device),
        direct_light=no_direct_light(device),
        point_lights=_convert_point_lights(model, device),
        bvh=None,
        textures=pool,
    )
    return scene, _convert_camera(model), pool


def _concat_primitives(parts: list[dict]) -> dict:
    """One indexed vertex set of every primitive, with per-triangle flags:
    the arguments of ``make_trace_geometry``."""
    base = np.cumsum([0] + [p["positions"].shape[0] for p in parts[:-1]])
    out = {name: np.concatenate([p[name] for p in parts])
           for name in ("positions", "normals", "tangents", "uvs")}
    out["indices"] = np.concatenate([p["indices"] + b for p, b in zip(parts, base)])
    for name in ("material_id", "cull_disable", "opaque", "alpha_test"):
        out[name] = np.concatenate([np.full(p["indices"].shape[0], p[name]) for p in parts])
    return out


def _convert_primitive(
    model: GltfModel, prim: dict, world: np.ndarray, mat_meta: list[dict]
) -> dict:
    attrs = prim["attributes"]
    positions = model.accessor(attrs["POSITION"]).astype(np.float32)
    count = positions.shape[0]

    if "indices" in prim:
        indices = model.accessor(prim["indices"]).reshape(-1).astype(np.int64)
    else:
        indices = np.arange(count, dtype=np.int64)
    indices = indices.reshape(-1, 3)

    uvs = (
        model.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
        if "TEXCOORD_0" in attrs
        else np.zeros((count, 2), np.float32)
    )
    normals = (
        model.accessor(attrs["NORMAL"]).astype(np.float32)
        if "NORMAL" in attrs
        else calculate_normals(positions, indices)
    )
    tangents = (
        model.accessor(attrs["TANGENT"]).astype(np.float32)[:, :3]
        if "TANGENT" in attrs
        else calculate_tangents(positions, uvs, indices)
    )

    # world-space flatten; normals and tangents by M itself
    m3 = world[:3, :3]
    pos_w = positions @ m3.T + world[:3, 3]
    nrm_w = normals @ m3.T
    nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-20)
    tan_w = tangents @ m3.T
    tan_w /= np.maximum(np.linalg.norm(tan_w, axis=-1, keepdims=True), 1e-20)

    # a negative-determinant transform flips the winding; compensate so
    # that back-face culling sees mirrored instances as Vulkan does
    if np.linalg.det(m3) < 0:
        indices = indices[:, ::-1]

    mat_id = prim.get("material", 0)
    meta = mat_meta[mat_id] if mat_id < len(mat_meta) else {}
    alpha_mode = meta.get("alphaMode", "OPAQUE")
    double_sided = bool(meta.get("doubleSided", False))
    base_alpha = meta.get("pbrMetallicRoughness", {}).get(
        "baseColorFactor", [1, 1, 1, 1]
    )[3]
    has_base_tex = (
        meta.get("pbrMetallicRoughness", {}).get("baseColorTexture") is not None
    )
    # OPAQUE commits directly; a non-opaque material with a base texture
    # needs the per-hit alpha test; an untextured cutout resolves here
    if alpha_mode == "OPAQUE":
        opaque, alpha_test = True, False
    elif has_base_tex:
        opaque, alpha_test = False, True
    else:
        opaque, alpha_test = base_alpha >= meta.get("alphaCutoff", 0.5), False

    return dict(positions=pos_w, indices=indices, normals=nrm_w, tangents=tan_w, uvs=uvs,
                material_id=mat_id, cull_disable=double_sided, opaque=opaque,
                alpha_test=alpha_test)


def _convert_materials(doc: dict, device):
    """Materials -> the SOA material table."""
    mats = doc.get("materials") or [{}]

    def tex(m: dict, *keys) -> int:
        cur: Any = m
        for k in keys:
            cur = cur.get(k) if isinstance(cur, dict) else None
            if cur is None:
                return -1
        return cur

    return make_materials(
        base_color_factors=[
            m.get("pbrMetallicRoughness", {}).get("baseColorFactor", [1, 1, 1, 1])
            for m in mats
        ],
        emission_factors=[m.get("emissiveFactor", [0, 0, 0]) + [1] for m in mats],
        roughness_factors=[
            m.get("pbrMetallicRoughness", {}).get("roughnessFactor", 1.0)
            for m in mats
        ],
        metallic_factors=[
            m.get("pbrMetallicRoughness", {}).get("metallicFactor", 1.0)
            for m in mats
        ],
        normal_scales=[m.get("normalTexture", {}).get("scale", 1.0) for m in mats],
        alpha_cutoffs=[m.get("alphaCutoff", 0.5) for m in mats],
        base_color_textures=[
            tex(m, "pbrMetallicRoughness", "baseColorTexture", "index")
            for m in mats
        ],
        roughness_metallic_textures=[
            tex(m, "pbrMetallicRoughness", "metallicRoughnessTexture", "index")
            for m in mats
        ],
        normal_textures=[tex(m, "normalTexture", "index") for m in mats],
        emission_textures=[tex(m, "emissiveTexture", "index") for m in mats],
        occlusion_textures=[tex(m, "occlusionTexture", "index") for m in mats],
        device=device,
    )


def _convert_point_lights(model: GltfModel, device) -> Optional[PointLights]:
    """KHR_lights_punctual point lights, colour times intensity."""
    doc = model.doc
    lights_def = doc.get("extensions", {}).get("KHR_lights_punctual", {}).get(
        "lights", []
    )
    if not lights_def:
        return None
    positions, colors = [], []
    for node_index, world in enumerate_nodes(model):
        node = doc["nodes"][node_index]
        ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if not ext:
            continue
        light = lights_def[ext["light"]]
        if light.get("type") != "point":
            continue
        intensity = light.get("intensity", 1.0)
        color = np.asarray(light.get("color", [1, 1, 1]), np.float32) * intensity
        positions.append(np.append(world[:3, 3].astype(np.float32), 1.0))
        colors.append(np.append(color, np.float32(intensity)))
    if not positions:
        return None

    def t(rows):
        return torch.from_numpy(np.stack(rows).astype(np.float32)).to(device)

    return PointLights(position=t(positions), color=t(colors))


def _convert_camera(model: GltfModel) -> Optional[CameraConfig]:
    """The first perspective camera node: x_fov = yfov * aspect, the
    direction rotation * (-Z), +Y up; the node's scale and matrix are
    ignored, as the reference renderer ignores them."""
    doc = model.doc
    for node_index, _world in enumerate_nodes(model):
        node = doc["nodes"][node_index]
        cam_idx = node.get("camera")
        if cam_idx is None:
            continue
        cam = doc["cameras"][cam_idx]
        if cam.get("type") != "perspective":
            continue
        p = cam["perspective"]
        aspect = p.get("aspectRatio", 16.0 / 9.0)
        rotation = node.get("rotation", [0, 0, 0, 1])
        rot = _quat_matrix(*rotation)[:3, :3]
        position = np.asarray(node.get("translation", [0, 0, 0]), np.float64)
        direction = rot @ np.array([0.0, 0.0, -1.0])
        return CameraConfig(
            position=tuple(position),
            target=tuple(position + direction),
            up=(0.0, 1.0, 0.0),
            x_fov=float(p["yfov"] * aspect),
            aspect_ratio=float(aspect),
            z_near=float(p.get("znear", 0.01)),
            z_far=float(p.get("zfar", 1000.0)),
        )
    return None


def _convert_textures(model: GltfModel, size: int, device) -> Optional[TexturePool]:
    """Textures and samplers -> the mipped texture pool at native
    resolutions, capped at ``size``."""
    doc = model.doc
    images, wraps = [], []
    samplers = doc.get("samplers", [])
    for tex in doc.get("textures", []):
        images.append(model.image_pixels(tex["source"]))
        s = samplers[tex["sampler"]] if "sampler" in tex else {}
        wraps.append(
            (
                _WRAP_MODES.get(s.get("wrapS", 10497), WRAP_REPEAT),
                _WRAP_MODES.get(s.get("wrapT", 10497), WRAP_REPEAT),
            )
        )
    return build_texture_pool(images, wraps, max_size=size, device=device)
