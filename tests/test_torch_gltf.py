"""The port's glTF loader and .glb exporter against the JAX package's.

- Each synthesized asset of ``tests/test_gltf.py`` (and a few more that
  reach the loader's other paths: sparse and normalized accessors, a
  strided buffer view, a mirrored node, an untextured cutout, embedded
  PNG textures) is loaded by both loaders, and every array is bit-equal:
  positions, indices (as the triangles they pick), normals, tangents,
  uvs, flags, materials, lights, the camera and the texture pool.
- A .glb written by the port's exporter, loaded by the JAX loader, equals
  the JAX exporter's .glb loaded the same way (its PNGs are encoded by
  ``app.image_io.encode_png``, the JAX exporter's by Pillow).
"""

import base64
import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch
from test_gltf import _tri_gltf, _write

from vulkanraytracing_torch.ops.texture import TexturePool
from vulkanraytracing_torch.scene import gltf as tgltf
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.gltf_export import export_scene_glb as t_export
from vulkanraytracing_torch.scene.types import Materials, PointLights, TraceGeometry
from vulkanraytracing_tpu.scene import gltf as jgltf
from vulkanraytracing_tpu.scene import procedural as jproc
from vulkanraytracing_tpu.scene.gltf_export import export_scene_glb as j_export

torch.set_num_threads(1)


def _blob(doc):
    return base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])


def _set_blob(doc, blob):
    doc["buffers"] = [{"uri": "data:application/octet-stream;base64,"
                              + base64.b64encode(blob).decode(), "byteLength": len(blob)}]


def _append(doc, data: bytes) -> int:
    """A new buffer view over ``data`` appended to the document's buffer."""
    blob = _blob(doc)
    blob += b"\x00" * (-len(blob) % 4)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
    _set_blob(doc, blob + data)
    return len(doc["bufferViews"]) - 1


def _glb(doc, path):
    blob = _blob(doc)
    doc = dict(doc, buffers=[{"byteLength": len(blob)}])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob))
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)
    return path


def _sparse(tmp_path):
    """POSITION with a sparse override of vertex 2, uvs as normalized
    uint16 from a strided buffer view."""
    doc = _tri_gltf()
    idx = _append(doc, np.array([2], np.uint16).tobytes() + b"\x00\x00")
    val = _append(doc, np.array([[0.25, 2.0, 0.5]], np.float32).tobytes())
    doc["accessors"][0]["sparse"] = {
        "count": 1, "indices": {"bufferView": idx, "componentType": 5123},
        "values": {"bufferView": val}}
    # uvs: 3 vertices x (2 uint16 + 4 bytes of padding), stride 8
    uv = np.array([[0, 0], [65535, 0], [32768, 65535]], np.uint16)
    raw = b"".join(row.tobytes() + b"\xff" * 4 for row in uv)
    view = _append(doc, raw)
    doc["bufferViews"][view]["byteStride"] = 8
    doc["accessors"].append({"bufferView": view, "componentType": 5123, "count": 3,
                             "type": "VEC2", "normalized": True})
    doc["meshes"][0]["primitives"][0]["attributes"]["TEXCOORD_0"] = len(doc["accessors"]) - 1
    return _write(tmp_path, doc)


def _textured(tmp_path):
    """Two embedded PNG textures written by Pillow (the JAX exporter):
    an alpha-tested cutout and an opaque textured material."""
    from vulkanraytracing_tpu.ops.texture import build_texture_pool
    from vulkanraytracing_tpu.scene.types import (
        Scene, constant_environment, make_materials, make_trace_geometry, no_direct_light,
    )

    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (8, 8, 4), dtype=np.uint8),
              rng.integers(0, 256, (16, 4, 4), dtype=np.uint8)]
    positions = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    geom = make_trace_geometry(positions, np.array([[0, 1, 2], [0, 2, 3]]), uvs=uvs,
                               material_id=np.array([0, 1]), cull_disable=True,
                               opaque=np.array([False, True]), alpha_test=np.array([True, False]))
    mats = make_materials(base_color_factors=[(1, 1, 1, 1), (0.5, 0.6, 0.7, 1)],
                          roughness_factors=[0.7, 0.4], metallic_factors=[0.0, 0.5],
                          base_color_textures=[0, 1], alpha_cutoffs=[0.25, 0.5])
    scene = Scene(geometry=geom, materials=mats, environment=constant_environment((1, 1, 1)),
                  direct_light=no_direct_light(), point_lights=None, bvh=None,
                  textures=build_texture_pool(images, size=16))
    return j_export(scene, tmp_path / "textured.glb", images=images)


LIGHTS = {"KHR_lights_punctual": {"lights": [
    {"type": "point", "color": [1.0, 0.5, 0.25], "intensity": 4.0},
    {"type": "spot", "color": [1.0, 1.0, 1.0]}]}}
CAMERAS = [{"type": "perspective",
            "perspective": {"yfov": 0.8, "aspectRatio": 2.0, "znear": 0.1, "zfar": 500.0}}]


def _nested(tmp_path):
    doc = _tri_gltf()
    doc["nodes"] = [{"children": [1], "translation": [0, 10, 0]},
                    {"mesh": 0, "translation": [1, 0, 0]}]
    doc["scenes"] = [{"nodes": [0]}]
    return _write(tmp_path, doc)


ASSETS = {
    "basic_triangle": lambda p: _write(p, _tri_gltf()),
    "node_transform": lambda p: _write(p, _tri_gltf(
        transform={"translation": [5, 0, 0], "scale": [2, 2, 2]})),
    "nested_hierarchy": _nested,
    "material": lambda p: _write(p, _tri_gltf(material={
        "pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.25, 0.125, 1.0],
                                 "roughnessFactor": 0.3, "metallicFactor": 0.8},
        "emissiveFactor": [1.0, 2.0, 3.0], "alphaMode": "OPAQUE", "doubleSided": True})),
    "untextured_cutout": lambda p: _write(p, _tri_gltf(material={
        "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 0.3]},
        "alphaMode": "MASK", "alphaCutoff": 0.5})),
    "point_lights": lambda p: _write(p, _tri_gltf(
        extra_nodes=[{"translation": [1, 2, 3], "extensions": {"KHR_lights_punctual": {"light": 0}}},
                     {"translation": [4, 5, 6], "extensions": {"KHR_lights_punctual": {"light": 1}}}],
        extensions=LIGHTS)),
    "camera": lambda p: _write(p, _tri_gltf(
        extra_nodes=[{"camera": 0, "translation": [0, 0, 9], "rotation": [0, 0.38268343, 0, 0.9238795]}],
        cameras=CAMERAS)),
    "tangents_from_uvs": lambda p: _write(p, _tri_gltf(with_normals=True, with_uvs=True)),
    "rotated_mirrored": lambda p: _write(p, _tri_gltf(
        transform={"scale": [-1, 2, 1]}, rotation=[0.2, 0.3, 0.1, 0.9273618])),
    "glb_container": lambda p: _glb(_tri_gltf(with_uvs=True), p / "scene.glb"),
    "sparse_normalized_strided": _sparse,
    "textured_png": _textured,
}


def _port_arrays(scene, camera, pool):
    out = {f"geometry.{n}": getattr(scene.geometry, n).numpy() for n in TraceGeometry._fields}
    out.update({f"materials.{n}": getattr(scene.materials, n).numpy() for n in Materials._fields})
    if scene.point_lights is not None:
        out.update({f"lights.{n}": getattr(scene.point_lights, n).numpy()
                    for n in PointLights._fields})
    if pool is not None:
        out.update({f"pool.{n}": getattr(pool, n).numpy() for n in TexturePool._fields})
    return out, camera


def _jax_arrays(scene, camera, pool):
    scene = jax.tree.map(np.asarray, scene)
    out = {f"geometry.{n}": getattr(scene.geometry, n) for n in TraceGeometry._fields}
    out.update({f"materials.{n}": getattr(scene.materials, n) for n in Materials._fields})
    if scene.point_lights is not None:
        out.update({f"lights.{n}": getattr(scene.point_lights, n) for n in PointLights._fields})
    if pool is not None:
        out.update({f"pool.{n}": np.asarray(getattr(pool, n)) for n in TexturePool._fields})
    return out, camera


def _assert_same(got, want):
    (a, cam_a), (b, cam_b) = got, want
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert np.array_equal(a[name], b[name]), name
    assert (cam_a is None) == (cam_b is None)
    if cam_a is not None:
        assert dataclasses.asdict(cam_a) == dataclasses.asdict(cam_b)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_loaders_agree(asset, tmp_path):
    path = ASSETS[asset](tmp_path)
    got = tgltf.load_scene(path, device="cpu")
    want = jgltf.load_scene(path)
    _assert_same(_port_arrays(*got), _jax_arrays(*want))
    assert got[0].geometry.v0.device.type == "cpu"


def test_loader_refuses_an_image_it_cannot_decode(tmp_path, monkeypatch):
    """A JPEG needs Pillow; without it the load fails and names the image."""
    import builtins
    import io

    from PIL import Image

    doc = _tri_gltf(with_uvs=True, material={
        "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}})
    buf = io.BytesIO()
    Image.fromarray(np.full((4, 4, 3), 99, np.uint8)).save(buf, format="JPEG")
    doc["images"] = [{"bufferView": _append(doc, buf.getvalue()), "mimeType": "image/jpeg"}]
    doc["textures"] = [{"source": 0}]
    path = _write(tmp_path, doc)
    scene, _, pool = tgltf.load_scene(path, device="cpu")  # Pillow decodes it here
    assert pool.count == 1 and scene.textures is pool
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match="image 0 .bufferView"):
        tgltf.load_scene(path, device="cpu")


@pytest.mark.parametrize("name", ["cornell", "real"])
def test_port_export_loads_as_the_jax_export(name, tmp_path):
    """The same scene exported by both packages and loaded by the JAX
    loader: every array equal (the real scene's four textures included)."""
    if name == "cornell":
        t_scene, j_scene, images = (tproc.cornell_box_scene(device="cpu"),
                                    jproc.cornell_box_scene(), None)
    else:
        t_scene = tproc.sponza_like_scene(4000, workload="real", device="cpu")
        j_scene = jproc.sponza_like_scene(4000, workload="real")
        images = tproc.sponza_real_images()
    t_export(t_scene, tmp_path / "port.glb", images=images)
    j_export(j_scene, tmp_path / "jax.glb", images=images)
    got = _jax_arrays(*jgltf.load_scene(tmp_path / "port.glb"))
    want = _jax_arrays(*jgltf.load_scene(tmp_path / "jax.glb"))
    _assert_same(got, want)
    # and the port's loader reads the port's file as the JAX loader does
    _assert_same(_port_arrays(*tgltf.load_scene(tmp_path / "port.glb", device="cpu")), got)
