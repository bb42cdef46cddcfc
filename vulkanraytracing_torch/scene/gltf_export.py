"""Minimal glTF-binary (.glb) writer for flattened scenes.

Counterpart of ``vulkanraytracing_tpu/scene/gltf_export.py``: it puts the
glTF importer (``scene.gltf``) on the measured path.  A procedural scene
is exported once and loaded back, so that the scene then flows loader ->
BVH -> kernel as a user's asset would.

Scope: TRIANGLES primitives with POSITION/NORMAL/TEXCOORD_0 (each
triangle's three corners written out), pbrMetallicRoughness factors, one
embedded PNG a texture (encoded by ``app.image_io.encode_png``, zlib
only), doubleSided, alphaMode MASK and KHR_lights_punctual point lights.
The scene's tensors are read back to the host once.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from vulkanraytracing_torch.app.image_io import encode_png
from vulkanraytracing_torch.scene.types import Scene

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125
_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963


def export_scene_glb(
    scene: Scene,
    path: str | Path,
    images: list[np.ndarray] | None = None,
) -> Path:
    """Write ``scene``'s geometry/materials/textures/point lights as a .glb.

    Triangles are grouped into one primitive per (material_id,
    doubleSided, alphaTest) triple; each group becomes its own glTF
    material entry so per-triangle cull/alpha flags survive the round trip
    (the loader derives cull_disable from material.doubleSided and
    alpha_test from alphaMode MASK + baseColorTexture).

    ``images`` are the original texture images in pool order (the Scene
    only carries the flattened mipped pool); when given they are embedded
    as PNGs and material baseColorTexture indices are written, so
    scene.gltf._convert_textures rebuilds an equivalent pool on load."""
    def host(x, dtype):
        return np.asarray(x.detach().cpu().numpy(), dtype)

    geom = scene.geometry
    v0 = host(geom.v0, np.float32)
    p1 = v0 + host(geom.e1, np.float32)
    p2 = v0 + host(geom.e2, np.float32)
    normals = [host(n, np.float32) for n in (geom.n0, geom.n1, geom.n2)]
    uvs = [host(u, np.float32) for u in (geom.uv0, geom.uv1, geom.uv2)]
    mat_id = host(geom.material_id, np.int32)
    cull = host(geom.cull_disable, bool)
    atest = host(geom.alpha_test, bool)

    mats = scene.materials
    base_mats = host(mats.base_color_factor, np.float32)
    rough = host(mats.roughness_factor, np.float32)
    metal = host(mats.metallic_factor, np.float32)
    emission = host(mats.emission_factor, np.float32)
    cutoff = host(mats.alpha_cutoff, np.float32)
    bc_tex = host(mats.base_color_texture, np.int32)

    groups = sorted(
        {(int(m), bool(c), bool(a)) for m, c, a in zip(mat_id, cull, atest)}
    )

    blob = bytearray()
    buffer_views: list[dict] = []
    accessors: list[dict] = []

    def push(data: np.ndarray, target: int) -> int:
        start = len(blob)
        raw = np.ascontiguousarray(data).tobytes()
        blob.extend(raw)
        while len(blob) % 4:
            blob.append(0)
        buffer_views.append(
            {"buffer": 0, "byteOffset": start, "byteLength": len(raw),
             "target": target}
        )
        return len(buffer_views) - 1

    def accessor(view: int, comp: int, count: int, kind: str,
                 minmax: np.ndarray | None = None) -> int:
        acc = {"bufferView": view, "componentType": comp, "count": count,
               "type": kind}
        if minmax is not None:
            acc["min"] = [float(x) for x in minmax.min(axis=0)]
            acc["max"] = [float(x) for x in minmax.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    materials_json: list[dict] = []
    primitives: list[dict] = []
    for gmat, gcull, gatest in groups:
        sel = np.nonzero(
            (mat_id == gmat) & (cull == gcull) & (atest == gatest)
        )[0]
        t = sel.size
        # unindexed corners -> (3T, ...) vertex streams + trivial indices
        pos = np.empty((3 * t, 3), np.float32)
        pos[0::3], pos[1::3], pos[2::3] = v0[sel], p1[sel], p2[sel]
        nrm = np.empty((3 * t, 3), np.float32)
        nrm[0::3], nrm[1::3], nrm[2::3] = (n[sel] for n in normals)
        uv = np.empty((3 * t, 2), np.float32)
        uv[0::3], uv[1::3], uv[2::3] = (u[sel] for u in uvs)
        idx = np.arange(3 * t, dtype=np.uint32)

        attr = {
            "POSITION": accessor(
                push(pos, _ARRAY_BUFFER), _COMPONENT_F32, 3 * t, "VEC3",
                minmax=pos,
            ),
            "NORMAL": accessor(
                push(nrm, _ARRAY_BUFFER), _COMPONENT_F32, 3 * t, "VEC3"
            ),
            "TEXCOORD_0": accessor(
                push(uv, _ARRAY_BUFFER), _COMPONENT_F32, 3 * t, "VEC2"
            ),
        }
        indices = accessor(
            push(idx, _ELEMENT_ARRAY_BUFFER), _COMPONENT_U32, 3 * t, "SCALAR"
        )
        primitives.append(
            {"attributes": attr, "indices": indices,
             "material": len(materials_json)}
        )
        m = int(gmat)
        mat = {
            "name": f"mat{m}" + ("_ds" if gcull else "")
            + ("_cut" if gatest else ""),
            "pbrMetallicRoughness": {
                "baseColorFactor": [float(x) for x in base_mats[m]],
                "roughnessFactor": float(rough[m]),
                "metallicFactor": float(metal[m]),
            },
        }
        if images is not None and 0 <= int(bc_tex[m]) < len(images):
            mat["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": int(bc_tex[m])
            }
        if emission[m][:3].any():
            mat["emissiveFactor"] = [float(x) for x in emission[m][:3]]
        if gcull:
            mat["doubleSided"] = True
        if gatest:
            # the loader derives alpha_test from MASK + baseColorTexture
            mat["alphaMode"] = "MASK"
            mat["alphaCutoff"] = float(cutoff[m])
        materials_json.append(mat)

    textures_json: list[dict] = []
    images_json: list[dict] = []
    if images:
        for img in images:
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            view = push(np.frombuffer(encode_png(img), np.uint8), _ARRAY_BUFFER)
            # image bufferViews must not carry a vertex-attribute target
            del buffer_views[view]["target"]
            images_json.append(
                {"bufferView": view, "mimeType": "image/png"}
            )
            textures_json.append(
                {"source": len(images_json) - 1, "sampler": 0}
            )

    doc: dict = {
        "asset": {"version": "2.0", "generator": "vulkanraytracing_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "flattened"}],
        "meshes": [{"primitives": primitives}],
        "materials": materials_json,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(blob)}],
    }
    if textures_json:
        doc["textures"] = textures_json
        doc["images"] = images_json
        # one trilinear-repeat sampler (the reference defaultSampler,
        # Renderer.cpp:20-28)
        doc["samplers"] = [{
            "magFilter": 9729, "minFilter": 9987,
            "wrapS": 10497, "wrapT": 10497,
        }]

    if scene.point_lights is not None:
        pos = host(scene.point_lights.position, np.float32)
        col = host(scene.point_lights.color, np.float32)
        lights = []
        for i in range(pos.shape[0]):
            # the loader multiplies color * intensity; export intensity=1
            # with the raw (already-scaled) color so values round-trip
            lights.append(
                {"type": "point", "intensity": 1.0,
                 "color": [float(c) for c in col[i][:3]]}
            )
            doc["nodes"].append(
                {"name": f"light{i}",
                 "translation": [float(x) for x in pos[i][:3]],
                 "extensions": {"KHR_lights_punctual": {"light": i}}}
            )
            doc["scenes"][0]["nodes"].append(len(doc["nodes"]) - 1)
        doc["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
        doc["extensionsUsed"] = ["KHR_lights_punctual"]

    json_bytes = json.dumps(doc, separators=(",", ":")).encode()
    while len(json_bytes) % 4:
        json_bytes += b" "
    bin_bytes = bytes(blob)

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))  # JSON
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))   # BIN
        f.write(bin_bytes)
    return path
