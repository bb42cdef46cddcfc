"""The port's procedural scenes, camera and BVH build against the JAX
package's.

Scenes are numpy assembly from the same seeded ``default_rng`` calls, and
both packages build the BVH with the same native C++ sources and flags,
so every array must be bit-equal (no tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_scene_bvh as t_build
from vulkanraytracing_torch.config import CameraConfig as TCameraConfig
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.camera import Camera as TCamera
from vulkanraytracing_torch.scene.convert import camera_from_numpy, scene_from_numpy
from vulkanraytracing_torch.scene.types import make_trace_geometry
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
from vulkanraytracing_tpu.scene import procedural as jproc
from vulkanraytracing_tpu.scene.camera import Camera as JCamera

torch.set_num_threads(1)

SCENES = {  # the port's scenes are asked for on the CPU (device="cpu")
    "cornell": lambda mod, **kw: mod.cornell_box_scene(**kw),
    "soup960": lambda mod, **kw: mod.triangle_soup_scene(960, **kw),
    "sponza40k": lambda mod, **kw: mod.sponza_like_scene(40000, **kw),
    "real4k": lambda mod, **kw: mod.sponza_like_scene(4000, workload="real", **kw),
}

BVH_FIELDS = ("nodes", "child_index", "tris", "tri_flags", "tri_order",
              "nodes8", "child8", "tri_perm8")


def _eq(got: torch.Tensor, want, name: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_arrays_equal(name):
    js, ts = SCENES[name](jproc), SCENES[name](tproc, device="cpu")
    for group in ("geometry", "materials", "direct_light"):
        jg, tg = getattr(js, group), getattr(ts, group)
        for field in tg._fields:
            _eq(getattr(tg, field), getattr(jg, field), f"{group}.{field}")
    assert (ts.point_lights is None) == (js.point_lights is None)
    if ts.point_lights is not None:
        _eq(ts.point_lights.position, js.point_lights.position, "lights.position")
        _eq(ts.point_lights.color, js.point_lights.color, "lights.color")
    _eq(ts.environment.panorama, js.environment.panorama, "panorama")
    assert (ts.textures is None) == (js.textures is None)
    if ts.textures is not None:
        for field in ts.textures._fields:
            _eq(getattr(ts.textures, field), getattr(js.textures, field), f"textures.{field}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sah_bvh_bit_equal(name):
    js = j_build(SCENES[name](jproc), builder="sah")
    ts = t_build(SCENES[name](tproc, device="cpu"), builder="sah")
    assert js.bvh.nodes8 is not None
    for field in BVH_FIELDS:
        _eq(getattr(ts.bvh, field), getattr(js.bvh, field), field)
    for field in ts.geometry._fields:
        _eq(getattr(ts.geometry, field), getattr(js.geometry, field), field)


def test_convert_carries_the_jax_scene():
    js = j_build(jproc.cornell_box_scene(), builder="sah")
    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    for field in BVH_FIELDS:
        _eq(getattr(ts.bvh, field), getattr(js.bvh, field), field)
    _eq(ts.geometry.material_id, js.geometry.material_id, "material_id")
    _eq(ts.materials.emission_factor, js.materials.emission_factor, "emission")


def test_camera_matches():
    kw = dict(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
              aspect_ratio=1920 / 1080)
    jc = JCamera(JCameraConfig(**kw)).to_device()
    tc = TCamera(TCameraConfig(**kw)).to_device("cpu")
    _eq(tc.inverse_view, jc.inverse_view, "inverse_view")
    _eq(tc.inverse_proj, jc.inverse_proj, "inverse_proj")
    assert tc.z_near == float(jc.z_near) and tc.z_far == float(jc.z_far)
    carried = camera_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert torch.equal(carried.inverse_proj, tc.inverse_proj)


def test_unported_features_raise():
    """An unknown workload and an unknown builder are refused (the v1 and
    real workloads and ``builder="lbvh"``, the default, are ported)."""
    with pytest.raises(ValueError, match="workload"):
        tproc.sponza_like_scene(4000, workload="unreal", device="cpu")
    with pytest.raises(ValueError, match="builder"):
        t_build(tproc.cornell_box_scene(device="cpu"), builder="median")


def test_textures_and_alpha_refused_where_scenes_are_made():
    """Textures and alpha tests are carried wherever a static scene is made
    (made, carried across or given a BVH, which attaches the cutout
    subset); the Engine keeps a static scene's cutout subset as built (it
    refused textured scenes before they were ported to it)."""
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.config import Config as TConfig

    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    geom = make_trace_geometry(tri, [[0, 1, 2]], alpha_test=True, opaque=False, device="cpu")
    assert bool(geom.alpha_test.all()) and not bool(geom.opaque.any())
    js = jproc.cornell_box_scene()
    alpha = js.geometry._replace(alpha_test=np.ones_like(np.asarray(js.geometry.alpha_test)))
    carried = scene_from_numpy(jax.tree.map(np.asarray, js._replace(geometry=alpha)),
                               device="cpu")
    assert bool(carried.geometry.alpha_test.all()) and carried.alpha is None
    ts = tproc.cornell_box_scene(device="cpu")
    flagged = ts.geometry._replace(alpha_test=torch.ones_like(ts.geometry.alpha_test))
    built = t_build(ts._replace(geometry=flagged))
    assert built.alpha.geometry.num_triangles == ts.geometry.num_triangles
    assert not bool((built.alpha.opaque_bvh.tri_flags & 4).any())
    assert t_build(ts).alpha is None
    eng = Engine(TConfig(width=8, height=8), built, device="cpu")
    assert eng.scene.alpha is not None
    assert eng.scene.alpha.geometry.num_triangles == ts.geometry.num_triangles


def test_default_materials_match_jax():
    from vulkanraytracing_torch.scene.types import default_materials as t_default
    from vulkanraytracing_tpu.scene.types import default_materials as j_default

    kw = dict(base_color=(0.8, 0.5, 0.2, 0.9), emission=(1.0, 2.0, 3.0, 1.0),
              roughness=0.3, metallic=0.7)
    for args in ({}, kw):
        want, got = j_default(**args), t_default(**args, device="cpu")
        assert got._fields == want._fields
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
