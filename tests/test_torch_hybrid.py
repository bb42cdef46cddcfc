"""The port's hybrid mode against the JAX package's ``render_hybrid``.

Both renderers get the very same scene and baked environment: the JAX
package builds the scene and its BVH and bakes the IBL (small sizes), and
``scene.convert.scene_from_numpy`` carries all of it across, irradiance
cube, reflection mips, BRDF table and sun included.

- A 64x64 Cornell box through the port's ``BVH_KERNEL`` (the BVH8 plain
  version on the CPU) and ``BRUTE_FORCE``, against the JAX package's
  ``BVH`` frame (its XLA packet traversal, as ``tests/test_hybrid.py``).
- A textured quad at a grazing angle with the one-tap footprint.
- The real workload: ``tests/test_torch_hybrid_real.py``.

Gate: 99.9% of the channels within 1/255 (XLA:CPU fuses multiply-adds and
has its own transcendental functions), in the Cornell box leaving out the
pixels whose centre ray meets a triangle edge (``_on_an_edge``).  Within
the port, ``BVH_KERNEL`` and ``BRUTE_FORCE`` give the very same Cornell
image, edge pixels included.
"""

import jax
import numpy as np
import torch

from vulkanraytracing_torch.config import CameraConfig as TCameraConfig
from vulkanraytracing_torch.config import Config as TConfig
from vulkanraytracing_torch.config import TraversalMode as TMode
from vulkanraytracing_torch.hybrid import render_hybrid as t_hybrid
from vulkanraytracing_torch.ops import traverse_wide8 as tw8
from vulkanraytracing_torch.scene.camera import Camera as TCamera
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
from vulkanraytracing_tpu.config import Config as JConfig
from vulkanraytracing_tpu.config import TraversalMode as JMode
from vulkanraytracing_tpu.env.ibl import bake_ibl as j_bake
from vulkanraytracing_tpu.hybrid import render_hybrid as j_hybrid
from vulkanraytracing_tpu.scene.camera import Camera as JCamera
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene as j_cornell

torch.set_num_threads(1)

CORNELL = dict(position=(0.0, 0.0, 3.2), x_fov=float(np.radians(60.0)))
IBL = dict(irradiance_size=8, reflection_size=16, brdf_size=16)


def _carried(js):
    """The JAX scene with a baked environment, and the port's copy."""
    js = js._replace(environment=j_bake(js.environment, **IBL))
    return js, scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")


def _frames(js, ts, camera, width, height, t_modes, **cfg_kw):
    jcfg = JConfig(width=width, height=height, traversal=JMode.BVH,
                   camera=JCameraConfig(**camera, aspect_ratio=width / height), **cfg_kw)
    want = np.asarray(j_hybrid(js, jcfg, JCamera(jcfg.camera).to_device()))
    got = {}
    for mode in t_modes:
        tcfg = TConfig(width=width, height=height, traversal=mode,
                       camera=TCameraConfig(**camera, aspect_ratio=width / height), **cfg_kw)
        got[mode] = t_hybrid(ts, tcfg, TCamera(tcfg.camera).to_device("cpu"))
    return want, got


def _gate(got, want, skip=None):
    """99.9% of the channels within 1/255, leaving out the pixels where
    ``skip`` is set."""
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    if skip is not None:
        close = close[~skip]
    assert close.mean() >= 0.999, f"{close.mean():.5f} of channels within 1/255"


def _on_an_edge(ts, tcfg):
    """Pixels whose centre ray meets its triangle within 1e-6 of an edge
    (a barycentric below 1e-6), by the port's brute force: there the
    triangle that wins turns on the last bit of u and v, where XLA:CPU's
    fused multiply-adds and PyTorch's separate roundings may differ."""
    from vulkanraytracing_torch.hybrid.renderer import _center_rays
    from vulkanraytracing_torch.ops.intersect import intersect_closest_brute
    from vulkanraytracing_torch.pt.render import tile_pixel_coords, untile_image

    cam = TCamera(tcfg.camera).to_device("cpu")
    w, h = tcfg.width, tcfg.height
    px, py, _, ty, tx = tile_pixel_coords(w, h, device="cpu")
    o, d = _center_rays(cam, px, py, w, h)
    window = torch.full((px.shape[0],), cam.z_near), torch.full((px.shape[0],), cam.z_far)
    hit = intersect_closest_brute(ts.geometry, o, d, *window, cull_backface=True)
    low = torch.minimum(torch.minimum(hit.u, hit.v), 1.0 - hit.u - hit.v)
    edge = hit.is_hit & (low < 1e-6)
    return untile_image(edge[:, None].expand(-1, 3).float(), w, h, ty, tx)[..., 0].numpy() > 0


def test_cornell_hybrid_matches_jax():
    js, ts = _carried(j_build(j_cornell(), builder="sah"))
    assert ts.environment.irradiance.shape == (6, 8, 8, 3)
    assert len(ts.environment.reflection) == 5 and ts.bvh.nodes8 is not None
    before = sum(tw8.LAUNCHES.values())
    want, got = _frames(js, ts, CORNELL, 64, 64, (TMode.BVH_KERNEL, TMode.BRUTE_FORCE))
    assert sum(tw8.LAUNCHES.values()) == before  # CPU tensors: the plain version
    # The camera sits on the box's axis, so the centre rays of the image's
    # diagonals run exactly along the box's corner edges (and 40% of all
    # centre rays along the walls' quad diagonals): at the corners the wall
    # hit turns on the last bit of u and v.  Those pixels are held to the
    # port's own brute force below, bit for bit, and left out here.
    edge = _on_an_edge(ts, TConfig(width=64, height=64,
                                   camera=TCameraConfig(**CORNELL, aspect_ratio=1.0)))
    assert edge.mean() < 0.5
    _gate(got[TMode.BVH_KERNEL], want, skip=edge)
    assert torch.equal(got[TMode.BVH_KERNEL], got[TMode.BRUTE_FORCE])
    img = got[TMode.BVH_KERNEL].numpy()
    # red wall left, green wall right, the open front black
    assert img[28:36, 6:12, 0].mean() > img[28:36, 6:12, 1].mean()
    assert img[28:36, 52:58, 1].mean() > img[28:36, 52:58, 0].mean()
    assert img[2, 2].max() < 0.05


def test_one_tap_footprint_matches_jax():
    """The G-buffer's texture footprint with one tap (trilinear at the
    larger uv change), on a textured quad seen at a grazing angle (the
    anisotropic taps: ``tests/test_torch_hybrid_real.py``)."""
    from vulkanraytracing_tpu.ops.texture import build_texture_pool
    from vulkanraytracing_tpu.scene.types import (
        Scene, constant_environment, make_materials, make_trace_geometry, no_direct_light,
    )

    img = np.random.default_rng(3).integers(0, 256, (64, 64, 4), dtype=np.uint8)
    positions = np.array([[-4, -1, -8], [4, -1, -8], [4, -1, 2], [-4, -1, 2]], np.float32)
    uvs = np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32)
    js = Scene(
        geometry=make_trace_geometry(positions, np.array([[0, 2, 1], [0, 3, 2]]), uvs=uvs),
        materials=make_materials(base_color_factors=[(1, 1, 1, 1)], base_color_textures=[0]),
        environment=constant_environment((0.2, 0.3, 0.4)), direct_light=no_direct_light(),
        point_lights=None, bvh=None, textures=build_texture_pool([img], size=64))
    js, ts = _carried(js)
    jcfg = JConfig(width=32, height=24, traversal=JMode.BRUTE_FORCE, hybrid_aniso_taps=1,
                   camera=JCameraConfig(position=(0.0, 0.0, 3.0), target=(0.0, -1.0, -4.0),
                                        aspect_ratio=32 / 24))
    want = np.asarray(j_hybrid(js, jcfg, JCamera(jcfg.camera).to_device()))
    tcfg = TConfig(width=32, height=24, traversal=TMode.BRUTE_FORCE, hybrid_aniso_taps=1,
                   camera=TCameraConfig(position=(0.0, 0.0, 3.0), target=(0.0, -1.0, -4.0),
                                        aspect_ratio=32 / 24))
    got = t_hybrid(ts, tcfg, TCamera(tcfg.camera).to_device("cpu"))
    _gate(got, want)
