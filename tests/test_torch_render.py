"""The port's whole slice against the JAX package: a 32x32 Cornell box,
2 progressive frames, on the same SAH-permuted scene (the JAX build,
carried across).  The port runs on the CPU with its default BVH kernel
traversal (the BVH8 plain version, the SAH build carries its collapse);
the JAX package runs brute force, its parity oracle.

Gate: at least 99% of pixel channels within 1/255 and ray counts within
0.5%.  Bit equality is the target, but not the gate: XLA:CPU fuses
multiply-adds and has its own sin, cos, pow and rsqrt, so a last-bit
difference can push a Russian-roulette draw or an 8-bit rounding to the
other side and change a pixel.  Within the port, BVH8 and brute force
must give the very same image and ray count.  Each packet backend (BVH,
BVH_SUBPACKET, BVH_SHARED) is held to the same gate against the JAX
package's render in the same mode.
"""

import jax
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.config import CameraConfig as TCameraConfig
from vulkanraytracing_torch.config import Config as TConfig
from vulkanraytracing_torch.config import TraversalMode as TMode
from vulkanraytracing_torch.pt.render import create_render_state as t_state
from vulkanraytracing_torch.pt.render import render_frame as t_render
from vulkanraytracing_torch.pt.render import render_progressive as t_progressive
from vulkanraytracing_torch.scene.camera import Camera as TCamera
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_torch.scene.procedural import sponza_like_scene
from vulkanraytracing_torch.accel.lbvh import build_scene_bvh as t_build
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
from vulkanraytracing_tpu.config import Config as JConfig
from vulkanraytracing_tpu.config import TraversalMode as JMode
from vulkanraytracing_tpu.pt.render import create_render_state as j_state
from vulkanraytracing_tpu.pt.render import render_frame as j_render
from vulkanraytracing_tpu.scene.camera import Camera as JCamera
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene

torch.set_num_threads(1)

SIZE = 32
CAMERA = dict(position=(0.0, 0.0, 3.2), aspect_ratio=1.0, x_fov=float(np.radians(60)))


def _render_port(scene, mode, frames, **cfg_kw):
    cfg = TConfig(width=SIZE, height=SIZE, traversal=mode,
                  camera=TCameraConfig(**CAMERA), **cfg_kw)
    cam = TCamera(cfg.camera).to_device("cpu")
    state, rays = t_state(cfg, "cpu"), 0
    for _ in range(frames):
        state, stats = t_render(scene, cfg, cam, state)
        rays += int(stats.rays)
    return state.accumulation.numpy(), rays


def _render_jax(js, mode, frames, **cfg_kw):
    cfg = JConfig(width=SIZE, height=SIZE, traversal=mode,
                  camera=JCameraConfig(**CAMERA), **cfg_kw)
    cam = JCamera(cfg.camera).to_device()
    state, rays = j_state(cfg), 0.0
    for _ in range(frames):
        state, stats = j_render(js, cfg, cam, state)
        rays += float(stats.rays)
    return np.asarray(state.accumulation), rays


def _assert_gate(got, rays, want, want_rays):
    assert got.shape == want.shape and not np.isnan(got).any()
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of channels within 1/255"
    assert abs(rays - want_rays) <= 0.005 * want_rays, (rays, want_rays)
    assert got.mean() > 0.05  # lit, not black


def test_cornell_matches_jax_brute_force():
    js = j_build(cornell_box_scene(), builder="sah")
    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    want, want_rays = _render_jax(js, JMode.BRUTE_FORCE, frames=2)
    got, rays = _render_port(ts, TMode.BVH_KERNEL, frames=2)
    _assert_gate(got, rays, want, want_rays)

    brute, brute_rays = _render_port(ts, TMode.BRUTE_FORCE, frames=2)
    np.testing.assert_array_equal(got, brute)
    assert rays == brute_rays


# each packet backend of the port and its JAX counterpart
PACKET_MODES = {
    TMode.BVH: JMode.BVH,
    TMode.BVH_SUBPACKET: JMode.BVH_PALLAS_SUBPACKET,
    TMode.BVH_SHARED: JMode.BVH_PALLAS_SHARED,
}


@pytest.mark.parametrize("mode", list(PACKET_MODES), ids=lambda m: m.name)
def test_cornell_matches_jax_in_each_packet_mode(mode):
    """2 frames of 1 bounce (primary hits, their shadow rays and the
    bounce go through the mode's closest and any-hit traversal) against
    the JAX package's render in the same mode (its Pallas kernels in
    interpret mode), to the same gate."""
    js = j_build(cornell_box_scene(), builder="sah")
    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    want, want_rays = _render_jax(js, PACKET_MODES[mode], frames=2, max_bounce_count=1)
    got, rays = _render_port(ts, mode, frames=2, max_bounce_count=1)
    _assert_gate(got, rays, want, want_rays)


def test_one_sample_image_is_finite():
    """1 spp of a small v1 hall (sun, 4 point lights, flipped point-light
    shadow rays from bounce 1) through render_progressive."""
    scene = t_build(sponza_like_scene(8000, device="cpu"))
    cfg = TConfig(width=24, height=16, camera=TCameraConfig(
        position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=1.5))
    state, rays = t_progressive(scene, cfg, TCamera(cfg.camera).to_device("cpu"), spp=1)
    img = state.accumulation.numpy()
    assert img.shape == (16, 24, 3)
    assert np.isfinite(img).all() and img.max() > 0.0
    assert rays >= 24 * 16 * 2  # primary + point-light sphere rays at least
