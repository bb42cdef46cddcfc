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

The real workload (textures, alpha-tested foliage, an HDR sky) at its
20,000-triangle target: the port's ``BVH_KERNEL`` frame, 64x36, 4 bounces,
against the JAX package's ``BVH`` frame (its XLA packet traversal); gate:
99.9% of channels within 1/255 and equal ray counts.  The wavefront sort
only permutes rays, so a frame under ``VRT_DEBUG_NO_SORT`` must equal the
sorted frame bit for bit, for the v1 and the real workload.
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
from vulkanraytracing_tpu.scene.procedural import sponza_like_scene as j_sponza

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


HALL = dict(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0))
REAL_SIZE = (64, 36)


@pytest.fixture(scope="module")
def real_scenes():
    """The real workload at its 20,000-triangle target (SAH build, BVH8
    collapse, cutout subset) in the JAX package, and carried across."""
    js = j_build(j_sponza(20000, workload="real"), builder="sah")
    return js, scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")


def _render_hall(render, scene, cfg_cls, cam_cls, cam_to, state, mode, width, height):
    cfg = cfg_cls(width=width, height=height, max_bounce_count=4, traversal=mode,
                  camera=cam_cls(**HALL, aspect_ratio=width / height))
    out, stats = render(scene, cfg, cam_to(cfg), state(cfg))
    return out.accumulation, stats.rays


def test_real_scene_matches_jax(real_scenes):
    js, ts = real_scenes
    w, h = REAL_SIZE
    want, want_rays = _render_hall(j_render, js, JConfig, JCameraConfig,
                                   lambda c: JCamera(c.camera).to_device(), j_state,
                                   JMode.BVH, w, h)
    got, rays = _render_hall(t_render, ts, TConfig, TCameraConfig,
                             lambda c: TCamera(c.camera).to_device("cpu"),
                             lambda c: t_state(c, "cpu"), TMode.BVH_KERNEL, w, h)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (h, w, 3) and np.isfinite(got).all() and got.mean() > 0.05
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.999, f"{close.mean():.5f} of channels within 1/255"
    assert int(rays) == int(float(want_rays))


@pytest.mark.parametrize("workload", ["v1", "real"])
def test_sorted_frame_equals_unsorted(workload, real_scenes, monkeypatch):
    """The port's frame with the wavefront sort equals its frame under
    VRT_DEBUG_NO_SORT, bit for bit, and so does the ray count."""
    if workload == "real":
        scene = real_scenes[1]
    else:
        scene = t_build(sponza_like_scene(8000, device="cpu"), builder="sah")
    frames = []
    for unsorted in (False, True):
        if unsorted:
            monkeypatch.setenv("VRT_DEBUG_NO_SORT", "1")
        frames.append(_render_hall(t_render, scene, TConfig, TCameraConfig,
                                   lambda c: TCamera(c.camera).to_device("cpu"),
                                   lambda c: t_state(c, "cpu"), TMode.BVH_KERNEL,
                                   *REAL_SIZE))
    (a, ra), (b, rb) = frames
    assert torch.equal(a, b) and int(ra) == int(rb)
    assert float(a.max()) > 0.0
