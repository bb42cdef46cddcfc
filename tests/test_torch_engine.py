"""The port's Engine: event bus, camera system, accumulation resets,
resize, checkpoints, the mode toggle, and the animated-instances path
(TLAS build, per-move refit, reset) against the JAX package's Engine.

Ports of ``tests/test_engine.py``; the toggle test draws a hybrid frame.
The JAX comparison renders
``animated_instances_demo(orbiters=2)`` at 32x32 for 2 frames (a build
frame and a refit frame): the JAX Engine in brute force (its oracle),
the port through its BVH2 traversal (the plain version on the CPU).
Gate, as ``tests/test_torch_render.py``: at least 99% of channels within
1/255 and ray counts within 0.5% (XLA:CPU fuses multiply-adds and has its
own transcendental functions, so a last-bit difference can flip a
Russian-roulette draw or an 8-bit rounding).
"""

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh
from vulkanraytracing_torch.accel.tlas import world_geometry
from vulkanraytracing_torch.app.engine import Engine
from vulkanraytracing_torch.app.events import EventBus, EventType, Key, KeyAction, KeyInput
from vulkanraytracing_torch.app.systems import CameraSystem
from vulkanraytracing_torch.config import CameraConfig, Config, RenderMode, TraversalMode
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.pt.render import create_render_state, render_frame
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.procedural import (
    animated_instances_demo, cornell_box_scene, sponza_like_scene,
)

torch.set_num_threads(1)


def _engine(**cfg_kw):
    cfg = Config(
        width=16, height=16, traversal=TraversalMode.BRUTE_FORCE,
        camera=CameraConfig(position=(0.0, 0.0, 3.2), aspect_ratio=1.0), **cfg_kw,
    )
    return Engine(cfg, cornell_box_scene(device="cpu"), device="cpu")


def test_event_bus_dispatch():
    bus = EventBus()
    seen = []
    bus.add_handler(EventType.RESIZE, seen.append)
    bus.trigger(EventType.RESIZE, (10, 20))
    assert seen == [(10, 20)]


def test_camera_system_wasd_moves_forward():
    bus = EventBus()
    cam = Camera(CameraConfig(position=(0, 0, 5), target=(0, 0, 0)))
    cs = CameraSystem(cam, bus)
    moved = []
    bus.add_handler(EventType.CAMERA_UPDATE, lambda _: moved.append(1))
    bus.trigger(EventType.KEY_INPUT, KeyInput(Key.W, KeyAction.PRESS))
    cs.process(0.5)  # speed 2.0 * 0.5 s = 1 unit forward (-Z, toward the target)
    assert moved
    np.testing.assert_allclose(cam.description.position, (0, 0, 4), atol=1e-6)
    bus.trigger(EventType.KEY_INPUT, KeyInput(Key.W, KeyAction.RELEASE))
    cs.process(0.5)
    np.testing.assert_allclose(cam.description.position, (0, 0, 4), atol=1e-6)


def test_camera_speed_keys():
    bus = EventBus()
    cam = Camera(CameraConfig(position=(0, 0, 5), target=(0, 0, 0)))
    cs = CameraSystem(cam, bus)
    bus.trigger(EventType.KEY_INPUT, KeyInput(Key.DIGIT_3, KeyAction.PRESS))
    assert cs.speed_index == 2  # speed = 2 * 4^2 = 32
    bus.trigger(EventType.KEY_INPUT, KeyInput(Key.S, KeyAction.PRESS))
    cs.process(0.25)  # 32 * 0.25 = 8 backward
    np.testing.assert_allclose(cam.description.position, (0, 0, 13), atol=1e-5)


def test_mouse_look_clamps_pitch():
    bus = EventBus()
    cam = Camera(CameraConfig(position=(0, 0, 5), target=(0, 0, 0)))
    cs = CameraSystem(cam, bus, sensitivity=1000.0)
    bus.trigger(EventType.MOUSE_MOVE, (0.0, 0.0))
    bus.trigger(EventType.MOUSE_MOVE, (0.0, -10.0))  # look up hard
    assert abs(cs.pitch) <= np.radians(89.0) + 1e-6


def test_camera_move_resets_accumulation():
    eng = _engine()
    eng.run(2)
    assert eng.state.accum_index == 2
    eng.inject_mouse_move(0, 0)
    eng.inject_mouse_move(5, 5)  # camera update fires
    assert eng.state.accum_index == 0
    eng.run(1)
    assert eng.state.accum_index == 1
    eng.inject_key(Key.R)  # reload
    assert eng.state.accum_index == 0


def test_mode_toggle():
    """The T key toggles the mode; a hybrid frame draws (the display image
    goes into the accumulation, the frame count stays), and path tracing
    draws again after the second toggle; with a mesh the hybrid frame is
    the same."""
    eng = _engine()
    assert eng.render_mode == RenderMode.PATH_TRACING
    eng.inject_key(Key.T)
    assert eng.render_mode == RenderMode.HYBRID
    eng.run(1)
    img = eng.display_image()
    assert img.shape == (16, 16, 3) and img.max() > 0 and eng.state.accum_index == 0
    eng.inject_key(Key.T)
    assert eng.render_mode == RenderMode.PATH_TRACING
    eng.run(1)
    assert eng.display_image().shape == (16, 16, 3)
    # a mesh shards path-traced frames only: the hybrid mode ignores it
    meshed = Engine(eng.cfg, cornell_box_scene(device="cpu"), mesh=["cpu"] * 2, device="cpu")
    for e in (eng, meshed):
        e.inject_key(Key.T)
        e.run(1)
    assert meshed.render_mode == RenderMode.HYBRID
    assert np.array_equal(meshed.display_image(), eng.display_image())


def test_engine_device_is_required():
    """No default device: a scene on the card is never moved to the host
    (and onto the plain traversal) by an Engine that was not told where
    to run."""
    with pytest.raises(TypeError, match="device"):
        Engine(Config(width=8, height=8), cornell_box_scene(device="cpu"))
    eng = _engine()
    assert eng.device == torch.device("cpu")
    assert eng.scene.geometry.v0.device == eng.device
    assert eng.state.accumulation.device == eng.device


def test_resize_recreates_framebuffer():
    eng = _engine()
    eng.run(1)
    eng.inject_resize(24, 12)
    assert eng.state.accumulation.shape == (12, 24, 3)
    assert eng.state.accum_index == 0
    eng.run(1)
    assert eng.display_image().shape == (12, 24, 3)


def test_checkpoint_roundtrip(tmp_path):
    eng = _engine()
    eng.run(3)
    p = tmp_path / "ckpt.npz"
    eng.save_checkpoint(p)

    eng2 = _engine()
    eng2.load_checkpoint(p)
    assert eng2.state.accum_index == 3
    assert torch.equal(eng2.state.accumulation, eng.state.accumulation)
    # a resumed render continues exactly as an uninterrupted one
    eng.run(1)
    eng2.run(1)
    assert torch.equal(eng2.state.accumulation, eng.state.accumulation)


DEMO_CAMERA = dict(position=(0.0, 4.0, 10.0), target=(0.0, 1.0, 0.0), aspect_ratio=1.0)


def test_animated_instances_refit_and_reset():
    """Animated instances: a TLAS refit per move, through the BVH2
    traversal, with an accumulation reset; the refitted image is bit-equal
    to one rendered over a from-scratch build at the same transforms, and
    a static frame accumulates."""
    scene, soup, anim = animated_instances_demo(orbiters=2, device="cpu")
    cfg = Config(width=32, height=32, max_bounce_count=2,
                 traversal=TraversalMode.BVH_KERNEL, camera=CameraConfig(**DEMO_CAMERA))
    eng = Engine(cfg, scene, instances=soup, animation=anim, device="cpu")
    assert eng.scene.bvh.nodes8 is None  # the 2-wide kernel's tree

    eng.run(2)  # frame 0 (build) + frame 1 (refit)
    assert eng.state.accum_index == 1  # reset on every move
    img_refit = eng.state.accumulation.clone()
    assert torch.isfinite(img_refit).all() and float(img_refit.max()) > 0.0

    geom, bvh = build_bvh(world_geometry(soup, torch.from_numpy(anim(1))))
    ref_scene = eng.scene._replace(geometry=geom, bvh=bvh)
    cam = Camera(cfg.camera).to_device("cpu")
    state, _ = render_frame(ref_scene, cfg, cam, create_render_state(cfg, "cpu"))
    assert torch.equal(state.accumulation, img_refit)

    # a static frame (same transforms) accumulates instead of resetting
    eng._animation = lambda i: anim(1)
    eng.run(1)
    assert eng.state.accum_index == 2


def test_engine_matches_jax_on_animated_instances(tmp_path):
    """The port's Engine against the JAX package's on the same demo, and
    the JAX package's checkpoint resumed by the port."""
    from vulkanraytracing_tpu.app.engine import Engine as JEngine
    from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
    from vulkanraytracing_tpu.config import Config as JConfig
    from vulkanraytracing_tpu.config import TraversalMode as JMode
    from vulkanraytracing_tpu.scene.procedural import animated_instances_demo as j_demo

    j_scene, j_soup, j_anim = j_demo(orbiters=2)
    jeng = JEngine(JConfig(width=32, height=32, traversal=JMode.BRUTE_FORCE,
                           camera=JCameraConfig(**DEMO_CAMERA)),
                   j_scene, instances=j_soup, animation=j_anim)
    jeng.run(2)
    want = np.asarray(jeng.state.accumulation)

    scene, soup, anim = animated_instances_demo(orbiters=2, device="cpu")
    eng = Engine(Config(width=32, height=32, traversal=TraversalMode.BVH_KERNEL,
                        camera=CameraConfig(**DEMO_CAMERA)),
                 scene, instances=soup, animation=anim, device="cpu")
    before = sum(tw2.LAUNCHES.values())
    eng.run(2)
    assert sum(tw2.LAUNCHES.values()) == before  # CPU tensors: no kernel
    got = eng.state.accumulation.numpy()
    assert eng.state.accum_index == int(jeng.state.accum_index) == 1
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of channels within 1/255"
    assert abs(eng.total_rays - jeng.total_rays) <= 0.005 * jeng.total_rays
    assert got.mean() > 0.05

    p = tmp_path / "jax.npz"
    jeng.save_checkpoint(p)
    eng.load_checkpoint(p)
    assert eng.state.accum_index == 1
    np.testing.assert_array_equal(eng.state.accumulation.numpy(), want)
    assert eng.camera.description.position == pytest.approx(DEMO_CAMERA["position"])


def test_engine_real_scene_matches_jax():
    """A static textured scene with alpha-tested foliage goes through the
    Engine as its caller built it (the opaque view and the cutout subset):
    the real workload at its 20,000-triangle target, 64x36, against the
    JAX package's Engine under the gate above.  The depth is cut to 1
    bounce: the JAX frame's compile grows with the bounces (14 s at 1, 29
    s at 2, about 90 s at 4 on this CPU).  The hybrid mode draws the same
    scene too."""
    from vulkanraytracing_torch.scene.convert import scene_from_numpy
    from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
    from vulkanraytracing_tpu.app.engine import Engine as JEngine
    from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
    from vulkanraytracing_tpu.config import Config as JConfig
    from vulkanraytracing_tpu.config import TraversalMode as JMode
    from vulkanraytracing_tpu.scene.procedural import sponza_like_scene as j_sponza

    import jax

    hall = dict(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=64 / 36)
    js = j_build(j_sponza(20000, workload="real"), builder="sah")
    jeng = JEngine(JConfig(width=64, height=36, max_bounce_count=1, traversal=JMode.BVH,
                           camera=JCameraConfig(**hall)), js)
    jeng.run(1)
    want = np.asarray(jeng.state.accumulation)

    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    eng = Engine(Config(width=64, height=36, max_bounce_count=1,
                        traversal=TraversalMode.BVH_KERNEL, camera=CameraConfig(**hall)),
                 ts, device="cpu")
    assert eng.scene.alpha is not None and eng.scene.textures is not None
    eng.run(1)
    got = eng.state.accumulation.numpy()
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of channels within 1/255"
    assert abs(eng.total_rays - jeng.total_rays) <= 0.005 * jeng.total_rays
    assert got.mean() > 0.05

    eng.inject_key(Key.T)
    eng.run(1)
    assert eng.render_mode == RenderMode.HYBRID
    assert eng.display_image().shape == (36, 64, 3) and eng.display_image().mean() > 10


def test_animated_textured_instances_trace_the_whole_scene_loop():
    """Animated instances of a textured scene: the TLAS carries no cutout
    subset, so the Engine drops the static one and every trace runs the
    alpha re-trace over the whole scene (both modes draw)."""
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh

    from vulkanraytracing_torch.accel.tlas import make_instances

    real = build_scene_bvh(sponza_like_scene(4000, workload="real", device="cpu"),
                           builder="sah")
    assert real.alpha is not None

    def moves(frame):  # the hall, and a copy of it sliding along x
        t = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        t[1, 0, 3] = 30.0 + frame
        return t

    eng = Engine(Config(width=16, height=16, max_bounce_count=1,
                        camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                            aspect_ratio=1.0)),
                 real, instances=make_instances([real.geometry], [0, 0]), animation=moves,
                 device="cpu")
    assert eng.scene.alpha is None and eng.scene.textures is not None
    eng.run(2)
    assert np.isfinite(eng.display_image()).all()
    eng.inject_key(Key.T)
    eng.run(1)
    assert eng.display_image().shape == (16, 16, 3)
