"""The port's per-ray reference backend (``ops.traverse``,
``TraversalMode.BVH_PER_RAY``) against the JAX package's
``ops/traverse.py``, on the very 2-wide BVH the JAX package built (carried
across with ``scene_from_numpy``), at the JAX suite's shapes: a
960-triangle soup and the Cornell box, 256 random rays each.

Both keep the JAX module's rules (the window ``t_min <= t < best``, the
first-tested tie, a push past the stack dropped).  Hit masks, ``tri`` and
``backface`` must be equal; t within rtol 1e-5, u and v within atol 1e-5:
XLA:CPU contracts the Moller-Trumbore cross products into fused
multiply-adds, the port rounds every product.  With the stack forced down
to a few entries both sides drop the same pushes and miss the same hits.
A 32x32 Cornell frame under ``BVH_PER_RAY`` is held to the JAX package's
frame in the same mode at the repo's gate (99% of channels within 1/255,
ray counts within 0.5%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.config import CameraConfig as TCameraConfig
from vulkanraytracing_torch.config import Config as TConfig
from vulkanraytracing_torch.config import TraversalMode as TMode
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import traverse as ttr
from vulkanraytracing_torch.pt.render import create_render_state as t_state
from vulkanraytracing_torch.pt.render import render_frame as t_render
from vulkanraytracing_torch.scene.camera import Camera as TCamera
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh
from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
from vulkanraytracing_tpu.config import Config as JConfig
from vulkanraytracing_tpu.config import TraversalMode as JMode
from vulkanraytracing_tpu.ops import traverse as jtr
from vulkanraytracing_tpu.pt.render import create_render_state as j_state
from vulkanraytracing_tpu.pt.render import render_frame as j_render
from vulkanraytracing_tpu.scene.camera import Camera as JCamera
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene, triangle_soup_scene

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5


def _rays(n, extent, seed):
    """The JAX suite's random rays (``tests/test_lbvh.py``), some dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e3, np.float32)
    t_max[::17] = 0.0
    return o, d, np.zeros((n,), np.float32), t_max


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX scene, port scene on the CPU, rays)} sharing one BVH per
    scene: the soup as an LBVH (as the JAX suite builds it), the Cornell
    box as an SAH tree."""
    out = {}
    for name, scene, builder, extent, seed in (
            ("soup", triangle_soup_scene(960, seed=3), "lbvh", 11.0, 4),
            ("cornell", cornell_box_scene(), "sah", 0.9, 7)):
        js = build_scene_bvh(scene, builder=builder)
        out[name] = (js, scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu"),
                     _rays(256, extent, seed))
    return out


def _assert_hits_match(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy()[hit], np.asarray(want.tri)[hit])
    np.testing.assert_array_equal(got.backface.numpy()[hit], np.asarray(want.backface)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=RTOL_T)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit], rtol=0, atol=ATOL_UV)


def _both_args(js, ts, rays):
    return ([jnp.asarray(x) for x in rays], [torch.from_numpy(x) for x in rays])


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["soup", "cornell"])
def test_closest_matches_jax(name, cull, scenes):
    js, ts, rays = scenes[name]
    jr, tr = _both_args(js, ts, rays)
    want = jtr.intersect_closest_bvh(js.geometry, js.bvh, *jr, cull_backface=cull)
    got = ttr.intersect_closest_bvh(ts.bvh, *tr, cull_backface=cull)
    assert np.asarray(want.is_hit).sum() >= 10
    _assert_hits_match(got, want)
    # and against the port's brute force (the same window up to t_max)
    brute = tint.intersect_closest_brute(ts.geometry, *tr, cull_backface=cull)
    assert torch.equal(got.is_hit, brute.is_hit)
    assert torch.equal(got.tri[got.is_hit], brute.tri[brute.is_hit])


@pytest.mark.parametrize("name", ["soup", "cornell"])
def test_any_matches_jax(name, scenes):
    js, ts, rays = scenes[name]
    jr, tr = _both_args(js, ts, rays)
    want = np.asarray(jtr.intersect_any_bvh(js.geometry, js.bvh, *jr))
    got = ttr.intersect_any_bvh(ts.bvh, *tr).numpy()
    assert want.sum() >= 10
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tint.intersect_any_brute(ts.geometry, *tr).numpy())


@pytest.mark.parametrize("name,depth", [("soup", 1), ("cornell", 1), ("cornell", 2)])
def test_small_stack_drops_the_same_pushes(name, depth, scenes):
    """With ``depth`` stack entries the pushes past them are dropped on
    both sides: some hits are lost, the same ones."""
    js, ts, rays = scenes[name]
    jr, tr = _both_args(js, ts, rays)
    want = jtr._traverse(js.bvh, *jr, cull_backface=True, any_hit=False, stack_depth=depth)
    got = ttr._traverse(ts.bvh, *tr, cull_backface=True, any_hit=False, stack_depth=depth)
    full = ttr.intersect_closest_bvh(ts.bvh, *tr, cull_backface=True)
    assert int(got.is_hit.sum()) < int(full.is_hit.sum())  # pushes were dropped
    _assert_hits_match(got, want)


def test_hit_at_t_max_is_not_committed(scenes):
    """The window is exclusive at t_max: a ray whose t_max is its own hit
    distance misses, where the per-ray kernels' window commits it."""
    _, ts, rays = scenes["cornell"]
    tr = [torch.from_numpy(x) for x in rays]
    first = ttr.intersect_closest_bvh(ts.bvh, *tr, cull_backface=False)
    hit = first.is_hit
    again = ttr.intersect_closest_bvh(ts.bvh, tr[0][hit], tr[1][hit], tr[2][hit],
                                      first.t[hit], cull_backface=False)
    brute = tint.intersect_closest_brute(ts.geometry, tr[0][hit], tr[1][hit], tr[2][hit],
                                         first.t[hit], cull_backface=False)
    assert brute.is_hit.all()
    assert not bool((again.is_hit & (again.t == first.t[hit])).any())


SIZE = 32
CAMERA = dict(position=(0.0, 0.0, 3.2), aspect_ratio=1.0, x_fov=float(np.radians(60)))


def test_cornell_frame_matches_jax():
    """2 frames of 1 bounce under BVH_PER_RAY in both packages."""
    js = build_scene_bvh(cornell_box_scene(), builder="sah")
    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jcfg = JConfig(width=SIZE, height=SIZE, traversal=JMode.BVH_PER_RAY, max_bounce_count=1,
                   camera=JCameraConfig(**CAMERA))
    tcfg = TConfig(width=SIZE, height=SIZE, traversal=TMode.BVH_PER_RAY, max_bounce_count=1,
                   camera=TCameraConfig(**CAMERA))
    jcam, tcam = JCamera(jcfg.camera).to_device(), TCamera(tcfg.camera).to_device("cpu")
    jst, tst, want_rays, rays = j_state(jcfg), t_state(tcfg, "cpu"), 0.0, 0
    for _ in range(2):
        jst, jstats = j_render(js, jcfg, jcam, jst)
        tst, tstats = t_render(ts, tcfg, tcam, tst)
        want_rays += float(jstats.rays)
        rays += int(tstats.rays)
    got, want = tst.accumulation.numpy(), np.asarray(jst.accumulation)
    assert got.shape == want.shape and np.isfinite(got).all() and got.mean() > 0.05
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of channels within 1/255"
    assert abs(rays - want_rays) <= 0.005 * want_rays, (rays, want_rays)
