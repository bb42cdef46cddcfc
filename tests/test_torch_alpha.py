"""The port's alpha split for cutout geometry against the JAX package's,
on the real workload at its 20,000-triangle target (37,676 triangles, 800
alpha-tested).

- The cutout subset's tree, ``tri_map`` and the opaque view's flags are
  built by the same native builders from the same triangles: bit-equal.
- ``_hit_alpha``: within 1e-6; pass/fail decisions equal wherever the
  alpha is more than 1e-5 from the cutoff.
- ``trace_closest`` / ``trace_any`` through the split, the port's
  ``BVH_KERNEL`` (the BVH8 plain version on the CPU) against the JAX
  package's ``BVH`` (its XLA packet traversal), on camera rays and 4,096
  random rays: ``tri`` and ``blocked`` equal in at least 99.9% of rays
  (the JAX packet traversal lets the first triangle tested win an exact
  tie); t within 1e-5, u and v within 1e-5 in 99% of the hits.  XLA:CPU
  fuses multiply-adds, and on the hall's 40 m shell triangles, seen at a
  grazing angle, u and v are quotients of dot products of 10-40 m vectors
  by a small determinant: 0.3% of the hits differ by 1e-5 to 1.3e-4, and
  all must be within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_scene_bvh as t_build
from vulkanraytracing_torch.config import CameraConfig as TCameraConfig
from vulkanraytracing_torch.config import Config as TConfig
from vulkanraytracing_torch.config import TraversalMode as TMode
from vulkanraytracing_torch.ops import trace as ttrace
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit
from vulkanraytracing_torch.ops.texture import build_texture_pool
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_torch.scene.types import (
    Scene,
    concat_geometry,
    constant_environment,
    make_materials,
    make_trace_geometry,
    no_direct_light,
)
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.config import Config as JConfig
from vulkanraytracing_tpu.config import TraversalMode as JMode
from vulkanraytracing_tpu.ops import trace as jtrace
from vulkanraytracing_tpu.ops.intersect import Hit as JHit
from vulkanraytracing_tpu.scene import procedural as jproc

torch.set_num_threads(1)

TARGET = 20000
BVH_FIELDS = ("nodes", "child_index", "tris", "tri_flags", "tri_order",
              "nodes8", "child8", "tri_perm8")


@pytest.fixture(scope="module")
def scenes():
    """(the JAX scene, it carried across, the port's own build)."""
    js = j_build(jproc.sponza_like_scene(TARGET, workload="real"), builder="sah")
    carried = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    own = t_build(tproc.sponza_like_scene(TARGET, workload="real", device="cpu"),
                  builder="sah")
    return js, carried, own


def _eq(got, want, name):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_subset_tree_and_opaque_flags_match_jax(scenes):
    js, carried, own = scenes
    assert own.geometry.num_triangles == 37676
    assert own.alpha.geometry.num_triangles == 800
    for name in BVH_FIELDS:
        _eq(getattr(own.bvh, name), getattr(js.bvh, name), name)
        _eq(getattr(own.alpha.bvh, name), getattr(js.alpha.bvh, name), "subset " + name)
    for name, got in own.alpha.geometry._asdict().items():
        _eq(got, getattr(js.alpha.geometry, name), "subset " + name)
    _eq(own.alpha.tri_map, js.alpha.tri_map, "tri_map")
    want_flags = np.asarray(js.bvh.tri_flags) & ~4
    _eq(own.alpha.opaque_bvh.tri_flags, want_flags, "opaque flags")
    _eq(carried.alpha.opaque_bvh.tri_flags, want_flags, "carried opaque flags")
    # the opaque view shares the tree and packs tables of its own
    assert own.alpha.opaque_bvh.nodes8 is own.bvh.nodes8
    assert (own.bvh.tri_flags.numpy() & 4).sum() == 4 * 800


def test_hit_alpha_matches_jax(scenes):
    js, carried, _ = scenes
    gen = np.random.default_rng(1)
    n = 20000
    cut = np.nonzero(np.asarray(js.geometry.alpha_test))[0]
    tri = np.where(gen.random(n) < 0.8, gen.choice(cut, n),
                   gen.integers(0, js.geometry.num_triangles, n)).astype(np.int32)
    u = gen.random(n).astype(np.float32)
    v = (gen.random(n) * (1.0 - u)).astype(np.float32)
    t = np.where(gen.random(n) < 0.1, 3.0e38, 5.0).astype(np.float32)
    want_a, want_c = jtrace._hit_alpha(js, JHit(jnp.asarray(t), jnp.asarray(u), jnp.asarray(v),
                                                jnp.asarray(tri), jnp.zeros(n, bool)))
    hit = Hit(*(torch.from_numpy(x) for x in (t, u, v, tri)),
              backface=torch.zeros(n, dtype=torch.bool))
    got_a, got_c = ttrace._hit_alpha(carried, hit)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    want_a, want_c = np.asarray(want_a), np.asarray(want_c)
    sure = np.abs(want_a - want_c) > 1e-5
    got_fail = (got_a < got_c).numpy()
    assert sure.mean() > 0.9 and (got_fail[sure] == (want_a < want_c)[sure]).all()


def _rays(js):
    """Camera rays of a 64x36 view from the bench camera, and 4,096 random
    rays inside the hall, half of them along the foliage strips."""
    from vulkanraytracing_torch.config import CameraConfig
    from vulkanraytracing_torch.core import rng
    from vulkanraytracing_torch.pt.integrator import primary_rays
    from vulkanraytracing_torch.pt.render import tile_pixel_coords
    from vulkanraytracing_torch.scene.camera import Camera

    cam = Camera(CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                              aspect_ratio=64 / 36)).to_device("cpu")
    px, py, _, _, _ = tile_pixel_coords(64, 36, device="cpu")
    s0, s1 = rng.pixel_seed(px, py, 0)
    co, cd = primary_rays(cam, px, py, 64, 36, s0, s1)
    gen = np.random.default_rng(3)
    n = 4096
    ro = gen.uniform([-19.0, 0.2, -9.0], [19.0, 7.5, 9.0], (n, 3)).astype(np.float32)
    ro[: n // 2, 2] = np.sign(ro[: n // 2, 2]) * gen.uniform(8.4, 9.4, n // 2)
    ro[: n // 2, 1] = gen.uniform(0.2, 1.8, n // 2)
    rd = gen.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    o = np.concatenate([co.numpy(), ro]).astype(np.float32)
    d = np.concatenate([cd.numpy(), rd]).astype(np.float32)
    r = o.shape[0]
    t_min = np.full(r, 1e-3, np.float32)
    t_max = np.full(r, 1e3, np.float32)
    t_max[::97] = 0.0
    return o, d, t_min, t_max


@pytest.fixture(scope="module")
def traced(scenes):
    js, carried, _ = scenes
    rays = _rays(js)
    jcfg, tcfg = JConfig(traversal=JMode.BVH), TConfig(traversal=TMode.BVH_KERNEL)
    jr, tr = [jnp.asarray(x) for x in rays], [torch.from_numpy(x) for x in rays]
    out = {}
    for cull in (True, False):
        out[f"closest cull={cull}"] = (
            Hit(*(np.asarray(x) for x in jtrace.trace_closest(js, jcfg, *jr, cull_backface=cull))),
            Hit(*(x.numpy() for x in ttrace.trace_closest(carried, tcfg, *tr, cull_backface=cull))))
    out["any"] = (np.asarray(jtrace.trace_any(js, jcfg, *jr)),
                  ttrace.trace_any(carried, tcfg, *tr).numpy())
    return out


@pytest.mark.parametrize("case", ["closest cull=True", "closest cull=False"])
def test_trace_closest_through_the_split_matches_jax(traced, case):
    want, got = traced[case]
    hit = want.t < BIG_T
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(got.t < BIG_T, hit)
    same = hit & (got.tri == want.tri)
    assert same.sum() >= 0.999 * hit.sum()
    np.testing.assert_allclose(got.t[same], want.t[same], rtol=1e-5, atol=1e-5)
    for name in ("u", "v"):
        g, w = getattr(got, name)[same], getattr(want, name)[same]
        assert (np.abs(g - w) <= 1e-5).mean() >= 0.99, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=name)


def test_trace_any_through_the_split_matches_jax(traced):
    want, got = traced["any"]
    assert 0.2 < want.mean() < 1.0
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("branch", ["split", "whole-scene loop", "no textures"])
def test_reorder_leaves_traces_unchanged(scenes, branch):
    """``reorder=True`` (coherence-sort the rays for the traversal, restore
    their order after it) gives the same hits and verdicts bit for bit: the
    BVH8 walk is a pure function of ray and table.  Through the alpha split
    (the opaque phase is sorted), the whole-scene loop (its first trace is
    sorted, the re-trace rounds run in the rays' own order) and a scene
    without textures."""
    js, carried, _ = scenes
    scene = {"split": carried,
             "whole-scene loop": carried._replace(alpha=None),
             "no textures": carried._replace(textures=None, alpha=None)}[branch]
    cfg = TConfig(traversal=TMode.BVH_KERNEL)
    rays = [torch.from_numpy(x) for x in _rays(js)]
    want = ttrace.trace_closest(scene, cfg, *rays)
    got = ttrace.trace_closest(scene, cfg, *rays, reorder=True)
    assert float((want.t < BIG_T).float().mean()) > 0.5
    for name, a, b in zip(Hit._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(ttrace.trace_any(scene, cfg, *rays, reorder=True),
                       ttrace.trace_any(scene, cfg, *rays))


def test_split_sees_cutouts_on_real_rays(traced, scenes):
    """Some rays of the comparison pass a cutout and some stop at one."""
    js, _, _ = scenes
    want, _ = traced["closest cull=True"]
    at = np.asarray(js.geometry.alpha_test)
    hit = want.t < BIG_T
    assert at[want.tri[hit]].sum() > 10


def test_merge_tie_breaks_to_lowest_global_id():
    t = torch.tensor([1.0, 1.0, 2.0, BIG_T, 1.0])
    a = Hit(t=t, u=torch.full((5,), 0.1), v=torch.zeros(5),
            tri=torch.tensor([7, 3, 1, 0, 9], dtype=torch.int32),
            backface=torch.zeros(5, dtype=torch.bool))
    b = Hit(t=torch.tensor([1.0, 1.0, 1.0, 1.0, BIG_T]), u=torch.full((5,), 0.2),
            v=torch.zeros(5), tri=torch.tensor([5, 5, 5, 5, 5], dtype=torch.int32),
            backface=torch.ones(5, dtype=torch.bool))
    m = ttrace._merge_closest(a, b)
    assert m.tri.tolist() == [5, 3, 5, 5, 9]
    assert m.u.tolist() == pytest.approx([0.2, 0.1, 0.2, 0.2, 0.1])
    assert m.backface.tolist() == [True, False, True, True, False]


def _stack_scene(n_layers):
    """``n_layers`` cutout quads (left half transparent, right half an
    opaque leaf) in front of an opaque wall."""
    img = np.zeros((16, 16, 4), np.uint8)
    img[:, :8] = [40, 160, 40, 0]
    img[:, 8:] = [40, 160, 40, 255]
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    parts = []
    for k in range(n_layers):
        z = 1.0 - 0.3 * k
        pos = np.array([[-2, -2, z], [2, -2, z], [2, 2, z], [-2, 2, z]], np.float32)
        uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
        parts.append(make_trace_geometry(pos, quad, uvs=uvs, material_id=0, cull_disable=True,
                                         opaque=False, alpha_test=True, device="cpu"))
    wall = np.array([[-3, -3, -1], [3, -3, -1], [3, 3, -1], [-3, 3, -1]], np.float32)
    parts.append(make_trace_geometry(wall, quad, material_id=1, cull_disable=True,
                                     device="cpu"))
    return Scene(
        geometry=concat_geometry(parts),
        materials=make_materials([(1, 1, 1, 1), (0.8, 0.2, 0.2, 1)], base_color_textures=[0, -1],
                                 alpha_cutoffs=[0.5, 0.5], device="cpu"),
        environment=constant_environment((1.0, 1.0, 1.0), device="cpu"),
        direct_light=no_direct_light("cpu"), point_lights=None, bvh=None,
        textures=build_texture_pool([img], device="cpu"),
    )


@pytest.mark.parametrize("mode", [TMode.BVH_KERNEL, TMode.BRUTE_FORCE], ids=lambda m: m.name)
@pytest.mark.parametrize("split", [True, False], ids=["split", "whole-scene loop"])
def test_four_layer_stack_resolves_within_max_alpha_iters(mode, split):
    """Rays through the transparent halves of 4 cutout layers reach the
    wall (4 rejected hits: exactly ``MAX_ALPHA_ITERS`` re-traces); rays at
    the opaque halves stop at the first layer.  A fifth layer is one too
    many for the whole-scene loop, which gives those hits up as misses;
    the split still finds the wall in its opaque phase."""
    assert ttrace.MAX_ALPHA_ITERS == 4
    cfg = TConfig(traversal=mode)
    for layers, wall_reached in ((4, True), (5, split)):
        scene = _stack_scene(layers)
        if split:
            scene = t_build(scene)
            assert scene.alpha is not None
        ys = torch.linspace(-1.5, 1.5, 8)
        o = torch.stack([torch.cat([torch.full((8,), -1.0), torch.full((8,), 1.0)]),
                         torch.cat([ys, ys]), torch.full((16,), 5.0)], dim=1)
        d = torch.tensor([0.0, 0.0, -1.0]).expand(16, 3).contiguous()
        t_min, t_max = torch.full((16,), 1e-3), torch.full((16,), 100.0)
        hit = ttrace.trace_closest(scene, cfg, o, d, t_min, t_max)
        left, right = hit.t[:8], hit.t[8:]
        assert torch.allclose(right, torch.full((8,), 4.0))
        if wall_reached:
            assert torch.allclose(left, torch.full((8,), 6.0))
        else:
            assert (left >= BIG_T).all()
        blocked = ttrace.trace_any(scene, cfg, o, d, t_min, t_max)
        assert blocked[8:].all() and bool(blocked[:8].all()) == wall_reached
