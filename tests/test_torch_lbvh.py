"""The port's on-device LBVH and two-level TLAS against the JAX package.

The LBVH is integer arithmetic plus exact float mins and maxes, one
divide and adds in the JAX package's order, so Morton codes, the Karras
hierarchy, the refit boxes and the whole ``build_bvh`` output must be
bit-equal (no tolerance).  The TLAS world transform is written out as
elementwise products and sums; the JAX package's ``einsum`` sums in
another order, so transformed vertices agree within 1e-6 relative in
general and bit for bit under translations and axis mirrors (products by
0 and 1 are exact), which is where whole trees and refits are compared.
The ports of ``tests/test_tlas.py`` run the refitted trees through the
port's BVH2 traversal (its plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel import lbvh as tl
from vulkanraytracing_torch.accel import tlas as tt
from vulkanraytracing_torch.accel.sah import build_bvh_sah
from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import trace
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.convert import soup_from_numpy
from vulkanraytracing_torch.scene.types import make_trace_geometry as t_make
from vulkanraytracing_tpu.accel import lbvh as jl
from vulkanraytracing_tpu.accel import tlas as jt
from vulkanraytracing_tpu.scene import procedural as jproc
from vulkanraytracing_tpu.scene.types import make_trace_geometry as j_make

torch.set_num_threads(1)

SCENES = {  # the port's scenes are asked for on the CPU (device="cpu")
    "soup960": lambda mod, **kw: mod.triangle_soup_scene(960, seed=3, **kw),
    "cornell": lambda mod, **kw: mod.cornell_box_scene(**kw),
}
BVH_FIELDS = ("nodes", "child_index", "tris", "tri_flags", "tri_order")


def _eq(got: torch.Tensor, want, name: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


def _boxes_and_codes(mod_lbvh, geometry):
    v0 = geometry.v0
    p1, p2 = v0 + geometry.e1, v0 + geometry.e2
    mn, mx = (jnp.minimum, jnp.maximum) if mod_lbvh is jl else (torch.minimum, torch.maximum)
    lo, hi = mn(mn(v0, p1), p2), mx(mx(v0, p1), p2)
    centroid = (lo + hi) * 0.5
    if mod_lbvh is jl:
        return lo, hi, jl.morton_codes(centroid, lo.min(axis=0), hi.max(axis=0))
    return lo, hi, tl.morton_codes(centroid, lo.amin(dim=0), hi.amax(dim=0))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_morton_karras_refit_bit_equal(name):
    jg, tg = SCENES[name](jproc).geometry, SCENES[name](tproc, device="cpu").geometry
    j_lo, j_hi, j_codes = _boxes_and_codes(jl, jg)
    t_lo, t_hi, t_codes = _boxes_and_codes(tl, tg)
    _eq(t_codes, j_codes, "morton codes")

    j_order = jnp.argsort(j_codes, stable=True)
    t_sorted, t_order = torch.sort(t_codes, stable=True)
    _eq(t_order, j_order, "stable sort order")
    j_tree = jl.karras_hierarchy(j_codes[j_order])
    t_tree = tl.karras_hierarchy(t_sorted)
    for field, a, b in zip(("left", "right", "range_lo", "range_hi"), t_tree, j_tree):
        assert a.dtype == torch.int32
        _eq(a, b, field)

    j_box = jl.refit_aabbs(j_tree[0], j_tree[1], j_lo[j_order], j_hi[j_order])
    t_box = tl.refit_aabbs(t_tree[0], t_tree[1], t_lo[t_order], t_hi[t_order])
    _eq(t_box[0], j_box[0], "refit lo")
    _eq(t_box[1], j_box[1], "refit hi")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_bit_equal(name):
    jg, jb = jl.build_bvh(SCENES[name](jproc).geometry)
    tg, tb = tl.build_bvh(SCENES[name](tproc, device="cpu").geometry)
    for field in BVH_FIELDS:
        _eq(getattr(tb, field), getattr(jb, field), field)
    for field in tg._fields:
        _eq(getattr(tg, field), getattr(jg, field), field)
    assert tb.nodes8 is None and tb.table2 is None
    assert 1 <= tb.topology.stack_need <= tw2.STACK_DEPTH


def test_build_scene_bvh_defaults_to_lbvh():
    """The JAX package's default builder, and the same BVH8 collapse."""
    js = jl.build_scene_bvh(jproc.cornell_box_scene())
    ts = tl.build_scene_bvh(tproc.cornell_box_scene(device="cpu"))
    for field in BVH_FIELDS + ("nodes8", "child8", "tri_perm8"):
        _eq(getattr(ts.bvh, field), getattr(js.bvh, field), field)


def test_single_triangle_leaf():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    jg, jb = jl.build_bvh(j_make(tri, [[0, 1, 2]]))
    tg, tb = tl.build_bvh(t_make(tri, [[0, 1, 2]], device="cpu"))
    for field in BVH_FIELDS:
        _eq(getattr(tb, field), getattr(jb, field), field)
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    hit = tw2.intersect_closest(tb, o, d, torch.zeros(1), torch.full((1,), 10.0))
    assert bool(hit.is_hit[0]) and float(hit.t[0]) == 1.0


def test_refit_levels_follow_readiness():
    """Pass k holds exactly the nodes whose node children finished in
    earlier passes, unreachable rows included; a cycle is refused."""
    leaf = -1
    child = np.array([[1, 2], [leaf, leaf], [3, leaf], [leaf, leaf], [leaf, leaf]])
    levels = tl.refit_levels(child)
    assert [x.tolist() for x in levels] == [[1, 3, 4], [2], [0]]
    assert tl.worst_case_stack(child) == 3  # 0 -> 2 -> 3
    with pytest.raises(ValueError, match="forest"):
        tl.refit_levels(np.array([[1, leaf], [0, leaf]]))


# --- two-level instancing (ports of tests/test_tlas.py) ---------------------


def _spheres(radius=0.5):
    v, i = tproc.generate_sphere(radius, lat=6, lon=10)
    return t_make(v, i, device="cpu"), j_make(v, i)


def _transforms(positions, scale=1.0, mirror_x=()):
    out = []
    for k, p in enumerate(positions):
        m = np.eye(4, dtype=np.float32) * scale
        m[3, 3] = 1.0
        m[:3, 3] = p
        if k in mirror_x:
            m[0, 0] = -m[0, 0]
        out.append(m)
    return np.stack(out)


def _rays(n=256, seed=0, extent=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n), torch.full((n,), 100.0)]


def _scene(geom, bvh):
    return tproc.cornell_box_scene(device="cpu")._replace(geometry=geom, bvh=bvh)


CFG = Config(traversal=TraversalMode.BVH_KERNEL)


def test_instances_match_brute_force():
    blas, _ = _spheres()
    soup = tt.make_instances([blas], [0, 0, 0], material_offsets=[0, 1, 2])
    geom, bvh, _ = tt.build_tlas(soup, torch.from_numpy(
        _transforms([(-2, 0, 0), (0, 0, 0), (2, 1, 0)])))
    rays = _rays(n=2048)
    fast = trace.trace_closest(_scene(geom, bvh), CFG, *rays)
    brute = tint.intersect_closest_brute(geom, *rays)
    assert torch.equal(fast.is_hit, brute.is_hit) and brute.is_hit.sum() > 10
    for a, b in zip(fast, brute):
        assert torch.equal(a[brute.is_hit], b[brute.is_hit])
    mids = geom.material_id[fast.tri[brute.is_hit].long()]
    assert set(mids.tolist()) <= {0, 1, 2}


def test_refit_tracks_moving_instance():
    """Through the BVH2 traversal (plain version on the CPU): after a
    refit a ray at the old position misses and one at the new position
    hits; the refitted BVH carries no stale table."""
    blas, _ = _spheres()
    soup = tt.make_instances([blas], [0, 0])
    geom, bvh, order = tt.build_tlas(soup, torch.from_numpy(_transforms([(-2, 0, 0), (2, 0, 0)])))
    soup_sorted = tt.permute_soup(soup, order)
    o2 = torch.tensor([[2.0, 0.0, 5.0]])
    d2 = torch.tensor([[0.0, 0.0, -1.0]])
    window = (torch.zeros(1), torch.full((1,), 100.0))
    assert bool(trace.trace_closest(_scene(geom, bvh), CFG, o2, d2, *window).is_hit[0])
    assert bvh.table2 is not None  # cached by that trace

    geom1, bvh1 = tt.refit_tlas(bvh, soup_sorted, torch.from_numpy(
        _transforms([(-2, 0, 0), (2, 3, 0)])))
    assert bvh1.table2 is None and bvh1.table8 is None
    assert bvh1.topology is bvh.topology
    scene1 = _scene(geom1, bvh1)
    rays = _rays(seed=2)
    fast = trace.trace_closest(scene1, CFG, *rays)
    brute = tint.intersect_closest_brute(geom1, *rays)
    assert torch.equal(fast.is_hit, brute.is_hit)
    assert torch.equal(fast.t[brute.is_hit], brute.t[brute.is_hit])

    assert not bool(trace.trace_closest(scene1, CFG, o2, d2, *window).is_hit[0])
    assert not bool(trace.trace_any(scene1, CFG, o2, d2, *window)[0])
    o3 = torch.tensor([[2.0, 3.0, 5.0]])
    assert bool(trace.trace_closest(scene1, CFG, o3, d2, *window).is_hit[0])
    assert bool(trace.trace_any(scene1, CFG, o3, d2, *window)[0])


def test_mirrored_instance_winding():
    """Negative-determinant instances flip winding so back-face culling
    still shows the outside of the sphere."""
    blas, _ = _spheres()
    soup = tt.make_instances([blas], [0])
    geom, bvh, _ = tt.build_tlas(soup, torch.from_numpy(_transforms([(0, 0, 0)], mirror_x=(0,))))
    hit = tw2.intersect_closest(bvh, torch.tensor([[0.0, 0.0, 5.0]]),
                                torch.tensor([[0.0, 0.0, -1.0]]), torch.zeros(1),
                                torch.full((1,), 100.0), cull_backface=True)
    assert bool(hit.is_hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 4.5, atol=0.05)


def test_refit_equals_rebuild_geometry():
    """A refit at the build transforms gives the build's geometry and
    boxes bit for bit."""
    blas, _ = _spheres()
    soup = tt.make_instances([blas], [0, 0])
    t0 = torch.from_numpy(_transforms([(0, 0, 0), (3, 0, 0)]))
    geom0, bvh0, order = tt.build_tlas(soup, t0)
    geom_refit, bvh_refit = tt.refit_tlas(bvh0, tt.permute_soup(soup, order), t0)
    for field in geom0._fields:
        assert torch.equal(getattr(geom_refit, field), getattr(geom0, field)), field
    # rows a refit reaches carry the build's boxes; the padding row's
    # empty boxes are (+inf, -inf) after a refit, as in the JAX package
    assert torch.equal(bvh_refit.nodes[:-1], bvh0.nodes[:-1])


def test_world_geometry_matches_jax():
    """A rotated, a scaled and a mirrored instance: vertices within 1e-6
    relative of the JAX package's (einsum sums in another order), normals
    and tangents within 1e-6, the mirrored instance's winding swapped."""
    t_blas, j_blas = _spheres()
    j_soup = jt.make_instances([j_blas], [0, 0, 0], material_offsets=[0, 2, 1])
    t_soup = soup_from_numpy(jax.tree.map(np.asarray, j_soup), device="cpu")
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    rot[:3, 3] = (1.0, 2.0, -1.0)
    transforms = np.stack([rot, _transforms([(0, 1, 0)], scale=2.0)[0],
                           _transforms([(-3, 0, 0)], mirror_x=(0,))[0]])
    want = jt.world_geometry(j_soup, jnp.asarray(transforms))
    got = tt.world_geometry(t_soup, torch.from_numpy(transforms))
    for field in got._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
    mirrored = np.asarray(t_soup.instance_id) == 2
    # swapped corners: e1 of a mirrored triangle is the object e2, mirrored
    e2_obj = t_soup.object_geometry.e2.numpy()[mirrored]
    np.testing.assert_allclose(got.e1.numpy()[mirrored][:, 0], -e2_obj[:, 0], atol=1e-6)


def test_build_and_refit_tlas_bit_equal_to_jax():
    """Under translations and an axis mirror the world geometry is exact
    in both packages, so the TLAS build (order, child ids, boxes) and a
    refit after a move are bit-equal to the JAX package's."""
    _, j_blas = _spheres()
    j_soup = jt.make_instances([j_blas], [0, 0, 0], material_offsets=[0, 1, 2])
    t_soup = soup_from_numpy(jax.tree.map(np.asarray, j_soup), device="cpu")
    t0 = _transforms([(-2, 0, 0), (0, 0, 0), (2, 1, 0)], mirror_x=(2,))
    t1 = _transforms([(-2, 0, 1), (0, 2, 0), (2, 1, 0)], mirror_x=(2,))

    j_geom, j_bvh, j_order = jt.build_tlas(j_soup, jnp.asarray(t0))
    t_geom, t_bvh, t_order = tt.build_tlas(t_soup, torch.from_numpy(t0))
    for field in BVH_FIELDS:
        _eq(getattr(t_bvh, field), getattr(j_bvh, field), field)
    for field in ("v0", "e1", "e2", "material_id"):
        _eq(getattr(t_geom, field), getattr(j_geom, field), field)

    j_geom1, j_bvh1 = jt.refit_tlas(j_bvh, jt.permute_soup(j_soup, j_order), jnp.asarray(t1))
    t_geom1, t_bvh1 = tt.refit_tlas(t_bvh, tt.permute_soup(t_soup, t_order),
                                    torch.from_numpy(t1))
    for field in BVH_FIELDS:
        _eq(getattr(t_bvh1, field), getattr(j_bvh1, field), f"refit {field}")
    for field in ("v0", "e1", "e2"):
        _eq(getattr(t_geom1, field), getattr(j_geom1, field), f"refit {field}")


def test_refit_single_triangle_bit_equal_to_jax():
    """The one-triangle tree (two leaf children, no padding row) refits
    by the same route as the build, as the JAX package's does."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    j_soup = jt.make_instances([j_make(tri, [[0, 1, 2]])], [0])
    t_soup = tt.make_instances([t_make(tri, [[0, 1, 2]], device="cpu")], [0])
    t0, t1 = _transforms([(0, 0, 0)]), _transforms([(1, 2, 3)])
    _, j_bvh, j_order = jt.build_tlas(j_soup, jnp.asarray(t0))
    _, t_bvh, t_order = tt.build_tlas(t_soup, torch.from_numpy(t0))
    _, j_bvh1 = jt.refit_tlas(j_bvh, jt.permute_soup(j_soup, j_order), jnp.asarray(t1))
    _, t_bvh1 = tt.refit_tlas(t_bvh, tt.permute_soup(t_soup, t_order), torch.from_numpy(t1))
    for field in BVH_FIELDS:
        _eq(getattr(t_bvh1, field), getattr(j_bvh1, field), f"refit {field}")
    assert float(t_bvh1.nodes[0, 1]) == 2.0


def test_refit_refuses_trees_it_cannot_refit():
    scene = tl.build_scene_bvh(tproc.cornell_box_scene(device="cpu"))
    blas, _ = _spheres()
    soup = tt.make_instances([blas], [0])
    with pytest.raises(ValueError, match="8-wide"):
        tt.refit_tlas(scene.bvh, soup, torch.from_numpy(_transforms([(0, 0, 0)])))
    _, sah = build_bvh_sah(tproc.cornell_box_scene(device="cpu").geometry)  # no topology
    with pytest.raises(ValueError, match="topology"):
        tt.refit_tlas(sah, soup, torch.from_numpy(_transforms([(0, 0, 0)])))
