"""The port's BVH2 traversal (``ops.traverse_wide``) on LBVH trees.

- The plain PyTorch version against the CPU twin (the CUDA kernel's
  header compiled by g++) and against the port's brute force: these share
  one operation order, so every field must be bit-equal.
- The port against the JAX package's ``traverse_wide`` (the Pallas kernel
  in interpret mode, as the JAX tests run it) on the very tree the JAX
  package built (the port's LBVH is bit-equal to it): hits, triangle ids
  and any-hit verdicts must be equal; t within rtol 1e-5, the
  barycentrics u, v within atol 1e-5.  The JAX package recomputes u, v
  and the back face for the winner with ``jnp.cross``, and XLA:CPU
  contracts ``a*b - c*d`` into fused multiply-adds; the port commits them
  in the traversal and rounds every product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh, build_scene_bvh, encode_leaf
from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import trace
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.ops import traverse_wide8 as tw8
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.types import BVH, make_trace_geometry
from vulkanraytracing_tpu.accel import lbvh as jl
from vulkanraytracing_tpu.ops import traverse_wide as jw
from vulkanraytracing_tpu.scene import procedural as jproc

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5


def _rays(n, extent, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.zeros((n,), np.float32), np.full((n,), 1e3, np.float32)


def _t(rays):
    return [torch.from_numpy(np.array(x, np.float32)) for x in rays]


@pytest.fixture(scope="module")
def soup():
    return build_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu").geometry)


@pytest.fixture(scope="module")
def cornell():
    return build_bvh(tproc.cornell_box_scene(device="cpu").geometry)


def _assert_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("scene_name", ["soup", "cornell"])
def test_cpu_twin_matches_plain(scene_name, request):
    """The kernel's own code (stack, leaf decoding, near-first order) on
    the CPU, bit-equal to the plain version on every field."""
    _, bvh = request.getfixturevalue(scene_name)
    extent = 11.0 if scene_name == "soup" else 0.9
    o, d, tmin, tmax = _rays(1000, extent, seed=21)
    tmax[::5] = 0.0
    rays = _t((o, d, tmin, tmax))
    table = tw2.get_table2(bvh)
    for cull in (True, False):
        plain = tw2.closest_plain(table, *rays, cull_backface=cull)
        assert plain.is_hit.sum() > 20
        _assert_equal(tw2.closest_twin(table, *rays, cull_backface=cull), plain)
    assert torch.equal(tw2.any_twin(table, *rays), tw2.any_plain(table, *rays))


@pytest.mark.parametrize("cull", [True, False])
def test_plain_matches_port_brute_force(soup, cull):
    geom, bvh = soup
    rays = _t(_rays(300, 11.0, seed=4))
    got = tw2.intersect_closest(bvh, *rays, cull_backface=cull)
    want = tint.intersect_closest_brute(geom, *rays, cull_backface=cull)
    hit = want.is_hit
    assert torch.equal(got.is_hit, hit) and hit.sum() > 10
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a[hit], b[hit]), name
    assert torch.equal(tw2.intersect_any(bvh, *rays), tint.intersect_any_brute(geom, *rays))


def test_port_matches_jax_traverse_wide():
    """One closest and one any-hit call of the JAX kernel (interpret
    mode), 300 rays with every third t_max = 0, on the JAX LBVH."""
    jg, jb = jl.build_bvh(jproc.triangle_soup_scene(960, seed=3).geometry)
    _, tb = build_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu").geometry)
    assert torch.equal(tb.nodes, torch.from_numpy(np.array(jb.nodes)))
    o, d, tmin, tmax = _rays(300, 11.0, seed=4)
    tmax[::3] = 0.0
    jrays = [jnp.asarray(x) for x in (o, d, tmin, tmax)]

    want = jw.intersect_closest(jg, jb, *jrays, cull_backface=True)
    got = tw2.intersect_closest(tb, *_t((o, d, tmin, tmax)), cull_backface=True)
    hit = np.asarray(want.is_hit)
    assert hit.sum() > 10 and not hit[::3].any()
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy()[hit], np.asarray(want.tri)[hit])
    np.testing.assert_array_equal(got.backface.numpy(), np.asarray(want.backface))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=RTOL_T)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit],
                                   rtol=0, atol=ATOL_UV, err_msg=name)

    want_any = np.asarray(jw.intersect_any(jg, jb, *jrays))
    assert want_any.sum() > 10
    np.testing.assert_array_equal(tw2.intersect_any(tb, *_t((o, d, tmin, tmax))).numpy(),
                                  want_any)


def _tie_bvh():
    """The unit quad at z=0 three times (bitwise-identical t/u/v for every
    ray) interleaved with displaced decoys: equal-t ties must go to the
    lowest triangle id."""
    quad_v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    quad_i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    vs, idx = [], []
    for k, dz in enumerate([0.0, 3.0, 0.0, -3.0, 0.0, 6.0]):
        vs.append(quad_v + np.array([0, 0, dz], np.float32))
        idx.append(quad_i + 4 * k)
    return build_bvh(make_trace_geometry(np.concatenate(vs), np.concatenate(idx),
                                         cull_disable=True, device="cpu"))


def _tie_rays(jitter: bool):
    n = 128
    rng = np.random.default_rng(11)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 2.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    if jitter:
        o[:, 0] = rng.uniform(-0.8, 0.8, n)
        o[:, 1] = rng.uniform(-0.8, 0.8, n)
        d[:, 0] = rng.uniform(-0.05, 0.05, n)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    else:
        o[:, 0] = np.linspace(-0.8, 0.8, n, dtype=np.float32)
    return o, d, np.zeros((n,), np.float32), np.full((n,), 1e3, np.float32)


def test_closest_tie_breaks_to_lowest_id():
    geom, bvh = _tie_bvh()
    rays = _t(_tie_rays(jitter=True))
    want = tint.intersect_closest_brute(geom, *rays, cull_backface=False)
    assert want.is_hit.all()
    table = tw2.get_table2(bvh)
    for got in (tw2.intersect_closest(bvh, *rays, cull_backface=False),
                tw2.closest_twin(table, *rays, cull_backface=False)):
        assert torch.equal(got.tri, want.tri)
        assert torch.equal(got.t, want.t)


def test_closest_tmax_boundary_inclusive():
    """A hit exactly at t_max commits."""
    geom, bvh = _tie_bvh()
    o, d, tmin, tmax = _t(_tie_rays(jitter=False))
    probe = tint.intersect_closest_brute(geom, o, d, tmin, tmax, cull_backface=False)
    rays = (o, d, tmin, probe.t)
    want = tint.intersect_closest_brute(geom, *rays, cull_backface=False)
    assert want.is_hit.all()
    table = tw2.get_table2(bvh)
    for got in (tw2.intersect_closest(bvh, *rays, cull_backface=False),
                tw2.closest_twin(table, *rays, cull_backface=False)):
        assert got.is_hit.all()
        assert torch.equal(got.tri, want.tri)
    assert tw2.intersect_any(bvh, *rays).all()


def _chain(bvh: BVH, levels: int) -> BVH:
    """A BVH2 of ``levels`` internal nodes in a chain: node i has node
    i + 1 as child 0 and a one-triangle leaf as child 1, the last node two
    leaves, every box spanning [-100, 100]^3.  A ray inside the boxes hits
    both children everywhere, so every node visit pushes one entry: the
    stack reaches ``levels``."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    child = torch.full((levels, 2), leaf, dtype=torch.int32)
    child[:-1, 0] = torch.arange(1, levels, dtype=torch.int32)
    box = torch.tensor([-100.0] * 3 + [100.0] * 3).repeat(2)
    return BVH(nodes=box.repeat(levels, 1), child_index=child, tris=bvh.tris,
               tri_flags=bvh.tri_flags, tri_order=bvh.tri_order)


def test_stack_bound(soup):
    """The exact bound is the deepest chain of internal nodes.  A tree
    that needs STACK_DEPTH - 1 entries is traversed to full depth (twin =
    plain version); one that needs STACK_DEPTH + 1 is refused, never
    traversed with dropped entries."""
    _, bvh = soup
    deep = _chain(bvh, tw2.STACK_DEPTH + 1)
    with pytest.raises(ValueError, match="stack"):
        tw2.build_table2(deep)
    with pytest.raises(ValueError, match="stack"):
        tw2.intersect_closest(deep, *_t(_rays(4, 1.0, seed=0)))

    chain = _chain(bvh, tw2.STACK_DEPTH - 1)
    table = tw2.build_table2(chain)
    v0, e1, e2 = table.tri[0, 0:3], table.tri[0, 3:6], table.tri[0, 6:9]
    target = (v0 + (e1 + e2) / 3.0).numpy()
    o, _, tmin, tmax = _rays(64, 11.0, seed=9)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = _t((o, d, tmin, tmax))
    for cull in (True, False):
        plain = tw2.closest_plain(table, *rays, cull_backface=cull)
        _assert_equal(tw2.closest_twin(table, *rays, cull_backface=cull), plain)
    plain = tw2.closest_plain(table, *rays, cull_backface=False)
    assert plain.is_hit.all() and (plain.tri == 0).all()
    assert torch.equal(tw2.any_twin(table, *rays), tw2.any_plain(table, *rays))


def test_trace_dispatch_by_bvh_shape(monkeypatch):
    """BVH_KERNEL takes the 8-wide kernel for a collapsed BVH and the
    2-wide kernel otherwise, as the JAX package's BVH_PALLAS does."""
    calls = []
    monkeypatch.setattr(tw8, "intersect_closest", lambda *a, **k: calls.append("8"))
    monkeypatch.setattr(tw8, "intersect_any", lambda *a, **k: calls.append("8any"))
    monkeypatch.setattr(tw2, "intersect_closest", lambda *a, **k: calls.append("2"))
    monkeypatch.setattr(tw2, "intersect_any", lambda *a, **k: calls.append("2any"))
    cfg = Config(traversal=TraversalMode.BVH_KERNEL)
    flat = build_scene_bvh(tproc.cornell_box_scene(device="cpu"))
    geom, bvh2 = build_bvh(flat.geometry)
    for scene in (flat, flat._replace(geometry=geom, bvh=bvh2)):
        trace.trace_closest(scene, cfg, None, None, None, None)
        trace.trace_any(scene, cfg, None, None, None, None)
    assert calls == ["8", "8any", "2", "2any"]


def test_cuda_rays_never_take_the_plain_path(soup, monkeypatch):
    """Dispatch: CPU rays run the plain version; CUDA rays go to the
    kernel wrapper (here replaced by a recorder)."""
    _, bvh = soup
    calls = []
    monkeypatch.setattr(tw2, "closest_cuda", lambda *a, **k: calls.append("closest"))
    monkeypatch.setattr(tw2, "any_cuda", lambda *a, **k: calls.append("any"))
    monkeypatch.setattr(tw2, "closest_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tw2, "any_plain", lambda *a, **k: calls.append("plain"))

    class FakeCuda:
        device = torch.device("cuda", 0)

    tw2.intersect_closest(bvh, FakeCuda(), None, None, None)
    tw2.intersect_any(bvh, FakeCuda(), None, None, None)
    assert calls == ["closest", "any"]


def test_kernel_wrapper_refuses_cpu_tensors(soup):
    _, bvh = soup
    with pytest.raises(ValueError, match="cuda"):
        tw2.closest_cuda(tw2.get_table2(bvh), *_t(_rays(4, 1.0, seed=0)))
    with pytest.raises(ValueError, match="cuda"):
        tw2.any_cuda(tw2.get_table2(bvh), *_t(_rays(4, 1.0, seed=0)))
