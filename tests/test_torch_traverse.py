"""The port's BVH8 traversal against the JAX package, on the very BVH the
JAX package built (carried across with ``scene_from_numpy``).

- The plain PyTorch traversal against JAX ``traverse_wide8`` (the Pallas
  kernel in interpret mode, as the JAX tests run it) and JAX brute force.
  ``is_hit``, ``tri``, ``backface`` and the any-hit booleans must be
  equal; ``t`` within rtol 1e-5, and the barycentrics ``u``, ``v`` (in
  [0, 1]) within atol 1e-5.  Under jit, XLA:CPU contracts the
  Moller-Trumbore cross products ``a*b - c*d`` into fused multiply-adds
  (a quarter of such products then differ in the last bit); the port
  rounds every product, as the CUDA kernel built with ``-fmad=false``
  does.  t, u and v are ratios of cancelling sums over det, so one ulp in
  a cross-product component moves them by up to a few 1e-6 (measured:
  1.03e-6 relative in t, 1.3e-6 absolute in v, on these rays).
- The CPU twin (the CUDA kernel's header compiled by g++) against the
  plain version, and the port's brute force against the plain version:
  these share one operation order, so every field must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.bvh8 import _worst_case_stack
from vulkanraytracing_torch.accel.lbvh import encode_leaf
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import traverse_wide8 as tw
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh
from vulkanraytracing_tpu.ops import intersect as jint
from vulkanraytracing_tpu.ops import traverse_wide8 as jw8
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene, triangle_soup_scene
from vulkanraytracing_tpu.scene.types import make_trace_geometry

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5


def _rays(n, extent, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.zeros((n,), np.float32), np.full((n,), 1e3, np.float32)


def _both(jscene):
    """(JAX scene, port scene on the CPU) sharing one SAH-built BVH."""
    js = build_scene_bvh(jscene, builder="sah")
    return js, scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")


def _j(rays):
    return [jnp.asarray(x) for x in rays]


def _t(rays):
    return [torch.from_numpy(np.array(x, np.float32)) for x in rays]


@pytest.fixture(scope="module")
def soup():
    return _both(triangle_soup_scene(960, seed=3))


@pytest.fixture(scope="module")
def cornell():
    return _both(cornell_box_scene())


def _assert_hits_match(got, want, exact: bool):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy()[hit], np.asarray(want.tri)[hit])
    np.testing.assert_array_equal(got.backface.numpy(), np.asarray(want.backface))
    for name in ("t", "u", "v"):
        a, b = getattr(got, name).numpy()[hit], np.asarray(getattr(want, name))[hit]
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            tol = dict(rtol=RTOL_T, atol=0) if name == "t" else dict(rtol=0, atol=ATOL_UV)
            np.testing.assert_allclose(a, b, err_msg=name, **tol)


def test_plain_closest_matches_jax_wide8(soup):
    js, ts = soup
    rays = _rays(300, 11.0, seed=4)  # not a multiple of 128
    want = jw8.intersect_closest(js.geometry, js.bvh, *_j(rays), cull_backface=True)
    got = tw.intersect_closest(ts.bvh, *_t(rays), cull_backface=True)
    assert np.asarray(want.is_hit).sum() > 10
    _assert_hits_match(got, want, exact=False)


def test_plain_any_matches_jax_wide8(soup):
    js, ts = soup
    rays = _rays(300, 11.0, seed=6)
    want = np.asarray(jw8.intersect_any(js.geometry, js.bvh, *_j(rays)))
    got = tw.intersect_any(ts.bvh, *_t(rays)).numpy()
    assert want.sum() > 10
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cull", [True, False])
def test_plain_closest_matches_jax_brute(soup, cull):
    js, ts = soup
    rays = _rays(300, 11.0, seed=4)
    want = jint.intersect_closest_brute(js.geometry, *_j(rays), cull_backface=cull)
    got = tw.intersect_closest(ts.bvh, *_t(rays), cull_backface=cull)
    mine = tint.intersect_closest_brute(ts.geometry, *_t(rays), cull_backface=cull)
    _assert_hits_match(got, mine, exact=True)
    _assert_hits_match(got, want, exact=False)


def test_plain_any_matches_brute(soup):
    js, ts = soup
    rays = _rays(300, 11.0, seed=8)
    want = np.asarray(jint.intersect_any_brute(js.geometry, *_j(rays)))
    np.testing.assert_array_equal(tw.intersect_any(ts.bvh, *_t(rays)).numpy(), want)
    np.testing.assert_array_equal(
        tint.intersect_any_brute(ts.geometry, *_t(rays)).numpy(), want)


def _tie_scene():
    """The unit quad at z=0 three times (bitwise-identical t/u/v for every
    ray) interleaved with displaced decoys: equal-t ties must go to the
    lowest triangle id."""
    quad_v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    quad_i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    vs, idx = [], []
    for k, dz in enumerate([0.0, 3.0, 0.0, -3.0, 0.0, 6.0]):
        vs.append(quad_v + np.array([0, 0, dz], np.float32))
        idx.append(quad_i + 4 * k)
    geom = make_trace_geometry(np.concatenate(vs), np.concatenate(idx),
                               cull_disable=True)
    return cornell_box_scene()._replace(geometry=geom, point_lights=None)


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
    js, ts = _both(_tie_scene())
    rays = _tie_rays(jitter=True)
    want = jint.intersect_closest_brute(js.geometry, *_j(rays), cull_backface=False)
    assert np.asarray(want.is_hit).all()
    table = tw.get_table8(ts.bvh)
    for got in (tw.intersect_closest(ts.bvh, *_t(rays), cull_backface=False),
                tw.closest_twin(table, *_t(rays), cull_backface=False)):
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_closest_tmax_boundary_inclusive():
    """A hit exactly at t_max commits."""
    js, ts = _both(_tie_scene())
    o, d, tmin, tmax = _tie_rays(jitter=False)
    probe = jint.intersect_closest_brute(js.geometry, *_j((o, d, tmin, tmax)),
                                         cull_backface=False)
    rays = (o, d, tmin, np.asarray(probe.t))
    want = jint.intersect_closest_brute(js.geometry, *_j(rays), cull_backface=False)
    assert np.asarray(want.is_hit).all()
    table = tw.get_table8(ts.bvh)
    for got in (tw.intersect_closest(ts.bvh, *_t(rays), cull_backface=False),
                tw.closest_twin(table, *_t(rays), cull_backface=False)):
        assert got.is_hit.all()
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))


def test_dead_lanes_miss(cornell):
    """t_max = 0 lanes and inverted windows (t_min 0 > t_max -1) miss."""
    js, ts = cornell
    o, d, tmin, tmax = _rays(300, 0.9, seed=7)
    tmax[::3] = 0.0
    tmax[1::7] = -1.0
    dead = tmax <= 0.0
    want = jint.intersect_closest_brute(js.geometry, *_j((o, d, tmin, tmax)))
    got = tw.intersect_closest(ts.bvh, *_t((o, d, tmin, tmax)))
    assert not got.is_hit.numpy()[dead].any()
    assert got.is_hit.numpy()[~dead].mean() > 0.5  # the box is open on +z
    _assert_hits_match(got, want, exact=False)
    assert not tw.intersect_any(ts.bvh, *_t((o, d, tmin, tmax))).numpy()[dead].any()


def _full_chain(bvh, levels):
    """A BVH8 of ``levels`` full nodes in a chain: node i descends into
    node i + 1 through slot 0, its other slots are one-triangle leaves, and
    every box spans [-100, 100]^3.  A ray inside the boxes hits every
    child, so each node visit pushes 7 entries: the stack reaches
    7 * levels."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    child8 = torch.full((levels, 8), leaf, dtype=torch.int32)
    child8[:-1, 0] = torch.arange(1, levels, dtype=torch.int32)
    box = torch.tensor([-100.0] * 3 + [100.0] * 3).repeat(8)
    return type(bvh)(
        nodes=bvh.nodes, child_index=bvh.child_index, tris=bvh.tris,
        tri_flags=bvh.tri_flags, tri_order=bvh.tri_order,
        nodes8=box.repeat(levels, 1), child8=child8, tri_perm8=bvh.tri_perm8,
    )


def test_stack_need_past_kernel_depth_raises(soup):
    """A tree deeper than the kernel's stack is refused, never traversed
    with dropped entries."""
    _, ts = soup
    deep = _full_chain(ts.bvh, tw.STACK_DEPTH // 7 + 1)  # needs 98 > 96
    with pytest.raises(ValueError, match="stack"):
        tw.build_table8(deep)
    with pytest.raises(ValueError, match="stack"):
        tw.intersect_closest(deep, *_t(_rays(4, 1.0, seed=0)))


def test_worst_case_stack_counts_the_kernels_pushes(soup):
    """The bound is exact for this traversal: (non-empty children - 1) per
    node on the deepest path, nothing for leaves.  A tree that needs 91 of
    the 96 entries is accepted and traversed to full depth; the CPU twin
    (the kernel's code) and the plain version agree bit for bit."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    small = np.array([[1, leaf, 0, 0, 0, 0, 0, 0],
                      [leaf, leaf, leaf, 0, 0, 0, 0, 0]], np.int32)
    assert _worst_case_stack(small) == 1 + 2

    _, ts = soup
    levels = tw.STACK_DEPTH // 7
    deep = _full_chain(ts.bvh, levels)
    assert _worst_case_stack(deep.child8.numpy()) == 7 * levels
    table = tw.build_table8(deep)
    v0, e1, e2 = table.tri[0, 0:3], table.tri[0, 4:7], table.tri[0, 8:11]
    target = (v0 + (e1 + e2) / 3.0).numpy()
    o, _, tmin, tmax = _rays(64, 11.0, seed=9)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = _t((o, d, tmin, tmax))
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        for name, a, b in zip(plain._fields, twin, plain):
            assert torch.equal(a, b), name
    plain = tw.closest_plain(table, *rays, cull_backface=False)
    assert plain.is_hit.all() and (plain.tri == table.tri_meta[0, 1]).all()
    assert torch.equal(tw.any_twin(table, *rays), tw.any_plain(table, *rays))


@pytest.mark.parametrize("scene_name", ["soup", "cornell"])
def test_cpu_twin_matches_plain(scene_name, request):
    """The kernel's own code (stack, leaf decoding, near-first order) on
    the CPU, bit-equal to the plain version on every field."""
    _, ts = request.getfixturevalue(scene_name)
    extent = 11.0 if scene_name == "soup" else 0.9
    o, d, tmin, tmax = _rays(1000, extent, seed=21)
    tmax[::5] = 0.0
    rays = _t((o, d, tmin, tmax))
    table = tw.get_table8(ts.bvh)
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        assert plain.is_hit.sum() > 20
        for name, a, b in zip(plain._fields, twin, plain):
            assert torch.equal(a, b), name
    assert torch.equal(tw.any_twin(table, *rays), tw.any_plain(table, *rays))


def test_cuda_rays_never_take_the_plain_path(soup, monkeypatch):
    """Dispatch: CPU rays run the plain version; CUDA rays go to the
    kernel wrapper (here replaced by a recorder)."""
    _, ts = soup
    calls = []
    monkeypatch.setattr(tw, "closest_cuda", lambda *a, **k: calls.append("closest"))
    monkeypatch.setattr(tw, "any_cuda", lambda *a, **k: calls.append("any"))
    monkeypatch.setattr(tw, "closest_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tw, "any_plain", lambda *a, **k: calls.append("plain"))

    class FakeCuda:
        device = torch.device("cuda", 0)

    tw.intersect_closest(ts.bvh, FakeCuda(), None, None, None)
    tw.intersect_any(ts.bvh, FakeCuda(), None, None, None)
    assert calls == ["closest", "any"]


def test_kernel_wrapper_refuses_cpu_tensors(soup):
    _, ts = soup
    with pytest.raises(ValueError, match="cuda"):
        tw.closest_cuda(tw.get_table8(ts.bvh), *_t(_rays(4, 1.0, seed=0)))
    with pytest.raises(ValueError, match="cuda"):
        tw.any_cuda(tw.get_table8(ts.bvh), *_t(_rays(4, 1.0, seed=0)))
