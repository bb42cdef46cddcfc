"""The port's shared-cursor packet traversal (``ops.traverse_pallas``,
``TraversalMode.BVH_SHARED``) on the CPU.  ``PacketKernelCases`` holds the
cases both packet kernels share; ``test_torch_traverse_subpacket.py`` runs
them for the subpacket kernel.

- The plain PyTorch version against the CPU twin (the CUDA kernel's
  header compiled by g++): the same visit order and operation order, so
  every field must be bit-equal.
- The plain version against the port's brute force: hits and t bit-equal
  (the same Moller-Trumbore code), triangle ids where one triangle alone
  attains the nearest t (the packet kernels let the first triangle tested
  win a tie, brute force the lowest id).
- The port against the JAX package's own kernel in interpret mode, as the
  JAX tests run it, on the very trees the JAX package builds (the port's
  LBVH and SAH builds are bit-equal to them): 300 rays (a multiple of
  neither 128 nor 1024), every third one dead.  Hits, triangle ids and
  any-hit verdicts must be equal; t within rtol 1e-5, u and v within atol
  1e-5: the JAX package recomputes u, v and the back face for the winner
  with ``jnp.cross``, which XLA:CPU contracts into fused multiply-adds,
  while the port commits them in the traversal and rounds every product.
- A hit exactly at t_max is not committed, in the port and in the JAX
  kernel alike; one float further it is.
- A chain of interior nodes whose traversal needs STACK_DEPTH - 1 stack
  entries is walked to full depth (twin = plain); one that needs more is
  refused.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh, encode_leaf
from vulkanraytracing_torch.accel.sah import build_bvh_sah
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import traverse_pallas as tpal
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.types import BVH
from vulkanraytracing_tpu.accel import lbvh as jl
from vulkanraytracing_tpu.accel.sah import build_bvh_sah as j_build_sah
from vulkanraytracing_tpu.ops import traverse_pallas as jpal
from vulkanraytracing_tpu.scene import procedural as jproc

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5

# name: (scene factory, builders (port, JAX), ray origin extent)
TREES = {
    "soup_lbvh": (lambda m, **kw: m.triangle_soup_scene(960, seed=3, **kw),
                  (build_bvh, jl.build_bvh), 11.0),
    "soup_sah": (lambda m, **kw: m.triangle_soup_scene(960, seed=3, **kw),
                 (build_bvh_sah, j_build_sah), 11.0),
    "cornell": (lambda m, **kw: m.cornell_box_scene(**kw),
                (build_bvh, jl.build_bvh), 0.9),
}


def _rays(n, extent, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.zeros((n,), np.float32), np.full((n,), 1e3, np.float32)


def _t(rays):
    return [torch.from_numpy(np.array(x, np.float32)) for x in rays]


@functools.cache
def _port_tree(name):
    make, (build, _), extent = TREES[name]
    geom, bvh = build(make(tproc, device="cpu").geometry)
    return geom, bvh, extent


@functools.cache
def _jax_tree(name):
    make, (_, build), _ = TREES[name]
    return build(make(jproc).geometry)


def _assert_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


def _single_winner(geom, rays, cull, t):
    """Rays whose nearest valid t (brute force's rules) is attained by one
    triangle only."""
    o, d, t_min, t_max = rays
    tt, u, v, det = tint.moller_trumbore(o[:, None], d[:, None], geom.v0[None],
                                         geom.e1[None], geom.e2[None])
    valid = (det.abs() > tint.DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
    valid &= (tt >= t_min[:, None]) & (tt <= t_max[:, None])
    if cull:
        valid &= (det > tint.DET_EPS) | geom.cull_disable[None]
    return (valid & (tt == t[:, None])).sum(dim=1) == 1


def _deep_chain(bvh: BVH, levels: int) -> BVH:
    """A BVH2 whose node i < ``levels`` has chain node i + 1 as child 0
    and a side node as child 1 (the last chain node a one-triangle leaf
    and a side node); each side node holds two one-triangle leaves; every
    box spans [-100, 100]^3.  A ray inside the boxes hits every child, so
    a shared-cursor packet pushes a side node at each chain node and a
    subpacket also pushes the last leaves: the stack need is ``levels`` +
    1 internal nodes on the deepest path."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    child = torch.full((2 * levels, 2), leaf, dtype=torch.int32)
    child[: levels - 1, 0] = torch.arange(1, levels, dtype=torch.int32)
    child[:levels, 1] = torch.arange(levels, 2 * levels, dtype=torch.int32)
    box = torch.tensor([-100.0] * 3 + [100.0] * 3).repeat(2)
    return BVH(nodes=box.repeat(2 * levels, 1), child_index=child, tris=bvh.tris,
               tri_flags=bvh.tri_flags, tri_order=bvh.tri_order)


class PacketKernelCases:
    """The cases of a packet kernel; a subclass names the port's module
    (``port``) and the JAX package's (``jax_mod``)."""

    port = None
    jax_mod = None

    @pytest.fixture(scope="class")
    def jax_runs(self):
        """JAX interpret-mode results, cached across the class's tests:
        each call of the JAX kernel costs seconds of tracing."""
        return {}

    def _jax(self, jax_runs, name, kind, rays, tag="main"):
        key = (name, kind, tag)
        if key not in jax_runs:
            jg, jb = _jax_tree(name)
            jrays = [jnp.asarray(x) for x in rays]
            if kind == "closest":
                got = self.jax_mod.intersect_closest(jg, jb, *jrays, cull_backface=True)
                jax_runs[key] = {f: np.asarray(x) for f, x in zip(got._fields, got)}
            else:
                jax_runs[key] = np.asarray(self.jax_mod.intersect_any(jg, jb, *jrays))
        return jax_runs[key]

    @pytest.mark.parametrize("name", ["soup_lbvh", "cornell"])
    def test_cpu_twin_matches_plain(self, name):
        """The kernel's own code (shared stack, leaf decoding, packet
        decisions) on the CPU, bit-equal to the plain version."""
        _, bvh, extent = _port_tree(name)
        o, d, tmin, tmax = _rays(1000, extent, seed=21)
        tmax[::5] = 0.0
        rays = _t((o, d, tmin, tmax))
        table = tw2.get_table2(bvh)
        for cull in (True, False):
            plain = self.port.closest_plain(table, *rays, cull_backface=cull)
            assert plain.is_hit.sum() > 20 and not plain.is_hit[::5].any()
            _assert_equal(self.port.closest_twin(table, *rays, cull_backface=cull), plain)
        assert torch.equal(self.port.any_twin(table, *rays), self.port.any_plain(table, *rays))

    @pytest.mark.parametrize("cull", [True, False])
    def test_plain_matches_port_brute_force(self, cull):
        geom, bvh, _ = _port_tree("soup_lbvh")
        rays = _t(_rays(300, 11.0, seed=4))
        got = self.port.intersect_closest(bvh, *rays, cull_backface=cull)
        want = tint.intersect_closest_brute(geom, *rays, cull_backface=cull)
        hit = want.is_hit
        assert torch.equal(got.is_hit, hit) and hit.sum() > 10
        for name in ("t", "u", "v", "backface"):
            assert torch.equal(getattr(got, name)[hit], getattr(want, name)[hit]), name
        single = hit & _single_winner(geom, rays, cull, want.t)
        assert single.sum() > 10
        assert torch.equal(got.tri[single], want.tri[single])
        assert torch.equal(self.port.intersect_any(bvh, *rays),
                           tint.intersect_any_brute(geom, *rays))

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_port_matches_jax_kernel(self, name, jax_runs):
        """One closest (culling on) and one any-hit call of the JAX kernel
        in interpret mode on the JAX package's tree."""
        _, bvh, extent = _port_tree(name)
        _, jb = _jax_tree(name)
        for field in ("nodes", "child_index", "tris"):
            assert torch.equal(getattr(bvh, field),
                               torch.from_numpy(np.array(getattr(jb, field)))), field
        o, d, tmin, tmax = _rays(300, extent, seed=4)
        tmax[::3] = 0.0
        want = self._jax(jax_runs, name, "closest", (o, d, tmin, tmax))
        got = self.port.intersect_closest(bvh, *_t((o, d, tmin, tmax)), cull_backface=True)
        hit = want["t"] < tint.BIG_T
        assert hit.sum() > 10 and not hit[::3].any()
        np.testing.assert_array_equal(got.is_hit.numpy(), hit)
        np.testing.assert_array_equal(got.tri.numpy()[hit], want["tri"][hit])
        np.testing.assert_array_equal(got.backface.numpy(), want["backface"])
        np.testing.assert_allclose(got.t.numpy()[hit], want["t"][hit], rtol=RTOL_T)
        for field in ("u", "v"):
            np.testing.assert_allclose(getattr(got, field).numpy()[hit], want[field][hit],
                                       rtol=0, atol=ATOL_UV, err_msg=field)
        want_any = self._jax(jax_runs, name, "any", (o, d, tmin, tmax))
        assert want_any.sum() > 10
        np.testing.assert_array_equal(
            self.port.intersect_any(bvh, *_t((o, d, tmin, tmax))).numpy(), want_any)

    def test_hit_at_t_max_is_not_committed(self, jax_runs):
        """t_max set to each ray's own closest t: the kernels test
        t < best with best starting at t_max, so nothing commits (the
        per-ray kernels commit such a hit).  One float further, every hit
        is back, with the same triangle."""
        _, bvh, extent = _port_tree("soup_lbvh")
        o, d, tmin, tmax = _rays(300, extent, seed=4)
        tmax[::3] = 0.0
        for side in ("jax", "port"):
            if side == "jax":
                first = self._jax(jax_runs, "soup_lbvh", "closest", (o, d, tmin, tmax))
            else:
                got = self.port.intersect_closest(bvh, *_t((o, d, tmin, tmax)))
                first = {f: x.numpy() for f, x in zip(got._fields, got)}
            hit = first["t"] < tint.BIG_T
            assert hit.sum() > 10
            at = np.where(hit, first["t"], 0.0).astype(np.float32)
            after = np.where(hit, np.nextafter(at, np.float32(np.inf)), 0.0).astype(np.float32)
            for bound, tag in ((at, "at"), (after, "after")):
                rays = (o, d, tmin, bound)
                if side == "jax":
                    closest = self._jax(jax_runs, "soup_lbvh", "closest", rays, tag)
                    blocked = self._jax(jax_runs, "soup_lbvh", "any", rays, tag)
                    closest_hit, tri = closest["t"] < tint.BIG_T, closest["tri"]
                else:
                    got = self.port.intersect_closest(bvh, *_t(rays))
                    blocked = self.port.intersect_any(bvh, *_t(rays)).numpy()
                    closest_hit, tri = got.is_hit.numpy(), got.tri.numpy()
                want = hit if tag == "after" else np.zeros_like(hit)
                np.testing.assert_array_equal(closest_hit, want, err_msg=f"{side} {tag}")
                np.testing.assert_array_equal(blocked, want, err_msg=f"{side} {tag} any")
                if tag == "after":
                    np.testing.assert_array_equal(tri[hit], first["tri"][hit])

    def test_stack_bound(self):
        """The deepest chain of interior nodes bounds the stack: a tree
        that needs STACK_DEPTH - 1 entries is walked to full depth (twin =
        plain version, every ray hits triangle 0); one that needs more than
        STACK_DEPTH is refused, never traversed with dropped entries."""
        _, bvh, _ = _port_tree("soup_lbvh")
        deep = _deep_chain(bvh, tw2.STACK_DEPTH)
        assert tw2.stack_need(deep) == tw2.STACK_DEPTH + 1
        with pytest.raises(ValueError, match="stack"):
            self.port.intersect_closest(deep, *_t(_rays(4, 1.0, seed=0)))

        chain = _deep_chain(bvh, tw2.STACK_DEPTH - 2)
        assert tw2.stack_need(chain) == tw2.STACK_DEPTH - 1
        table = tw2.build_table2(chain)
        v0, e1, e2 = table.tri[0, 0:3], table.tri[0, 3:6], table.tri[0, 6:9]
        target = (v0 + (e1 + e2) / 3.0).numpy()
        o, _, tmin, tmax = _rays(64, 11.0, seed=9)
        d = target - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rays = _t((o, d, tmin, tmax))
        for cull in (True, False):
            plain = self.port.closest_plain(table, *rays, cull_backface=cull)
            _assert_equal(self.port.closest_twin(table, *rays, cull_backface=cull), plain)
        plain = self.port.closest_plain(table, *rays, cull_backface=False)
        assert plain.is_hit.all() and (plain.tri == 0).all()
        assert torch.equal(self.port.any_twin(table, *rays), self.port.any_plain(table, *rays))
        assert self.port.any_plain(table, *rays).all()

    def test_cuda_rays_never_take_the_plain_path(self, monkeypatch):
        """CPU rays run the plain version; CUDA rays go to the kernel
        wrapper (here replaced by a recorder)."""
        _, bvh, _ = _port_tree("cornell")
        calls = []
        for fn in ("closest_cuda", "any_cuda", "closest_plain", "any_plain"):
            monkeypatch.setattr(self.port, fn, lambda *a, _fn=fn, **k: calls.append(_fn))

        class FakeCuda:
            device = torch.device("cuda", 0)

        self.port.intersect_closest(bvh, FakeCuda(), None, None, None)
        self.port.intersect_any(bvh, FakeCuda(), None, None, None)
        assert calls == ["closest_cuda", "any_cuda"]
        with pytest.raises(ValueError, match="meta"):
            self.port.intersect_any(bvh, torch.zeros((1, 3), device="meta"), None, None, None)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        _, bvh, _ = _port_tree("cornell")
        table = tw2.get_table2(bvh)
        with pytest.raises(ValueError, match="cuda"):
            self.port.closest_cuda(table, *_t(_rays(4, 1.0, seed=0)))
        with pytest.raises(ValueError, match="cuda"):
            self.port.any_cuda(table, *_t(_rays(4, 1.0, seed=0)))


class TestSharedCursor(PacketKernelCases):
    port = tpal
    jax_mod = jpal
