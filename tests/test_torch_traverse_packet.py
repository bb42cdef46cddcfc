"""The port's packet backend (``ops.traverse_packet``, ``TraversalMode.BVH``)
and the trace-backend switch.

The packet backend is plain code in both packages (XLA in JAX, torch
here): 256-lane packets, a 48-entry stack, the inclusive window
``t_min <= t <= best`` and lowest-id ties.  Against the port's brute force
it must agree bit for bit (the same Moller-Trumbore code, the same rules);
against the JAX package's ``traverse_packet`` hits, triangle ids and
any-hit verdicts must be equal, t within rtol 1e-5 and u, v within atol
1e-5 (XLA:CPU contracts ``a*b - c*d`` into fused multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse2 import _chain, _rays, _t, _tie_bvh, _tie_rays
from vulkanraytracing_torch.accel.lbvh import build_bvh, build_scene_bvh
from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import trace
from vulkanraytracing_torch.ops import traverse_packet as tpk
from vulkanraytracing_torch.ops import traverse_pallas as tpal
from vulkanraytracing_torch.ops import traverse_subpacket as tsub
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_tpu.accel import lbvh as jl
from vulkanraytracing_tpu.ops import traverse_packet as jpk
from vulkanraytracing_tpu.scene import procedural as jproc

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5


@pytest.fixture(scope="module")
def soup():
    return build_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu").geometry)


@pytest.mark.parametrize("cull", [True, False])
def test_packet_matches_port_brute_force(soup, cull):
    geom, bvh = soup
    o, d, tmin, tmax = _rays(600, 11.0, seed=4)
    tmax[::4] = 0.0
    rays = _t((o, d, tmin, tmax))
    got = tpk.intersect_closest_packet(bvh, *rays, cull_backface=cull)
    want = tint.intersect_closest_brute(geom, *rays, cull_backface=cull)
    hit = want.is_hit
    assert torch.equal(got.is_hit, hit) and hit.sum() > 10
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a[hit], b[hit]), name
    assert torch.equal(tpk.intersect_any_packet(bvh, *rays),
                       tint.intersect_any_brute(geom, *rays))


def test_packet_matches_jax_traverse_packet():
    """One closest (culling on) and one any-hit call of the JAX package's
    packet backend on the JAX LBVH, 300 rays, every third one dead."""
    jg, jb = jl.build_bvh(jproc.triangle_soup_scene(960, seed=3).geometry)
    _, tb = build_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu").geometry)
    assert torch.equal(tb.child_index, torch.from_numpy(np.array(jb.child_index)))
    o, d, tmin, tmax = _rays(300, 11.0, seed=4)
    tmax[::3] = 0.0
    jrays = [jnp.asarray(x) for x in (o, d, tmin, tmax)]

    want = jpk.intersect_closest_packet(jg, jb, *jrays, cull_backface=True)
    got = tpk.intersect_closest_packet(tb, *_t((o, d, tmin, tmax)), cull_backface=True)
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
    want_any = np.asarray(jpk.intersect_any_packet(jg, jb, *jrays))
    assert want_any.sum() > 10
    np.testing.assert_array_equal(
        tpk.intersect_any_packet(tb, *_t((o, d, tmin, tmax))).numpy(), want_any)


def test_closest_tie_breaks_to_lowest_id():
    geom, bvh = _tie_bvh()
    rays = _t(_tie_rays(jitter=True))
    want = tint.intersect_closest_brute(geom, *rays, cull_backface=False)
    got = tpk.intersect_closest_packet(bvh, *rays, cull_backface=False)
    assert want.is_hit.all()
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.t, want.t)


def test_closest_tmax_boundary_inclusive():
    """A hit exactly at t_max commits in the packet backend (as in the
    per-ray kernels, and unlike the packet kernels)."""
    geom, bvh = _tie_bvh()
    o, d, tmin, tmax = _t(_tie_rays(jitter=False))
    probe = tint.intersect_closest_brute(geom, o, d, tmin, tmax, cull_backface=False)
    rays = (o, d, tmin, probe.t)
    got = tpk.intersect_closest_packet(bvh, *rays, cull_backface=False)
    assert got.is_hit.all()
    assert torch.equal(got.tri, probe.tri)
    assert tpk.intersect_any_packet(bvh, *rays).all()
    # the packet kernels' window is exclusive: no hit commits there
    table = tw2.get_table2(bvh)
    assert not tpal.closest_plain(table, *rays, cull_backface=False).is_hit.any()
    assert not tsub.any_plain(table, *rays).any()


def test_packet_stack_bound(soup):
    """A tree whose traversal needs more than the 48-entry stack is
    refused (the JAX code would drop the push and skip a subtree)."""
    _, bvh = soup
    deep = _chain(bvh, tpk.STACK_DEPTH + 1)
    with pytest.raises(ValueError, match="stack"):
        tpk.intersect_closest_packet(deep, *_t(_rays(4, 1.0, seed=0)))
    ok = _chain(bvh, tpk.STACK_DEPTH)
    v0, e1, e2 = ok.tris[0, 0:3], ok.tris[0, 3:6], ok.tris[0, 6:9]
    target = (v0 + (e1 + e2) / 3.0).numpy()
    o, _, tmin, tmax = _rays(64, 11.0, seed=9)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tpk.intersect_closest_packet(ok, *_t((o, d, tmin, tmax)), cull_backface=False)
    assert got.is_hit.all() and (got.tri == 0).all()


MODES = {
    TraversalMode.BVH: (tpk, "intersect_closest_packet", "intersect_any_packet"),
    TraversalMode.BVH_SUBPACKET: (tsub, "intersect_closest", "intersect_any"),
    TraversalMode.BVH_SHARED: (tpal, "intersect_closest", "intersect_any"),
}


@pytest.mark.parametrize("mode", list(MODES), ids=lambda m: m.name)
def test_trace_dispatches_each_mode(mode, monkeypatch):
    """Each mode reaches its own backend on SAH (8-wide collapse kept
    beside the 2-wide arrays) and LBVH trees alike; a scene without a BVH
    is traced by brute force in every mode, as in the JAX package."""
    module, closest, blocked = MODES[mode]
    calls = []
    monkeypatch.setattr(module, closest, lambda *a, **k: calls.append("closest"))
    monkeypatch.setattr(module, blocked, lambda *a, **k: calls.append("any"))
    cfg = Config(traversal=mode)
    sah = build_scene_bvh(tproc.cornell_box_scene(device="cpu"), builder="sah")
    geom, bvh2 = build_bvh(sah.geometry)
    assert sah.bvh.nodes8 is not None
    for scene in (sah, sah._replace(geometry=geom, bvh=bvh2)):
        trace.trace_closest(scene, cfg, None, None, None, None)
        trace.trace_any(scene, cfg, None, None, None, None)
    assert calls == ["closest", "any"] * 2

    flat = sah._replace(bvh=None)
    rays = _t(_rays(50, 0.9, seed=1))
    want = tint.intersect_closest_brute(flat.geometry, *rays)
    got = trace.trace_closest(flat, cfg, *rays)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert calls == ["closest", "any"] * 2
