"""The plane ("Woop") leaf test of the port's BVH8 traversal (``VRT_WOOP=1``)
against the JAX package's, on the very BVH the JAX package built (carried
across with ``scene_from_numpy``).

- The plain version over plane records against JAX ``traverse_wide8``'s
  woop kernel (``_traverse_wide8_packed(..., woop=True)`` in interpret
  mode over ``_unified_table8(bvh, woop=True)``, as the JAX tests run it),
  on rays aimed at the soup's triangles: hit set, ``tri``, ``backface``
  and the any-hit verdicts equal; ``t`` within rtol 1e-5 (measured:
  5.8e-6).  ``u`` and ``v`` within 1e-5 plus what that t tolerance moves
  them by: 1e-5 * t * |up| (|vp| for v), the planes' gradients.  t comes
  from a cancelling sum (n.o + dn over n.d) and u, v from p = o + t d, so
  a t difference of a few ulps of the terms moves u and v by |up| times
  its length along the ray: measured 4.6e-5 in u and 9.6e-5 in v
  (t = 8.0, |vp| = 2.3), where 1e-5 alone would not hold.  The port's
  plain version on the JAX package's own plane records differs from the
  JAX kernel by the same amounts, so the kernel's arithmetic is the cause
  (XLA contracts its products into fused multiply-adds), not the records.
- The records themselves against JAX ``_woop_records``: within 1e-6 of
  each column's largest magnitude (measured 2.8e-7; 35% of the entries
  differ in the last bits, for the same reason).
- Against JAX brute force (Moller-Trumbore) at the JAX woop test's
  tolerances (t rtol 1e-4, atol 1e-5), culling on and off.
- The CPU twin (the CUDA kernel's header compiled by g++) against the
  plain version, bit for bit; ties, the inclusive t_max, degenerate
  triangles, the table cache, the dispatch and a small frame under the
  switch against the same frame without it, under ``chip_smoke.py``'s
  frame gate.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_traverse import _both, _j, _rays, _t, _tie_rays, _tie_scene

from vulkanraytracing_torch.accel.lbvh import build_scene_bvh as build_port_scene_bvh
from vulkanraytracing_torch.config import CameraConfig, Config
from vulkanraytracing_torch.ops import traverse_wide8 as tw
from vulkanraytracing_torch.pt.render import create_render_state, render_frame
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.procedural import sponza_like_scene
from vulkanraytracing_tpu.ops import intersect as jint
from vulkanraytracing_tpu.ops import traverse_wide8 as jw8
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene, triangle_soup_scene
from vulkanraytracing_tpu.scene.types import make_trace_geometry

torch.set_num_threads(1)

RTOL_T = 1e-5
ATOL_UV = 1e-5
RECORD_TOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _aimed(geometry, n, extent, seed):
    """Rays from random origins in the cube of half-width ``extent`` toward
    random points inside random triangles: nearly all hit something."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (np.asarray(getattr(geometry, k)) for k in ("v0", "e1", "e2"))
    k = rng.integers(0, v0.shape[0], n)
    w = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    target = v0[k] + w[:, 1:2] * e1[k] + w[:, 2:3] * e2[k]
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.zeros((n,), np.float32), np.full((n,), 1e3, np.float32)


@pytest.fixture(scope="module")
def soup():
    js, ts = _both(triangle_soup_scene(960, seed=3))
    return js, ts, _aimed(js.geometry, 300, 11.0, seed=4)


@pytest.fixture(scope="module")
def cornell():
    js, ts = _both(cornell_box_scene())
    return js, ts, _rays(300, 0.9, seed=7)


def _jax_woop(js, rays, any_hit: bool):
    """The JAX package's woop kernel in interpret mode (one call: 6-20 s
    on a CPU)."""
    bvh = jw8._with_bvh8(js.bvh)
    table, nr = jw8._unified_table8(bvh, woop=True)
    extra = dict(any_order=True, phase_split=True) if any_hit else {}
    return jw8._traverse_wide8_packed(
        table, nr, bvh.tris, *_j(rays), cull_backface=not any_hit, any_hit=any_hit,
        interpret=True, woop=True, **extra)


@pytest.fixture(scope="module")
def jax_closest(soup):
    js, _, rays = soup
    return _jax_woop(js, rays, any_hit=False)


@pytest.fixture(scope="module")
def jax_any(soup):
    js, _, rays = soup
    return np.asarray(_jax_woop(js, rays, any_hit=True).is_hit)


def _assert_same_hits(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy()[hit], np.asarray(want.tri)[hit])
    np.testing.assert_array_equal(got.backface.numpy(), np.asarray(want.backface))
    return hit


def test_woop_plain_closest_matches_jax_woop_kernel(soup, jax_closest):
    _, ts, rays = soup
    got = tw.closest_plain(tw.get_table8(ts.bvh, woop=True), *_t(rays), cull_backface=True)
    hit = _assert_same_hits(got, jax_closest)
    assert hit.sum() > 250
    t = got.t.numpy()[hit]
    np.testing.assert_allclose(t, np.asarray(jax_closest.t)[hit], rtol=RTOL_T, atol=0)
    planes = tw.woop_records(ts.bvh.tris).numpy()[got.tri.numpy()[hit]]
    for name, cols in (("u", slice(4, 7)), ("v", slice(8, 11))):
        a, b = getattr(got, name).numpy()[hit], np.asarray(getattr(jax_closest, name))[hit]
        allowed = ATOL_UV + RTOL_T * t * np.linalg.norm(planes[:, cols], axis=1)
        assert (np.abs(a - b) <= allowed).all(), (name, np.abs(a - b).max())


def test_woop_plain_any_matches_jax_woop_kernel(soup, jax_any):
    _, ts, rays = soup
    got = tw.any_plain(tw.get_table8(ts.bvh, woop=True), *_t(rays)).numpy()
    assert jax_any.sum() > 250
    np.testing.assert_array_equal(got, jax_any)


def test_woop_records_match_jax(soup):
    js, ts, _ = soup
    want = np.asarray(jw8._woop_records(js.bvh.tris))
    got = tw.woop_records(ts.bvh.tris).numpy()
    assert got.shape == want.shape == (960, 12)
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) <= RECORD_TOL * scale).all()


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("scene_name", ["soup", "cornell"])
def test_woop_plain_matches_jax_brute(scene_name, cull, request):
    js, ts, rays = request.getfixturevalue(scene_name)
    want = jint.intersect_closest_brute(js.geometry, *_j(rays), cull_backface=cull)
    got = tw.closest_plain(tw.get_table8(ts.bvh, woop=True), *_t(rays), cull_backface=cull)
    hit = _assert_same_hits(got, want)
    assert hit.sum() > 200
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-4, atol=1e-5)
    u, v = got.u.numpy()[hit], got.v.numpy()[hit]
    assert (u >= -1e-3).all() and (v >= -1e-3).all() and (u + v <= 1.0 + 1e-3).all()


@pytest.mark.parametrize("scene_name", ["soup", "cornell"])
def test_woop_twin_matches_plain(scene_name, request):
    """The kernel's own code over plane records on the CPU, bit-equal to
    the plain version in every field."""
    _, ts, _ = request.getfixturevalue(scene_name)
    extent = 11.0 if scene_name == "soup" else 0.9
    o, d, tmin, tmax = _rays(1000, extent, seed=21)
    tmax[::5] = 0.0
    rays = _t((o, d, tmin, tmax))
    table = tw.get_table8(ts.bvh, woop=True)
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        assert plain.is_hit.sum() > 20
        for name, a, b in zip(plain._fields, twin, plain):
            assert torch.equal(a, b), name
    assert torch.equal(tw.any_twin(table, *rays), tw.any_plain(table, *rays))


def test_woop_tie_breaks_to_lowest_id():
    """Coincident quads have identical plane records: equal-t ties go to
    the lowest triangle id, in the plain version and the twin."""
    js, ts = _both(_tie_scene())
    rays = _tie_rays(jitter=True)
    want = jint.intersect_closest_brute(js.geometry, *_j(rays), cull_backface=False)
    assert np.asarray(want.is_hit).all()
    table = tw.get_table8(ts.bvh, woop=True)
    for got in (tw.closest_plain(table, *_t(rays), cull_backface=False),
                tw.closest_twin(table, *_t(rays), cull_backface=False)):
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=RTOL_T)


def test_woop_tmax_boundary_inclusive():
    """A hit exactly at t_max (the plane test's own t) commits."""
    js, ts = _both(_tie_scene())
    o, d, tmin, tmax = _t(_tie_rays(jitter=False))
    table = tw.get_table8(ts.bvh, woop=True)
    probe = tw.closest_plain(table, o, d, tmin, tmax, cull_backface=False)
    assert probe.is_hit.all()
    want = jint.intersect_closest_brute(js.geometry, *_j(_tie_rays(jitter=False)),
                                        cull_backface=False)
    for got in (tw.closest_plain(table, o, d, tmin, probe.t, cull_backface=False),
                tw.closest_twin(table, o, d, tmin, probe.t, cull_backface=False)):
        assert got.is_hit.all()
        assert torch.equal(got.t, probe.t)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))


def test_woop_degenerate_triangle_never_hit():
    """A triangle with a zero edge and one with collinear edges get zero
    planes (n.d = 0 rejects every ray): rays through them go on to the
    quad below."""
    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0],   # the quad
                      [0, 0, 1], [0, 0, 1], [0.5, 0.5, 1],             # e1 = 0
                      [-0.5, 0, 0.5], [0, 0, 0.5], [0.5, 0, 0.5]],     # e2 = 2 e1
                     np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    geom = make_trace_geometry(verts, idx, cull_disable=True)
    js, ts = _both(cornell_box_scene()._replace(geometry=geom, point_lights=None))
    order = np.asarray(js.bvh.tri_order)
    degenerate = np.flatnonzero(order >= 2)  # their BVH-order ids
    records = tw.woop_records(ts.bvh.tris).numpy()
    assert (records[degenerate] == 0.0).all()
    n = 64
    s = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    target = np.concatenate([np.array([0, 0, 1], np.float32) + s * [0.5, 0.5, 0],
                             np.array([-0.5, 0, 0.5], np.float32) + s * [1.0, 0, 0]])
    o = np.tile(np.array([[0.1, 0.2, 3.0]], np.float32), (2 * n, 1))
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    rays = _t((o, d, np.zeros(2 * n, np.float32), np.full(2 * n, 1e3, np.float32)))
    table = tw.get_table8(ts.bvh, woop=True)
    for cull in (True, False):
        for got in (tw.closest_plain(table, *rays, cull_backface=cull),
                    tw.closest_twin(table, *rays, cull_backface=cull)):
            assert got.is_hit.all()
            assert not np.isin(got.tri.numpy(), degenerate).any()


def test_table_cache_never_mixes_variants(soup):
    """Each leaf test has its own cached table; the opaque view drops both."""
    _, ts, _ = soup
    bvh = dataclasses.replace(ts.bvh, table8=None, table8_woop=None, table2=None)
    woop = tw.get_table8(bvh, woop=True)
    mt = tw.get_table8(bvh)
    assert woop.woop and tuple(woop.tri.shape[1:]) == (16,)
    assert not mt.woop and tuple(mt.tri.shape[1:]) == (12,)
    assert tw.get_table8(bvh) is mt and tw.get_table8(bvh, woop=True) is woop
    assert torch.equal(woop.node.view(torch.int32), mt.node.view(torch.int32))
    assert torch.equal(woop.tri_meta, mt.tri_meta)
    view = bvh.opaque_view()
    assert view.table8 is None and view.table8_woop is None and view.table2 is None
    assert tw.get_table8(view, woop=True) is not woop and tw.get_table8(view) is not mt
    assert view.table8_woop.woop and not view.table8.woop


def test_switch_routes_every_call_and_cuda_rays_never_take_the_plain_path(soup,
                                                                         monkeypatch):
    """Under the switch CPU rays run the plain version over the plane
    table and CUDA rays go to the kernel wrappers (here recorders) with
    it; without it, the Moller-Trumbore table."""
    _, ts, _ = soup
    calls = []

    def recorder(what):
        return lambda table, *a, **k: calls.append((what, table.woop))

    for name in ("closest_cuda", "any_cuda", "closest_plain", "any_plain"):
        monkeypatch.setattr(tw, name, recorder(name))

    class FakeCuda:
        device = torch.device("cuda", 0)

    cpu = _t(_rays(4, 1.0, seed=0))
    for woop in (True, False):
        monkeypatch.setattr(tw, "WOOP_DEFAULT", woop)
        tw.intersect_closest(ts.bvh, FakeCuda(), None, None, None)
        tw.intersect_any(ts.bvh, FakeCuda(), None, None, None)
        tw.intersect_closest(ts.bvh, *cpu)
        tw.intersect_any(ts.bvh, *cpu)
        assert calls == [("closest_cuda", woop), ("any_cuda", woop),
                         ("closest_plain", woop), ("any_plain", woop)]
        calls.clear()


def _frame_gate():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.frame_gate


def test_frame_under_switch_within_frame_gate(monkeypatch):
    """A 128x72 frame of the real workload (37,036 triangles, 160 cutouts)
    with the switch on against the same frame with it off, under
    ``chip_smoke.py``'s frame gate (rays within 0.1%, at most 0.1% of the
    pixels more than 1/255 apart; measured: the same rays, 11 pixels
    differ, none by 1/255).  Every BVH8 call of the switched frame, over
    the opaque view and the cutout subset, takes the plane table."""
    scene = build_port_scene_bvh(sponza_like_scene(4000, workload="real", device="cpu"),
                                 builder="sah")
    cfg = Config(width=128, height=72, camera=CameraConfig(
        position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=128 / 72))
    camera = Camera(cfg.camera).to_device("cpu")
    frames = {}
    for woop in (False, True):
        tables = []
        for name in ("closest_plain", "any_plain"):
            original = getattr(tw, name)

            def recording(table, *a, _original=original, _name=name, **k):
                tables.append((_name, table.woop))
                return _original(table, *a, **k)

            monkeypatch.setattr(tw, name, recording)
        monkeypatch.setattr(tw, "WOOP_DEFAULT", woop)
        state, stats = render_frame(scene, cfg, camera, create_render_state(cfg, "cpu"))
        frames[woop] = (state.accumulation, int(stats.rays))
        assert {name for name, _ in tables} == {"closest_plain", "any_plain"}
        assert all(used == woop for _, used in tables)
        monkeypatch.undo()
    alpha = scene.alpha
    assert alpha.opaque_bvh.table8_woop is not None and alpha.bvh.table8_woop is not None
    _frame_gate()("real 128x72 VRT_WOOP=1", *frames[True], *frames[False], label="[test]")
