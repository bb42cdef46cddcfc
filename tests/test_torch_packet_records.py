"""The packet kernels' mapping onto the card, held on the CPU through their
twins (``csrc/subpacket_twin.cpp``, ``csrc/shared_twin.cpp``: the kernels'
own header compiled by g++, a thread carrying several rays, a packet served
by one or several warps).

- Twin = plain version bit for bit at ray counts around the packet sizes
  (1 / 127 / 128 / 129 / 1023 / 1025 / 4097) with no, all and scattered
  dead rays, for both kernels, closest hit with culling on and off and
  any-hit.
- One step's vote (order-preserving integer keys merged per warp, then
  over the warps' slots) and the decision taken from it equal
  ``subpacket_next`` / ``shared_next`` on the whole packet's ``fminf``
  minima: random distances, equal entry distances, -0.0 against +0.0, a
  child that one ray alone hits (so no warp's vote may be dropped), and no
  hit at all.
- The same twins built with other numbers of rays a thread (packets of 4,
  2 and 1 warps; blocks of 32, 16 and 4 warps) still equal the plain
  versions.
- The packed records are read with 16-byte loads: a misaligned or strided
  ``node`` or ``tri`` is refused.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh
from vulkanraytracing_torch.ops import packet_lockstep
from vulkanraytracing_torch.ops import traverse_pallas as tpal
from vulkanraytracing_torch.ops import traverse_subpacket as tsub
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.tools.traverse_sweep import variant_sources

torch.set_num_threads(1)

KERNELS = {"subpacket": tsub, "shared": tpal}
BIG = np.float32(3.0e38)
DEPTH = tw2.STACK_DEPTH


@functools.cache
def _table():
    _, bvh = build_bvh(tproc.triangle_soup_scene(480, seed=3, device="cpu").geometry)
    return tw2.get_table2(bvh)


def _rays(n, dead, seed=11):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-11.0, 11.0, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e3, np.float32)
    if dead == "all":
        t_max[:] = -1.0
    elif dead == "scattered":
        t_max[rng.random(n) < 0.3] = 0.0
    return [torch.from_numpy(x) for x in (o, d, np.zeros((n,), np.float32), t_max)]


def _results(module, table, rays, twin):
    """Closest hit with culling on and off and the any-hit verdicts."""
    closest = module.closest_twin if twin else module.closest_plain
    blocked = module.any_twin if twin else module.any_plain
    return (*closest(table, *rays, cull_backface=True),
            *closest(table, *rays, cull_backface=False), blocked(table, *rays))


@pytest.mark.parametrize("dead", ["none", "all", "scattered"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1023, 1025, 4097])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_twin_matches_plain_around_the_packet_sizes(name, n, dead):
    module, table, rays = KERNELS[name], _table(), _rays(n, dead)
    got = _results(module, table, rays, twin=True)
    want = _results(module, table, rays, twin=False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (n,) and torch.equal(a, b), i
    hits = int((want[0] < float(BIG)).sum())
    assert hits == 0 if dead == "all" else hits > 0 or n < 127


def _stack(seed):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(rng.integers(1, 1 << 20, DEPTH), np.int32), 5


def _lane_values(case, lanes, seed):
    """Per-ray entry distances of both children (BIG = the ray misses)."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(-2.0, 50.0, lanes).astype(np.float32)
    t1 = rng.uniform(-2.0, 50.0, lanes).astype(np.float32)
    t0[rng.random(lanes) < 0.5] = BIG
    t1[rng.random(lanes) < 0.5] = BIG
    if case == "equal":
        t1 = t0.copy()
        t1[-1] = t0[t0 < BIG].min()
        t0[0] = t1[-1]
    elif case == "zeros":
        t0 = np.where(rng.random(lanes) < 0.5, np.float32(0.0), np.float32(-0.0))
        t1 = np.where(rng.random(lanes) < 0.5, np.float32(-0.0), np.float32(0.0))
        t0, t1 = t0.astype(np.float32), t1.astype(np.float32)
    elif case == "no_hit":
        t0[:], t1[:] = BIG, BIG
    elif case == "only_child_1":
        t0[:] = BIG
    elif case == "one_ray":  # a child hit by one ray alone: the last, the first, a middle one
        a, b = ((lanes - 1, 0), (0, lanes // 2), (lanes // 2, lanes - 1))[seed % 3]
        near, far = t0[a], t1[b]
        t0[:], t1[:] = BIG, BIG
        t0[a], t1[b] = abs(near) % 40.0, abs(far) % 40.0
    elif case == "negative":
        t0, t1 = -t0, -t1
        t0[t0 == -BIG], t1[t1 == -BIG] = BIG, BIG
    return np.ascontiguousarray(t0), np.ascontiguousarray(t1)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


STEP_CASES = ["random", "equal", "zeros", "no_hit", "only_child_1", "one_ray", "negative"]
LEAF_A, LEAF_B = ~((3 << 4) | 2), ~((8 << 4) | 1)
CHILDREN = {"nodes": (7, 9), "leaf_node": (LEAF_A, 9), "leaves": (LEAF_A, LEAF_B)}


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", STEP_CASES)
def test_subpacket_vote_and_decision_match_subpacket_next(case, any_hit):
    lib = tsub.twin_library()
    for seed, (c0, c1) in enumerate(CHILDREN.values()):
        t0, t1 = _lane_values(case, tsub.LANE, seed)
        stack_in, sp_in = _stack(seed)
        got_stack, got_sp = stack_in.copy(), ctypes.c_int(sp_in)
        got = lib.vrt_subpacket_decide_cpu(int(any_hit), _ptr(t0), _ptr(t1), c0, c1,
                                           _ptr(got_stack), ctypes.byref(got_sp))
        m0, m1 = t0.min(), t1.min()
        want_stack, want_sp = stack_in.copy(), ctypes.c_int(sp_in)
        want = lib.vrt_subpacket_next_cpu(int(any_hit), int(m0 < BIG), int(m1 < BIG),
                                          float(m0), float(m1), c0, c1, _ptr(want_stack),
                                          ctypes.byref(want_sp))
        assert got == want and got_sp.value == want_sp.value, case
        np.testing.assert_array_equal(got_stack, want_stack)
        if case == "no_hit":
            assert want == stack_in[sp_in - 1] and want_sp.value == sp_in - 1
        if case in ("equal", "zeros") and not any_hit:
            assert want == c0 and want_stack[sp_in] == c1  # child 0 on equal distances


@pytest.mark.parametrize("case", STEP_CASES)
def test_shared_vote_and_decision_match_shared_next(case):
    lib = tpal.twin_library()
    for seed, (c0, c1) in enumerate(CHILDREN.values()):
        t0, t1 = _lane_values(case, tpal.LANE, seed)
        hit0, hit1 = np.ascontiguousarray(t0 < BIG), np.ascontiguousarray(t1 < BIG)
        # a ray that misses carries any entry distance: it must not count
        rng = np.random.default_rng(seed)
        tn0 = np.where(hit0, t0, rng.uniform(-9, 9, t0.shape)).astype(np.float32)
        tn1 = np.where(hit1, t1, rng.uniform(-9, 9, t1.shape)).astype(np.float32)
        stack_in, sp_in = _stack(seed)
        got_stack, got_sp = stack_in.copy(), ctypes.c_int(sp_in)
        got = lib.vrt_shared_decide_cpu(_ptr(hit0), _ptr(hit1), _ptr(tn0), _ptr(tn1), c0, c1,
                                        _ptr(got_stack), ctypes.byref(got_sp))
        want_stack, want_sp = stack_in.copy(), ctypes.c_int(sp_in)
        want = lib.vrt_shared_next_cpu(int(hit0.any()), int(hit1.any()), float(t0.min()),
                                       float(t1.min()), c0, c1, _ptr(want_stack),
                                       ctypes.byref(want_sp))
        assert got == want and got_sp.value == want_sp.value, case
        np.testing.assert_array_equal(got_stack, want_stack)
        if case in ("equal", "zeros") and c0 >= 0 and c1 >= 0:
            assert want == c0 and want_stack[sp_in] == c1
        if c0 < 0 and c1 < 0:  # leaf children were tested in the step: pop
            assert want == stack_in[sp_in - 1]


VARIANTS = {
    "four_warps_a_packet": {"kRaysPerLane": 1, "kRaysPerThread": 1},
    "two_warps_a_packet": {"kRaysPerLane": 2, "kRaysPerThread": 2},
    "eight_rays_a_thread": {"kRaysPerThread": 8},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_twins_of_other_layouts_match_plain(variant):
    """The constants a sweep varies: rays a thread (so warps a packet)."""
    src = variant_sources(VARIANTS[variant])
    table, rays = _table(), _rays(1500, "scattered", seed=5)
    for name, module in KERNELS.items():
        lib = packet_lockstep.twin_library(name, {}, src)
        for cull in (True, False, None):
            got = packet_lockstep.run_twin(lib, name, table, *rays, cull)
            want = ((module.any_plain(table, *rays),) if cull is None
                    else tuple(module.closest_plain(table, *rays, cull_backface=cull)))
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, cull)


def _misplaced(x, how):
    if how == "misaligned":  # the same rows, 4 bytes off a 16-byte boundary
        flat = torch.zeros(x.numel() + 4, dtype=x.dtype)
        shifted = flat[1: 1 + x.numel()].view(x.shape)
        if shifted.data_ptr() % 16 == 0:
            shifted = flat[2: 2 + x.numel()].view(x.shape)
        shifted.copy_(x)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        return shifted
    wide = torch.zeros((x.shape[0], x.shape[1] + 4), dtype=x.dtype)
    wide[:, : x.shape[1]] = x
    return wide[:, : x.shape[1]]  # strided rows


@pytest.mark.parametrize("how", ["misaligned", "strided"])
@pytest.mark.parametrize("field", ["node", "tri"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_misplaced_records_are_refused(name, field, how):
    module, table, rays = KERNELS[name], _table(), _rays(8, "none")
    bad = table._replace(**{field: _misplaced(getattr(table, field), how)})
    with pytest.raises(ValueError, match="16-byte aligned"):
        module.closest_twin(bad, *rays)
    with pytest.raises(ValueError, match="16-byte aligned"):
        module.any_twin(bad, *rays)


def test_records_of_another_width_are_refused():
    table, rays = _table(), _rays(8, "none")
    bad = table._replace(node=table.nodes)  # (N, 12): the BVH's own boxes
    with pytest.raises(ValueError, match=r"\(N, 16\)"):
        tsub.closest_twin(bad, *rays)
    with pytest.raises(ValueError, match=r"\(N, 16\)"):
        tpal.any_twin(bad, *rays)
