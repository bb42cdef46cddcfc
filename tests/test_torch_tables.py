"""The per-ray kernels' packed tables and what the kernels do with them,
through the CPU twins (the kernels' headers compiled by g++).

- ``Table8`` and ``Table2`` decode, bit for bit, to the BVH arrays they
  were packed from (``nodes8`` / ``child8`` / ``tri_perm8``; ``nodes`` /
  ``child_index`` / ``tris`` / ``tri_flags``), and packing leaves the BVH's
  own arrays as they were.
- The BVH8 child sort (a compare-exchange network in registers) orders as
  ``torch.sort(stable=True)`` does.
- Twin = plain version in every field over the packed tables for ray
  counts around a warp and a block, with no, all and scattered dead rays.
- A misaligned or non-contiguous table is refused.
- Chains that end below, at and above the shared-memory part of the
  kernels' stack are traversed alike by twin and plain version.
"""

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh, build_scene_bvh, encode_leaf
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.ops import traverse_wide8 as tw8
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_torch.scene.types import BVH

torch.set_num_threads(1)

# the kernels keep this many stack entries in shared memory
# (csrc/bvh8_traverse.cuh, csrc/bvh2_traverse.cuh: kFastStack)
FAST_STACK = 16


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def soup8():
    return build_scene_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu"),
                           builder="sah").bvh


@pytest.fixture(scope="module")
def soup2():
    return build_bvh(tproc.triangle_soup_scene(960, seed=3, device="cpu").geometry)[1]


def test_table8_decodes_to_the_bvh(soup8):
    bvh = soup8
    table = tw8.build_table8(bvh)
    m, t8 = bvh.nodes8.shape[0], bvh.tri_perm8.shape[0]
    assert table.node.shape == (m, 64) and table.tri.shape == (t8, 12)
    assert table.node.dtype == table.tri.dtype == torch.float32
    assert table.node.data_ptr() % 16 == 0 and table.tri.data_ptr() % 16 == 0
    assert torch.equal(_bits(table.boxes.reshape(m, 48)), _bits(bvh.nodes8))
    assert torch.equal(table.child, bvh.child8.to(torch.int32))
    assert torch.equal(_bits(table.node[:, 56:]), torch.zeros((m, 8), dtype=torch.int32))
    perm = bvh.tri_perm8.long()
    valid = perm >= 0
    assert valid.sum() == bvh.tris.shape[0] and (~valid).any()
    assert torch.equal(table.tri_meta[:, 1], bvh.tri_perm8.to(torch.int32))
    assert torch.equal(table.tri_meta[valid, 0], bvh.tri_flags[perm[valid]].to(torch.int32))
    assert not table.tri_meta[~valid, 0].any()
    src = bvh.tris[perm.clamp_min(0)]
    for lo, group in ((0, table.tri[:, 0:3]), (3, table.tri[:, 4:7]), (6, table.tri[:, 8:11])):
        assert torch.equal(_bits(group[valid]), _bits(src[valid, lo:lo + 3]))
        assert not _bits(group[~valid]).any()
    assert not _bits(table.tri[:, 11]).any()


def test_table2_decodes_to_the_bvh(soup2):
    bvh = soup2
    tris_before = bvh.tris.clone()
    table = tw2.build_table2(bvh)
    n, t = bvh.nodes.shape[0], bvh.tris.shape[0]
    assert table.node.shape == (n, 16) and table.tri.shape == (t, 12)
    assert table.node.data_ptr() % 16 == 0 and table.tri.data_ptr() % 16 == 0
    assert torch.equal(_bits(table.node[:, :12]), _bits(bvh.nodes))
    assert torch.equal(_bits(table.node[:, 12:14]), bvh.child_index.to(torch.int32))
    assert not _bits(table.node[:, 14:]).any()
    assert torch.equal(_bits(table.tri[:, :9]), _bits(bvh.tris[:, :9]))
    assert torch.equal(_bits(table.tri[:, 9]), bvh.tri_flags.to(torch.int32))
    assert not _bits(table.tri[:, 10:]).any()
    # the packet kernels' arrays are the BVH's own, and packing wrote into
    # a copy of the triangles, not into the BVH
    assert table.nodes.data_ptr() == bvh.nodes.data_ptr()
    assert table.child.data_ptr() == bvh.child_index.data_ptr()
    assert table.tri_flags.data_ptr() == bvh.tri_flags.data_ptr()
    assert torch.equal(_bits(bvh.tris), _bits(tris_before))
    assert table.records == (table.node, table.tri)
    assert table.arrays == (table.nodes, table.child, table.tri, table.tri_flags)


def _sort_case(name: str):
    gen = np.random.default_rng(17)
    n = 512
    if name == "all_equal":
        dist = np.full((n, 8), 2.5, np.float32)
    elif name == "all_missed":
        dist = np.full((n, 8), 3.0e38, np.float32)
    elif name == "duplicated":
        dist = gen.integers(0, 3, (n, 8)).astype(np.float32)
        dist[gen.random((n, 8)) < 0.3] = 3.0e38
    else:
        dist = gen.uniform(-5.0, 50.0, (n, 8)).astype(np.float32)
        dist[gen.random((n, 8)) < 0.4] = 3.0e38
    kid = gen.integers(-(2**27), 2**27, (n, 8)).astype(np.int32)
    return torch.from_numpy(dist), torch.from_numpy(kid)


@pytest.mark.parametrize("case", ["all_equal", "all_missed", "duplicated", "random"])
def test_sort_network_is_the_stable_sort(case):
    dist, kid = _sort_case(case)
    got_d, got_k = tw8.sort8_twin(dist, kid)
    want = torch.sort(dist, dim=1, stable=True)
    assert torch.equal(got_d, want.values)
    assert torch.equal(got_k, kid.gather(1, want.indices))


def test_sort_twin_refuses_other_shapes():
    with pytest.raises(ValueError, match="8"):
        tw8.sort8_twin(torch.zeros((4, 7)), torch.zeros((4, 7), dtype=torch.int32))


def _rays(n, dead, seed=5):
    gen = np.random.default_rng(seed)
    o = gen.uniform(-11.0, 11.0, (n, 3)).astype(np.float32)
    d = gen.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    t_min = np.zeros((n,), np.float32)
    t_max = np.full((n,), 1e3, np.float32)
    if dead == "all":
        t_max[:] = 0.0
        t_min[:] = 1.0
    elif dead == "scattered":
        t_max[gen.random(n) < 0.5] = -1.0
    return [torch.from_numpy(x) for x in (o, d, t_min, t_max)]


@pytest.mark.parametrize("dead", ["none", "all", "scattered"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 129, 1025])
@pytest.mark.parametrize("width", [8, 2])
def test_twin_matches_plain_at_odd_ray_counts(width, n, dead, soup8, soup2):
    tw, table = ((tw8, tw8.get_table8(soup8)) if width == 8
                 else (tw2, tw2.get_table2(soup2)))
    rays = _rays(n, dead)
    live = rays[2] <= rays[3]
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        for name, a, b in zip(plain._fields, twin, plain):
            assert a.shape == (n,) and torch.equal(a, b), name
        assert not plain.is_hit[~live].any()
    occluded = tw.any_plain(table, *rays)
    assert torch.equal(tw.any_twin(table, *rays), occluded)
    assert not occluded[~live].any()
    if dead == "none" and n >= 129:
        assert plain.is_hit.any() and occluded.any()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values 4 bytes off a 16-byte boundary."""
    buf = torch.empty((x.numel() + 5,), dtype=x.dtype)
    start = 1 + (-(buf.data_ptr() // 4) % 4)  # first 16-byte aligned element, plus one
    out = buf[start:start + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.parametrize("width", [8, 2])
def test_misaligned_or_strided_table_is_refused(width, soup8, soup2):
    tw, table = ((tw8, tw8.get_table8(soup8)) if width == 8
                 else (tw2, tw2.get_table2(soup2)))
    rays = _rays(4, "none")
    tw.closest_twin(table, *rays)  # the table as built is taken
    for field in ("node", "tri"):
        x = getattr(table, field)
        strided = torch.empty((x.shape[1], x.shape[0])).t()
        strided.copy_(x)
        for bad in (_misaligned(x), strided):
            broken = table._replace(**{field: bad})
            with pytest.raises(ValueError, match="aligned"):
                tw.closest_twin(broken, *rays)
            with pytest.raises(ValueError, match="aligned"):
                tw.any_twin(broken, *rays)


def _aimed_rays(table, width):
    """64 rays from all around toward the centroid of triangle record 0."""
    rec = table.tri[0]
    v0, e1, e2 = ((rec[0:3], rec[4:7], rec[8:11]) if width == 8
                  else (rec[0:3], rec[3:6], rec[6:9]))
    target = (v0 + (e1 + e2) / 3.0).numpy()
    o, _, t_min, t_max = [x.numpy() for x in _rays(64, "none", seed=9)]
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [torch.from_numpy(x) for x in (o, d.astype(np.float32), t_min, t_max)]


def _assert_twin_is_plain(tw, table, rays):
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        for name, a, b in zip(plain._fields, twin, plain):
            assert torch.equal(a, b), name
    assert plain.is_hit.all()
    assert torch.equal(tw.any_twin(table, *rays), tw.any_plain(table, *rays))


@pytest.mark.parametrize("levels", [FAST_STACK - 1, FAST_STACK, FAST_STACK + 1,
                                    tw2.STACK_DEPTH - 1])
def test_bvh2_chain_across_the_stack_split(levels, soup2):
    """A chain of ``levels`` internal nodes whose boxes every ray hits:
    the stack reaches ``levels`` entries, below, at and past the part the
    kernel keeps in shared memory."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    child = torch.full((levels, 2), leaf, dtype=torch.int32)
    child[:-1, 0] = torch.arange(1, levels, dtype=torch.int32)
    box = torch.tensor([-100.0] * 3 + [100.0] * 3).repeat(2)
    chain = BVH(nodes=box.repeat(levels, 1), child_index=child, tris=soup2.tris,
                tri_flags=soup2.tri_flags, tri_order=soup2.tri_order)
    assert tw2.stack_need(chain) == levels
    table = tw2.build_table2(chain)
    _assert_twin_is_plain(tw2, table, _aimed_rays(table, 2))


@pytest.mark.parametrize("levels", [2, 3, tw8.STACK_DEPTH // 7])
def test_bvh8_chain_across_the_stack_split(levels, soup8):
    """A chain of full BVH8 nodes whose boxes every ray hits pushes 7
    entries a level: 14 fit the shared-memory part of the stack, 21 and 91
    spill past it."""
    leaf = int(encode_leaf(torch.tensor(0), torch.tensor(1)))
    child8 = torch.full((levels, 8), leaf, dtype=torch.int32)
    child8[:-1, 0] = torch.arange(1, levels, dtype=torch.int32)
    box = torch.tensor([-100.0] * 3 + [100.0] * 3).repeat(8)
    chain = BVH(nodes=soup8.nodes, child_index=soup8.child_index, tris=soup8.tris,
                tri_flags=soup8.tri_flags, tri_order=soup8.tri_order,
                nodes8=box.repeat(levels, 1), child8=child8, tri_perm8=soup8.tri_perm8)
    assert (7 * levels > FAST_STACK) == (levels > 2)
    table = tw8.build_table8(chain)
    _assert_twin_is_plain(tw8, table, _aimed_rays(table, 8))
