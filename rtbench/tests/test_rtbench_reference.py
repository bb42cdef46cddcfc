"""The reference against brute force and against the program, at 64x36 on
the CPU (the program's kernels run their plain versions there)."""

import json
from pathlib import Path

import pytest
import torch

from rtbench import run, scenegen
from rtbench.reference import assets, bvh, render

ROOT = Path(run.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
# cells kept whole outside BENCHMARK.json (the hybrid one: its frame time
# follows the host too far for a bound), so each can come back as an entry
BENCH["workloads"] += json.loads((ROOT / "tests" / "kept_cells.json").read_text())
SMALL = {"workload": {"resolution": [64, 36], "warmup_frames": 1, "check": {"pixels": 512}},
         "config": {"scene": {"triangles": 4000},
                    "render": {"ibl": {"irradiance_size": 8, "reflection_size": 16,
                                       "brdf_lut_size": 16}}}}
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


def test_traversal_equals_brute_force(cache):
    glb, hdr = scenegen.scene_files(cache, "real", 4000, 7)
    scene = assets.load(glb, hdr, (0.3, -1.0, 0.2), (8.0, 7.5, 7.0), "cpu")
    g = scene.geometry
    tree = bvh.build(g.v0, g.e1, g.e2, g.double_sided)
    gen = torch.Generator().manual_seed(0)
    n = 3000
    o = torch.tensor([-16.0, 3.0, 0.0]) + torch.randn((n, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=1)
    t_min = torch.full((n,), 1e-3)
    t_max = torch.rand((n,), generator=gen) * 40.0
    t, u, v, det = bvh.moller_trumbore(o[:, None], d[:, None], g.v0[None], g.e1[None], g.e2[None])
    inside = (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= t_min[:, None]) & (t <= t_max[:, None])
    inside &= det.abs() > bvh.DET_EPS
    for cull in (True, False):
        ok = inside & ((det > bvh.DET_EPS) | g.double_sided[None]) if cull else inside
        tt = torch.where(ok, t, bvh.BIG_T)
        best_t, best_i = tt.min(dim=1)
        counts = {}
        hit = bvh.traverse(tree, o, d, t_min, t_max, cull, False, counts)
        assert torch.equal(hit.t, best_t)
        assert torch.equal(hit.tri[hit.is_hit], best_i[hit.is_hit])
        assert counts["box_tests"] > 0 and counts["tri_tests"] > 0
    blocked = bvh.traverse(tree, o, d, t_min, t_max, False, True)
    assert torch.equal(blocked.is_hit, inside.any(dim=1))
    assert 0 < int(blocked.is_hit.sum()) < n


def test_ibl_bake_equals_the_programs(cache):
    from vulkanraytracing_torch.env.ibl import bake_ibl
    from vulkanraytracing_torch.scene.types import make_environment

    _, hdr = scenegen.scene_files(cache, "real", 4000, 7)
    pano = torch.from_numpy(assets.read_hdr(hdr))
    ours = render.bake_ibl(pano, 8, 16, 16, lut_samples=4096)
    theirs = bake_ibl(make_environment(pano), 8, 16, 16)
    assert torch.equal(ours[0], theirs.irradiance)
    assert all(torch.equal(a, b) for a, b in zip(ours[1], theirs.reflection))
    assert torch.equal(ours[2], theirs.brdf_lut)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, cache):
    """A whole run of the cell at 64x36 on the CPU: the sampled pixels of
    the program's image equal the reference's."""
    result = run.run_cell(BENCH, cell, 7, 0.5, False, torch.device("cpu"), cache=cache,
                          overrides=SMALL)
    assert result["correct"] is True
    assert all(c["value"] == 0.0 for c in result["checks"].values()), result["checks"]
    assert result["attempted"] >= 1
