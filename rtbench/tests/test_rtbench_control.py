"""The check has to fail what is wrong (CPU, 64x36): the control (the
reference in bfloat16, put in the program's place) and the faults a cell
can have, planted in the program under a whole run."""

import json
import time
from pathlib import Path

import pytest
import torch

from rtbench import run

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


def _run(cell: str, cache) -> dict:
    return run.run_cell(BENCH, cell, 7, 0.5, False, torch.device("cpu"), cache=cache,
                        overrides=SMALL)


def _limits(cell: str) -> dict:
    return json.loads((ROOT / "workloads" / f"{cell}.json").read_text())["check"]["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, cache):
    """The reference at bfloat16 against the reference, over the pixels
    and frames of a small run, fails at least one compared number."""
    r = run.Run(*run.load_cell(BENCH, cell, overrides=SMALL), 7)
    r.device = torch.device("cpu")
    r.files = run.scene_files(r, cache)
    n = 64 * 36
    px, py = torch.arange(n) % 64, torch.arange(n) // 64
    ref = run.reference_pixels(r, px, py, 12, r.device, low=False)
    low = run.reference_pixels(r, px, py, 12, r.device, low=True)
    checks = run.compare(low, ref, _limits(cell))
    assert any(v > lim for v, lim in checks.values()), checks
    assert all(v == 0.0 for v, _ in run.compare(ref, ref, _limits(cell)).values())


def _unchanged(monkeypatch):
    """Each frame hands back the state it was given (hybrid: the cleared
    image the reset left), taking a frame's time."""
    from vulkanraytracing_torch.app import engine
    from vulkanraytracing_torch.pt.integrator import TraceStats

    def render_frame(scene, cfg, camera, state):
        time.sleep(0.1)
        return state, TraceStats(rays=torch.zeros((), dtype=torch.int64))

    def render_hybrid(scene, cfg, camera):
        time.sleep(0.1)
        return torch.zeros((cfg.height, cfg.width, 3))

    monkeypatch.setattr(engine, "render_frame", render_frame)
    monkeypatch.setattr(engine, "render_hybrid", render_hybrid)


def _half(monkeypatch):
    """Half of each frame's rays left out: every other lane never traced."""
    from vulkanraytracing_torch.hybrid import renderer
    from vulkanraytracing_torch.pt import render

    trace = render.pathtrace

    def pathtrace(*a, valid=None, **k):
        keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
        return trace(*a, valid=valid & keep, **k)

    coords = renderer.tile_pixel_coords

    def tile_pixel_coords(*a, **k):
        px, py, valid, ty, tx = coords(*a, **k)
        return px, py, valid & (torch.arange(valid.shape[0]) % 2 == 0), ty, tx

    monkeypatch.setattr(render, "pathtrace", pathtrace)
    monkeypatch.setattr(renderer, "tile_pixel_coords", tile_pixel_coords)


def _altered(monkeypatch):
    """Every 16th colour changed by 0.05 where it is produced."""
    from vulkanraytracing_torch.app import engine
    from vulkanraytracing_torch.pt import render

    trace = render.pathtrace

    def pathtrace(*a, **k):
        color, stats = trace(*a, **k)
        color = color.clone()
        color[::16] += 0.05
        return color, stats

    hybrid = engine.render_hybrid

    def render_hybrid(*a, **k):
        image = hybrid(*a, **k).clone()
        image.view(-1, 3)[::16] += 0.05
        return image

    monkeypatch.setattr(render, "pathtrace", pathtrace)
    monkeypatch.setattr(engine, "render_hybrid", render_hybrid)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, cache, monkeypatch):
    fault(monkeypatch)
    result = _run(cell, cache)
    assert result["correct"] is False, result["checks"]
