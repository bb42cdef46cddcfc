"""A moving configuration through the harness (CPU, 64x36): the v1 hall at
40,000 triangles asked (the smallest that holds materials 3 and 4) with 4
orbiting spheres, built here and not kept as a file under ``configs/``.
Three frames: two warm-up frames and one measured frame, each moving.  The
check (``px_off`` at every pixel) follows the motion and passes the
program; the control and three faults planted in the program fail it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import control, motion, run, scenegen

ROOT = Path(run.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
CELL = "v1-pt-1080p"
INSTANCES = {"mesh": {"radius": 1.5, "lat": 8, "lon": 16}, "count": 4, "materials": [3, 4],
             "orbit": {"radius": 4.0, "height": 2.0, "bob": 0.5, "period_frames": 8,
                       "phase_spacing_turns": 0.25}}
MOVING = {"workload": {"resolution": [64, 36], "warmup_frames": 2,
                       "check": {"pixels": 64 * 36, "limits": {"mean_off": None}}},
          "config": {"scene": {"triangles": 40000, "instances": INSTANCES}}}
SEED = 7


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


def _run(cache) -> dict:
    return run.run_cell(BENCH, CELL, SEED, 0.0, False, torch.device("cpu"), cache=cache,
                        overrides=MOVING)


def test_the_animation_is_a_function_of_the_frame():
    anim = motion.animation(INSTANCES)
    a, b = anim(3), anim(3 + INSTANCES["orbit"]["period_frames"])
    assert a.shape == (5, 4, 4) and a.dtype == np.float32
    assert np.allclose(a, b, atol=1e-6) and np.array_equal(anim(3), a)
    assert np.array_equal(a[0], np.eye(4, dtype=np.float32))
    assert np.array_equal(a[:, :3, :3], np.broadcast_to(np.eye(3), (5, 3, 3)))
    assert not np.array_equal(anim(4), a)
    # a quarter turn apart: instance 2 sits where instance 1 was two frames before
    assert np.allclose(anim(2)[1, :3, 3], anim(0)[2, :3, 3], atol=1e-6)
    assert motion.materials(INSTANCES) == [3, 4, 3, 4]


def test_the_mesh_file_is_the_sphere(cache):
    from vulkanraytracing_torch.scene.gltf import load_scene

    path = scenegen.mesh_file(cache, INSTANCES["mesh"])
    assert scenegen.mesh_file(cache, INSTANCES["mesh"]) == path
    scene, _, _ = load_scene(path, device="cpu")
    g = scene.geometry
    assert g.num_triangles == 2 * 8 * 16 and scene.point_lights is None
    assert not bool(g.cull_disable.any()) and bool(g.opaque.all())
    corners = torch.cat([g.v0, g.v0 + g.e1, g.v0 + g.e2])
    assert torch.allclose(corners.norm(dim=-1), torch.tensor(1.5), atol=1e-5)


def test_accumulated_frames_follow_the_harness_count():
    static = run.Run({}, {}, {"scene": {}}, 1)
    static.draws, static.reset_at = 9, 2
    assert static.accumulated() == (8, 7)
    moving = run.Run({}, {}, {"scene": {"instances": INSTANCES}}, 1)
    moving.draws, moving.reset_at = 9, 2
    assert moving.accumulated() == (8, 1)
    still = dict(INSTANCES, orbit=dict(INSTANCES["orbit"], radius=0.0, bob=0.0))
    resting = run.Run({}, {}, {"scene": {"instances": still}}, 1)
    resting.draws, resting.reset_at = 9, 2
    assert resting.accumulated() == (8, 7)


def test_a_moving_configuration_is_correct(cache):
    result = _run(cache)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == 1


def test_the_control_fails_the_limits(cache):
    """The reference in bfloat16 against the reference, at every pixel of
    the run's last frame (animation index 2, one frame since the scene
    moved)."""
    device = torch.device("cpu")
    got = control.readings(BENCH, CELL, SEED, 1, device, frame=2, overrides=MOVING,
                           cache=cache)
    assert any(c["value"] > c["limit"] for c in got["control"].values()), got


def _refit_late(monkeypatch):
    """Each refit at the transforms of the frame before: last frame's
    geometry."""
    from vulkanraytracing_torch.accel import tlas

    refit, seen = tlas.refit_tlas, []

    def refit_tlas(bvh, soup, transforms):
        seen.append(transforms)
        return refit(bvh, soup, seen[-2] if len(seen) > 1 else transforms)

    monkeypatch.setattr(tlas, "refit_tlas", refit_tlas)


def _index_ahead(monkeypatch):
    """The program reads the animation one frame ahead."""
    from vulkanraytracing_torch.app import engine

    init = engine.Engine.__init__

    def __init__(self, *a, animation=None, **k):
        init(self, *a, animation=lambda i: animation(i + 1), **k)

    monkeypatch.setattr(engine.Engine, "__init__", __init__)


def _no_reset(monkeypatch):
    """A moved scene keeps accumulating: the reset is left out of the
    animation step (the R key still resets), and one more frame is drawn
    after the R key so that two frames accumulate."""
    from vulkanraytracing_torch.app import engine

    advance, reset = engine.Engine._advance_animation, engine.reset_accumulation

    def _advance_animation(self):
        engine.reset_accumulation = lambda state: state
        try:
            advance(self)
        finally:
            engine.reset_accumulation = reset

    set_up = run.set_up

    def set_up_and_draw(r, device):
        eng = set_up(r, device)
        run.draw(r, eng, device)
        return eng

    monkeypatch.setattr(engine.Engine, "_advance_animation", _advance_animation)
    monkeypatch.setattr(run, "set_up", set_up_and_draw)


@pytest.mark.parametrize("fault", [_refit_late, _index_ahead, _no_reset])
def test_a_program_that_misses_the_motion_is_not_correct(fault, cache, monkeypatch):
    fault(monkeypatch)
    result = _run(cache)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("change, refused", [
    ({"config": {"scene": {"instances": dict(INSTANCES, spin=1.0)}}}, "instances.spin"),
    ({"config": {"scene": {"instances": dict(INSTANCES, orbit={"tilt": 1})}}},
     "instances.orbit.tilt"),
    ({"workload": {"mode": "hybrid"}, "config": {"scene": {"instances": INSTANCES}}},
     "hybrid"),
    ({"config": {"scene": {"instances": INSTANCES}}}, "mean_off under motion"),
])
def test_a_moving_setting_the_harness_ignores_is_refused(change, refused):
    with pytest.raises(ValueError, match="does not implement") as err:
        run.load_cell(BENCH, CELL, overrides=change)
    assert refused in str(err.value)
