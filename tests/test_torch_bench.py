"""The port's bench entry point (``vulkanraytracing_torch.bench``) on the CPU.

The bench runs in subprocesses at ``VRT_BENCH_SMALL=1`` with 4,000
triangles requested and 2 frames, ``--device cpu``, each with its own .glb
directory and one thread; the runs that need no cached .glb start together.
They check the one-line JSON report against the JAX bench's keys, the
per-frame lines, ``--devices 2``, the partial JSON on SIGTERM and on a
watchdog, the refusal of ``--device cuda`` without a card, and the .glb
cache.  The bench's case is then held against the JAX package's own steps
(``bench.py``'s scene, .glb export, load and SAH build, rebuilt here):
equal geometry and one equal frame.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.bench import bench_case
from vulkanraytracing_torch.pt.render import create_render_state, render_frame

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "mean", "median", "frames",
        "time_to_1024spp_s", "workload", "device"}
SMALL = {"VRT_BENCH_SMALL": "1", "VRT_BENCH_TRIS": "4000", "VRT_BENCH_FRAMES": "2",
         "OMP_NUM_THREADS": "1"}
TIMEOUT = 240

# the JAX package's bench case (bench.py's steps) and one frame through its
# plain BVH backend, in a process whose XLA:CPU code has no fused
# multiply-add: XLA contracts a * b + c where the port rounds each operation,
# which moves a few grazing bounce rays of the loaded scene (3 of 6,912
# channels at 64x36); without the contraction the two are one program
JAX_CASE = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from vulkanraytracing_tpu.accel import build_scene_bvh
    from vulkanraytracing_tpu.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_tpu.pt.render import create_render_state, render_frame
    from vulkanraytracing_tpu.scene.camera import Camera
    from vulkanraytracing_tpu.scene.gltf import load_scene
    from vulkanraytracing_tpu.scene.gltf_export import export_scene_glb
    from vulkanraytracing_tpu.scene.procedural import sponza_like_scene

    tris, width, height, glb, out = sys.argv[1:]
    tris, width, height = int(tris), int(width), int(height)
    cfg = Config(width=width, height=height, ray_chunk_size=1 << 22,
                 traversal=TraversalMode.BVH,
                 camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                     aspect_ratio=width / height))
    scene = sponza_like_scene(target_triangles=tris, workload="v1")
    export_scene_glb(scene, glb)
    loaded, _cam, _pool = load_scene(glb)
    scene = loaded._replace(environment=scene.environment, direct_light=scene.direct_light)
    scene = build_scene_bvh(scene, builder="sah")
    state, stats = render_frame(scene, cfg, Camera(cfg.camera).to_device(),
                                create_render_state(cfg))
    g = scene.geometry
    np.savez(out, image=np.asarray(state.accumulation), rays=float(stats.rays),
             **{f: np.asarray(getattr(g, f)) for f in g._fields})
""")
JAX_SIZE = (20000, 64, 36)


def _start(glb_dir, *args, module="vulkanraytracing_torch bench", **env):
    return subprocess.Popen(
        [sys.executable, "-m", *module.split(), *args], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, **SMALL, "VRT_BENCH_GLB_DIR": str(glb_dir), **env})


def _finish(proc) -> tuple[int, list[str], str]:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out.splitlines(), err


class Runs:
    """Bench subprocesses started at once, each read when first asked for."""

    def __init__(self, procs: dict, dirs: dict, jax_out: Path):
        self.procs, self.dirs, self.jax_out, self.done = procs, dirs, jax_out, {}

    def __getitem__(self, name):
        if name not in self.done:
            self.done[name] = _finish(self.procs[name])
        return self.done[name]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = {name: tmp_path_factory.mktemp(name) for name in
         ("one", "two", "noloader", "watchdog", "cuda", "jax")}
    jax_out = d["jax"] / "case.npz"
    procs = {
        "one": _start(d["one"], "--device", "cpu"),
        "two": _start(d["two"], "--devices", "2", "--device", "cpu"),
        "noloader": _start(d["noloader"], "--device", "cpu",
                           module="vulkanraytracing_torch.bench", VRT_BENCH_NO_LOADER="1"),
        "watchdog": _start(d["watchdog"], "--device", "cpu", VRT_BENCH_NO_LOADER="1",
                           VRT_BENCH_FRAME_S="0.001"),
        "cuda": _start(d["cuda"]),
        "jax": subprocess.Popen(
            [sys.executable, "-c", JAX_CASE, *map(str, JAX_SIZE), str(d["jax"] / "case.glb"),
             str(jax_out)], cwd=ROOT, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env={**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
                 "XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2"}),
    }
    runs = Runs(procs, d, jax_out)
    yield runs
    runs.close()


def _report(lines: list[str]) -> dict:
    assert lines, "no stdout"
    return json.loads(lines[-1])


def _frames(err: str) -> list[tuple[int, float, float]]:
    """(rays, Mrays/s, ms) of each ``frame i:`` line on stderr."""
    out = []
    for line in err.splitlines():
        if line.startswith("frame "):
            parts = line.split()
            out.append((int(parts[4]), float(parts[6]), float(parts[2])))
    return out


def test_report_has_the_bench_keys(runs):
    rc, out, err = runs["one"]
    assert rc == 0, err
    report = _report(out)
    assert set(report) == KEYS
    assert report["metric"] == "Mrays/s/chip" and report["unit"] == "Mrays/s"
    assert report["workload"] == "v1" and report["device"] == "cpu" and report["frames"] == 2
    frames = _frames(err)
    assert len(frames) == 2
    assert report["value"] == max(m for _, m, _ in frames)
    # both are rounded from the same best frame (to 3 and 4 decimals)
    assert report["vs_baseline"] == pytest.approx(report["value"] / 100.0, abs=6e-5)
    assert report["median"] == pytest.approx(np.median([m for _, m, _ in frames]), abs=2e-3)
    # the best frame's rate at the last frame's rays, times 1024
    best_rays, _, best_ms = max(frames, key=lambda f: f[0] / f[2])
    t1024 = frames[-1][0] / best_rays * best_ms * 1e-3 * 1024.0
    assert report["time_to_1024spp_s"] == pytest.approx(t1024, rel=1e-3)
    assert "bvh8 launches over the 2 measured frames: closest 0, any 0" in err


def test_two_devices_report_the_same_rays(runs):
    rc, out, err = runs["two"]
    assert rc == 0, err
    report = _report(out)
    assert set(report) == KEYS | {"devices"} and report["devices"] == 2
    assert "2 used" in err
    one = [r for r, _, _ in _frames(runs["one"][2])]
    assert [r for r, _, _ in _frames(err)] == one and len(one) == 2


def test_sigterm_flushes_a_partial_report(runs):
    assert runs["one"][0] == 0
    proc = _start(runs.dirs["one"], "--device", "cpu", VRT_BENCH_FRAMES="50")
    try:
        for line in proc.stderr:
            if line.startswith("frame 0:"):
                proc.send_signal(signal.SIGTERM)
                break
        rc, out, _ = _finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 2
    report = _report(out)
    assert report["partial"] is True and report["frames"] >= 1
    assert report["stage"] == "measurement" and report["value"] is not None
    assert f"signal {int(signal.SIGTERM)}" in report["error"]


def test_watchdog_ends_an_overrunning_frame(runs):
    rc, out, err = runs["watchdog"]
    assert rc == 3, err
    report = _report(out)
    assert report["partial"] is True and report["stage"] == "measurement"
    assert "watchdog" in report["error"] and "frame 0" in report["error"]


def test_no_card_refuses_the_default_device(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default --device cuda would run")
    rc, out, err = runs["cuda"]
    assert rc != 0
    assert "--device cpu" in err
    report = _report(out)
    assert report["partial"] is True and report["stage"] == "device_discovery"
    assert "--device cpu" in report["error"]
    assert not list(runs.dirs["cuda"].iterdir())


def test_second_run_reuses_the_cached_glb(runs):
    rc, _, err = runs["one"]
    assert rc == 0 and "scene: written and loaded" in err
    glb = runs.dirs["one"] / "sponza_like_4000.glb"
    assert sorted(p.name for p in runs.dirs["one"].iterdir()) == [glb.name]
    stamp = glb.stat().st_mtime_ns
    rc, out, err = _finish(_start(runs.dirs["one"], "--device", "cpu", VRT_BENCH_FRAMES="1"))
    assert rc == 0, err
    assert f"scene: loaded {glb}" in err and "written" not in err
    assert glb.stat().st_mtime_ns == stamp and _report(out)["frames"] == 1


def test_no_loader_skips_the_glb(runs):
    rc, out, err = runs["noloader"]
    assert rc == 0, err
    assert "scene:" not in err and not list(runs.dirs["noloader"].iterdir())
    assert set(_report(out)) == KEYS


def test_bench_case_matches_jax(runs, tmp_path):
    tris, width, height = JAX_SIZE
    scene, cfg, camera = bench_case(width, height, tris, "v1", True, "cpu", tmp_path)
    state, stats = render_frame(scene, cfg, camera, create_render_state(cfg, "cpu"))
    rc, _, err = runs["jax"]
    assert rc == 0, err
    want = np.load(runs.jax_out)
    for field in scene.geometry._fields:
        np.testing.assert_array_equal(getattr(scene.geometry, field).numpy(),
                                      want[field], err_msg=field)
    got = state.accumulation.numpy()
    assert got.shape == (height, width, 3) and np.isfinite(got).all() and got.mean() > 0.05
    close = np.abs(got - want["image"]) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.999, f"{close.mean():.5f} of channels within 1/255"
    assert int(stats.rays) == int(want["rays"])
