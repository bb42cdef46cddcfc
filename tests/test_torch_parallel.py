"""Multi-device rendering (``parallel``) on host shards: a mesh of
``["cpu"] * n`` runs its shards one after the other, as the JAX package's
virtual CPU devices stand in for a pod.

- Row-sharded frames equal the single-device frames bit for bit, image
  and ray count, over 2 accumulated frames; 40 rows over 4 shards gives
  10-row shards that are not whole 16-row tiles, so ``row0`` and the tile
  padding are exercised.  A height that does not divide raises.
- The sample-parallel step equals the mean of the ``n`` single-device
  samples at indices ``a * n + k``, folded in as ``n`` samples, with and
  without ``parity_quantization``; and over 2 steps it matches the JAX
  package's ``shard_render_frame_samples`` on a 2-device host mesh (run in
  a subprocess, as ``tests/test_sharding.py`` runs its meshes) at the
  repo's gate, its quantized images on the same 1/255 grid.
- ``Engine(mesh=...)`` draws the frames ``Engine()`` draws, static and
  animated (refitted every moving frame).
- ``--device cpu --devices 4`` writes the PNG ``--devices 1`` writes; a
  height that does not divide, or more cards than exist, exit with an
  error.
- The port's sharded frame against the JAX package's single-device
  ``render_frame`` (brute force, its oracle) at the repo's gate: 99% of
  channels within 1/255, rays within 0.5%.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
from vulkanraytracing_torch.app import cli
from vulkanraytracing_torch.app.engine import Engine
from vulkanraytracing_torch.app.image_io import read_png
from vulkanraytracing_torch.config import CameraConfig, Config
from vulkanraytracing_torch.parallel import (
    make_render_mesh,
    replicate_scene,
    shard_render_frame,
    shard_render_frame_samples,
)
from vulkanraytracing_torch.pt.render import (
    accumulate,
    create_render_state,
    render_frame,
    trace_rows,
)
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_torch.scene.procedural import animated_instances_demo, cornell_box_scene
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh as j_build
from vulkanraytracing_tpu.config import CameraConfig as JCameraConfig
from vulkanraytracing_tpu.config import Config as JConfig
from vulkanraytracing_tpu.config import TraversalMode as JMode
from vulkanraytracing_tpu.pt.render import create_render_state as j_state
from vulkanraytracing_tpu.pt.render import render_frame as j_render
from vulkanraytracing_tpu.scene.camera import Camera as JCamera
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene as j_cornell

torch.set_num_threads(1)

CORNELL = dict(position=(0.0, 0.0, 3.2), x_fov=float(np.radians(60)))


def _setup(width=24, height=40, **cfg_kw):
    cfg = Config(width=width, height=height, max_bounce_count=2,
                 camera=CameraConfig(**CORNELL, aspect_ratio=width / height), **cfg_kw)
    scene = build_scene_bvh(cornell_box_scene(device="cpu"), builder="sah")
    return scene, cfg, Camera(cfg.camera).to_device("cpu")


def test_make_render_mesh():
    mesh = make_render_mesh(["cpu"] * 3)
    assert mesh == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_render_mesh()
    with pytest.raises(ValueError):
        make_render_mesh([])


def test_replicate_scene_one_copy_per_device():
    scene, _, _ = _setup()
    copies = replicate_scene(scene, make_render_mesh(["cpu"] * 4))
    assert list(copies) == [torch.device("cpu")]
    assert copies[torch.device("cpu")] is scene  # its cached tables stay


def test_row_sharded_frames_equal_single_device():
    scene, cfg, camera = _setup()
    mesh = make_render_mesh(["cpu"] * 4)
    replicas = replicate_scene(scene, mesh)
    single, sharded = create_render_state(cfg, "cpu"), create_render_state(cfg, "cpu")
    for _ in range(2):
        single, s_stats = render_frame(scene, cfg, camera, single)
        sharded, m_stats = shard_render_frame(replicas, cfg, camera, sharded, mesh)
        assert torch.equal(single.accumulation, sharded.accumulation)
        assert int(s_stats.rays) == int(m_stats.rays) > 0
        assert m_stats.rays.dtype == torch.int64
    assert sharded.accum_index == 2 and float(sharded.accumulation.mean()) > 0.05


def test_height_must_divide():
    scene, cfg, camera = _setup(height=30)
    mesh = make_render_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="divide"):
        shard_render_frame(replicate_scene(scene, mesh), cfg, camera,
                           create_render_state(cfg, "cpu"), mesh)


@pytest.mark.parametrize("quantize", [True, False])
def test_sample_parallel_is_the_mean_of_the_shards_samples(quantize):
    scene, cfg, camera = _setup(width=16, height=16, parity_quantization=quantize)
    n = 2
    mesh = make_render_mesh(["cpu"] * n)
    replicas = replicate_scene(scene, mesh)
    state = create_render_state(cfg, "cpu")
    want = state.accumulation
    for a in range(2):
        state, stats = shard_render_frame_samples(replicas, cfg, camera, state, mesh)
        samples = [trace_rows(scene, cfg, camera, a * n + k, "cpu") for k in range(n)]
        mean = (samples[0][0] + samples[1][0]) / n
        want = accumulate(mean * n, want, float(a * n), float(n), cfg)
        assert torch.equal(state.accumulation, want)
        assert int(stats.rays) == sum(int(r) for _, r in samples)
    assert state.accum_index == 2
    # the shards' samples are the frames' own: index 1 is render_frame's
    # second frame
    value, _ = trace_rows(scene, cfg, camera, 1, "cpu")
    frame, _ = render_frame(scene, cfg.replace(parity_quantization=False), camera,
                            create_render_state(cfg, "cpu")._replace(accum_index=1))
    assert torch.allclose(frame.accumulation * 2.0, value, atol=1e-6)


@pytest.mark.parametrize("animated", [False, True])
def test_engine_mesh_draws_the_single_device_frames(animated):
    if animated:
        scene, soup, anim = animated_instances_demo(orbiters=3, device="cpu")
        cfg = Config(width=16, height=16, max_bounce_count=2, camera=CameraConfig(
            position=(0.0, 4.0, 10.0), target=(0.0, 1.0, 0.0), aspect_ratio=1.0))
        kw = dict(instances=soup, animation=anim)
    else:
        scene, cfg, _ = _setup(width=16, height=16)
        kw = {}
    engines = [Engine(cfg, scene, device="cpu", **kw),
               Engine(cfg, scene, mesh=["cpu"] * 4, device="cpu", **kw)]
    for _ in range(3):
        for eng in engines:
            eng.draw()
        a, b = (eng.state for eng in engines)
        assert torch.equal(a.accumulation, b.accumulation) and a.accum_index == b.accum_index
    assert engines[0].total_rays == engines[1].total_rays > 0


def test_engine_mesh_must_start_at_its_device():
    scene, cfg, _ = _setup(width=16, height=16)
    with pytest.raises(ValueError, match="first device"):
        Engine(cfg, scene, mesh=["cuda:0", "cpu"], device="cpu")


def _render_cli(tmp_path, devices, height=16):
    out = tmp_path / f"d{devices}.png"
    rc = cli.main(["render", "--scene", "cornell", "--out", str(out), "--spp", "2",
                   "--width", "16", "--height", str(height), "--device", "cpu",
                   "--devices", str(devices)])
    return rc, out


def test_cli_devices_png_equals_one_device(tmp_path):
    rc1, one = _render_cli(tmp_path, 1)
    rc4, four = _render_cli(tmp_path, 4)
    assert rc1 == rc4 == 0
    np.testing.assert_array_equal(read_png(four), read_png(one))


def test_cli_devices_errors(tmp_path):
    with pytest.raises(SystemExit, match="divisible"):
        _render_cli(tmp_path, 3)
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit, match="available"):
        cli.main(["render", "--scene", "cornell", "--width", "16", "--height", "16",
                  "--devices", str(have + 2), "--out", str(tmp_path / "x.png")])


def test_sharded_frame_matches_jax():
    size = 32
    js = j_build(j_cornell(), builder="sah")
    ts = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jcfg = JConfig(width=size, height=size, traversal=JMode.BRUTE_FORCE,
                   camera=JCameraConfig(**CORNELL, aspect_ratio=1.0))
    tcfg = Config(width=size, height=size, camera=CameraConfig(**CORNELL, aspect_ratio=1.0))
    jcam, tcam = JCamera(jcfg.camera).to_device(), Camera(tcfg.camera).to_device("cpu")
    mesh = make_render_mesh(["cpu"] * 4)
    jst, tst, want_rays, rays = j_state(jcfg), create_render_state(tcfg, "cpu"), 0.0, 0
    for _ in range(2):
        jst, jstats = j_render(js, jcfg, jcam, jst)
        tst, tstats = shard_render_frame(replicate_scene(ts, mesh), tcfg, tcam, tst, mesh)
        want_rays += float(jstats.rays)
        rays += int(tstats.rays)
    got, want = tst.accumulation.numpy(), np.asarray(jst.accumulation)
    assert got.shape == want.shape and np.isfinite(got).all() and got.mean() > 0.05
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of channels within 1/255"
    assert abs(rays - want_rays) <= 0.005 * want_rays, (rays, want_rays)


# The JAX package's sample-parallel step needs a mesh of several devices;
# it runs in its own process, as tests/test_sharding.py runs its meshes, so
# its shard_map compiles stay out of this process's JAX state.
_JAX_SAMPLES = """
import os, sys
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
import numpy as np
from vulkanraytracing_tpu.accel.lbvh import build_scene_bvh
from vulkanraytracing_tpu.config import CameraConfig, Config, TraversalMode
from vulkanraytracing_tpu.parallel import (
    make_render_mesh, replicate_scene, shard_render_frame_samples)
from vulkanraytracing_tpu.pt.render import create_render_state
from vulkanraytracing_tpu.scene.camera import Camera
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene

size, steps, fov, out = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3]), sys.argv[4]
mesh = make_render_mesh(jax.devices()[:2])
replicas = replicate_scene(build_scene_bvh(cornell_box_scene(), builder="sah"), mesh)
got = {}
for quantize in (True, False):
    cfg = Config(width=size, height=size, traversal=TraversalMode.BRUTE_FORCE,
                 parity_quantization=quantize, camera=CameraConfig(
                     position=(0.0, 0.0, 3.2), x_fov=fov, aspect_ratio=1.0))
    camera, state = Camera(cfg.camera).to_device(), create_render_state(cfg)
    for a in range(steps):
        state, stats = shard_render_frame_samples(replicas, cfg, camera, state, mesh)
        got[f"image_{quantize}_{a}"] = np.asarray(state.accumulation)
        got[f"rays_{quantize}_{a}"] = np.float64(stats.rays)
np.savez(out, **got)
"""
SAMPLE_SIZE, SAMPLE_STEPS = 32, 2


@pytest.fixture(scope="module")
def jax_sample_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_samples") / "steps.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_SAMPLES, str(SAMPLE_SIZE),
                        str(SAMPLE_STEPS), repr(CORNELL["x_fov"]), str(out)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("quantize", [True, False])
def test_sample_parallel_matches_jax(quantize, jax_sample_steps):
    js = j_build(j_cornell(), builder="sah")
    scene = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    cfg = Config(width=SAMPLE_SIZE, height=SAMPLE_SIZE, parity_quantization=quantize,
                 camera=CameraConfig(**CORNELL, aspect_ratio=1.0))
    camera = Camera(cfg.camera).to_device("cpu")
    mesh = make_render_mesh(["cpu"] * 2)
    replicas = replicate_scene(scene, mesh)
    state = create_render_state(cfg, "cpu")
    for a in range(SAMPLE_STEPS):
        state, stats = shard_render_frame_samples(replicas, cfg, camera, state, mesh)
        got = state.accumulation.numpy()
        want = jax_sample_steps[f"image_{quantize}_{a}"]
        want_rays = float(jax_sample_steps[f"rays_{quantize}_{a}"])
        assert got.shape == want.shape and np.isfinite(got).all() and got.mean() > 0.05
        close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
        assert close.mean() >= 0.99, f"step {a}: {close.mean():.4f} of channels within 1/255"
        assert abs(int(stats.rays) - want_rays) <= 0.005 * want_rays, (int(stats.rays), want_rays)
        on_grid = np.abs(got * 255.0 - np.round(got * 255.0)) <= 1e-3
        assert on_grid.all() == quantize
