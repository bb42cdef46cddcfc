"""The port's evidence tools (``vulkanraytracing_torch/tools``) on the CPU.

Each tool runs in its small mode, with ``--device cpu``, in a subprocess
writing into a temporary directory, and once more without ``--device``;
all start together when the module's first test starts.  Checked: each exits with 0, its report has
the JAX tool's keys plus ``device`` ("cpu") and the BVH8 launches, and its
gates pass (the parity tool's Cornell box at RMSE 0.0, the hybrid frame
on the "device" against the CPU frame); the aniso report's three RMSEs are
within 2% of the JAX package's ``artifacts/aniso/report.json`` (also
computed on a CPU), and the aniso renders at a reduced size equal the JAX
package's ``render_hybrid`` of the same scene at the repo's gates (the
baked IBL within 1e-5, 99.9% of the image channels within 1/255).  The
JAX side renders through brute force with 1 and 4 taps: at 16 taps its
unrolled tap loop takes 90 s to compile here; the port's taps are one
loop, and the aniso report holds its 16-tap frames.  Without a card, each
tool refuses to run unless asked for the CPU.  No tool imports JAX
(``tests/test_torch_package.py`` scans every module of the port).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.tools import measure_aniso

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600  # alone the slowest (parity) takes about 30 s

# tool -> (extra environment, arguments before --device).  The parity
# tool's brute-force oracle takes the host's threads, which wait passively:
# spinning OpenMP threads on a host busy with the other test workers slow
# it down several times over; the others, whose small tensors gain little from
# threads, take one each
ONE = {"OMP_NUM_THREADS": "1"}
RUNS = {
    "parity_artifact": ({"VRT_PARITY_SMALL": "1", "OMP_WAIT_POLICY": "PASSIVE"}, []),
    "measure_t1024": ({"VRT_T1024_TRIS": "4000", **ONE}, ["32", "4"]),
    "hybrid_artifact": ({"VRT_HYBRID_SMALL": "1", **ONE}, []),
    "measure_aniso": (ONE, []),
}
REPORTS = {"parity_artifact": "report_smoke.json", "measure_t1024": "t1024.json",
           "hybrid_artifact": "report_smoke.json", "measure_aniso": "report.json"}


class Run:
    """One tool's subprocess, its output files and its report."""

    def __init__(self, tool: str, base: Path, on_cpu: bool = True) -> None:
        env, argv = RUNS[tool] if on_cpu else ({}, [])
        name = tool if on_cpu else f"{tool}_no_device"
        self.out_dir = base / name
        self.out_dir.mkdir(parents=True)
        self.stdout = open(base / f"{name}.out", "w+")
        self.stderr = open(base / f"{name}.err", "w+")
        self.report_path = self.out_dir / REPORTS[tool]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"vulkanraytracing_torch.tools.{tool}", *argv,
             *(["--device", "cpu"] if on_cpu else []), "--out-dir", str(self.out_dir)],
            cwd=ROOT, env={**os.environ, **env}, stdout=self.stdout, stderr=self.stderr)

    def output(self) -> tuple[int, str, str]:
        rc = self.proc.wait(timeout=TIMEOUT_S)
        self.stdout.seek(0)
        self.stderr.seek(0)
        return rc, self.stdout.read(), self.stderr.read()

    def result(self) -> tuple[str, dict]:
        rc, out, err = self.output()
        assert rc == 0, err[-3000:]
        report = json.loads(self.report_path.read_text())
        assert report == json.loads(out.splitlines()[-1])
        return err, report

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.stdout.close()
        self.stderr.close()


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every tool on the CPU, and every tool without ``--device``, all
    started at once."""
    base = tmp_path_factory.mktemp("tools")
    started = {}
    try:
        for tool in RUNS:
            started[tool] = Run(tool, base)
            if not torch.cuda.is_available():
                started[f"{tool}_no_device"] = Run(tool, base, on_cpu=False)
        yield started
    finally:
        for run in started.values():
            run.close()


# -- the aniso frames against the JAX package (runs while the tools do) ----

W, H = 64, 36


@pytest.fixture(scope="module")
def aniso_scenes():
    """The grazing plane built and baked by the port's tool and by the JAX
    package (as the root tool builds it)."""
    from vulkanraytracing_tpu.accel import build_scene_bvh
    from vulkanraytracing_tpu.env.ibl import bake_ibl
    from vulkanraytracing_tpu.ops.texture import WRAP_REPEAT, build_texture_pool
    from vulkanraytracing_tpu.scene.types import (
        Scene, constant_environment, make_materials, make_trace_geometry, no_direct_light,
    )

    s = 40.0
    positions = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uvs = np.array([[0, 0], [24, 0], [24, 24], [0, 24]], np.float32)
    c = np.indices((64, 64)).sum(axis=0) // 8 % 2
    img = np.zeros((64, 64, 4), np.uint8)
    img[..., :3] = np.where(c[..., None] > 0, 230, 25)
    img[..., 3] = 255
    js = build_scene_bvh(Scene(
        geometry=make_trace_geometry(positions, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                                     uvs=uvs, cull_disable=True, opaque=True),
        materials=make_materials(base_color_factors=[(1.0, 1.0, 1.0, 1.0)],
                                 roughness_factors=[1.0], metallic_factors=[0.0],
                                 base_color_textures=[0]),
        environment=constant_environment((1.0, 1.0, 1.0)), direct_light=no_direct_light(),
        point_lights=None, bvh=None,
        textures=build_texture_pool([img], [(WRAP_REPEAT, WRAP_REPEAT)])))
    js = js._replace(environment=bake_ibl(js.environment, **measure_aniso.IBL))
    return js, measure_aniso.grazing_plane_scene("cpu")


def test_aniso_scene_matches_jax(aniso_scenes):
    js, ts = aniso_scenes
    for name in ("texels", "offset", "width", "height", "wrap_s", "wrap_t"):
        np.testing.assert_array_equal(getattr(ts.textures, name).numpy(),
                                      np.asarray(getattr(js.textures, name)), err_msg=name)
    jg = jax.tree.map(np.asarray, js.geometry)
    tg = ts.geometry
    order = np.argsort(np.asarray(js.bvh.tri_order))
    t_order = np.argsort(ts.bvh.tri_order.numpy())
    for name in ("v0", "e1", "e2", "uv0", "uv1", "uv2"):
        np.testing.assert_allclose(getattr(tg, name).numpy()[t_order],
                                   getattr(jg, name)[order], rtol=0, atol=1e-5, err_msg=name)
    env_j, env_t = js.environment, ts.environment
    np.testing.assert_allclose(env_t.irradiance.numpy(), np.asarray(env_j.irradiance),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(env_t.reflection, env_j.reflection, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(env_t.brdf_lut.numpy(), np.asarray(env_j.brdf_lut),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("taps", [1, 4])
def test_aniso_render_matches_jax(aniso_scenes, taps):
    from vulkanraytracing_tpu.config import Config, TraversalMode
    from vulkanraytracing_tpu.hybrid.renderer import render_hybrid
    from vulkanraytracing_tpu.scene.camera import Camera

    js, ts = aniso_scenes
    cam = measure_aniso.camera_config(W, H)
    cfg = Config(width=W, height=H, traversal=TraversalMode.BRUTE_FORCE, camera=cam,
                 hybrid_aniso_taps=taps, parity_quantization=False)
    want = np.asarray(render_hybrid(js, cfg, Camera(cam).to_device()))
    got = measure_aniso.render_taps(ts, taps, W, H, "cpu")
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    close = np.abs(got - want) <= 1.0 / 255.0 + 1e-6
    assert close.mean() >= 0.999, f"{close.mean():.5f} of channels within 1/255"
    assert got.mean() > 0.3  # the lit plane fills the lower half


# -- each tool's run -----------------------------------------------------

def test_parity_small(runs):
    err, report = runs["parity_artifact"].result()
    assert set(report) == {"size", "spp", "cases", "oracle_scope", "device", "all_pass",
                           "bvh8_launches"}
    assert report["device"] == "cpu" and (report["size"], report["spp"]) == (64, 8)
    assert set(report["cases"]) == {f"{c}_{m}" for c in ("cornell", "textured")
                                    for m in ("parity", "hdr")}
    for name, entry in report["cases"].items():
        assert entry["oracle"] == "BRUTE_FORCE" and entry["spp"] == 8, name
        assert entry["passes_1e-3"] and entry["rmse"] <= 1e-3, name
    assert report["cases"]["cornell_parity"]["rmse"] == 0.0
    assert report["cases"]["cornell_hdr"]["rmse"] == 0.0
    assert report["all_pass"] is True
    assert report["bvh8_launches"] == {"closest": 0, "any": 0}  # CPU: the plain version
    assert "bvh8 launches over this run: closest 0, any 0" in err
    assert all(c["bvh8_launches"] == {"closest": 0, "any": 0}
               for c in report["cases"].values())
    pngs = sorted(p.name for p in runs["parity_artifact"].out_dir.glob("*.png"))
    assert len(pngs) == 8 and all(p.startswith("smoke_") for p in pngs)


def test_t1024_small(runs):
    err, report = runs["measure_t1024"].result()
    assert set(report) == {"size", "spp", "tris", "measured_s", "extrapolated_s", "ratio",
                           "mrays_per_s", "backend", "device"}
    assert (report["size"], report["spp"], report["tris"]) == (32, 4, 4000)
    assert report["backend"] == "cpu" and report["device"] == "cpu"
    assert report["measured_s"] > 0 and report["extrapolated_s"] > 0
    assert report["ratio"] == pytest.approx(report["measured_s"] / report["extrapolated_s"])
    assert report["mrays_per_s"] > 0
    assert err.count("probe frame") == 10
    assert "bvh8 launches over the 4 measured frames" in err


def test_hybrid_small(runs):
    err, report = runs["hybrid_artifact"].result()
    assert set(report) == {"tris", "device", "small", "rmse_vs_cpu", "rmse_pass_1e-3",
                           "bvh8_launches"}
    assert report["device"] == "cpu" and report["tris"] == 20000
    assert report["small"]["size"] == [256, 144]
    # on the CPU both frames are the same computation
    assert report["rmse_vs_cpu"] == 0.0 and report["rmse_pass_1e-3"] is True
    from vulkanraytracing_torch.app.image_io import read_png

    img = read_png(runs["hybrid_artifact"].out_dir / "hybrid_256x144_device.png")
    assert img.shape == (144, 256, 3) and 40 < img.mean() < 220


def test_aniso_report_matches_the_jax_report(runs):
    err, report = runs["measure_aniso"].result()
    want = json.loads((ROOT / "artifacts" / "aniso" / "report.json").read_text())
    assert set(report) == set(want) | {"device", "bvh8_launches"}
    assert report["device"] == "cpu" and report["scene"] == want["scene"]
    for key in ("rmse_trilinear_vs_aniso16", "rmse_aniso4_vs_aniso16",
                "rmse_trilinear_vs_aniso4"):
        assert report[key] == pytest.approx(want[key], rel=0.02), key
    for key in ("gate", "trilinear_breaks_gate", "aniso4_breaks_gate"):
        assert report[key] == want[key], key
    assert len(list(runs["measure_aniso"].out_dir.glob("grazing_taps*.png"))) == 3


@pytest.mark.parametrize("tool", sorted(RUNS))
def test_tool_needs_the_card_unless_asked(tool, runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    run = runs[f"{tool}_no_device"]
    rc, out, err = run.output()
    assert rc != 0
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert out == "" and not any(run.out_dir.iterdir())
