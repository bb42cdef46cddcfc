"""What the benchmark imports, how it finds its parts by name, and how it
refuses to run without a card (CPU)."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rtbench import run

ROOT = Path(run.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vulkanraytracing_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute
    imports; the part before the first dot, whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not _imports(path) & FORBIDDEN, path
    # "vulkanraytracing_tpu" is not "vulkanraytracing_torch": whole names
    assert "vulkanraytracing_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").rglob("*.py")):
        assert "vulkanraytracing_torch" not in _imports(path), path
        assert "vulkanraytracing_torch" not in path.read_text(), path


def test_probe_targets_are_the_programs():
    for path in sorted((ROOT / "metrics").glob("*.py")):
        module = run.load_module(path)
        for target in getattr(module, "RECORD", {}).values():
            assert target.split(".")[0] == "vulkanraytracing_torch", (path, target)


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric dropped into a
    copy of the folder run with no edit to any file that is there."""
    copy = tmp_path / "rtbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    config = json.loads((copy / "configs" / "sponza_v1.json").read_text())
    config["name"] = "sponza_small"
    config["scene"]["triangles"] = 3000
    (copy / "configs" / "sponza_small.json").write_text(json.dumps(config))
    traffic = json.loads((copy / "traffic" / "pt_1080p.json").read_text())
    traffic.update(resolution=[32, 24], warmup_frames=1)
    (copy / "traffic" / "pt_tiny.json").write_text(json.dumps(traffic))
    (copy / "workloads" / "small-pt-tiny.json").write_text(json.dumps(
        {"check": {"pixels": 64, "limits": {"px_off": 0.0, "mean_off": 0.0}}}))
    (copy / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frame_s))\n")
    bench["configs"].append({"name": "sponza_small", "source": "test", "file": "x",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small-pt-tiny", "config": "sponza_small",
                               "traffic": "pt_tiny", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["small-pt-tiny"]})
    result = run.run_cell(bench, "small-pt-tiny", 5, 0.2, False, torch.device("cpu"),
                          root=copy, cache=tmp_path / "cache")
    assert result["correct"] is True
    assert result["metrics"]["frames_seen"]["value"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"frame_ms", "setup_s", "frames_seen"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("change", [{"camera": {"path": "orbit"}}, {"loop": "open"},
                                    {"mode": "raster"}])
def test_a_traffic_setting_the_harness_ignores_is_refused(change):
    """A key or value the harness does not implement stops the run
    instead of running a static path-traced cell under another name."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    with pytest.raises(ValueError, match="does not implement"):
        run.load_cell(bench, cell, overrides={"workload": change})


def _cli(cwd: Path, env=None):
    return subprocess.run([sys.executable, "-m", "rtbench", "--workload", "v1-pt-1080p",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_no_card_means_no_result():
    """Here there is no CUDA device: exit 2, nothing on stdout."""
    proc = _cli(ROOT.parent)
    assert proc.returncode == 2 and proc.stdout == "", proc.stderr
    assert "CUDA" in proc.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _cli(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr
