"""One short run of each cell on the card, through the command the driver
runs, and one of the moving configuration that waits to become a cell
(``sponza_v1`` with ``DYNAMIC``'s instances), in process through
``run.run_cell``.  Marked ``gpu``: it skips where there is no CUDA device.

    python -m pytest rtbench/tests/test_rtbench_card.py -m gpu -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rtbench import run

pytestmark = pytest.mark.gpu
ROOT = Path(run.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
# the v1 hall as instance 0 and 64 spheres of 1,024 triangles on orbits of
# radius 3 around the hall's centre, 96 frames a turn, 1/64 turn apart,
# bobbing 0.4 about a height of 1.2, in materials 3 and 4 by turns; checked
# by px_off at 262,144 pixels (one block of the reference's paths)
DYNAMIC = {"config": {"scene": {"instances": {
    "mesh": {"radius": 0.6, "lat": 16, "lon": 32}, "count": 64, "materials": [3, 4],
    "orbit": {"radius": 3.0, "height": 1.2, "bob": 0.4, "period_frames": 96,
              "phase_spacing_turns": 0.015625}}}},
    "workload": {"check": {"pixels": 262144, "limits": {"mean_off": None}}}}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    proc = subprocess.run([sys.executable, "-m", "rtbench", "--workload", cell, "--seed",
                           "2147483659", "--seconds", "2", "--trace", "0"],
                          cwd=ROOT.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"


def test_the_moving_configuration_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    result = run.run_cell(BENCH, "v1-pt-1080p", 2147483661, 2.0, False,
                          torch.device("cuda", 0), overrides=DYNAMIC)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["device"]["platform"] == "gpu"
