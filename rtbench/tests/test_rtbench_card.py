"""One short run of each cell on the card, through the command the driver
runs.  Marked ``gpu``: it skips where there is no CUDA device.

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
