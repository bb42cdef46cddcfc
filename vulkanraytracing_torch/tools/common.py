"""What the evidence tools share: their command line, the device they run
on and its label, and the BVH8 kernel's launches.

Each tool runs on the card unless it is given ``--device cpu``; a card
asked for and not there ends the run with an error, never on the host.
Its report names the device as ``bench.card_label`` does (the card's name
and power limit from ``nvidia-smi``) or ``"cpu"``, and goes to
``--out-dir`` (default ``artifacts/torch/<tool>/`` in the checkout).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts" / "torch"


def parser(tool: str, doc: str) -> argparse.ArgumentParser:
    """The arguments every tool takes: ``--device`` and ``--out-dir``."""
    p = argparse.ArgumentParser(prog=f"python -m vulkanraytracing_torch.tools.{tool}",
                                description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    p.add_argument("--out-dir", type=Path, default=ARTIFACTS / tool,
                   help=f"where the report and images go (default: artifacts/torch/{tool})")
    return p


def open_device(name: str, tool: str) -> tuple[torch.device, str]:
    """The device to run on and the report's label for it."""
    from vulkanraytracing_torch.bench import card_label

    device = torch.device(name)
    if device.type != "cuda":
        return device, device.type
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: --device {name}, but no CUDA device is available "
                         "(--device cpu runs on the host)")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    label = card_label(device.index)
    print(f"{tool}: {label}", file=sys.stderr, flush=True)
    return device, label


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bvh8_launches() -> dict:
    """The BVH8 kernel's launches so far, by query (either leaf test)."""
    from vulkanraytracing_torch.ops import traverse_wide8

    return traverse_wide8.launches_by_kind()


def report_launches(before: dict, what: str) -> dict:
    """Print on stderr, and return, the BVH8 launches since ``before``."""
    now = bvh8_launches()
    n = {kind: now[kind] - before[kind] for kind in now}
    print(f"bvh8 launches over {what}: closest {n['closest']}, any {n['any']}",
          file=sys.stderr, flush=True)
    return n


def write_report(path: Path, report: dict) -> None:
    path.write_text(json.dumps(report, indent=2) + "\n")
