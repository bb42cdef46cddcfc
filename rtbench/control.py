"""The control of a cell's check, read on the card at the cell's size.

    python3 -m rtbench.control --workload <cell> --frames <n> --seeds <s> [<s> ...]

For each seed: the cell's scene files, then the reference at the cell's
sample of pixels over ``--frames`` frames twice, in float32 and with
every shading quantity rounded to bfloat16 (the control), and the
compared numbers of the control put in the program's place, each beside
its limit.  The benchmark's runs do not run this; it gives the upper
readings that the limits in ``workloads/<cell>.json`` are set below.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rtbench import run


def readings(bench: dict, cell: str, seed: int, frames: int, device, frame: int = 0,
             overrides: dict | None = None, cache=run.CACHE) -> dict:
    r = run.Run(*run.load_cell(bench, cell, overrides=overrides), seed)
    r.device = device
    r.files = run.scene_files(r, cache)
    px, py = run.sample_pixels(r, device)
    t0 = time.perf_counter()
    ref = run.reference_pixels(r, px, py, frames, device, low=False, frame=frame)
    t1 = time.perf_counter()
    low = run.reference_pixels(r, px, py, frames, device, low=True, frame=frame)
    t2 = time.perf_counter()
    checks = run.compare(low, ref, r.workload["check"]["limits"])
    diff = (low - ref).abs().amax(dim=-1) * 255.0
    return {"cell": cell, "seed": seed, "frames": frames, "frame": frame,
            "control": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "max_levels": float(diff.max()),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtbench.control", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--frames", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    bench = json.loads((run.CHECKOUT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        print(json.dumps(readings(bench, args.workload, seed, args.frames, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
