#!/usr/bin/env python3
"""Time variants of the port's per-ray traversal kernels (BVH8, BVH2) on
the real launches of a frame, on one NVIDIA GPU.

    python3 -m vulkanraytracing_torch.tools.traverse_sweep [VARIANT ...]

Run from the repository root (it drives the frames through ``chip_smoke``'s
helpers).  The script records the arguments of every
traversal launch of one 1080p v1 frame (BVH8, ``render_frame``) and of one
moving frame of the dynamic path (BVH2, ``Engine``), as ``chip_smoke.py``
does.  Then, for each variant, it copies ``vulkanraytracing_torch/csrc``
into the build directory, rewrites the named ``constexpr int`` constants
of the copy, builds both kernels from it with the package's nvcc flags and
replays every recorded launch through them: milliseconds by CUDA events
(mean of 5), every output held bit-equal to the first variant's.  One line
per variant and kernel: ptxas's registers, then the 8 launches in frame
order (closest, any-hit of bounces 0-3) and their sums.

A variant is ``name=value[,name=value...]`` over the constants of
``csrc/traverse_common.cuh`` (``kRefillBelow``, ``kLeaveLoopBelow``,
``kMinBlocksPerSm``, ``kBlock``) and ``kFastStack`` (both kernels'), or
``base`` for the sources as they are.  With no arguments a default list
runs.  The sources in the package are never changed: what a sweep finds
goes into them by hand.  A structural variant (another loop, another
load order) is measured the same way over sources edited for the run.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

DEFAULT_VARIANTS = [
    "base",
    "kRefillBelow=1", "kRefillBelow=8", "kRefillBelow=24", "kRefillBelow=32",
    "kLeaveLoopBelow=0", "kLeaveLoopBelow=6", "kLeaveLoopBelow=16",
    "kMinBlocksPerSm=4", "kMinBlocksPerSm=6", "kMinBlocksPerSm=10",
    "kFastStack=4", "kFastStack=8", "kFastStack=24", "kFastStack=32",
    "kBlock=64,kMinBlocksPerSm=16", "kBlock=256,kMinBlocksPerSm=4",
    "base",
]
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"closest": [_P] * 6 + [_I, _I] + [_P] * 7, "any": [_P] * 6 + [_I] + [_P] * 3}


def parse_variant(text: str) -> dict[str, int]:
    if text == "base":
        return {}
    return {name: int(value) for name, value in (item.split("=") for item in text.split(","))}


def variant_sources(constants: dict[str, int]) -> Path:
    """A copy of csrc/ with the constants rewritten (the package's own
    directory for no constants)."""
    from vulkanraytracing_torch import native

    if not constants:
        return native.CSRC_DIR
    tag = hashlib.sha256(repr(sorted(constants.items())).encode()).hexdigest()[:12]
    out = native.BUILD_DIR / "sweep" / tag
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(native.CSRC_DIR, out)
    for name, value in constants.items():
        pattern = re.compile(rf"(constexpr int {name} = )\d+;")
        hits = 0
        for path in out.glob("*.cuh"):
            text, n = pattern.subn(rf"\g<1>{value};", path.read_text())
            if n:
                path.write_text(text)
                hits += n
        if not hits:
            raise SystemExit(f"no constant {name} in {native.CSRC_DIR}")
    return out


def build(which: str, src: Path) -> ctypes.CDLL:
    """The BVH8 or BVH2 kernel library built from the sources in ``src``."""
    from vulkanraytracing_torch import native
    from vulkanraytracing_torch.ops.traverse_wide8 import STACK_DEPTH

    cmd = [native.nvcc_path(), *native.NVCC_FLAGS, f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{src}"]
    path = native.build_library(
        f"{which}_traverse", cmd, [src / f"{which}_traverse.cu"],
        (src / f"{which}_traverse.cuh", src / "traverse_common.cuh"))
    return native.load_library(path, {f"vrt_{which}_closest": (_I, SIGNATURES["closest"]),
                                      f"vrt_{which}_any": (_I, SIGNATURES["any"])})


def launch(lib, which, kind, tensors, rays, cull) -> tuple:
    """One launch as the package's wrappers make it (counter included)."""
    o, d, t_min, t_max = rays
    n, dev = o.shape[0], o.device
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptrs(*xs):
        return [x.data_ptr() for x in xs]

    if kind == "closest":
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        out = (t, torch.empty_like(t), torch.empty_like(t),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.bool, device=dev))
        err = getattr(lib, f"vrt_{which}_closest")(
            *ptrs(*tensors, o, d, t_min, t_max), n, int(cull), *ptrs(counter, *out), stream)
    else:
        out = (torch.empty((n,), dtype=torch.bool, device=dev),)
        err = getattr(lib, f"vrt_{which}_any")(
            *ptrs(*tensors, o, d, t_min, t_max), n, *ptrs(counter, *out), stream)
    if err:
        raise RuntimeError(f"{which} {kind} launch failed: cudaError {err}")
    return out


def recorded_launches(device) -> dict:
    """{"bvh8" / "bvh2": [(kind, table tensors, rays, cull), ...]} of one
    v1 frame and one moving dynamic frame at 1920x1080, 4 bounces."""
    import chip_smoke as cs
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.ops import traverse_wide as tw2
    from vulkanraytracing_torch.ops import traverse_wide8 as tw8
    from vulkanraytracing_torch.pt.render import create_render_state, render_frame
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    camera_cfg = CameraConfig(**cs.BENCH_CAMERA, aspect_ratio=1920 / 1080)
    v1 = build_scene_bvh(sponza_like_scene(262144, workload="v1", device=device),
                         builder="sah")
    cfg = Config(width=1920, height=1080, max_bounce_count=4, ray_chunk_size=1 << 22,
                 traversal=TraversalMode.BVH_KERNEL, camera=camera_cfg)
    camera = Camera(cfg.camera).to_device(device)
    state = create_render_state(cfg, device)
    calls8 = cs.record_frame(lambda: render_frame(v1, cfg, camera, state))
    hall, instances, animation = cs.instanced_hall(device)
    engine = Engine(Config(width=1920, height=1080, max_bounce_count=4, camera=camera_cfg),
                    hall, instances=instances, animation=animation, device=device)
    engine.run(2)
    calls2 = cs.record_frame(engine.draw)
    return {"bvh8": [(k, tuple(tw8.get_table8(b)), r, c) for k, b, r, c in calls8],
            "bvh2": [(k, tw2.get_table2(b).records, r, c) for k, b, r, c in calls2]}


def main() -> int:
    if not torch.cuda.is_available():
        print("traverse_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from vulkanraytracing_torch import native

    names = sys.argv[1:] or DEFAULT_VARIANTS
    variants = [parse_variant(name) for name in names]
    device = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; variants: {' '.join(names)}", flush=True)
    t0 = time.perf_counter()
    sources = [variant_sources(constants) for constants in variants]
    jobs = [(which, src) for src in sources for which in ("bvh8", "bvh2")]
    with ThreadPoolExecutor(8) as pool:  # a variant named twice is built once
        built = {job: pool.submit(build, *job) for job in dict.fromkeys(jobs)}
    libs = [built[job].result() for job in jobs]
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    work = recorded_launches(device)
    first = {}
    for i, name in enumerate(names):
        for j, which in enumerate(("bvh8", "bvh2")):
            lib = libs[2 * i + j]
            regs = re.findall(r"Used (\d+) registers",
                              native.build_log(Path(lib._name)).read_text())
            times, sums = [], {"closest": 0.0, "any": 0.0}
            for k, (kind, tensors, rays, cull) in enumerate(work[which]):
                out = launch(lib, which, kind, tensors, rays, cull)
                torch.cuda.synchronize()
                want = first.setdefault((which, k), out)
                cs.check(all(torch.equal(a, b) for a, b in zip(out, want)),
                         f"{name} {which} launch {k}: bit-equal to the first variant")
                ms = cs.cuda_ms(lambda: launch(lib, which, kind, tensors, rays, cull), 5)
                times.append(f"{ms:.3f}")
                sums[kind] += ms
            print(f"{which} {name}: registers {'/'.join(regs)} | {' '.join(times)} | closest "
                  f"{sums['closest']:.3f} any {sums['any']:.3f} sum "
                  f"{sums['closest'] + sums['any']:.3f} ms", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
