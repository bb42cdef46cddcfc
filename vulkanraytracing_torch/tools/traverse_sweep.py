#!/usr/bin/env python3
"""Time variants of the port's traversal kernels on the real launches of a
frame, on one NVIDIA GPU: the per-ray kernels (BVH8, BVH2) or, with
``--packet``, the packet kernels (subpacket, shared cursor).

    python3 -m vulkanraytracing_torch.tools.traverse_sweep [--packet] [VARIANT ...]

Run from the repository root (it drives the frames through ``chip_smoke``'s
helpers).  The script records the arguments of every traversal launch of
one 1080p v1 frame (BVH8 under ``BVH_KERNEL``; both packet kernels replay
the launches of a ``BVH_SUBPACKET`` frame) and of one moving frame of the
dynamic path (BVH2, ``Engine``), as ``chip_smoke.py`` does.  Then, for each
variant, it copies ``vulkanraytracing_torch/csrc`` into the build
directory, rewrites the named ``constexpr int`` constants of the copy,
builds both kernels from it with the package's nvcc flags and replays
every recorded launch through them: milliseconds by CUDA events (mean of
5), every output held bit-equal to the first variant's.  One line per
variant and kernel: ptxas's registers and spilled bytes, then the 8
launches in frame order (closest, any-hit of bounces 0-3) and their sums.

A variant is ``name=value[,name=value...]``, or ``base`` for the sources
as they are.  ``VRT_STACK_DEPTH=n`` (per-ray kernels only) builds with
another stack depth than the package's ``STACK_DEPTH``; the recorded
frame's trees must fit both.  The per-ray kernels' constants are in
``csrc/traverse_common.cuh`` (``kRefillBelow``, ``kLeaveLoopBelow``,
``kMinBlocksPerSm``, ``kBlock``) and ``kFastStack`` (both kernels'); the
packet kernels' in ``csrc/packet_common.cuh`` (``kRaysPerLane``: 1, 2, 4;
``kRaysPerThread``: 1, 2, 4, 8) and in their sources (``kSubpacketBlocksPerSm``,
``kSharedBlocksPerSm``, the blocks a SM that cap the registers: 1,024
threads need ``kSharedBlocksPerSm=1``).  With no variants a default list
runs.  The sources in the package are never changed: what a sweep finds
goes into them by hand.  A structural variant (another loop, another load
order) is measured the same way over sources edited for the run.
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

DEFAULT_VARIANTS = {
    False: [
        "base",
        "kRefillBelow=1", "kRefillBelow=8", "kRefillBelow=24", "kRefillBelow=32",
        "kLeaveLoopBelow=0", "kLeaveLoopBelow=6", "kLeaveLoopBelow=16",
        "kMinBlocksPerSm=4", "kMinBlocksPerSm=6", "kMinBlocksPerSm=10",
        "kFastStack=4", "kFastStack=8", "kFastStack=24", "kFastStack=32",
        "kBlock=64,kMinBlocksPerSm=16", "kBlock=256,kMinBlocksPerSm=4",
        "base",
    ],
    True: [
        "base",
        "kRaysPerLane=1,kRaysPerThread=1,kSharedBlocksPerSm=1",
        "kRaysPerLane=2,kRaysPerThread=2,kSharedBlocksPerSm=1",
        "kRaysPerLane=2,kSubpacketBlocksPerSm=8,kRaysPerThread=8,kSharedBlocksPerSm=2",
        "kRaysPerThread=8,kSharedBlocksPerSm=3",
        "kSubpacketBlocksPerSm=3,kSharedBlocksPerSm=1",
        "kSubpacketBlocksPerSm=5,kSharedBlocksPerSm=3",
        "base",
    ],
}
KERNELS = {False: ("bvh8", "bvh2"), True: ("subpacket", "shared")}


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
        for path in [*out.glob("*.cuh"), *out.glob("*.cu")]:
            text, n = pattern.subn(rf"\g<1>{value};", path.read_text())
            if n:
                path.write_text(text)
                hits += n
        if not hits:
            raise SystemExit(f"no constant {name} in {native.CSRC_DIR}")
    return out


def build(which: str, src: Path, depth: int | None = None):
    """The kernel library of ``which`` built from the sources in ``src``
    with ``depth`` stack entries (the package's ``STACK_DEPTH`` by
    default)."""
    import ctypes

    from vulkanraytracing_torch import native
    from vulkanraytracing_torch.ops import packet_lockstep
    from vulkanraytracing_torch.ops.traverse_wide8 import STACK_DEPTH

    if which in KERNELS[True]:
        if depth is not None:
            raise SystemExit("VRT_STACK_DEPTH variants are for the per-ray kernels")
        return packet_lockstep.kernel_library(which, src)
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS,
           f"-DVRT_STACK_DEPTH={STACK_DEPTH if depth is None else depth}", f"-I{src}"]
    path = native.build_library(
        f"{which}_traverse", cmd, [src / f"{which}_traverse.cu"],
        (src / f"{which}_traverse.cuh", src / "traverse_common.cuh"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return native.load_library(path, {
        f"vrt_{which}_closest": (i32, [ptr] * 6 + [i32, i32] + [ptr] * 7),
        f"vrt_{which}_any": (i32, [ptr] * 6 + [i32] + [ptr] * 3)})


def launch(lib, which, kind, table, rays, cull) -> tuple:
    """One launch as the package's wrappers make it (counter included);
    ``table`` holds the kernel's table arguments."""
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
            *table, *ptrs(o, d, t_min, t_max), n, int(cull), *ptrs(counter, *out), stream)
    else:
        out = (torch.empty((n,), dtype=torch.bool, device=dev),)
        err = getattr(lib, f"vrt_{which}_any")(
            *table, *ptrs(o, d, t_min, t_max), n, *ptrs(counter, *out), stream)
    if err:
        raise RuntimeError(f"{which} {kind} launch failed: cudaError {err}")
    return out


def recorded_launches(device, packet: bool) -> tuple[dict, list]:
    """({kernel: [(kind, table arguments, rays, cull), ...]}, the tables
    those arguments point into) of one v1 frame at 1920x1080, 4 bounces
    (under ``BVH_SUBPACKET`` for the packet kernels, which both replay it),
    and for BVH2 of one moving dynamic frame."""
    import chip_smoke as cs
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.ops import traverse_wide as tw2
    from vulkanraytracing_torch.ops import traverse_wide8 as tw8
    from vulkanraytracing_torch.ops.packet_lockstep import table_args
    from vulkanraytracing_torch.pt.render import create_render_state, render_frame
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    def ptrs(tensors):
        return [x.data_ptr() for x in tensors]

    camera_cfg = CameraConfig(**cs.BENCH_CAMERA, aspect_ratio=1920 / 1080)
    v1 = build_scene_bvh(sponza_like_scene(262144, workload="v1", device=device),
                         builder="sah")
    mode = TraversalMode.BVH_SUBPACKET if packet else TraversalMode.BVH_KERNEL
    cfg = Config(width=1920, height=1080, max_bounce_count=4, ray_chunk_size=1 << 22,
                 traversal=mode, camera=camera_cfg)
    camera = Camera(cfg.camera).to_device(device)
    state = create_render_state(cfg, device)
    calls = cs.record_frame(lambda: render_frame(v1, cfg, camera, state))
    if packet:
        work = [(k, table_args(tw2.get_table2(b)), r, c) for k, b, r, c in calls]
        return {"subpacket": work, "shared": work}, [v1]
    hall, instances, animation = cs.instanced_hall(device)
    engine = Engine(Config(width=1920, height=1080, max_bounce_count=4, camera=camera_cfg),
                    hall, instances=instances, animation=animation, device=device)
    engine.run(2)
    calls2 = cs.record_frame(engine.draw)
    return {"bvh8": [(k, ptrs(tw8.get_table8(b)), r, c) for k, b, r, c in calls],
            "bvh2": [(k, ptrs(tw2.get_table2(b).records), r, c) for k, b, r, c in calls2]
            }, [v1, calls2]


def main() -> int:
    if not torch.cuda.is_available():
        print("traverse_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from vulkanraytracing_torch import native

    packet = "--packet" in sys.argv[1:]
    names = [a for a in sys.argv[1:] if a != "--packet"] or DEFAULT_VARIANTS[packet]
    kernels = KERNELS[packet]
    variants = [parse_variant(name) for name in names]
    depths = [constants.pop("VRT_STACK_DEPTH", None) for constants in variants]
    device = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; kernels: {' '.join(kernels)}; variants: "
          f"{' '.join(names)}", flush=True)
    t0 = time.perf_counter()
    sources = [variant_sources(constants) for constants in variants]
    jobs = [(which, src, depth) for src, depth in zip(sources, depths) for which in kernels]
    with ThreadPoolExecutor(8) as pool:  # a variant named twice is built once
        built = {job: pool.submit(build, *job) for job in dict.fromkeys(jobs)}
    libs = [built[job].result() for job in jobs]
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    work, alive = recorded_launches(device, packet)  # `alive` keeps the tables
    first = {}
    for i, name in enumerate(names):
        for j, which in enumerate(kernels):
            lib = libs[2 * i + j]
            log = native.build_log(Path(lib._name)).read_text()
            regs = re.findall(r"Used (\d+) registers", log)
            spilled = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
            times, sums = [], {"closest": 0.0, "any": 0.0}
            for k, (kind, table, rays, cull) in enumerate(work[which]):
                out = launch(lib, which, kind, table, rays, cull)
                torch.cuda.synchronize()
                want = first.setdefault((which, k), out)
                cs.check(all(torch.equal(a, b) for a, b in zip(out, want)),
                         f"{name} {which} launch {k}: bit-equal to the first variant")
                ms = cs.cuda_ms(lambda: launch(lib, which, kind, table, rays, cull), 5)
                times.append(f"{ms:.3f}")
                sums[kind] += ms
            print(f"{which} {name}: registers {'/'.join(regs)}, {spilled} B spilled | "
                  f"{' '.join(times)} | closest {sums['closest']:.3f} any "
                  f"{sums['any']:.3f} sum {sums['closest'] + sums['any']:.3f} ms", flush=True)
    del alive
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
