"""Benchmark: Mrays/s of the Sponza-like scene at 1080p through the BVH8 kernel.

Counterpart of the JAX package's root ``bench.py``:

    python -m vulkanraytracing_torch bench [--devices N] [--device cuda|cpu]
    python -m vulkanraytracing_torch.bench [--devices N] [--device cuda|cpu]

The scene (262,144 triangles requested, 4 bounces, camera (-16, 3, 0) ->
(0, 3, 0)) goes through a .glb written by ``scene.gltf_export`` and read
back by ``scene.gltf.load_scene``, an SAH build and the BVH8 collapse;
then one warm-up frame (the first use builds the kernel library and grows
the allocator's pool) and the measured frames, each timed on the host
clock around ``render_frame`` up to ``float(stats.rays)``, which waits for
the card.  Each frame's line goes to stderr as it lands, then the BVH8
kernel's launches over the measured frames.  The last stdout line is one
JSON object with the JAX bench's keys::

    {"metric": "Mrays/s/chip", "value": best, "unit": "Mrays/s",
     "vs_baseline": best / 100, "mean": ..., "median": ..., "frames": N,
     "time_to_1024spp_s": ..., "workload": "v1" | "real",
     "devices": N (when N > 1), "device": "<name>, <power limit>" | "cpu"}

``device`` names the card as ``nvidia-smi`` gives its name and power
limit.  Rays are the integrator's exact int64 count.  ``--device`` is the
card unless ``--device cpu``: there the kernel's plain version runs, and
without a card ``--device cuda`` exits with an error.  ``--devices N``
shards the frame's pixel rows over the first N cards (``parallel``), or
over N host shards with ``--device cpu``; Mrays/s is divided by N.

SIGTERM and SIGINT print a partial JSON (``"partial": true``, the stage,
the frames measured, the error) and exit with 2; a stage that overruns its
watchdog prints one and exits with 3.

Environment: ``VRT_BENCH_SMALL=1`` (256x144, 20,000 triangles, 2 frames;
it picks the sizes, never the device), ``VRT_BENCH_FRAMES``,
``VRT_BENCH_TRIS``, ``VRT_BENCH_WORKLOAD`` (``v1`` or ``real``),
``VRT_BENCH_DEVICES`` (the default of ``--devices``),
``VRT_BENCH_NO_LOADER=1`` (skip the .glb round trip),
``VRT_BENCH_GLB_DIR`` (where the .glb is kept; default
``vulkanraytracing_torch/build/bench``), and the watchdogs' seconds:
``VRT_BENCH_WATCHDOG_S`` (device discovery, 120), ``VRT_BENCH_WARMUP_S``
(the warm-up frame with the kernel build, 2700 for v1 and 4800 for real)
and ``VRT_BENCH_FRAME_S`` (each measured frame, 300).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
from vulkanraytracing_torch.scene.camera import Camera, CameraPT
from vulkanraytracing_torch.scene.types import Scene

GLB_DIR = Path(__file__).resolve().parent / "build" / "bench"


class Evidence:
    """What a run has measured so far, for the partial JSON that a signal
    or a watchdog prints before the process exits."""

    def __init__(self) -> None:
        self.stage = "startup"
        self.per_frame: list[float] = []

    @staticmethod
    def emit(obj: dict) -> None:
        print(json.dumps(obj), flush=True)

    def partial(self, reason: str) -> dict:
        best = max(self.per_frame) if self.per_frame else None
        return {
            "metric": "Mrays/s/chip",
            "value": round(best, 3) if best is not None else None,
            "unit": "Mrays/s",
            "vs_baseline": round(best / 100.0, 4) if best is not None else None,
            "partial": True,
            "stage": self.stage,
            "frames": len(self.per_frame),
            "error": reason,
        }

    def on_signal(self, signum, frame) -> None:  # noqa: ARG002
        self.emit(self.partial(f"interrupted by signal {signum} during stage "
                               f"'{self.stage}'"))
        os._exit(2)

    def arm_watchdog(self, budget_s: float, stage: str) -> threading.Timer:
        """Exit with a partial JSON if ``stage`` has not ended within
        ``budget_s`` seconds (cancel the returned timer when it has)."""

        def fire():
            self.emit(self.partial(f"watchdog: stage '{stage}' did not complete within "
                                   f"{budget_s:g}s"))
            os._exit(3)

        timer = threading.Timer(budget_s, fire)
        timer.daemon = True
        timer.start()
        return timer


def bench_case(width: int, height: int, tris: int, workload: str = "v1",
               loader: bool = True, device: torch.device | str = "cuda",
               cache_dir: Path | str = GLB_DIR) -> tuple[Scene, Config, CameraPT]:
    """The bench's scene (through its cached .glb unless ``loader`` is
    false, then SAH-built), config and camera on ``device``."""
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    cfg = Config(
        width=width,
        height=height,
        ray_chunk_size=1 << 22,  # the whole frame as one wavefront
        traversal=TraversalMode.BVH_KERNEL,
        camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                            aspect_ratio=width / height),
    )
    scene = sponza_like_scene(tris, workload=workload, device=device)
    if loader:
        scene = _through_glb(scene, tris, workload, device, Path(cache_dir))
    scene = build_scene_bvh(scene, builder="sah")
    return scene, cfg, Camera(cfg.camera).to_device(device)


def _through_glb(scene: Scene, tris: int, workload: str, device, cache_dir: Path) -> Scene:
    """The scene written to (once) and read back from its .glb, with the
    procedural environment and sun put back (glTF carries neither)."""
    from vulkanraytracing_torch.scene.gltf import load_scene
    from vulkanraytracing_torch.scene.gltf_export import export_scene_glb

    suffix = "" if workload == "v1" else f"_{workload}"
    glb = cache_dir / f"sponza_like{suffix}_{tris}.glb"
    if not glb.exists():
        from vulkanraytracing_torch.scene.procedural import sponza_real_images

        cache_dir.mkdir(parents=True, exist_ok=True)
        # a private name, then one rename: concurrent runs never read half a file
        tmp = glb.with_name(f"{glb.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        export_scene_glb(scene, tmp,
                         images=sponza_real_images() if workload == "real" else None)
        os.replace(tmp, glb)
        made = "written and "
    else:
        made = ""
    loaded, _camera, _pool = load_scene(glb, device=device)
    if loaded.geometry.num_triangles != scene.geometry.num_triangles:
        raise RuntimeError(f"{glb}: {loaded.geometry.num_triangles} triangles, the scene has "
                           f"{scene.geometry.num_triangles}")
    if workload == "real":
        if loaded.textures is None:
            raise RuntimeError(f"{glb} lost the texture pool")
        if not bool(loaded.geometry.alpha_test.any()):
            raise RuntimeError(f"{glb} lost the alpha-test (foliage) flags")
    print(f"scene: {made}loaded {glb} ({loaded.geometry.num_triangles} tris via scene.gltf)",
          file=sys.stderr, flush=True)
    return loaded._replace(environment=scene.environment, direct_light=scene.direct_light)


def card_label(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    name alone where ``nvidia-smi`` cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(index)


def discover_devices(device: str, n: int, height: int) -> tuple[torch.device, list | None, str]:
    """(the device the state lives on, the shard devices or None for one,
    the label of the report's ``device``).  Refuses, before any scene is
    built, a card that is not there, more cards than are visible, and a
    height that does not divide over the shards."""
    if n < 1:
        raise SystemExit(f"bench: --devices {n} must be at least 1")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: --device cuda, but no CUDA device is available "
                             "(--device cpu runs on the host)")
        torch.cuda.init()
        have = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if n > have:
            raise SystemExit(f"bench: --devices {n} requested but only {have} CUDA devices "
                             "are visible")
        label = card_label(dev.index)
        shards = [torch.device("cuda", i) for i in range(n)]
    else:
        have, label, shards = 1, dev.type, [dev] * n
    if height % n:
        raise SystemExit(f"bench: height {height} not divisible by {n} devices")
    print(f"devices: {label}; {have} visible; {n} used", file=sys.stderr, flush=True)
    return (shards[0] if n > 1 else dev), (shards if n > 1 else None), label


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--devices", type=int,
                        default=int(os.environ.get("VRT_BENCH_DEVICES", "1")),
                        help="shard the frame's pixel rows over N devices (with --device "
                             "cpu: N shards on the host)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")


def run(args: argparse.Namespace) -> int:
    from vulkanraytracing_torch.ops import traverse_wide8
    from vulkanraytracing_torch.pt.render import create_render_state, render_frame

    evidence = Evidence()
    signal.signal(signal.SIGTERM, evidence.on_signal)
    signal.signal(signal.SIGINT, evidence.on_signal)
    env = os.environ

    if env.get("VRT_BENCH_SMALL"):
        width, height, tris, frames = 256, 144, 20000, 2
    else:
        width, height, tris, frames = 1920, 1080, 262144, 10
    frames = int(env.get("VRT_BENCH_FRAMES", frames))
    tris = int(env.get("VRT_BENCH_TRIS", tris))
    workload = env.get("VRT_BENCH_WORKLOAD", "v1")
    n_devices = args.devices

    evidence.stage = "device_discovery"
    watchdog = evidence.arm_watchdog(float(env.get("VRT_BENCH_WATCHDOG_S", 120)),
                                     "device_discovery")
    try:
        device, mesh, label = discover_devices(args.device, n_devices, height)
    except SystemExit as exc:
        evidence.emit(evidence.partial(str(exc)))
        raise
    finally:
        watchdog.cancel()

    loader = not env.get("VRT_BENCH_NO_LOADER")
    # the scene and its SAH build; the JAX bench's stage names
    evidence.stage = "gltf_round_trip" if loader else "startup"
    scene, cfg, camera = bench_case(width, height, tris, workload, loader, device,
                                    env.get("VRT_BENCH_GLB_DIR", GLB_DIR))
    if mesh is None:
        def render(state):
            return render_frame(scene, cfg, camera, state)
    else:
        from vulkanraytracing_torch.parallel import replicate_scene, shard_render_frame

        replicas = replicate_scene(scene, mesh)

        def render(state):
            return shard_render_frame(replicas, cfg, camera, state, mesh)

    def sync():
        for dev in dict.fromkeys(mesh or [device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    state = create_render_state(cfg, device)
    evidence.stage = "warmup_compile"
    watchdog = evidence.arm_watchdog(
        float(env.get("VRT_BENCH_WARMUP_S", 4800 if workload == "real" else 2700)),
        "warmup_compile")
    t0 = time.perf_counter()
    try:
        state, stats = render(state)
        warm_rays = float(stats.rays)
    except Exception as exc:
        evidence.emit(evidence.partial(f"warmup failed: {exc!r:.300}"))
        raise
    finally:
        watchdog.cancel()
    print(f"warmup: {time.perf_counter() - t0:.1f}s, {warm_rays / 1e6:.1f} Mrays/frame",
          file=sys.stderr, flush=True)

    # the best frame is the headline (co-tenants stretch single frames); the
    # window closes on float(stats.rays), which waits for the frame's work
    evidence.stage = "measurement"
    per_frame = evidence.per_frame
    before = traverse_wide8.launches_by_kind()
    for i in range(frames):
        watchdog = evidence.arm_watchdog(float(env.get("VRT_BENCH_FRAME_S", 300)),
                                         f"frame {i}")
        sync()
        t0 = time.perf_counter()
        state, stats = render(state)
        rays = float(stats.rays)
        dt = time.perf_counter() - t0
        watchdog.cancel()
        mrays = rays / dt / 1e6 / n_devices
        per_frame.append(mrays)
        print(f"frame {i}: {dt * 1e3:.1f} ms, {int(rays)} rays, {mrays:.3f} Mrays/s/chip",
              file=sys.stderr, flush=True)
    launched = {k: n - before[k] for k, n in traverse_wide8.launches_by_kind().items()}
    print(f"bvh8 launches over the {frames} measured frames: closest {launched['closest']}, "
          f"any {launched['any']}" + (" (plane leaf test)" if traverse_wide8.WOOP_DEFAULT
                                      else ""), file=sys.stderr, flush=True)

    evidence.stage = "report"
    best = max(per_frame)
    # accumulation frames are the same work, so the best frame extrapolates
    best_frame_s = rays / (best * n_devices * 1e6)
    out = {
        "metric": "Mrays/s/chip",
        "value": round(best, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(best / 100.0, 4),
        "mean": round(float(np.mean(per_frame)), 3),
        "median": round(float(np.median(per_frame)), 3),
        "frames": frames,
        "time_to_1024spp_s": round(best_frame_s * 1024.0, 1),
        "workload": workload,
    }
    if n_devices > 1:
        out["devices"] = n_devices
    out["device"] = label
    evidence.emit(out)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vulkanraytracing_torch.bench",
                                     description=__doc__.splitlines()[0])
    add_arguments(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
