"""The hybrid mode at scale: one 1080p hybrid frame of the real workload on the card.

    python -m vulkanraytracing_torch.tools.hybrid_artifact [--device cuda|cpu] [--out-dir DIR]

Counterpart of the root ``tools/hybrid_artifact.py``.  The real workload
(``sponza_like_scene(VRT_HYBRID_TRIS, workload="real")``, default 262,144
triangles: textures, alpha-tested foliage, the HDR sky; no IBL bake, as
the JAX tool has none), SAH build, the bench camera, ``BVH_KERNEL``:

1. a 256x144 hybrid frame on the device (a warm-up call, then the frame
   timed), written as ``hybrid_256x144_device.png``, and the same frame
   rendered by the port on the CPU (the traversal's plain version) from a
   host copy of the same built scene, in this process, written as
   ``hybrid_256x144_cpu.png``; the 8-bit images are held at RMSE <= 1e-3
   (the hybrid frame has no RNG: they differ only where the device's and
   the host's arithmetic do);
2. the 1920x1080 frame: the warm-up call's seconds, the hot frame's
   seconds and fps, written as ``hybrid_1080p.png``.

Each call is timed on the wall clock up to the image's copy to the host.
``VRT_HYBRID_SMALL=1``: 20,000 triangles and the small frame only, into
``report_smoke.json``.  Exits 1 when the small frame fails the gate.  The
BVH8 kernel's launches over the run go to stderr and into the report.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from vulkanraytracing_torch.tools import common

GATE = 1e-3


def render(scene, cfg, camera) -> tuple[np.ndarray, float, float]:
    """(image, warm-up seconds, hot frame seconds) of two calls."""
    from vulkanraytracing_torch.hybrid import render_hybrid

    t0 = time.perf_counter()
    render_hybrid(scene, cfg, camera).cpu()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render_hybrid(scene, cfg, camera).cpu().numpy()
    return img, warm, time.perf_counter() - t0


def to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def main(argv=None) -> int:
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.app.image_io import rmse, write_png
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.hybrid import render_hybrid
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    args = common.parser("hybrid_artifact", __doc__).parse_args(argv)
    device, label = common.open_device(args.device, "hybrid_artifact")
    small = bool(os.environ.get("VRT_HYBRID_SMALL"))
    tris = int(os.environ.get("VRT_HYBRID_TRIS", 20000 if small else 262144))
    out_dir = args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    scene = build_scene_bvh(sponza_like_scene(tris, workload="real", device=device),
                            builder="sah")
    host_scene = scene.to("cpu")
    print(f"hybrid_artifact: {scene.geometry.num_triangles} triangles "
          f"({scene.alpha.geometry.num_triangles} alpha-tested), scene and SAH build "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)

    def cfg_for(width, height):
        return Config(width=width, height=height, traversal=TraversalMode.BVH_KERNEL,
                      camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                          aspect_ratio=width / height))

    before = common.bvh8_launches()
    report: dict = {"tris": tris, "device": label}
    w, h = 256, 144
    cfg = cfg_for(w, h)
    img, warm, hot = render(scene, cfg, Camera(cfg.camera).to_device(device))
    write_png(out_dir / "hybrid_256x144_device.png", img)
    report["small"] = {"size": [w, h], "warmup_seconds": warm, "seconds": hot}
    t0 = time.perf_counter()
    host = render_hybrid(host_scene, cfg, Camera(cfg.camera).to_device("cpu")).numpy()
    write_png(out_dir / "hybrid_256x144_cpu.png", host)
    value = rmse(to_u8(host).astype(np.float32) / 255.0, to_u8(img).astype(np.float32) / 255.0)
    report["small"]["cpu_seconds"] = time.perf_counter() - t0
    report["rmse_vs_cpu"] = value
    report["rmse_pass_1e-3"] = value <= GATE
    print(f"256x144: {hot:.3f} s on {device.type}, RMSE against the CPU frame {value:.2e}",
          file=sys.stderr, flush=True)

    if not small:
        cfg = cfg_for(1920, 1080)
        img, warm, hot = render(scene, cfg, Camera(cfg.camera).to_device(device))
        write_png(out_dir / "hybrid_1080p.png", img)
        report["full"] = {"size": [1920, 1080], "warmup_seconds": warm,
                          "frame_seconds": hot, "fps": 1.0 / hot}
        print(f"1920x1080: warm-up {warm:.2f} s, frame {hot:.3f} s", file=sys.stderr,
              flush=True)
    report["bvh8_launches"] = common.report_launches(before, "the run")
    common.write_report(out_dir / ("report_smoke.json" if small else "report.json"), report)
    print(json.dumps(report), flush=True)
    return 0 if report["rmse_pass_1e-3"] else 1


if __name__ == "__main__":
    sys.exit(main())
