"""Time-to-1024-spp, measured: 1024 progressive frames on the wall clock.

    python -m vulkanraytracing_torch.tools.measure_t1024 [SIZE] [SPP] [--device cuda|cpu] [--out-dir DIR]

Counterpart of the root ``tools/measure_t1024.py``.  The bench states
``time_to_1024spp_s`` as its best frame times 1024; this renders SPP
(default 1024) progressive frames at SIZE x SIZE (default 512) of the v1
bench scene (``sponza_like_scene(VRT_T1024_TRIS)``, default 262,144
triangles, SAH build, the bench camera, ``BVH_KERNEL``) through
``render_progressive`` (one ``render_span``), timed on the wall clock; the
window closes on the read of the ray count, which waits for the device.
Before it, one warm-up frame and a 10-frame probe, each frame closed the
same way: ``extrapolated_s`` is SPP times the probe's median frame, the
bench's rule at this size.

Writes ``t1024.json``: the JAX artifact's keys (``size``, ``spp``,
``tris``, ``measured_s``, ``extrapolated_s``, ``ratio``, ``mrays_per_s``,
``backend``: the device type) and ``device``.  Each probe frame and the
BVH8 kernel's launches over the measured frames go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from vulkanraytracing_torch.tools import common

PROBE_FRAMES = 10


def main(argv=None) -> int:
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.pt.render import (
        create_render_state, render_frame, render_progressive,
    )
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    p = common.parser("measure_t1024", __doc__)
    p.add_argument("size", nargs="?", type=int, default=512)
    p.add_argument("spp", nargs="?", type=int, default=1024)
    args = p.parse_args(argv)
    device, label = common.open_device(args.device, "measure_t1024")
    size, spp = args.size, args.spp
    tris = int(os.environ.get("VRT_T1024_TRIS", 262144))

    cfg = Config(width=size, height=size, ray_chunk_size=1 << 22,
                 traversal=TraversalMode.BVH_KERNEL,
                 camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                     aspect_ratio=1.0))
    scene = build_scene_bvh(sponza_like_scene(tris, device=device), builder="sah")
    camera = Camera(cfg.camera).to_device(device)
    print(f"measure_t1024: {device.type}, {size}^2, {spp} spp, {tris} tris "
          f"({scene.geometry.num_triangles} built)", file=sys.stderr, flush=True)

    # the probe: the extrapolation the bench would make at this size
    state = create_render_state(cfg, device)
    state, stats = render_frame(scene, cfg, camera, state)  # builds and packs
    float(stats.rays)
    times = []
    for i in range(PROBE_FRAMES):
        t0 = time.perf_counter()
        state, stats = render_frame(scene, cfg, camera, state)
        rays = float(stats.rays)
        times.append(time.perf_counter() - t0)
        print(f"probe frame {i}: {times[-1] * 1e3:.2f} ms, {int(rays)} rays",
              file=sys.stderr, flush=True)
    median = float(np.median(times))
    extrapolated = median * spp
    print(f"median frame {median * 1e3:.2f} ms -> extrapolated {extrapolated:.2f} s",
          file=sys.stderr, flush=True)

    before = common.bvh8_launches()
    state = create_render_state(cfg, device)
    common.sync(device)
    t0 = time.perf_counter()
    state, rays = render_progressive(scene, cfg, camera, spp=spp, state=state)
    measured = time.perf_counter() - t0
    if state.accum_index != spp:
        raise RuntimeError(f"accumulated {state.accum_index} frames, not {spp}")
    common.report_launches(before, f"the {spp} measured frames")
    out = {
        "size": size, "spp": spp, "tris": tris,
        "measured_s": measured,
        "extrapolated_s": extrapolated,
        "ratio": measured / extrapolated,
        "mrays_per_s": rays / measured / 1e6,
        "backend": device.type,
        "device": label,
    }
    args.out_dir.mkdir(parents=True, exist_ok=True)
    common.write_report(args.out_dir / "t1024.json", out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
