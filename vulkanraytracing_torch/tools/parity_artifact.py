"""The RMSE parity gate: the production traversal against an oracle, at 1024 spp.

    python -m vulkanraytracing_torch.tools.parity_artifact [--device cuda|cpu] [--out-dir DIR]

Counterpart of the root ``tools/parity_artifact.py``.  BASELINE.json's
quality metric is image RMSE parity at most 1e-3 after 1024 spp.  Every
case renders one scene twice from one built tree (SAH): through the
production traversal (``TraversalMode.BVH_KERNEL``, the BVH8 kernel on the
card) and through an oracle, with the same RNG stream, estimator and
accumulation, in both accumulation modes:

- ``parity``: tone-map, then accumulate with RGBA8 quantization each frame
  (``parity_quantization`` and ``tone_map_before_accumulation`` on);
- ``hdr``: accumulate linear radiance, tone-map at display (both off).

Cases: ``cornell`` (the Cornell box) and ``textured`` (a checkered quad
under a constant sky) at 512x512 and 1024 spp against brute force; and
``sponza262k`` (``sponza_like_scene(262144)``, 80-degree camera) at 128 spp
against the plain ``BVH`` backend (brute force over 262,144 triangles is
out of reach).  One ``sponza262k`` oracle frame is timed first, and the
case's spp is cut, and recorded in its entry, only where its oracle frames
(128 in each mode) would take more than 20 minutes.  Both backends render
the same built scene, so an exact tie resolves to the same lowest id on
both sides.

RMSE is taken on the 8-bit images (``app.image_io.rmse`` over values /
255), and each case's entry is flushed to ``report.json`` as it lands; a
rerun at the same size and spp skips the cases already there
(``VRT_PARITY_FRESH=1`` starts over).  ``VRT_PARITY_FIRST=name,...`` runs
the named cases first.  ``VRT_PARITY_SMALL=1``: 64x64 and 8 spp, without
``sponza262k``, into ``report_smoke.json`` and ``smoke_*.png``.  Exits 1
when a case fails the gate.  The BVH8 kernel's launches go into each case's
entry and, summed over the cases, into the report; those of this process
go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from vulkanraytracing_torch.tools import common

GATE = 1e-3
MODES = ("parity", "hdr")
ORACLE_BUDGET_S = 20 * 60  # the most the sponza262k oracle may take, both modes

ORACLE_SCOPE = (
    "oracle = the port's brute-force intersector (or, at 262k triangles, its "
    "plain BVH backend) over the same RNG/tonemap/accumulation pipeline; RMSE "
    "certifies traversal+pipeline consistency. Estimator parity with the "
    "Vulkan reference is carried by the unit layer (the RNG, BSDF and "
    "integrator held to the JAX package) because the reference binary "
    "cannot run in this environment."
)


def textured_quad_scene(device):
    """A checkered textured quad under constant light (the texture slice of
    BASELINE config 2)."""
    from vulkanraytracing_torch.ops.texture import build_texture_pool
    from vulkanraytracing_torch.scene.types import (
        Scene, constant_environment, make_materials, make_trace_geometry, no_direct_light,
    )

    checker = np.zeros((64, 64, 4), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    cells = ((xx // 8 + yy // 8) % 2).astype(bool)
    checker[..., 0] = np.where(cells, 230, 40)
    checker[..., 1] = np.where(cells, 120, 160)
    checker[..., 2] = np.where(cells, 40, 230)
    checker[..., 3] = 255
    positions = np.array([[-1.5, -1.5, 0], [1.5, -1.5, 0], [1.5, 1.5, 0], [-1.5, 1.5, 0]],
                         np.float32)
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)[indices].reshape(-1, 2)
    return Scene(
        geometry=make_trace_geometry(positions, indices, uvs=uvs, cull_disable=True,
                                     device=device),
        materials=make_materials(base_color_factors=[(1.0, 1.0, 1.0, 1.0)],
                                 roughness_factors=[0.8], metallic_factors=[0.0],
                                 base_color_textures=[0], device=device),
        environment=constant_environment((0.9, 0.9, 0.9), device=device),
        direct_light=no_direct_light(device),
        point_lights=None,
        bvh=None,
        textures=build_texture_pool([checker], device=device),
    )


def render(scene, cfg, camera, spp: int, device) -> tuple[np.ndarray, float, float]:
    """``spp`` progressive frames -> (the 8-bit display image, rays,
    seconds)."""
    from vulkanraytracing_torch.pt.render import render_progressive, to_display

    common.sync(device)
    t0 = time.perf_counter()
    state, rays = render_progressive(scene, cfg, camera, spp=spp)
    img = to_display(state, cfg)
    return img, rays, time.perf_counter() - t0


def oracle_frame_seconds(scene, cfg, camera, device) -> float:
    """One oracle frame's wall seconds, after a frame that warms it up."""
    from vulkanraytracing_torch.pt.render import create_render_state, render_frame

    state = create_render_state(cfg, device)
    state, stats = render_frame(scene, cfg, camera, state)
    float(stats.rays)
    t0 = time.perf_counter()
    _, stats = render_frame(scene, cfg, camera, state)
    float(stats.rays)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.app.image_io import rmse, write_png
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import cornell_box_scene, sponza_like_scene

    args = common.parser("parity_artifact", __doc__).parse_args(argv)
    device, label = common.open_device(args.device, "parity_artifact")
    small = bool(os.environ.get("VRT_PARITY_SMALL"))
    size, spp = (64, 8) if small else (512, 1024)
    prefix = "smoke_" if small else ""
    out_dir = args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    report_path = out_dir / ("report_smoke.json" if small else "report.json")

    report: dict = {"size": size, "spp": spp, "cases": {}, "oracle_scope": ORACLE_SCOPE,
                    "device": label}
    if report_path.exists() and not os.environ.get("VRT_PARITY_FRESH"):
        try:
            prev = json.loads(report_path.read_text())
        except (json.JSONDecodeError, OSError):
            prev = {}
        if prev.get("size") == size and prev.get("spp") == spp:
            report["cases"] = {k: v for k, v in prev.get("cases", {}).items() if "spp" in v}
            if report["cases"]:
                print(f"resuming: {sorted(report['cases'])} already done", file=sys.stderr,
                      flush=True)

    def flush():
        report["all_pass"] = bool(report["cases"]) and all(
            c["passes_1e-3"] for c in report["cases"].values())
        common.write_report(report_path, report)

    before = common.bvh8_launches()

    def case(name, scene_fn, oracle=TraversalMode.BRUTE_FORCE, case_spp=None, cam=None):
        modes = [m for m in MODES if f"{name}_{m}" not in report["cases"]]
        if not modes:
            print(f"{name}: skipped (resumed from the report)", file=sys.stderr, flush=True)
            return
        cam = cam or CameraConfig(position=(0.0, 0.0, 3.2), aspect_ratio=1.0,
                                  x_fov=float(np.radians(60.0)))
        camera = Camera(cam).to_device(device)
        t0 = time.perf_counter()
        built = build_scene_bvh(scene_fn(), builder="sah")
        print(f"{name}: {built.geometry.num_triangles} triangles, SAH build "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
        cspp = case_spp or spp
        extra = {}
        if case_spp is not None:  # the oracle's cost decides the spp
            probe_cfg = Config(width=size, height=size, camera=cam, traversal=oracle,
                               alpha_visibility=False)
            frame_s = oracle_frame_seconds(built, probe_cfg, camera, device)
            if frame_s * case_spp * len(MODES) > ORACLE_BUDGET_S:
                cspp = max(1, int(ORACLE_BUDGET_S // (frame_s * len(MODES))))
            extra["oracle_frame_s"] = frame_s
            print(f"{name}: one {oracle.name} frame {frame_s:.3f} s -> {cspp} spp",
                  file=sys.stderr, flush=True)
        for mode in modes:
            base = Config(width=size, height=size, camera=cam,
                          parity_quantization=(mode == "parity"),
                          tone_map_before_accumulation=(mode == "parity"),
                          alpha_visibility=False)
            imgs, seconds = {}, {}
            launched = common.bvh8_launches()
            for backend, traversal in (("oracle", oracle),
                                       ("production", TraversalMode.BVH_KERNEL)):
                cfg = base.replace(traversal=traversal)
                img, rays, dt = render(built, cfg, camera, cspp, device)
                imgs[backend], seconds[f"{backend}_s"] = img, dt
                write_png(out_dir / f"{prefix}{name}_{mode}_{backend}.png", img)
                print(f"{name}/{mode}/{backend}: {rays / 1e6:.1f} Mrays in {dt:.1f} s",
                      file=sys.stderr, flush=True)
            value = rmse(imgs["oracle"].astype(np.float32) / 255.0,
                         imgs["production"].astype(np.float32) / 255.0)
            report["cases"][f"{name}_{mode}"] = {
                "rmse": value, "passes_1e-3": value <= GATE, "spp": cspp,
                "oracle": oracle.name, **seconds, **extra,
                "bvh8_launches": {k: n - launched[k]
                                  for k, n in common.bvh8_launches().items()},
            }
            flush()
            print(f"{name}/{mode}: RMSE {value:.2e} ({'PASS' if value <= GATE else 'FAIL'} "
                  f"@1e-3)", file=sys.stderr, flush=True)

    cases = [
        ("cornell", lambda: case("cornell", lambda: cornell_box_scene(device=device))),
        ("textured", lambda: case("textured", lambda: textured_quad_scene(device))),
    ]
    if not small:
        cases.append(("sponza262k", lambda: case(
            "sponza262k", lambda: sponza_like_scene(262144, device=device),
            oracle=TraversalMode.BVH, case_spp=128,
            cam=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                             aspect_ratio=1.0, x_fov=float(np.radians(80.0))))))
    first = [s for s in os.environ.get("VRT_PARITY_FIRST", "").split(",") if s]
    cases.sort(key=lambda kv: first.index(kv[0]) if kv[0] in first else len(first))
    for _, run in cases:
        run()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    common.report_launches(before, "this run")
    report["bvh8_launches"] = {
        kind: sum(c["bvh8_launches"][kind] for c in report["cases"].values())
        for kind in ("closest", "any")}
    flush()
    print(json.dumps(report), flush=True)
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
