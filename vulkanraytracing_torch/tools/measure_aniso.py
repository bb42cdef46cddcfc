"""Anisotropy divergence: hybrid texturing at 1, 4 and 16 taps on a grazing checkerboard.

    python -m vulkanraytracing_torch.tools.measure_aniso [--device cuda|cpu] [--out-dir DIR]

Counterpart of the root ``tools/measure_aniso.py``, the evidence for the
default ``Config.hybrid_aniso_taps = 16``.  The reference samples the
hybrid mode's textures with hardware anisotropy 16; the pool's trilinear
path (one tap) takes its mip from the footprint's longer axis and
over-blurs along the shorter one, where anisotropy matters: textured
surfaces at grazing angles.

A 64x64 checker (8-texel squares, a full mip chain) tiled 24 times over an
80x80 ground plane, seen about one degree above the horizon at 256x144,
lit by a constant white sky through the IBL (irradiance 8, reflection 16,
BRDF table 16), is rendered in hybrid mode through ``BVH_KERNEL`` with
``hybrid_aniso_taps`` 1 (trilinear), 4 and 16.  Writes
``grazing_taps{1,4,16}.png`` and ``report.json``: the three pairwise RMSEs
of the float images, the 1e-3 gate and whether trilinear and 4 taps break
it, as the JAX report has them, with ``device`` and the BVH8 kernel's
launches, which also go to stderr.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from vulkanraytracing_torch.tools import common

SIZE = (256, 144)
TAPS = (1, 4, 16)
IBL = dict(irradiance_size=8, reflection_size=16, brdf_size=16)


def grazing_plane_scene(device):
    """The ground plane, its tree and its baked constant sky."""
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.env.ibl import bake_ibl
    from vulkanraytracing_torch.ops.texture import WRAP_REPEAT, build_texture_pool
    from vulkanraytracing_torch.scene.types import (
        Scene, constant_environment, make_materials, make_trace_geometry, no_direct_light,
    )

    s = 40.0
    positions = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uvs = np.array([[0, 0], [24, 0], [24, 24], [0, 24]], np.float32)
    indices = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    c = np.indices((64, 64)).sum(axis=0) // 8 % 2
    img = np.zeros((64, 64, 4), np.uint8)
    img[..., :3] = np.where(c[..., None] > 0, 230, 25)
    img[..., 3] = 255
    scene = Scene(
        geometry=make_trace_geometry(positions, indices, uvs=uvs, cull_disable=True,
                                     opaque=True, device=device),
        materials=make_materials(base_color_factors=[(1.0, 1.0, 1.0, 1.0)],
                                 roughness_factors=[1.0], metallic_factors=[0.0],
                                 base_color_textures=[0], device=device),
        environment=constant_environment((1.0, 1.0, 1.0), device=device),
        direct_light=no_direct_light(device),
        point_lights=None,
        bvh=None,
        textures=build_texture_pool([img], [(WRAP_REPEAT, WRAP_REPEAT)], device=device),
    )
    scene = build_scene_bvh(scene)
    return scene._replace(environment=bake_ibl(scene.environment, **IBL))


def camera_config(width: int, height: int):
    from vulkanraytracing_torch.config import CameraConfig

    return CameraConfig(position=(0.0, 0.35, 16.0), target=(0.0, 0.0, -20.0),
                        aspect_ratio=width / height, x_fov=float(np.radians(75.0)))


def render_taps(scene, taps: int, width: int, height: int, device) -> np.ndarray:
    """One hybrid frame with ``taps`` anisotropic taps -> (H, W, 3) float32."""
    from vulkanraytracing_torch.config import Config, TraversalMode
    from vulkanraytracing_torch.hybrid import render_hybrid
    from vulkanraytracing_torch.scene.camera import Camera

    cfg = Config(width=width, height=height, traversal=TraversalMode.BVH_KERNEL,
                 camera=camera_config(width, height), hybrid_aniso_taps=taps,
                 parity_quantization=False)
    return render_hybrid(scene, cfg, Camera(cfg.camera).to_device(device)).cpu().numpy()


def main(argv=None) -> int:
    from vulkanraytracing_torch.app.image_io import rmse, write_png

    args = common.parser("measure_aniso", __doc__).parse_args(argv)
    device, label = common.open_device(args.device, "measure_aniso")
    scene = grazing_plane_scene(device)
    before = common.bvh8_launches()
    renders = {taps: render_taps(scene, taps, *SIZE, device) for taps in TAPS}
    launches = common.report_launches(before, "the three frames")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    for taps, img in renders.items():
        write_png(args.out_dir / f"grazing_taps{taps}.png", img)
    report = {
        "scene": "checker plane, grazing view, 256x144 hybrid",
        "rmse_trilinear_vs_aniso16": rmse(renders[1], renders[16]),
        "rmse_aniso4_vs_aniso16": rmse(renders[4], renders[16]),
        "rmse_trilinear_vs_aniso4": rmse(renders[1], renders[4]),
        "gate": 1e-3,
    }
    report["trilinear_breaks_gate"] = report["rmse_trilinear_vs_aniso16"] > report["gate"]
    report["aniso4_breaks_gate"] = report["rmse_aniso4_vs_aniso16"] > report["gate"]
    report["device"] = label
    report["bvh8_launches"] = launches
    common.write_report(args.out_dir / "report.json", report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
