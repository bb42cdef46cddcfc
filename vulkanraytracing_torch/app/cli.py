"""Command-line interface: render / view / bench / compare.

Counterpart of ``vulkanraytracing_tpu/app/cli.py``, with the same flags
and one more, ``--device`` (the card unless ``--device cpu``; asking for
the card where there is none fails).  ``render`` takes a glTF/GLB path or
a procedural scene's name and an optional HDR panorama (``--env``), from
which the sun is extracted; ``--mode hybrid`` bakes the IBL and draws one
hybrid frame, ``--mode pt`` accumulates ``--spp`` path-traced frames.
The default traversal is ``TraversalMode.BVH_KERNEL`` over an SAH tree,
``--brute`` the brute-force oracle.  ``compare`` prints the RMSE of two
images (PNG or .npy), the parity metric.  ``--devices N`` shards the
path-traced frame's pixel rows over N devices (``parallel``): the first N
cards, or with ``--device cpu`` N shards on the host (the JAX package's
``VRT_NUM_CPU_DEVICES``); the image equals one device's bit for bit.
``render --profile DIR`` writes a ``torch.profiler`` Chrome trace of the
set-up and the frames into DIR, with the port's ``vrt.*`` spans over the
operators and kernels.  ``bench`` runs ``vulkanraytracing_torch.bench``
(Mrays/s of the 1080p Sponza-like frame, one JSON line) with the same
``--devices`` and ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from vulkanraytracing_torch import bench
from vulkanraytracing_torch.app.engine import Engine


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda, but no CUDA device is available "
                         "(--device cpu runs on the host)")
    return device


def _make_mesh(args, device: torch.device):
    """--devices N -> the shard devices (None for one device): the first N
    cards for ``--device cuda``, N host shards for ``--device cpu``.  The
    height must divide over N (each shard takes whole row blocks)."""
    from vulkanraytracing_torch.parallel import make_render_mesh

    n = args.devices
    if n <= 1:
        return None
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise SystemExit(f"error: --devices {n} but only {have} available")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [device] * n
    if args.height % n:
        raise SystemExit(f"error: --height {args.height} must be divisible by --devices {n}")
    return make_render_mesh(devices)


def _attach_environment(scene, args):
    """The ``--env`` panorama with its extracted sun; the IBL bake for
    ``--mode hybrid``."""
    from vulkanraytracing_torch.utils import ScopeTime

    if args.env:
        from vulkanraytracing_torch.app.hdr import read_hdr
        from vulkanraytracing_torch.env.sun import extract_direct_light
        from vulkanraytracing_torch.scene.types import make_environment

        pano = torch.from_numpy(read_hdr(args.env)).to(scene.geometry.v0.device)
        scene = scene._replace(environment=make_environment(pano),
                               direct_light=extract_direct_light(pano))
    if args.mode == "hybrid":
        from vulkanraytracing_torch.env.ibl import bake_ibl

        with ScopeTime("IBL bake"):
            scene = scene._replace(environment=bake_ibl(scene.environment))
    return scene


def _build_scene(args, device):
    """(scene, camera config or None, (soup, animation) or None); the
    animated demo's instances are built and refitted by the Engine."""
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.config import CameraConfig
    from vulkanraytracing_torch.scene import procedural

    aspect = args.width / args.height
    camera_cfg = None
    if args.scene == "animated":
        scene, soup, anim = procedural.animated_instances_demo(device=device)
        camera_cfg = CameraConfig(position=(0.0, 4.0, 10.0), target=(0.0, 1.0, 0.0),
                                  aspect_ratio=aspect)
        return _attach_environment(scene, args), camera_cfg, (soup, anim)
    if args.scene in ("cornell", "triangle", "sponza_like"):
        scene = {
            "cornell": procedural.cornell_box_scene,
            "triangle": procedural.single_triangle_scene,
            "sponza_like": procedural.sponza_like_scene,
        }[args.scene](device=device)
        if args.scene == "cornell":
            camera_cfg = CameraConfig(position=(0.0, 0.0, 3.2), aspect_ratio=aspect,
                                      x_fov=float(np.radians(60.0)))
        elif args.scene == "sponza_like":
            camera_cfg = CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                      aspect_ratio=aspect)
    else:
        if not Path(args.scene).exists():
            raise SystemExit(
                f"error: scene '{args.scene}' not found (expected a glTF/GLB path or one "
                "of: cornell, triangle, sponza_like, animated)")
        from vulkanraytracing_torch.scene.gltf import load_scene

        scene, camera_cfg, _pool = load_scene(args.scene, device=device)

    scene = _attach_environment(scene, args)
    if not args.brute:
        scene = build_scene_bvh(scene, builder="sah")
    return scene, camera_cfg, None


def _scene_needs_alpha(scene) -> bool:
    """Does any triangle of a textured scene carry the alpha-test flag?"""
    return scene.textures is not None and bool(scene.geometry.alpha_test.any())


def _engine(args, **cfg_kw) -> Engine:
    from vulkanraytracing_torch.config import Config, RenderMode, TraversalMode
    from vulkanraytracing_torch.scene.camera import Camera

    device = _device(args)
    mesh = _make_mesh(args, device)
    scene, camera_cfg, animation = _build_scene(args, device)
    cfg = Config(
        width=args.width,
        height=args.height,
        render_mode=RenderMode.HYBRID if args.mode == "hybrid" else RenderMode.PATH_TRACING,
        traversal=TraversalMode.BRUTE_FORCE if args.brute else TraversalMode.BVH_KERNEL,
        alpha_visibility=_scene_needs_alpha(scene),
        **cfg_kw,
    )
    if camera_cfg is not None:
        cfg = cfg.replace(camera=camera_cfg)
    return Engine(
        cfg, scene, Camera(cfg.camera),
        instances=animation[0] if animation else None,
        animation=animation[1] if animation else None,
        mesh=mesh,
        device=device,
    )


def cmd_render(args) -> int:
    from vulkanraytracing_torch.app.image_io import write_png, write_radiance_npy
    from vulkanraytracing_torch.utils import ScopeTime, log_i
    from vulkanraytracing_torch.utils.profiling import profile_to

    # --profile: one trace of the set-up and the frames, with the vrt.* spans
    with profile_to(args.profile) if args.profile else contextlib.nullcontext():
        engine = _engine(args, parity_quantization=not args.hdr_accumulation,
                         tone_map_before_accumulation=not args.hdr_accumulation)
        if args.resume:
            engine.load_checkpoint(args.resume)
            log_i(f"resumed at spp {int(engine.state.accum_index)}")

        frames = 1 if args.mode == "hybrid" else args.spp
        with ScopeTime(f"render {frames} frame(s)"):
            engine.run(frames)

    for line in engine.hud_lines():
        log_i(line)
    if args.checkpoint:
        engine.save_checkpoint(args.checkpoint)
    if args.out.endswith(".npy"):
        write_radiance_npy(args.out, engine.state.accumulation.cpu().numpy())
    else:
        write_png(args.out, engine.display_image())
    log_i(f"wrote {args.out} ({args.width}x{args.height}, "
          f"{engine.total_rays / 1e6:.1f} Mrays)")
    return 0


def cmd_view(args) -> int:
    from vulkanraytracing_torch.app.viewer import TerminalViewer

    engine = _engine(args)
    if not sys.stdin.isatty():
        print("view requires a tty (WASD fly camera, t toggles mode, q quits)",
              file=sys.stderr)
        return 1
    TerminalViewer(engine).run()
    return 0


def _read_image(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) float in [0, 1] (greyscale repeated, alpha dropped)."""
    from vulkanraytracing_torch.app.image_io import read_png

    img = read_png(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


def cmd_compare(args) -> int:
    from vulkanraytracing_torch.app.image_io import rmse

    a = np.load(args.a) if args.a.endswith(".npy") else _read_image(args.a)
    b = np.load(args.b) if args.b.endswith(".npy") else _read_image(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    value = rmse(a, b)
    print(json.dumps({"rmse": value, "passes_1e-3": value <= 1e-3}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vulkanraytracing_torch",
        description="path tracer and hybrid renderer in PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, width, height):
        p.add_argument("--scene", default="cornell",
                       help="glTF/GLB path or procedural name "
                            "(cornell, triangle, sponza_like, animated)")
        p.add_argument("--env", default=None, help="HDR panorama path")
        p.add_argument("--width", type=int, default=width)
        p.add_argument("--height", type=int, default=height)
        p.add_argument("--mode", choices=["pt", "hybrid"], default="pt")
        p.add_argument("--brute", action="store_true", help="skip the BVH")
        p.add_argument("--devices", type=int, default=1,
                       help="shard pixel rows over the first N devices (with --device "
                            "cpu: N shards on the host)")
        p.add_argument("--device", default="cuda",
                       help="torch device to render on (default: the card)")

    render = sub.add_parser("render", help="render a scene to an image")
    common(render, 1280, 720)
    render.add_argument("--out", default="out.png")
    render.add_argument("--spp", type=int, default=16)
    render.add_argument(
        "--hdr-accumulation", action="store_true",
        help="accumulate linear HDR instead of the reference's tone-mapped RGBA8")
    render.add_argument("--checkpoint", default=None, help="save render state")
    render.add_argument("--resume", default=None, help="resume render state")
    render.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a Chrome trace of the set-up and the frames into DIR")
    render.set_defaults(fn=cmd_render)

    view = sub.add_parser("view", help="interactive terminal viewer (WASD fly camera)")
    common(view, 256, 144)
    view.set_defaults(fn=cmd_view)

    b = sub.add_parser("bench", help="run the Mrays/s benchmark (one JSON line)")
    bench.add_arguments(b)
    b.set_defaults(fn=bench.run)

    cmp_ = sub.add_parser("compare", help="image RMSE (parity metric)")
    cmp_.add_argument("a")
    cmp_.add_argument("b")
    cmp_.set_defaults(fn=cmd_compare)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
