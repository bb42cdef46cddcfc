"""The benchmark of the PyTorch and CUDA renderer (``vulkanraytracing_torch``).

    python3 -m rtbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One cell of ``BENCHMARK.json`` is a configuration (``configs/<name>.json``:
the scene, its lights and the renderer's settings) under a traffic mix
(``traffic/<name>.json``: the render mode, the camera, the resolution and
the warm-up), with the cell's output check in ``workloads/<cell>.json``
(the pixels sampled and each compared number's limit).  A run:

1. writes the cell's scene for ``--seed`` with the frozen generator
   (``scenegen.py``) as a .glb and an .hdr under ``rtbench/.cache/`` (once
   per configuration and seed; not part of the timed set-up: it stands for
   an asset already on disk), and a moving configuration's mesh as a .glb
   of its own;
2. set-up, timed from here to the first measured frame (``setup_s``): the
   program is imported and loads the files (``scene.gltf.load_scene``,
   ``app.hdr.read_hdr``).  A static scene: the program builds its SAH tree
   and the BVH8 collapse.  A moving one (``scene.instances``, ``motion.py``):
   ``accel.tlas.make_instances`` makes the hall instance 0 and the mesh
   instances 1 to count, and ``Engine(..., instances=, animation=)`` builds
   its two-level tree on the device (the stage ``tlas_build``).  Then the
   IBL is baked where the mode needs it, the ``Engine`` made, the mode
   selected by the T key as a user does, the warm-up frames drawn (the
   first builds the kernel library) and the accumulation reset (the R key);
3. the window: ``Engine.draw()`` and ``torch.cuda.synchronize()`` in a
   closed loop until ``--seconds`` have passed; the frame that ends past
   the deadline closes it;
4. with ``--trace 1`` the probes' passes (``probes.py``) on further frames
   of the same Engine, for the per-layer metrics;
5. the check: the program's image is copied to the host and the program
   freed, then the plain reference (``reference/``, which imports nothing
   of the program) renders a sample of pixels drawn from the seed, from
   the same files, with its own tree and its own IBL, over the frames the
   program has accumulated since its last reset.  The harness counts every
   ``draw`` it makes (warm-up, window, traced passes): the accumulation
   restarts at the R key and at each frame whose transforms differ from
   the frame before, and its frames take the sample indices 0, 1, ...; a
   moving scene's triangles are those of the last frame drawn.  Each
   compared number is held to its limit in the workload file (a moving
   scene's: ``px_off`` alone, ``load_cell``).

Each metric is a reader in ``metrics/<name>.py``, found by its name in
``BENCHMARK.json``: the end-to-end ones with ``--trace 0``, the per-layer
ones with ``--trace 1``, each in the cells its entry lists.  The last
stdout line is the result as one JSON object; the compared numbers are
also the last lines on stderr.  Without a card, or with fewer cards than
the cell asks for, the run prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from rtbench import motion, scenegen

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
CACHE = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "vulkanraytracing_tpu")
# what a traffic mix and a cell's file may set: anything else would be
# ignored, so it is refused
TRAFFIC_KEYS = {"mode", "resolution", "camera", "warmup_frames", "trace", "check"}
CAMERA_KEYS = {"position", "target"}  # a static camera
MODES = ("path_tracing", "hybrid")


class Run:
    """What a run measured, handed to each metric's reader."""

    def __init__(self, cell: dict, workload: dict, config: dict, seed: int):
        self.cell, self.workload, self.config, self.seed = cell, workload, config, seed
        self.frame_s: list[float] = []
        self.window_s = self.setup_s = 0.0
        self.window_rays = None       # rays the integrator counted in the window
        self.setup_stages: dict[str, float] = {}
        self.device_profile = None    # probes.profile_device
        self.ranges = None            # probes.profile_ranges
        self.records = None           # probes.record_calls, over one frame
        self.program_scene = None
        self.files = None             # (scene.glb, sky.hdr)
        self.mesh_file = None         # a moving configuration's mesh.glb
        self.instance_materials = None  # the hall's glTF material of instances 1 to count
        self.device = None
        self.setup_start = 0.0
        self.draws = 0                # every Engine.draw() the harness made
        self.reset_at = 0             # draws made before the R key
        self.instances = config["scene"].get("instances")
        self.animation = None if self.instances is None else motion.animation(self.instances)
        self._hall = None             # the reference's static parts
        self._reference = None        # (animation index, scene, trees)

    @property
    def moving(self) -> bool:
        return self.instances is not None

    def accumulated(self) -> tuple[int, int]:
        """(animation index of the last frame drawn, frames the program
        has accumulated since its last reset), from the harness's own count
        of draws: the R key restarts the accumulation, and so does each
        frame whose transforms differ from the frame before."""
        last, first = self.draws - 1, self.reset_at
        if self.animation is not None:
            for k in range(last, first, -1):
                if not np.array_equal(self.animation(k), self.animation(k - 1)):
                    first = k
                    break
        return last, self.draws - first

    def reference(self, frame: int = 0):
        """(reference scene, its trees) at animation index ``frame``, built
        once a frame, on the run's device."""
        from rtbench.reference import assets, render

        if self._hall is None:
            sun = self.config["sun"]
            hall = assets.load(*self.files, sun["direction"], sun["color"][:3], self.device)
            mesh = assets.load_mesh(self.mesh_file, self.device) if self.moving else None
            self._hall = (hall, mesh)
        frame = frame if self.moving else 0
        if self._reference is None or self._reference[0] != frame:
            scene, mesh = self._hall
            if self.moving:
                scene = assets.place(scene, mesh, self.animation(frame),
                                     self.instance_materials)
            self._reference = (frame, scene, render.build_trees(scene))
        return self._reference[1:]


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries that ``cell`` reports with or without tracing."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def readers(root: Path, entries: list[dict]) -> dict:
    return {m["name"]: load_module(root / "metrics" / f"{m['name']}.py") for m in entries}


def render_config(cfg: dict, wl: dict):
    """The program's ``Config`` for the cell."""
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode

    r = cfg["render"]
    w, h = wl["resolution"]
    cam = wl["camera"]
    return Config(
        width=w, height=h, traversal=TraversalMode(r["traversal"]),
        min_bounce_count=r["min_bounces"], max_bounce_count=r["max_bounces"],
        rr_min_threshold=r["rr_min"], parity_quantization=r["rgba8_accumulation"],
        tone_map_before_accumulation=r["tone_map_before_accumulation"],
        point_light_radius=r["point_light_radius"], alpha_visibility=r["alpha_test"],
        reverse_depth=r["reverse_depth"], irradiance_size=r["ibl"]["irradiance_size"],
        reflection_size=r["ibl"]["reflection_size"], brdf_lut_size=r["ibl"]["brdf_lut_size"],
        ray_chunk_size=r["ray_chunk_size"], hybrid_aniso_taps=r["aniso_taps"],
        camera=CameraConfig(position=tuple(cam["position"]), target=tuple(cam["target"]),
                            aspect_ratio=w / h),
    )


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def draw(run: Run, engine, device) -> None:
    """One frame, waited for, and counted."""
    engine.draw()
    sync(device)
    run.draws += 1


def set_up(run: Run, device) -> object:
    """Everything before the first measured frame; returns the Engine."""
    import torch

    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.accel.tlas import make_instances
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.app.events import Key
    from vulkanraytracing_torch.app.hdr import read_hdr
    from vulkanraytracing_torch.scene.gltf import load_scene
    from vulkanraytracing_torch.scene.types import DirectLight, make_environment

    cfg, wl = run.config, run.workload
    rcfg = render_config(cfg, wl)
    glb, hdr = run.files

    def stage(name, fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        run.setup_stages[name] = time.perf_counter() - t0
        return out

    def load():
        scene, _, _ = load_scene(glb, device=device)
        pano = torch.from_numpy(read_hdr(hdr)).to(device)
        sun = cfg["sun"]
        light = DirectLight(
            direction=torch.tensor([*sun["direction"], 0.0], dtype=torch.float32, device=device),
            color=torch.tensor(sun["color"], dtype=torch.float32, device=device))
        scene = scene._replace(environment=make_environment(pano), direct_light=light)
        mesh = load_scene(run.mesh_file, device=device)[0].geometry if run.moving else None
        return scene, mesh

    scene, mesh = stage("scene_load", load)
    if not run.moving:
        scene = stage("bvh_build", lambda: build_scene_bvh(scene, builder="sah"))
    if wl["mode"] == "hybrid":
        from vulkanraytracing_torch.env.ibl import bake_ibl

        scene = scene._replace(environment=stage("ibl_bake", lambda: bake_ibl(
            scene.environment, rcfg.irradiance_size, rcfg.reflection_size,
            rcfg.brdf_lut_size)))
    if run.moving:
        # the mesh file's one material is 0: each instance's offset is the
        # hall material it takes
        offsets = [0] + run.instance_materials
        engine = stage("tlas_build", lambda: Engine(
            rcfg, scene, instances=make_instances([scene.geometry, mesh],
                                                  [0] + [1] * (len(offsets) - 1), offsets),
            animation=run.animation, device=device))
    else:
        engine = Engine(rcfg, scene, device=device)
    if wl["mode"] == "hybrid":
        engine.inject_key(Key.T)
    for _ in range(wl["warmup_frames"]):
        draw(run, engine, device)
    engine.inject_key(Key.R)
    run.reset_at = run.draws
    run.program_scene = engine.scene
    return engine


def measure(run: Run, engine, seconds: float, device) -> None:
    """The window: closed-loop frames until ``seconds`` have passed."""
    rays0 = engine.total_rays
    t_win = time.perf_counter()
    run.setup_s = t_win - run.setup_start
    while True:
        t0 = time.perf_counter()
        draw(run, engine, device)
        t1 = time.perf_counter()
        run.frame_s.append(t1 - t0)
        if t1 - t_win >= seconds:
            break
    run.window_s = t1 - t_win
    if run.workload["mode"] == "path_tracing":
        run.window_rays = engine.total_rays - rays0


def traced_passes(run: Run, engine, metric_modules: dict, device) -> None:
    """The probes' passes that the cell's per-layer metrics ask for."""
    from rtbench import probes

    def frame():
        draw(run, engine, device)

    record = {}
    for module in metric_modules.values():
        record.update(getattr(module, "RECORD", {}))
    run.device_profile = probes.profile_device(frame, run.workload["trace"]["profiled_frames"])
    run.ranges = probes.profile_ranges(frame)
    if record:
        run.records = probes.record_calls(frame, record)


def kernel_label(name: str) -> str:
    """A device operation's name up to its argument list (the template
    says what it does), at most 200 characters."""
    return name.replace("(anonymous namespace)", "{anonymous}").split("(")[0][:200]


def breakdown(run: Run) -> dict:
    """The device operations that took most time in the device profile,
    and the longest idle gaps of the ranges' frame by the innermost host
    operation open at each gap's start."""
    from rtbench.yardstick import idle_gaps

    per_name: dict[str, float] = {}
    for name, s, e in run.device_profile["events"]:
        per_name[name] = per_name.get(name, 0.0) + (e - s) * 1e-6
    ops = [(kernel_label(n), v) for n, v in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]]
    dev = [(s, e) for _, s, e in run.ranges["device"]]
    host = run.ranges["host"]
    gaps = []
    if dev:
        lo = min(h["start"] for h in host) if host else min(s for s, _ in dev)
        for s, e in idle_gaps(dev, lo, max(e for _, e in dev)):
            open_ops = [h for h in host if h["start"] <= s < h["end"]]
            inner = min(open_ops, key=lambda h: h["end"] - h["start"])["name"] if open_ops \
                else "host idle"
            gaps.append((inner, (e - s) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps[:10]]}


def load_cell(bench: dict, name: str, root: Path = ROOT, overrides: dict | None = None):
    """(cell entry, workload, configuration) of cell ``name``: its traffic
    mix with its own file over it, and its configuration's file;
    ``overrides`` ({"workload": ..., "config": ...}) shrink them for the
    CPU tests, or add a moving scene (``scene.instances``, ``motion.py``).
    A moving scene is checked by ``px_off`` alone: at one sample a frame a
    path that a rounding sends another way shows whole, and ``mean_off``
    reads such paths about as high as it reads the control."""
    cell = next(c for c in bench["workloads"] if c["name"] == name)
    workload = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    workload.update(json.loads((root / "workloads" / f"{name}.json").read_text()))
    config = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
    for part, changes in (overrides or {}).items():
        _merge({"workload": workload, "config": config}[part], changes)
    unread = sorted((set(workload) - TRAFFIC_KEYS) | (set(workload["camera"]) - CAMERA_KEYS))
    instances = config["scene"].get("instances")
    if instances is not None:
        unread += [f"instances.{k}" for k in motion.unread_keys(instances)]
        if workload["mode"] == "hybrid":
            unread.append("instances under the hybrid mode")
        if "mean_off" in workload["check"]["limits"]:
            unread.append("mean_off under motion")
    if unread or workload["mode"] not in MODES:
        raise ValueError(f"cell {name}: the harness does not implement "
                         f"{unread or workload['mode']!r}")
    return cell, workload, config


def scene_files(run: Run, cache: Path = CACHE):
    """The run's (scene.glb, sky.hdr); where the scene moves, also its
    mesh.glb (``run.mesh_file``) and the hall's glTF material of each
    instance (``run.instance_materials``), which both sides take as input."""
    sc = run.config["scene"]
    files = scenegen.scene_files(cache, sc["kind"], sc["triangles"], run.seed)
    if run.moving:
        run.mesh_file = scenegen.mesh_file(cache, run.instances["mesh"])
        run.instance_materials = scenegen.material_indices(
            files[0], motion.materials(run.instances))
    return files


def sample_pixels(run: Run, device):
    """The checked pixels (x, y), drawn from the seed without repeats."""
    import numpy as np
    import torch

    w, h = run.workload["resolution"]
    rng = np.random.default_rng(run.seed)
    n = min(run.workload["check"]["pixels"], w * h)
    flat = torch.from_numpy(rng.choice(w * h, size=n, replace=False)).to(device)
    return flat % w, flat // w


def check(run: Run, image, device) -> dict:
    """The reference at a sample of pixels against the program's image,
    over the frames accumulated since the last reset, at the last frame's
    animation index: {name: (value, limit)}."""
    px, py = sample_pixels(run, device)
    frame, frames = run.accumulated()
    ref = reference_pixels(run, px, py, frames, device, low=False, frame=frame)
    return compare(image.to(device)[py, px], ref, run.workload["check"]["limits"])


def reference_pixels(run: Run, px, py, frames: int, device, low: bool, frame: int = 0):
    """The reference's image at pixels (px, py) after ``frames`` frames
    (sample indices 0 to frames - 1) of the scene at animation index
    ``frame``."""
    from rtbench.reference import render

    wl, cfg = run.workload, run.config
    w, h = wl["resolution"]
    scene, trees = run.reference(frame)
    cam = render.camera(wl["camera"]["position"], wl["camera"]["target"], w, h, device)
    r = cfg["render"]
    rcfg = {"max_bounces": r["max_bounces"], "min_bounces": r["min_bounces"],
            "rr_min": r["rr_min"], "point_light_radius": r["point_light_radius"],
            "aniso_taps": r["aniso_taps"]}
    if wl["mode"] == "hybrid":
        ibl_cfg = cfg["render"]["ibl"]
        ibl = render.bake_ibl(scene.panorama, ibl_cfg["irradiance_size"],
                              ibl_cfg["reflection_size"], ibl_cfg["brdf_lut_size"])
        return render.hybrid_pixels(scene, trees, rcfg, cam, ibl, px, py, w, h, low)
    return render.path_pixels(scene, trees, rcfg, cam, px, py, frames, w, h, low)


def compare(got, ref, limits: dict) -> dict:
    """The compared numbers, in 8-bit levels (1/255) of the display image:
    ``px_off`` the share of sampled pixels with a channel more than half a
    level off (in an RGBA8 image: off at all), ``mean_off`` the mean
    channel difference in levels.  A channel that is not finite counts as
    255 levels off."""
    import torch

    diff = (got.float() - ref.float()).abs() * 255.0
    diff = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, 255.0))
    values = {"px_off": float((diff.amax(dim=-1) > 0.5).float().mean()),
              "mean_off": float(diff.mean())}
    return {k: (values[k], limits[k]) for k in limits}


def _merge(into: dict, changes: dict) -> None:
    """``changes`` into ``into``, group by group; a value of None takes
    the key out."""
    for key, value in changes.items():
        if value is None:
            into.pop(key, None)
        elif isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = value


def log(text: str) -> None:
    print(f"[rtbench] {text}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, cache: Path = CACHE, overrides: dict | None = None) -> dict:
    """One run of cell ``name`` on ``device``; returns the result object."""
    import torch

    run = Run(*load_cell(bench, name, root, overrides), seed)
    run.device = device
    e2e = cell_metrics(bench, name, False)
    layer = cell_metrics(bench, name, True)
    modules = readers(root, layer if trace else e2e)
    t0 = time.perf_counter()
    run.files = scene_files(run, cache)
    log(f"scene files {time.perf_counter() - t0:.2f} s: {run.files[0]}")

    run.setup_start = time.perf_counter()
    engine = set_up(run, device)
    measure(run, engine, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"set-up {run.setup_s:.3f} s {run.setup_stages}; window {run.window_s:.3f} s, "
        f"{len(run.frame_s)} frames")
    if trace:
        t0 = time.perf_counter()
        traced_passes(run, engine, modules, device)
        log(f"traced passes {time.perf_counter() - t0:.2f} s")
    metrics = {}
    units = {m["name"]: m["unit"] for m in (layer if trace else e2e)}
    for metric, module in modules.items():
        t0 = time.perf_counter()
        value = module.read(run)
        log(f"metric {metric}: {value!r} ({time.perf_counter() - t0:.2f} s)")
        if value is not None:
            metrics[metric] = {"value": value, "unit": units[metric]}
    out_breakdown = breakdown(run) if trace else None
    run.records = None

    image = engine.state.accumulation.detach().to("cpu")
    attempted = len(run.frame_s)
    run.program_scene = None
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(run, image, device)
    frame, frames = run.accumulated()
    log(f"reference over {frames} frame(s) at animation index {frame}: "
        f"{time.perf_counter() - t0:.2f} s")
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        from rtbench.yardstick import busy_union

        prof = run.device_profile
        busy_us = busy_union([(s, e) for _, s, e in prof["events"]])
        device_info["busy_s"] = busy_us * 1e-6
        device_info["window_s"] = prof["wall_s"]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": attempted, "failed": 0, "metrics": metrics, "device": device_info}
    if out_breakdown is not None:
        result["breakdown"] = out_breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtbench", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # compile caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"rtbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"rtbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("vulkanraytracing_torch") is None:
        print("rtbench: the program (vulkanraytracing_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
