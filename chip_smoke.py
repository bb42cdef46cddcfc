#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--save-dir DIR]

Run from the repository root.  Phases, each printing its result:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the four traversal kernels (BVH8, BVH2, subpacket and shared
   cursor; nvcc, sm_90a) and the native BVH builders, from the sources in
   the checkout, all at once; ptxas's registers, stack, spills and shared
   memory of each kernel specialization, and the widths of the per-ray
   kernels' loads as the machine code has them;
3. kernel against plain version: a 20,000-triangle soup and the v1 hall,
   65,536 camera and random rays each (some with t_max = 0), closest hit
   with culling on and off and any-hit; then the same comparison at the
   shapes the 1080p frame gives the kernels (its primary rays, and its
   point-light plus sun shadow rays); every field bit for bit, each kernel
   run twice (as in phase 6);
4. the slice: a 64x64 Cornell box, 4 frames, BVH8 kernel against brute
   force;
5. the main path: the v1 scene (262,144-triangle target), SAH build and
   BVH8 collapse, then 3 frames of ``render_frame`` at 1920x1080 with 4
   bounces, with per-frame time, rays, Mrays/s and kernel launch counts;
   then one more frame under ``torch.profiler``: the device's busy time,
   its idle share of the frame's wall time and the costliest kernels; then
   one more frame with the arguments of every traversal launch recorded,
   and each recorded launch replayed alone: kernel ms, live rays, the plain
   version's box and triangle tests for these rays, the bound they give,
   kernel = plain version in every field;
6. BVH2 kernel against plain version: the 20,000-triangle soup as an LBVH
   with no collapse (camera and random rays as in phase 3), then the
   dynamic frame's shapes (its primary rays with culling on and off, its
   bounce-0 shadow rays);
7. the dynamic path through ``Engine``: the v1 hall as instance 0 plus 64
   orbiting spheres (327,436 triangles), TLAS build on the device, then
   5 frames at 1920x1080 with 4 bounces (the build frame and 4 moving
   frames, each refitting the TLAS and resetting the accumulation) with
   refit ms (CUDA events around the Engine's refit, no synchronization
   inside the frame), frame ms, rays, Mrays/s and the launches of all
   four kernel specializations, one static frame that accumulates, the
   refitted image against a frame over a from-scratch LBVH build
   (bit-equal), the peak device memory, one profiled moving frame and one
   recorded moving frame replayed launch by launch as in phase 5;
8. the packet kernels (subpacket, shared cursor) on the 2-wide arrays of
   the trees: against their plain versions on the 20,000-triangle soup as
   an LBVH and as an SAH tree (camera and random rays as in phase 3), then
   at the 1080p v1 frame's shapes, every field bit for bit, each kernel run
   twice; then 2 frames of ``render_frame`` at 1920x1080 with 4 bounces
   under each of ``TraversalMode.BVH_SUBPACKET`` and ``BVH_SHARED`` with
   per-frame time, rays, Mrays/s and the launches of every kernel, each
   mode's first frame against phase 5's first ``BVH_KERNEL`` frame (ray
   counts within 0.1%, at most 0.1% of pixels more than 1/255 apart: the
   packet kernels let the first triangle tested win an exact tie and do not
   commit a hit exactly at t_max); then one frame under ``TraversalMode.BVH``
   (the plain packet backend, which launches no kernel) with the depth cut
   to 1 bounce, held to the same gate against a ``BVH_KERNEL`` frame of
   that depth.

Each kernel's ``bound_ms`` is the larger of two times at the frame's
shapes: its bytes (each ray's 32 input bytes once, the table once, the
results once: 17 bytes a ray for closest hit, 1 for any-hit) over 3.35
TB/s, and its operations over 67 TFLOP/s (fp32 off the tensor cores).  The
operations are the slab and triangle tests that the per-ray plain version
of the same tree makes for the same rays (its ``counts``; the three 2-wide
kernels are held to the BVH2 one's), times the operations of one test
counted from the code (``BOX_OPS``, ``TRI_OPS``).  No single PyTorch call
traverses a BVH, so ``library_ms`` is null.  ``ms`` and ``bound_ms`` are
taken on the frame's primary rays and bounce-0 shadow rays; the four
per-ray entries also carry ``frame_ms``, ``frame_bound_ms`` and
``frame_launches``: the kernel's time and bound summed over the replayed
launches of one whole frame, whose later bounces are incoherent and full
of dead rays.

Any failure raises and exits non-zero.  Without a CUDA device it exits 1
before printing any result.  The second-to-last line is a JSON object
describing each kernel; the last is ``{"ok": true, "device": {...}}``.
With ``--save-dir`` the last frame of each path is written there as a
.npy image (``main_frame.npy``, ``dynamic_frame.npy``,
``subpacket_frame.npy``, ``shared_frame.npy``) and the profiled frames'
Chrome traces as ``frame_trace.json`` and ``dynamic_frame_trace.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import operator
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# each kernel's source; the TPU kernel it replaces is named on the
# source's own "// Replaces: file:line" line
SOURCES = {
    "bvh8": "vulkanraytracing_torch/csrc/bvh8_traverse.cu",
    "bvh2": "vulkanraytracing_torch/csrc/bvh2_traverse.cu",
    "subpacket": "vulkanraytracing_torch/csrc/subpacket_traverse.cu",
    "shared": "vulkanraytracing_torch/csrc/shared_traverse.cu",
}
ORBITERS = 64
BENCH_CAMERA = dict(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0))
# kernel against plain version: the tolerance is none.  Every field of
# every comparison must be equal bit for bit (both round every operation:
# the kernels are built with -fmad=false), and a second kernel run must
# equal the first
# the bound: H100 SXM peaks (NVIDIA's data sheet, at 700 W), and the
# operations of one slab test and one triangle test, counted from the code
# (csrc/traverse_common.cuh and csrc/packet_common.cuh, the same
# arithmetic).  A slab test: 6 differences, 6 products, 6 min/max per axis,
# 3 max for the entry, 3 min for the exit, 1 compare.  A triangle test: 27
# products (the two cross products, three dot products, three scalings by
# 1/det), 17 sums and differences, the reciprocal with its guard (abs,
# compare, select, divide) and 8 for the window (u + v and 7 compares)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
BOX_OPS = 25
TRI_OPS = 56
# bytes a ray reads (o, d, t_min, t_max) and writes (t, u, v, tri and the
# back face; the any-hit verdict)
RAY_IN_BYTES = 32
RAY_OUT_BYTES = {"closest": 17, "any": 1}
# the packet kernels' frames against the per-ray kernels' frame: a hit
# moves only on exact ties and at exactly t_max
FRAME_RAY_TOL = 1e-3
FRAME_PIXEL_SHARE = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def replaces(source: str) -> str:
    """The TPU kernel a kernel source names on its "// Replaces:" line."""
    for line in Path(source).read_text().splitlines():
        match = re.match(r"//\s*Replaces:\s*(\S+:\d+)", line)
        if match:
            return match.group(1)
    raise RuntimeError(f"{source} names no TPU kernel it replaces")


def ptxas_report(lib) -> list[str]:
    """Registers, stack frame, spills and static shared memory of each
    kernel specialization (its template flags as in the source: any-hit,
    culling) in a library built by ``native.build_library`` (ptxas -v, kept
    beside it)."""
    from vulkanraytracing_torch import native

    log = native.build_log(Path(lib._name)).read_text()
    rows, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(r"(?:traverse|shared|subpacket)_kernel", mangled).group(0)
            flags = re.findall(r"Lb([01])E", mangled[mangled.index(kernel):])
            name = kernel + (f"<{','.join(flags)}>" if flags else "")
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads", line)
        if spills and name:
            stack, st, ld = spills.groups()
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(f"{name}: {regs.group(1)} registers, {stack} B stack, "
                        f"spills {st} B stored / {ld} B loaded, "
                        f"{smem.group(1) if smem else 0} B shared")
            name = None
    return rows


def sass_loads(lib) -> list[str]:
    """The global loads of each kernel in a library, by width, and its
    local and shared loads and stores, counted in the machine code
    (``cuobjdump -sass``): the per-ray kernels should read their tables
    with 16-byte loads (8 bytes where only half a group is used) and only
    the ray itself with 4-byte ones.  Empty where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return []
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    rows, counts = [], None
    for line in sass.splitlines() + ["Function : end"]:
        function = re.search(r"Function : (\S+)", line)
        if function:
            if counts:
                rows.append(f"{name}: global loads " + ", ".join(
                    f"{n} x {w} B" for w, n in sorted(counts["LDG"].items()))
                    + f"; local {counts['LDL'][0]} loads / {counts['STL'][0]} stores; "
                    f"shared {counts['LDS'][0]} / {counts['STS'][0]}")
            flags = re.findall(r"Lb([01])E", function.group(1))
            name = "traverse_kernel" + (f"<{','.join(flags)}>" if flags else "")
            counts = collections.defaultdict(collections.Counter)
        op = re.search(r"\b(LDG|LDL|STL|LDS|STS)((?:\.\w+)*)", line)
        if op and counts is not None:
            width = 16 if ".128" in op.group(2) else 8 if ".64" in op.group(2) else 4
            counts[op.group(1)][width if op.group(1) == "LDG" else 0] += 1
    return rows


def bound(kind: str, n_rays: int, table, counts: dict) -> tuple[float, str]:
    """The least time the card could take for a traversal call: (ms, what
    bounds it), from the bytes it must move (the rays, the results and
    ``table``, the tensors of the table that the kernel reads) and the
    tests the per-ray plain version counted for the same rays."""
    n_bytes = (n_rays * (RAY_IN_BYTES + RAY_OUT_BYTES[kind])
               + sum(t.numel() * t.element_size() for t in table))
    ops = counts["box_tests"] * BOX_OPS + counts["tri_tests"] * TRI_OPS
    byte_ms, op_ms = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def camera_rays(width, height, camera_cfg, device):
    """Jittered primary rays of a width x height image, in tile order, and
    the valid mask of the tile padding (as the integrator makes them)."""
    from vulkanraytracing_torch.core import rng
    from vulkanraytracing_torch.pt.integrator import primary_rays
    from vulkanraytracing_torch.pt.render import tile_pixel_coords
    from vulkanraytracing_torch.scene.camera import Camera

    camera = Camera(camera_cfg).to_device(device)
    px, py, valid, _, _ = tile_pixel_coords(width, height, device=device)
    s0, s1 = rng.pixel_seed(px, py, 0)
    o, d = primary_rays(camera, px, py, width, height, s0, s1)
    return o.contiguous(), d.contiguous(), valid, camera


def random_rays(n, lo, hi, seed, device):
    gen = np.random.default_rng(seed)
    o = gen.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = gen.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def timed(fn):
    """(fn(), its milliseconds by CUDA events) for one run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(tw, table, o, d, t_min, t_max, label, culls=(True, False),
            any_hit=True, reps=20):
    """Kernel against plain version of the traversal module ``tw``
    (``ops.traverse_wide8``, ``ops.traverse_wide``, ``ops.traverse_subpacket``
    or ``ops.traverse_pallas``) for closest hit (with each culling setting
    in ``culls``) and any-hit: every field must be equal, and a second
    kernel run must equal the first.  Returns {"closest" (culling on) /
    "any": (max_abs_err, kernel_ms, plain_ms)}; the plain version runs once
    and that run is timed."""
    out = {}
    for cull in culls:
        k = tw.closest_cuda(table, o, d, t_min, t_max, cull)
        p, p_ms = timed(lambda: tw.closest_plain(table, o, d, t_min, t_max, cull))
        again = tw.closest_cuda(table, o, d, t_min, t_max, cull)
        hit = p.is_hit
        err = 0.0
        for name, a, b, c in zip(p._fields, k, p, again):
            check(torch.equal(a, b), f"{label} cull={cull}: {name} bit-equal")
            check(torch.equal(a, c), f"{label} cull={cull}: {name} alike twice")
            if name in ("t", "u", "v") and bool(hit.any()):
                err = max(err, float((a[hit] - b[hit]).abs().max()))
        k_ms = cuda_ms(lambda: tw.closest_cuda(table, o, d, t_min, t_max, cull), reps)
        print(f"  {label} closest cull={cull}: {int(hit.sum())}/{hit.numel()} hits, "
              f"equal in every field, twice (max |t,u,v diff| {err:.3g}); "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms", flush=True)
        if cull:
            out["closest"] = (err, k_ms, p_ms)
    if not any_hit:
        return out
    k = tw.any_cuda(table, o, d, t_min, t_max)
    p, p_ms = timed(lambda: tw.any_plain(table, o, d, t_min, t_max))
    check(torch.equal(k, p), f"{label} any-hit verdicts")
    check(torch.equal(k, tw.any_cuda(table, o, d, t_min, t_max)),
          f"{label} any-hit verdicts alike twice")
    k_ms = cuda_ms(lambda: tw.any_cuda(table, o, d, t_min, t_max), reps)
    print(f"  {label} any-hit: {int(k.sum())}/{k.numel()} occluded, equal, twice; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms", flush=True)
    out["any"] = (0.0, k_ms, p_ms)
    return out


def per_ray_work(tw, table, closest_rays, shadow_rays) -> dict:
    """The slab and triangle tests that the per-ray plain version of ``tw``
    (``ops.traverse_wide8`` or ``ops.traverse_wide``) makes for the frame's
    primary rays (closest hit, culling on) and its shadow rays (any-hit),
    counted in runs of their own so that no timed run counts."""
    work = {"closest": {}, "any": {}}
    tw.closest_plain(table, *closest_rays, counts=work["closest"])
    tw.any_plain(table, *shadow_rays, counts=work["any"])
    return work


def frame_gate(name, img, rays, ref_img, ref_rays) -> None:
    """A frame through a packet backend against the ``BVH_KERNEL`` frame
    from the same state: finite and lit, ray counts within
    ``FRAME_RAY_TOL``, at most ``FRAME_PIXEL_SHARE`` of the pixels more
    than 1/255 apart."""
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.0,
          f"{name} image finite and not black")
    far = ((img - ref_img).abs() > 1.0 / 255.0 + 1e-6).any(dim=-1)
    share = float(far.float().mean())
    print(f"[8 packet] {name} frame 0 against BVH_KERNEL frame 0: rays {rays} vs "
          f"{ref_rays} ({(rays - ref_rays) / ref_rays:+.2e}); {int(far.sum())} pixels "
          f"({share:.2e}) more than 1/255 apart, "
          f"{int((img != ref_img).any(dim=-1).sum())} differ at all", flush=True)
    check(abs(rays - ref_rays) <= FRAME_RAY_TOL * ref_rays,
          f"{name} ray count within {FRAME_RAY_TOL}")
    check(share <= FRAME_PIXEL_SHARE, f"{name} pixels within {FRAME_PIXEL_SHARE}")


def record_frame(render):
    """Run ``render()`` (one frame) and record the arguments of every
    traversal launch it makes, in order: ``ops.trace.trace_closest`` and
    ``trace_any`` are wrapped for this frame only.  Returns the frame's
    launches as (kind, the BVH traced, clones of o, d, t_min, t_max, the
    culling flag)."""
    from vulkanraytracing_torch.ops import trace

    calls = []
    closest, blocked = trace.trace_closest, trace.trace_any

    def record_closest(scene, cfg, o, d, t_min, t_max, cull_backface=True):
        calls.append(("closest", scene.bvh,
                      tuple(x.clone() for x in (o, d, t_min, t_max)), cull_backface))
        return closest(scene, cfg, o, d, t_min, t_max, cull_backface=cull_backface)

    def record_any(scene, cfg, o, d, t_min, t_max):
        calls.append(("any", scene.bvh,
                      tuple(x.clone() for x in (o, d, t_min, t_max)), False))
        return blocked(scene, cfg, o, d, t_min, t_max)

    trace.trace_closest, trace.trace_any = record_closest, record_any
    try:
        render()
        torch.cuda.synchronize()
    finally:
        trace.trace_closest, trace.trace_any = closest, blocked
    return calls


def replay(tw, get_table, table_tensors, calls, label) -> dict:
    """Each recorded launch of a frame (``record_frame``) alone, through
    the per-ray traversal module ``tw`` over ``get_table(bvh)``: the
    kernel's ms (CUDA events, mean of 5), the live rays (t_min <= t_max),
    the box and triangle tests the plain version makes for these rays, the
    bound they give (``table_tensors(table)``: the tensors the kernel
    reads), and the kernel held to the plain version in every field.  Prints one line per launch
    and returns {"closest" / "any": (summed kernel ms, summed bound ms,
    launches)}."""
    totals = {"closest": [0.0, 0.0, 0], "any": [0.0, 0.0, 0]}
    t0 = time.perf_counter()
    for i, (kind, bvh, rays, cull) in enumerate(calls):
        table = get_table(bvh)
        counts = {}
        if kind == "closest":
            k = tw.closest_cuda(table, *rays, cull)
            p = tw.closest_plain(table, *rays, cull, counts=counts)
            equal = all(torch.equal(a, b) for a, b in zip(k, p))
            ms = cuda_ms(lambda: tw.closest_cuda(table, *rays, cull), 5)
        else:
            k = tw.any_cuda(table, *rays)
            p = tw.any_plain(table, *rays, counts=counts)
            equal = torch.equal(k, p)
            ms = cuda_ms(lambda: tw.any_cuda(table, *rays), 5)
        check(equal, f"{label} launch {i} ({kind}): kernel equals plain version")
        n = rays[0].shape[0]
        live = int((rays[2] <= rays[3]).sum())
        bound_ms, by = bound(kind, n, table_tensors(table), counts)
        print(f"{label} launch {i} {kind}: {n} rays, {live} live; kernel {ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({by}); {counts['box_tests']} box and "
              f"{counts['tri_tests']} triangle tests; equal in every field", flush=True)
        tot = totals[kind]
        tot[0] += ms
        tot[1] += bound_ms
        tot[2] += 1
    print(f"{label} frame: " + "; ".join(
        f"{kind} {ms:.3f} ms over {n} launches against a bound of {b:.4f} ms"
        for kind, (ms, b, n) in totals.items())
        + f"; replayed in {time.perf_counter() - t0:.1f} s", flush=True)
    return {kind: tuple(v) for kind, v in totals.items()}


def launch_counts(kernels) -> dict:
    """Launches so far of every kernel specialization, by JSON name."""
    return {f"{name}_{kind}": module.LAUNCHES[key]
            for name, (module, keys) in kernels.items()
            for kind, key in zip(("closest", "any"), keys)}


def main_path_rays(scene, device, tw, table):
    """The 1080p frame's primary rays (closest hit) and its bounce-0 shadow
    rays toward a point light and the sun (any-hit), at the frame's shapes:
    R = 2,088,960 tile-ordered rays and 2R shadow rays.  The primary hits
    come from the kernel of ``tw`` over ``table``."""
    from vulkanraytracing_torch.config import CameraConfig
    from vulkanraytracing_torch.core import math3d
    from vulkanraytracing_torch.ops.intersect import fetch_surface_attributes

    cam_cfg = CameraConfig(**BENCH_CAMERA, aspect_ratio=1920 / 1080)
    o, d, valid, camera = camera_rays(1920, 1080, cam_cfg, device)
    r = o.shape[0]
    t_min = torch.full((r,), camera.z_near, device=device)
    t_max = torch.where(valid, camera.z_far, 0.0)
    hit = tw.closest_cuda(table, o, d, t_min, t_max)
    alive = hit.is_hit
    p = o + d * torch.where(alive, hit.t, 0.0)[:, None]
    n = fetch_surface_attributes(scene.geometry, hit).normal
    origin = p + n * math3d.BIAS
    light = scene.point_lights.position[torch.arange(r, device=device) % 4, :3]
    delta = light - origin
    dist = math3d.length(delta)
    sun = math3d.normalize(-scene.direct_light.direction[:3]).expand(r, 3)
    so = torch.cat([origin, origin])
    sd = torch.cat([math3d.normalize(delta), sun]).contiguous()
    s_min = torch.full((2 * r,), math3d.RAY_MIN_T, device=device)
    s_max = torch.cat([torch.where(alive, dist, 0.0),
                       torch.where(alive, math3d.RAY_MAX_T, 0.0)])
    return (o, d, t_min, t_max), (so, sd, s_min, s_max)


def instanced_hall(device):
    """The dynamic path's scene, from the public API: the v1 hall
    (261,900 triangles, identity transform) as instance 0 and a 1,024-
    triangle sphere as instances 1-64 with materials 3 and 4 (the v1
    clutter materials), moved by ``animated_instances_demo``'s orbits, the
    hall in the slot of the demo's ground quad.  Returns (the hall scene:
    materials, sun, 4 point lights, environment; the soup; the
    animation)."""
    from vulkanraytracing_torch.accel.tlas import make_instances
    from vulkanraytracing_torch.scene.procedural import (
        animated_instances_demo, generate_sphere, sponza_like_scene,
    )
    from vulkanraytracing_torch.scene.types import make_trace_geometry

    hall = sponza_like_scene(262144, workload="v1", device=device)
    sphere = make_trace_geometry(*generate_sphere(0.6), material_id=3, device=device)
    soup = make_instances([hall.geometry, sphere], [0] + [1] * ORBITERS,
                          material_offsets=[0] + [i % 2 for i in range(ORBITERS)])
    _, _, animation = animated_instances_demo(orbiters=ORBITERS, device=device)
    return hall, soup, animation


def profile_frame(render, untraced_ms, save_dir, trace_name="frame_trace.json"):
    """Run ``render()`` (one frame) under ``torch.profiler`` and print the
    device's busy time (the union of its kernel and copy intervals), its
    idle share of the traced frame's wall time and of ``untraced_ms`` (the
    mean untraced frame), and the kernels that take the most device time.
    With ``save_dir`` the Chrome trace is written there.  Only device
    activity is traced, and a first traced frame is thrown away, so that
    the tracer's start-up does not land in the measured frame; the tracing
    that remains still lengthens the frame, which the two shares show."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        render()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(device) > 0, "profile: the trace holds device activity")
    busy_us, end = 0.0, -math.inf
    for e in sorted(device, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy_us += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        per_name[e.name][0] += e.time_range.elapsed_us()
        per_name[e.name][1] += 1
    busy_ms = busy_us / 1e3
    print(f"[profile] traced frame {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"in {len(device)} device ops, idle share {1.0 - busy_ms / wall_ms:.4f} "
          f"(of the untraced frames' {untraced_ms:.2f} ms: "
          f"{1.0 - busy_ms / untraced_ms:.4f})", flush=True)
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {us / 1e3:9.3f} ms {n:5d}x  {name[:110]}", flush=True)
    if save_dir is not None:
        prof.export_chrome_trace(str(save_dir / trace_name))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-dir", type=Path, default=None)
    args = parser.parse_args()

    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port itself; without it (the script alone) this raises before
    # any result is printed
    from vulkanraytracing_torch.accel import bvh8, sah, tlas
    from vulkanraytracing_torch.accel.lbvh import build_bvh, build_scene_bvh
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
    from vulkanraytracing_torch.ops import traverse_pallas as tpal
    from vulkanraytracing_torch.ops import traverse_subpacket as tsub
    from vulkanraytracing_torch.ops import traverse_wide as tw2
    from vulkanraytracing_torch.ops import traverse_wide8 as tw
    from vulkanraytracing_torch.pt.render import (
        create_render_state, render_frame, render_progressive,
    )
    from vulkanraytracing_torch.scene.camera import Camera
    from vulkanraytracing_torch.scene.procedural import (
        cornell_box_scene, sponza_like_scene, triangle_soup_scene,
    )

    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {card}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[1 device] nvidia-smi: {smi}", flush=True)

    # each kernel: its module and its LAUNCHES keys (closest, any-hit)
    kernels = {"bvh8": (tw, ("closest", "any")), "bvh2": (tw2, ("closest2", "any2")),
               "subpacket": (tsub, ("closest", "any")), "shared": (tpal, ("closest", "any"))}

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    builds = [m.cuda_library for m, _ in kernels.values()] + [sah._library, bvh8._library]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = [future.result() for future in [pool.submit(build) for build in builds]]
    print(f"[2 build] the four traversal kernels (nvcc sm_90a) and the native "
          f"builders, in parallel: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, lib in zip(kernels, libs):
        for row in ptxas_report(lib):
            print(f"[2 build] ptxas {name} {row}", flush=True)
    for name, lib in list(zip(kernels, libs))[:2]:
        for row in sass_loads(lib):
            print(f"[2 build] sass {name} {row}", flush=True)

    # -- 3. kernel against plain version ------------------------------
    t0 = time.perf_counter()
    v1 = sponza_like_scene(262144, workload="v1", device=device)
    t1 = time.perf_counter()
    v1 = build_scene_bvh(v1, builder="sah")
    t2 = time.perf_counter()
    print(f"[3 kernel] v1 scene: {v1.geometry.num_triangles} triangles in "
          f"{t1 - t0:.2f} s; SAH build + BVH8 collapse {t2 - t1:.2f} s "
          f"({v1.bvh.nodes8.shape[0]} BVH8 nodes, worst-case stack "
          f"{bvh8._worst_case_stack(v1.bvh.child8.cpu().numpy())} of "
          f"{tw.STACK_DEPTH})", flush=True)
    soup = build_scene_bvh(triangle_soup_scene(20000, seed=1, device=device))
    n_half = 32768
    cases = {
        "soup20k": (soup, CameraConfig(position=(0.0, 0.0, 30.0), aspect_ratio=2.0),
                    (-10.0, 10.0)),
        "v1": (v1, CameraConfig(**BENCH_CAMERA, aspect_ratio=2.0),
               ((-19.0, 0.5, -9.0), (19.0, 7.5, 9.0))),
    }
    for label, (scene, cam_cfg, (lo, hi)) in cases.items():
        co, cd, _, _ = camera_rays(256, 128, cam_cfg, device)
        ro, rd = random_rays(n_half, lo, hi, seed=5, device=device)
        o, d = torch.cat([co, ro]), torch.cat([cd, rd])
        t_min = torch.full((2 * n_half,), 1e-3, device=device)
        t_max = torch.full((2 * n_half,), 1e3, device=device)
        t_max[::251] = 0.0
        compare(tw, tw.get_table8(scene.bvh), o, d, t_min, t_max, label)

    table8 = tw.get_table8(v1.bvh)
    v1_closest, v1_shadow = main_path_rays(v1, device, tw, table8)
    print("[3 kernel] at the 1080p frame's shapes:", flush=True)
    result = {"bvh8_closest": compare(tw, table8, *v1_closest, "frame primary", culls=(True,),
                                      any_hit=False, reps=5)["closest"],
              "bvh8_any": compare(tw, table8, *v1_shadow, "frame shadow", culls=(),
                                  reps=5)["any"]}
    work8 = per_ray_work(tw, table8, v1_closest, v1_shadow)
    bounds = {f"bvh8_{kind}": bound(kind, rays[0].shape[0], table8, work8[kind])
              for kind, rays in (("closest", v1_closest), ("any", v1_shadow))}

    # -- 4. the slice against brute force -------------------------------
    cornell = build_scene_bvh(cornell_box_scene(device=device))
    cfg = Config(width=64, height=64, camera=CameraConfig(
        position=(0.0, 0.0, 3.2), aspect_ratio=1.0, x_fov=float(np.radians(60))))
    cam = Camera(cfg.camera).to_device(device)
    images = {}
    for mode in (TraversalMode.BVH_KERNEL, TraversalMode.BRUTE_FORCE):
        state, rays = render_progressive(cornell, cfg.replace(traversal=mode), cam, 4)
        images[mode] = (state.accumulation, rays)
    (a, ra), (b, rb) = images[TraversalMode.BVH_KERNEL], images[TraversalMode.BRUTE_FORCE]
    diff = float((a - b).abs().max())
    check(diff <= 1.0 / 255.0 + 1e-6, f"Cornell BVH8 vs brute force: max diff {diff}")
    check(ra == rb, f"Cornell ray counts {ra} vs {rb}")
    check(bool(torch.isfinite(a).all()) and float(a.mean()) > 0.05, "Cornell image lit")
    print(f"[4 slice] Cornell 64x64, 4 frames: BVH8 kernel vs brute force max "
          f"diff {diff:.3g} (<= 1/255), rays {int(ra)} == {int(rb)}, "
          f"bit-equal {bool(torch.equal(a, b))}", flush=True)

    # -- 5. the main path ------------------------------------------------
    cfg = Config(width=1920, height=1080, max_bounce_count=4, ray_chunk_size=1 << 22,
                 traversal=TraversalMode.BVH_KERNEL,
                 camera=CameraConfig(**BENCH_CAMERA, aspect_ratio=1920 / 1080))
    camera = Camera(cfg.camera).to_device(device)
    state = create_render_state(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tw.LAUNCHES.clear()
    tw2.LAUNCHES.clear()
    frame_ms = []
    main_cfg, main_camera = cfg, camera
    for frame in range(3):
        before = dict(tw.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = render_frame(v1, cfg, camera, state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        frame_ms.append(ms)
        rays = int(stats.rays)
        n_closest = tw.LAUNCHES["closest"] - before.get("closest", 0)
        n_any = tw.LAUNCHES["any"] - before.get("any", 0)
        check(n_closest >= 4 and n_any >= 4,
              f"frame {frame}: kernel launches closest {n_closest}, any {n_any}")
        print(f"[5 main] frame {frame}: {ms:.1f} ms, {rays} rays, "
              f"{rays / ms / 1e3:.2f} Mrays/s; launches closest {n_closest}, "
              f"any {n_any}", flush=True)
        if frame == 0:
            first_frame = (state.accumulation.clone(), rays)
    launches = launch_counts(kernels)
    check(not any(tw2.LAUNCHES.values()), f"v1 frames launched BVH2 kernels: {tw2.LAUNCHES}")
    img = state.accumulation
    check(tuple(img.shape) == (1080, 1920, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image finite")
    check(float(img.max()) > 0.0, "image not all black")
    print(f"[5 main] image 1080x1920: mean {float(img.mean()):.4f}, max "
          f"{float(img.max()):.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if args.save_dir is not None:
        args.save_dir.mkdir(parents=True, exist_ok=True)
        np.save(args.save_dir / "main_frame.npy", img[::4, ::4].cpu().numpy())
    profile_frame(lambda: render_frame(v1, cfg, camera, state),
                  sum(frame_ms) / len(frame_ms), args.save_dir)
    # one more frame with every traversal launch recorded, then each alone
    calls = record_frame(lambda: render_frame(v1, cfg, camera, state))
    in_frame = {f"bvh8_{kind}": v for kind, v in
                replay(tw, tw.get_table8, tuple, calls, "[5 replay] bvh8").items()}
    del calls

    # -- 6. BVH2 kernel against plain version ---------------------------
    _, soup_bvh = build_bvh(triangle_soup_scene(20000, seed=1, device=device).geometry)
    co, cd, _, _ = camera_rays(256, 128, cases["soup20k"][1], device)
    ro, rd = random_rays(n_half, -10.0, 10.0, seed=5, device=device)
    soup_rays = (torch.cat([co, ro]), torch.cat([cd, rd]),
                 torch.full((2 * n_half,), 1e-3, device=device),
                 torch.full((2 * n_half,), 1e3, device=device))
    soup_rays[3][::251] = 0.0
    compare(tw2, tw2.get_table2(soup_bvh), *soup_rays, "soup20k LBVH")

    hall, inst, animation = instanced_hall(device)

    def transforms(frame):
        return torch.from_numpy(animation(frame)).to(device)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geom, dyn_bvh, _ = tlas.build_tlas(inst, transforms(0))
    torch.cuda.synchronize()
    print(f"[6 bvh2] dynamic scene: {geom.num_triangles} triangles; TLAS build "
          f"(world transform + LBVH) {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"{len(dyn_bvh.topology.levels)} refit levels, worst-case stack "
          f"{dyn_bvh.topology.stack_need} of {tw2.STACK_DEPTH}", flush=True)
    check(geom.num_triangles == 261900 + ORBITERS * 1024, "dynamic scene triangles")
    table2 = tw2.get_table2(dyn_bvh)
    closest_rays, shadow_rays = main_path_rays(hall._replace(geometry=geom, bvh=dyn_bvh),
                                               device, tw2, table2)
    print("[6 bvh2] at the dynamic 1080p frame's shapes:", flush=True)
    result["bvh2_closest"] = compare(tw2, table2, *closest_rays, "dynamic primary",
                                     any_hit=False, reps=5)["closest"]
    result["bvh2_any"] = compare(tw2, table2, *shadow_rays, "dynamic shadow", culls=(),
                                 reps=5)["any"]
    work2 = per_ray_work(tw2, table2, closest_rays, shadow_rays)
    for kind, rays in (("closest", closest_rays), ("any", shadow_rays)):
        bounds[f"bvh2_{kind}"] = bound(kind, rays[0].shape[0], table2.records,
                                       work2[kind])
    del closest_rays, shadow_rays

    # -- 7. the dynamic path through Engine -------------------------------
    cfg = Config(width=1920, height=1080, max_bounce_count=4,
                 camera=CameraConfig(**BENCH_CAMERA, aspect_ratio=1920 / 1080))

    def script(frame):
        """Frame 0 builds, 1-4 move, 5 holds still, later frames move."""
        return animation(frame if frame <= 4 else 4 if frame == 5 else frame - 1)

    # The Engine refits through accel.tlas.refit_tlas: CUDA events around
    # each call time it on the device's clock with no synchronization
    # inside the frame; they are read after the frame's closing sync.
    refit_events = []
    refit = tlas.refit_tlas

    def timed_refit(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = refit(*a)
        end.record()
        refit_events.append((start, end))
        return out

    tlas.refit_tlas = timed_refit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, hall, instances=inst, animation=script, device=device)
    torch.cuda.synchronize()
    print(f"[7 dynamic] Engine set-up (world transform, LBVH build, soup "
          f"permutation): {(time.perf_counter() - t0) * 1e3:.1f} ms; "
          f"{eng.scene.geometry.num_triangles} triangles, 2-wide BVH "
          f"{eng.scene.bvh.nodes8 is None}, stack need "
          f"{eng.scene.bvh.topology.stack_need} of {tw2.STACK_DEPTH}", flush=True)
    tw.LAUNCHES.clear()
    tw2.LAUNCHES.clear()
    moving_ms = []
    for frame in range(6):
        before8, before2 = dict(tw.LAUNCHES), dict(tw2.LAUNCHES)
        n_refits, rays0 = len(refit_events), eng.total_rays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.draw()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rays = eng.total_rays - rays0
        n = {k: tw.LAUNCHES[k] - before8.get(k, 0) for k in ("closest", "any")}
        n.update({k: tw2.LAUNCHES[k] - before2.get(k, 0) for k in ("closest2", "any2")})
        check(n["closest2"] >= 4 and n["any2"] >= 4 and n["closest"] == 0 and n["any"] == 0,
              f"dynamic frame {frame}: launches {n}")
        moved = 1 <= frame <= 4
        check((len(refit_events) > n_refits) == moved, f"dynamic frame {frame}: refit")
        spp = eng.state.accum_index
        check(spp == (2 if frame == 5 else 1), f"dynamic frame {frame}: accum_index {spp}")
        kind_of = "build" if frame == 0 else "moving" if moved else "static"
        refit_txt = (f"refit {refit_events[-1][0].elapsed_time(refit_events[-1][1]):.2f} "
                     "ms, " if moved else "")
        print(f"[7 dynamic] frame {frame} ({kind_of}): {refit_txt}{ms:.1f} ms, "
              f"{int(rays)} rays, {rays / ms / 1e3:.2f} Mrays/s, accum_index {spp}; "
              f"launches bvh2 closest {n['closest2']}, any {n['any2']}, "
              f"bvh8 closest {n['closest']}, any {n['any']}", flush=True)
        if moved:
            moving_ms.append(ms)
        if frame == 4:
            moved_img = eng.state.accumulation.clone()
    launches.update({k: n for k, n in launch_counts(kernels).items() if k.startswith("bvh2")})
    tlas.refit_tlas = refit
    img = eng.state.accumulation
    check(tuple(img.shape) == (1080, 1920, 3), f"dynamic image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.0,
          "dynamic image finite and not black")
    print(f"[7 dynamic] image 1080x1920: mean {float(img.mean()):.4f}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # the oracle: a from-scratch LBVH at the last move's transforms renders
    # the refitted frame bit for bit (a refit changes tree quality, never hits)
    geom, ref_bvh = build_bvh(tlas.world_geometry(inst, transforms(4)))
    ref, _ = render_frame(eng.scene._replace(geometry=geom, bvh=ref_bvh), cfg,
                          Camera(cfg.camera).to_device(device, cfg.reverse_depth),
                          create_render_state(cfg, device))
    differ = int((ref.accumulation != moved_img).any(dim=-1).sum())
    print(f"[7 dynamic] frame 4 over the refitted TLAS against a from-scratch "
          f"LBVH: {differ} pixels differ", flush=True)
    check(differ == 0, "refitted frame bit-equal to the rebuilt one")
    if args.save_dir is not None:
        np.save(args.save_dir / "dynamic_frame.npy", moved_img[::4, ::4].cpu().numpy())
    profile_frame(eng.draw, sum(moving_ms) / len(moving_ms), args.save_dir,
                  "dynamic_frame_trace.json")
    # one more moving frame with every traversal launch recorded, then each
    # alone over that frame's refitted tree
    calls = record_frame(eng.draw)
    in_frame.update({f"bvh2_{kind}": v for kind, v in
                     replay(tw2, tw2.get_table2, operator.attrgetter("records"), calls,
                            "[7 replay] bvh2").items()})
    del calls

    # -- 8. the packet kernels ----------------------------------------------
    packet = {"subpacket": TraversalMode.BVH_SUBPACKET, "shared": TraversalMode.BVH_SHARED}
    soup_sah = build_scene_bvh(triangle_soup_scene(20000, seed=1, device=device), builder="sah")
    for tree, bvh in (("LBVH", soup_bvh), ("SAH", soup_sah.bvh)):
        for name in packet:
            compare(kernels[name][0], tw2.get_table2(bvh), *soup_rays,
                    f"[8 packet] soup20k {tree} {name}", reps=5)
    table2 = tw2.get_table2(v1.bvh)
    print(f"[8 packet] at the 1080p v1 frame's shapes, over the SAH tree's 2-wide "
          f"arrays ({table2.nodes.shape[0]} nodes, stack need {tw2.stack_need(v1.bvh)} "
          f"of {tw2.STACK_DEPTH}):", flush=True)
    work = per_ray_work(tw2, table2, v1_closest, v1_shadow)
    print(f"[8 packet] the per-ray plain version's work on these rays: {work}", flush=True)
    for name in packet:
        module = kernels[name][0]
        result[f"{name}_closest"] = compare(module, table2, *v1_closest, "frame primary " + name,
                                            culls=(True,), any_hit=False, reps=5)["closest"]
        result[f"{name}_any"] = compare(module, table2, *v1_shadow, "frame shadow " + name,
                                        culls=(), reps=5)["any"]
        for kind, rays in (("closest", v1_closest), ("any", v1_shadow)):
            bounds[f"{name}_{kind}"] = bound(kind, rays[0].shape[0], table2.arrays,
                                             work[kind])

    ref_img, ref_rays = first_frame
    for name, mode in packet.items():
        cfg = main_cfg.replace(traversal=mode)
        state = create_render_state(cfg, device)
        torch.cuda.synchronize()
        for module, _ in kernels.values():
            module.LAUNCHES.clear()
        for frame in range(2):
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = render_frame(v1, cfg, main_camera, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rays = int(stats.rays)
            n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
            check(n[f"{name}_closest"] >= 4 and n[f"{name}_any"] >= 4
                  and not any(c for k, c in n.items() if not k.startswith(name)),
                  f"{name} frame {frame}: launches {n}")
            print(f"[8 packet] {mode.name} frame {frame}: {ms:.1f} ms, {rays} rays, "
                  f"{rays / ms / 1e3:.2f} Mrays/s; launches "
                  + ", ".join(f"{k} {c}" for k, c in n.items()), flush=True)
            if frame == 0:
                img = state.accumulation
                frame_gate(mode.name, img, rays, ref_img, ref_rays)
                if args.save_dir is not None:
                    np.save(args.save_dir / f"{name}_frame.npy", img[::4, ::4].cpu().numpy())
        launches.update({k: c for k, c in launch_counts(kernels).items() if k.startswith(name)})

    # the plain packet backend (TraversalMode.BVH, no kernel of its own):
    # one frame with the depth cut to 1 bounce (its lockstep loop takes
    # seconds a call on the incoherent rays of deeper bounces), against a
    # BVH_KERNEL frame of the same depth
    cfg = main_cfg.replace(max_bounce_count=1)
    ref, ref_stats = render_frame(v1, cfg, main_camera, create_render_state(cfg, device))
    cfg = cfg.replace(traversal=TraversalMode.BVH)
    before = launch_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = render_frame(v1, cfg, main_camera, create_render_state(cfg, device))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rays = int(stats.rays)
    n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
    check(not any(n.values()), f"BVH frame launched kernels: {n}")
    print(f"[8 packet] BVH frame 0, 1 bounce: {ms:.1f} ms, {rays} rays, "
          f"{rays / ms / 1e3:.2f} Mrays/s; no kernel launched", flush=True)
    frame_gate("BVH (1 bounce)", state.accumulation, rays, ref.accumulation,
               int(ref_stats.rays))

    lines = []
    for key, (err, ms, plain_ms) in result.items():
        name = key.rsplit("_", 1)[0]
        bound_ms, bound_by = bounds[key]
        lines.append({"name": key, "route": "cuda", "source": SOURCES[name],
                      "replaces": replaces(SOURCES[name]), "launches": launches[key],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        in_frame_txt = ""
        if key in in_frame:
            f_ms, f_bound_ms, f_launches = in_frame[key]
            lines[-1].update(frame_ms=f_ms, frame_bound_ms=f_bound_ms,
                             frame_launches=f_launches)
            in_frame_txt = (f"; {f_ms:.3f} ms over the {f_launches} launches of one "
                            f"replayed frame (bound {f_bound_ms:.4f} ms)")
        print(f"[kernels] {key}: kernel {ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.1f} ms, {launches[key]} launches "
              f"in the frames of its path{in_frame_txt}", flush=True)
    print(smi)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
