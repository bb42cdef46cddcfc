#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--save-dir DIR]

Run from the repository root.  Phases, each printing its result:

1. device: the card's name and ``nvidia-smi`` name and power limit, and
   whether Pillow is installed (the texture pool does not use it);
2. build: the four traversal kernels (BVH8, with its Moller-Trumbore and
   its plane leaf test, BVH2, subpacket and shared
   cursor; nvcc, sm_90a) and the native BVH builders, from the sources in
   the checkout, all at once; ptxas's registers, stack, spills and shared
   memory of each kernel specialization, and the widths of every
   kernel's loads and its barriers as the machine code has them;
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
   bounces (the wavefront sort on), with per-frame time, rays, Mrays/s and
   kernel launch counts; frame 0 again under ``VRT_DEBUG_NO_SORT=1``,
   bit-equal in image and ray count; the sort's calls timed by CUDA events
   in one frame; then one more frame under ``torch.profiler``: the
   device's busy time, its idle share of the frame's wall time and the
   costliest kernels; then one more frame with the arguments of every
   traversal launch recorded, and each recorded launch replayed alone:
   kernel ms, live rays, the plain version's box and triangle tests for
   these rays, the bound they give, kernel = plain version in every field;
   and an unsorted frame's launches replayed, kernel ms only;
6. BVH2 kernel against plain version: the 20,000-triangle soup as an LBVH
   with no collapse (camera and random rays as in phase 3), then the
   dynamic frame's shapes (its primary rays with culling on and off, its
   bounce-0 shadow rays);
7. the dynamic path through ``Engine``: the v1 hall as instance 0 plus 64
   orbiting spheres (327,436 triangles), TLAS build on the device, then
   3 frames at 1920x1080 with 4 bounces (the build frame and 2 moving
   frames, each refitting the TLAS and resetting the accumulation) with
   refit ms (CUDA events around the Engine's refit, no synchronization
   inside the frame), frame ms, rays, Mrays/s and the launches of all
   four kernel specializations, one static frame that accumulates, the
   refitted image against a frame over a from-scratch LBVH build
   (bit-equal), the peak device memory, one profiled moving frame, and
   one recorded moving frame's launches replayed alone as in phase 5;
8. the packet kernels (subpacket, shared cursor) on the packed 2-wide
   records of the trees: against their plain versions on the 20,000-triangle soup as
   an LBVH and as an SAH tree (camera and random rays as in phase 3), then
   at the 1080p v1 frame's shapes, every field bit for bit, each kernel run
   twice; then 2 frames of ``render_frame`` at 1920x1080 with 4 bounces
   under each of ``TraversalMode.BVH_SUBPACKET`` and ``BVH_SHARED`` with
   per-frame time, rays, Mrays/s, the launches of every kernel and the
   caching allocator's ``cudaMalloc`` calls and reserve, each
   mode's first frame against phase 5's first ``BVH_KERNEL`` frame (ray
   counts within 0.1%, at most 0.1% of pixels more than 1/255 apart: the
   packet kernels let the first triangle tested win an exact tie and do not
   commit a hit exactly at t_max), the ``BVH_SUBPACKET`` frame 0 again
   under ``VRT_DEBUG_NO_SORT=1`` to the same gate (a packet's ties follow
   its packet's visit order, which the sort changes); then one more
   ``BVH_SUBPACKET`` frame recorded and each of its launches replayed alone
   through both packet kernels, kernel ms and bound (the tests of a launch
   counted once, by the BVH2 plain version), an unsorted frame's launches
   likewise, kernel ms only, and every launch of a 480x270 frame (1/16 of
   the rays, 2 bounces) held to both plain versions; then one frame under
   ``TraversalMode.BVH`` (the plain packet backend, which launches no
   kernel) with the depth cut to 1 bounce, held to the same gate against a
   ``BVH_KERNEL`` frame of that depth;
9. the real workload: ``sponza_like_scene(262144, workload="real")``
   (textures, alpha-tested foliage, an HDR sky), SAH build, BVH8 collapse
   and the cutout subset's tree, with its triangle and cutout counts, its
   texture pool's bytes and the build seconds, and the pool's sha256 held
   to the digest of the JAX package's pool of the same images
   (``REAL_POOL_SHA256``: the mips are Pillow's bilinear ones); 3 frames
   at 1920x1080 with 4 bounces through ``BVH_KERNEL`` with ms, rays,
   Mrays/s and the BVH8 launches split by table (the opaque view, the
   subset); a profiled frame,
   and one more with named ranges (texture sampling, ``_hit_alpha``, the
   alpha rounds, traversal, the sort) and the device time inside each;
   frame 0 again under ``VRT_DEBUG_NO_SORT=1``, bit-equal; a recorded
   frame whose launches are replayed alone as in phase 5, kernel ms by
   table (the opaque view, the subset) and kernel = plain version in every
   field over both tables; and a 128x72
   frame at the 20,000-triangle target through ``BVH_KERNEL`` against
   ``BRUTE_FORCE`` (both with the alpha re-trace): at most 0.1% of the
   channels more than 1/255 apart;
10. the entry point: phase 9's real scene exported to a .glb (with its
   textures as PNGs) and its sky to an .hdr in a temporary directory, the
   .glb loaded back (triangles, cutouts and texture pool checked equal),
   its frame 0 as loaded printed, and with the procedural shading frames
   put back held to phase 9's frame 0 under phase 9's gate (the exporter
   writes no tangents, so the loader makes them from the uvs and 1-spp
   path tracing samples other directions); then ``cli.main(["render",
   "--scene", glb, "--env", hdr, "--mode", "hybrid", ...])`` at 1920x1080
   (the IBL bake's three products timed, with their peak memory), the PNG
   read back equal to the Engine's display image, 3 hybrid frames of that
   Engine from the bench camera with ms and the BVH8 launches by table,
   the frame's peak memory, a profiled frame, a recorded frame's launches
   replayed as in phase 5 (kernel = plain version over both tables), and
   a 128x72 hybrid frame at the 20,000-triangle target through
   ``BVH_KERNEL`` against ``BRUTE_FORCE`` (phase 9's gate); then
   ``--mode pt --spp 2`` at 1920x1080 through the CLI with frame ms and
   Mrays/s, and ``compare`` of its PNG with itself (RMSE 0);
11. the rest: (a) the v1 and real scenes at 1,048,576 triangles, SAH build
   and BVH8 collapse, each one table in global memory (triangles, stack
   need against ``STACK_DEPTH``, build seconds; every table a frame reads
   is packed before the frames), 2 v1 frames and 2 real frames at
   1920x1080 with 4 bounces through ``BVH_KERNEL`` (ms, rays,
   Mrays/s, BVH8 launches by table), and one more v1 frame whose launches
   are replayed alone as in phase 5 (kernel = plain version in every
   field, kernel ms, bound); (b) on phase 5's v1 scene,
   ``parallel.shard_render_frame`` over ``[cuda:0, cuda:0]`` for 2 frames
   (two shards on one card run one after the other: a check of
   correctness, not of speed), bit-equal to 2 unsharded frames, one
   ``shard_render_frame_samples`` step bit-equal to the mean of the
   samples of 2 unsharded frames, one ``Engine(mesh=...)`` frame
   bit-equal to ``render_frame``, and ``--devices`` past the card count
   exiting with its error; (c) ``render_span(4)`` at 480x270 bit-equal to
   4 frames, a 480x270 frame at 1 bounce under ``BVH_PER_RAY`` (plain
   torch, no kernel) against ``BVH_KERNEL`` at phase 8's gate, and
   ``utils.profiling.profile_to`` around a frame inside a ``trace_scope``,
   the scope's range and the traversal kernels found in the written trace;
12. the bench entry point: ``python -m vulkanraytracing_torch bench`` in
   a subprocess, v1 through its .glb (written to a temporary directory and
   read back) with 5 frames, then the real workload without the .glb and 3
   frames; each exits with 0 and its last line has the JAX bench's keys,
   it launched the BVH8 kernel's closest and any specializations over its
   measured frames, its best frame is at most 1.25x the median frame ms of
   phase 5 (v1) or 9 (real), and each frame's rays are within 1% of those
   phases' mean; ``bench --devices N`` past the card count exits non-zero
   with its message before it builds a scene;
13. the evidence tools (``vulkanraytracing_torch.tools``) in their small
   modes, four subprocesses on the card started together, each writing
   into a temporary directory: ``parity_artifact`` (64x64, 8 spp),
   ``measure_t1024`` (64x64, 16 spp, 20,000 triangles), ``hybrid_artifact``
   (256x144 at the 20,000-triangle target) and ``measure_aniso``; each exits with 0, its
   report names the card as ``nvidia-smi`` does, its gates pass (the parity
   cases at RMSE 1e-3 and the Cornell box at 0; the hybrid frame against
   the CPU's at 1e-3; the aniso RMSEs within 2% of the JAX package's
   ``artifacts/aniso/report.json``) and it launched the BVH8 kernel;
14. the plane ("Woop") leaf test (``VRT_WOOP=1``): (a) the v1 tree's
   plane table at the 1080p frame's bounce-0 shapes (phase 3's rays),
   kernel = plain version in every field, twice, with its bound, the
   Moller-Trumbore kernel timed in turns with it (MT, woop, woop, MT) and
   the two kernels' hits compared; (b) one v1 frame recorded under the
   switch and each launch replayed alone through the woop kernel (kernel =
   plain version, bound) and through the MT kernel (timed); (c) v1 and
   real 1080p frames from a fresh state, MT, woop, woop, MT, each woop
   frame held to phase 5's or 9's frame 0 under the packet kernels' frame
   gate (rays within 0.1%, at most 0.1% of the pixels more than 1/255
   apart: the plane test rounds t, u and v otherwise, which may move a
   hit at an edge or a cutout's texel), each MT frame bit-equal to it, the
   launches counted from 0 (woop frames launch only the woop
   specializations);
15. the point-light pick kernel (``ops.nee_select``): one v1 1080p frame's
   4 picks recorded, each replayed through the kernel (twice) against the
   plain body on the CPU, bit for bit, and against the plain body on the
   card (the state equal; lanes picking another light and the pdf's ulps
   reported: the card's own rsqrt and cumsum round otherwise), each timed
   on the device with the plain body's time beside it, and one frame
   profiled, whose ``vrt.nee`` spans must hold exactly its 4 kernels'
   device time (the kernel's op range encloses each launch).

Each kernel's ``bound_ms`` is the larger of two times at the frame's
shapes: its bytes (each ray's 32 input bytes once, the table once, the
results once: 17 bytes a ray for closest hit, 1 for any-hit) over 3.35
TB/s, and its operations over 67 TFLOP/s (fp32 off the tensor cores).  The
operations are the slab and triangle tests that the per-ray plain version
of the same tree makes for the same rays (its ``counts``; the three 2-wide
kernels are held to the BVH2 one's), times the operations of one test
counted from the code (``BOX_OPS``, ``TRI_OPS``; ``TRI_OPS_WOOP`` for the
plane test, whose records are 64 bytes a triangle against 48).  No single
PyTorch call traverses a BVH, so ``library_ms`` is null.  ``ms`` and
``bound_ms`` are taken on the frame's primary rays and bounce-0 shadow
rays; every entry also carries ``frame_ms``, ``frame_bound_ms`` and
``frame_launches``: the kernel's time and bound summed over the replayed
launches of one whole frame, whose later bounces are full of dead rays;
``frame_ms_unsorted``,
the same sum over an unsorted frame (BVH8 and the packet kernels); and
the BVH8 entries ``real_launches``, ``real_frame_ms``,
``real_frame_bound_ms`` and ``real_frame_launches`` from phase 9,
``hybrid_launches``, ``hybrid_frame_ms`` and ``hybrid_frame_bound_ms``
from phase 10, ``big_launches``, ``big_frame_ms`` and
``big_frame_bound_ms`` from phase 11's 1M-triangle frames,
``bench_launches`` (v1 and real) from phase 12's measured frames, and
``tools_launches`` (each tool) from phase 13.  The plane test's entries
(``bvh8woop_closest``, ``bvh8woop_any``) come from phase 14: launches
over its woop frames, ``frame_*`` from its replay, and the A/B against
Moller-Trumbore: ``mt_ms`` and ``ms_turns`` (the MT and woop kernels in
turns at bounce 0), ``mt_frame_ms`` (the MT kernel over the same replayed
frame) and ``frames_ms`` (whole frames, v1 and real, MT and woop).  The
point-light pick's entry (``nee_select``, phase 15) carries ``ms`` and
``plain_ms`` at bounce 0, ``bound_ms`` (its bytes), ``frame_ms`` over the
frame's 4 launches, and ``card_plain_idx_diff`` / ``card_plain_pdf_max_ulp``
against the plain body on the card.

Any failure raises and exits non-zero.  Without a CUDA device it exits 1
before printing any result.  The second-to-last line is a JSON object
describing each kernel; the last is ``{"ok": true, "device": {...}}``.
With ``--save-dir`` the last frame of each path is written there as a
.npy image (``main_frame.npy``, ``dynamic_frame.npy``,
``subpacket_frame.npy``, ``shared_frame.npy``, ``real_frame.npy``,
``hybrid_frame.npy``), the CLI's hybrid image as ``hybrid.png``, and the
profiled frames' Chrome traces as ``frame_trace.json``,
``dynamic_frame_trace.json``, ``real_frame_trace.json`` and
``hybrid_frame_trace.json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import importlib.metadata
import io
import json
import math
import operator
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# each kernel's source; the TPU kernel it replaces is named on the
# source's own "// Replaces: file:line" line
SOURCES = {
    "bvh8": "vulkanraytracing_torch/csrc/bvh8_traverse.cu",
    # the BVH8 kernel with the plane leaf test: the same source's
    # vrt_bvh8_woop_* entries (_kernel(woop=True) of the same TPU kernel)
    "bvh8woop": "vulkanraytracing_torch/csrc/bvh8_traverse.cu",
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
# the plane test (ops/intersect.py::plane_test, csrc/traverse_common.cuh::
# test_triangle_plane): 16 products (n.d, n.o, t = num * inv, t d, up.p,
# vp.p), 15 sums and negations (2 + 3 + 1, o + t d, the two planes' 3
# each), the reciprocal with its guard (4) and the window (8), as above
TRI_OPS_WOOP = 43
# bytes a ray reads (o, d, t_min, t_max) and writes (t, u, v, tri and the
# back face; the any-hit verdict)
RAY_IN_BYTES = 32
RAY_OUT_BYTES = {"closest": 17, "any": 1}
# the packet kernels' frames against the per-ray kernels' frame: a hit
# moves only on exact ties and at exactly t_max
FRAME_RAY_TOL = 1e-3
FRAME_PIXEL_SHARE = 1e-3
# the bench against the same workload's frames in this script: its best
# frame at most 1.25x their median ms (another process, the same path), its
# rays within 1% (the .glb round trip regenerates the tangents, which moves
# the noise, not the content)
BENCH_MS_RATIO = 1.25
BENCH_RAY_TOL = 1e-2
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mean", "median", "frames",
              "time_to_1024spp_s", "workload", "device"}
ROOT = Path(__file__).resolve().parent
# the real workload's texture pool as the JAX package builds it (its
# build_texture_pool of sponza_real_images(7), whose mips Pillow makes):
# sha256 over the texels, then the offset, width and height tables (int32)
REAL_POOL_SHA256 = "22aebe03db3fdd612203dd31f49f326757f65dc302a95fdb3da79ce6a5d040b7"
# the evidence tools in their small modes: (extra environment, arguments)
TOOL_RUNS = {
    "parity_artifact": ({"VRT_PARITY_SMALL": "1"}, []),
    "measure_t1024": ({"VRT_T1024_TRIS": "20000"}, ["64", "16"]),
    "hybrid_artifact": ({"VRT_HYBRID_SMALL": "1"}, []),
    "measure_aniso": ({}, []),
}
# the aniso RMSEs against the JAX package's report (computed on a CPU)
ANISO_REPORT = ROOT / "artifacts" / "aniso" / "report.json"
ANISO_REL_TOL = 0.02
ANISO_KEYS = ("rmse_trilinear_vs_aniso16", "rmse_aniso4_vs_aniso16", "rmse_trilinear_vs_aniso4")


# the point-light pick (phase 15): runs timed a call, the cycles the stream
# is held back before them, and the bytes a lane reads (normal 12, point
# 12, state 16) and writes (index 8, pdf 4, state 16), over PEAK_BYTES
NEE_REPS = 20
NEE_HOLD_CYCLES = 200_000_000
NEE_BYTES_PER_LANE = 68


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


def kernel_name(mangled: str) -> str:
    """A kernel specialization by its name and template arguments as in the
    source (the walk of a traverse_kernel, any-hit, culling), from its
    mangled name."""
    found = re.search(r"(?:traverse|shared|subpacket)_kernel", mangled)
    if not found:
        return mangled
    kernel = found.group(0)
    rest = mangled[found.end():]
    args = re.findall(r"Lb([01])E", rest)
    walk = re.match(r"INS_(\d+)", rest)
    if walk:  # the walk struct, a length-prefixed name: NS_4Bvh8E
        args.insert(0, rest[walk.end():walk.end() + int(walk.group(1))])
    return kernel + (f"<{','.join(args)}>" if args else "")


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
            name = kernel_name(entry.group(1))
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
    """The global loads of each kernel in a library, by width, its local
    and shared loads and stores and its block-wide barriers (``BAR``),
    counted in the machine code (``cuobjdump -sass``): every kernel should
    read its table with 16-byte loads (8 bytes where only half a group is
    used) and only the ray itself with 4-byte ones; the subpacket kernel
    has no barrier at all, the shared-cursor kernel one in its step and
    two where it takes a packet.  Empty where the toolkit has no
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
                    f"shared {counts['LDS'][0]} / {counts['STS'][0]}; "
                    f"barriers {counts['BAR'][0]}")
            name = kernel_name(function.group(1))
            counts = collections.defaultdict(collections.Counter)
        op = re.search(r"\b(LDG|LDL|STL|LDS|STS|BAR)((?:\.\w+)*)", line)
        if op and counts is not None:
            width = 16 if ".128" in op.group(2) else 8 if ".64" in op.group(2) else 4
            counts[op.group(1)][width if op.group(1) == "LDG" else 0] += 1
    return rows


def bound(kind: str, n_rays: int, table, counts: dict,
          tri_ops: int = TRI_OPS) -> tuple[float, str]:
    """The least time the card could take for a traversal call: (ms, what
    bounds it), from the bytes it must move (the rays, the results and
    ``table``, the tensors of the table that the kernel reads) and the
    tests the per-ray plain version counted for the same rays (``tri_ops``
    a triangle test: ``TRI_OPS_WOOP`` for the plane test)."""
    n_bytes = (n_rays * (RAY_IN_BYTES + RAY_OUT_BYTES[kind])
               + sum(t.numel() * t.element_size() for t in table))
    ops = counts["box_tests"] * BOX_OPS + counts["tri_tests"] * tri_ops
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


def frame_gate(name, img, rays, ref_img, ref_rays, label="[8 packet]",
               against="BVH_KERNEL frame 0") -> None:
    """A frame through a packet backend (or the plane leaf test) against
    the ``BVH_KERNEL`` frame from the same state: finite and lit, ray
    counts within ``FRAME_RAY_TOL``, at most ``FRAME_PIXEL_SHARE`` of the
    pixels more than 1/255 apart."""
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.0,
          f"{name} image finite and not black")
    far = ((img - ref_img).abs() > 1.0 / 255.0 + 1e-6).any(dim=-1)
    share = float(far.float().mean())
    print(f"{label} {name} frame 0 against {against}: rays {rays} vs "
          f"{ref_rays} ({(rays - ref_rays) / ref_rays:+.2e}); {int(far.sum())} pixels "
          f"({share:.2e}) more than 1/255 apart, "
          f"{int((img != ref_img).any(dim=-1).sum())} differ at all", flush=True)
    check(abs(rays - ref_rays) <= FRAME_RAY_TOL * ref_rays,
          f"{name} ray count within {FRAME_RAY_TOL}")
    check(share <= FRAME_PIXEL_SHARE, f"{name} pixels within {FRAME_PIXEL_SHARE}")


def record_frame(render):
    """Run ``render()`` (one frame) and record the arguments of every
    traversal launch it makes, in order: ``ops.trace.traverse_closest``
    and ``traverse_any``, through which every traversal of a tree goes,
    are wrapped for this frame only.  Returns the frame's launches as
    (kind, the BVH traced, clones of o, d, t_min, t_max, the culling
    flag); the BVH tells the tables apart (a scene's tree, its opaque view,
    its cutout subset)."""
    from vulkanraytracing_torch.ops import trace

    calls = []
    closest, blocked = trace.traverse_closest, trace.traverse_any

    def record_closest(cfg, bvh, o, d, t_min, t_max, cull_backface):
        calls.append(("closest", bvh, tuple(x.clone() for x in (o, d, t_min, t_max)),
                      cull_backface))
        return closest(cfg, bvh, o, d, t_min, t_max, cull_backface)

    def record_any(cfg, bvh, o, d, t_min, t_max):
        calls.append(("any", bvh, tuple(x.clone() for x in (o, d, t_min, t_max)), False))
        return blocked(cfg, bvh, o, d, t_min, t_max)

    trace.traverse_closest, trace.traverse_any = record_closest, record_any
    try:
        render()
        torch.cuda.synchronize()
    finally:
        trace.traverse_closest, trace.traverse_any = closest, blocked
    return calls


class TableCounts:
    """Traversal calls per (table, kind) while active: ``ops.trace``'s
    ``traverse_closest`` / ``traverse_any`` are wrapped, and ``name_of``
    names the BVH a call traverses.  Each call with rays launches one
    kernel, so the sums are checked against the wrappers' own counts."""

    def __init__(self, name_of):
        self.name_of = name_of
        self.counts = collections.Counter()

    def __enter__(self):
        from vulkanraytracing_torch.ops import trace

        self._saved = trace.traverse_closest, trace.traverse_any
        closest, blocked = self._saved

        def count_closest(cfg, bvh, o, *rest):
            self.counts[(self.name_of(bvh), "closest")] += int(o.shape[0] > 0)
            return closest(cfg, bvh, o, *rest)

        def count_any(cfg, bvh, o, *rest):
            self.counts[(self.name_of(bvh), "any")] += int(o.shape[0] > 0)
            return blocked(cfg, bvh, o, *rest)

        trace.traverse_closest, trace.traverse_any = count_closest, count_any
        return self

    def __exit__(self, *exc):
        from vulkanraytracing_torch.ops import trace

        trace.traverse_closest, trace.traverse_any = self._saved


class Woop:
    """The plane leaf test for every BVH8 call inside (as ``VRT_WOOP=1``
    at import: ``ops.traverse_wide8.WOOP_DEFAULT``), restored after."""

    def __enter__(self):
        from vulkanraytracing_torch.ops import traverse_wide8

        self._saved = traverse_wide8.WOOP_DEFAULT
        traverse_wide8.WOOP_DEFAULT = True
        return self

    def __exit__(self, *exc):
        from vulkanraytracing_torch.ops import traverse_wide8

        traverse_wide8.WOOP_DEFAULT = self._saved


class NoSort:
    """``VRT_DEBUG_NO_SORT=1`` for the frames inside, restored after."""

    def __enter__(self):
        import os

        self._saved = os.environ.get("VRT_DEBUG_NO_SORT")
        os.environ["VRT_DEBUG_NO_SORT"] = "1"
        return self

    def __exit__(self, *exc):
        import os

        if self._saved is None:
            os.environ.pop("VRT_DEBUG_NO_SORT", None)
        else:
            os.environ["VRT_DEBUG_NO_SORT"] = self._saved


def replay(modules, counter, get_table, table_tensors, calls, label, check_plain=True,
           count=True, name_of=None, tri_ops=TRI_OPS) -> dict:
    """Each recorded launch of a frame (``record_frame``) alone, through
    each traversal module of ``modules`` ({name: module}) over
    ``get_table(bvh)``: the kernel's ms (CUDA events, mean of 5) and the
    live rays (t_min <= t_max).  With ``check_plain`` the kernel, run twice, is
    held to the module's plain version in every field.  With ``count`` the
    box and triangle tests of a launch are those the per-ray plain version
    ``counter`` makes for its rays, counted once per launch and used for
    every module's bound (``table_tensors(table)``: the tensors the kernels
    read).  ``name_of(bvh)`` names each launch's table, and the sums are
    also printed per table.  Prints one line per launch and module and
    returns {name: {"closest" / "any": (summed kernel ms, summed bound ms,
    launches)}}."""
    totals = {name: {"closest": [0.0, 0.0, 0], "any": [0.0, 0.0, 0]} for name in modules}
    per_table = collections.defaultdict(lambda: [0.0, 0.0, 0])
    t0 = time.perf_counter()
    for i, (kind, bvh, rays, cull) in enumerate(calls):
        table = get_table(bvh)
        where = f" ({name_of(bvh)})" if name_of else ""
        n = rays[0].shape[0]
        live = int((rays[2] <= rays[3]).sum())
        counted, bound_ms = None, 0.0
        if count:
            counts = {}
            if kind == "closest":
                counted = counter.closest_plain(table, *rays, cull, counts=counts)
            else:
                counted = (counter.any_plain(table, *rays, counts=counts),)
            bound_ms, by = bound(kind, n, table_tensors(table), counts, tri_ops)
            print(f"{label} launch {i}{where} {kind}: {n} rays, {live} live; bound "
                  f"{bound_ms:.4f} ms ({by}); {counts['box_tests']} box and "
                  f"{counts['tri_tests']} triangle tests", flush=True)
        else:
            print(f"{label} launch {i}{where} {kind}: {n} rays, {live} live", flush=True)
        for name, tw in modules.items():
            if kind == "closest":
                def run():
                    return tuple(tw.closest_cuda(table, *rays, cull))
            else:
                def run():
                    return (tw.any_cuda(table, *rays),)
            first = run()
            if check_plain:
                if tw is counter and counted is not None:
                    plain = counted
                elif kind == "closest":
                    plain = tw.closest_plain(table, *rays, cull)
                else:
                    plain = (tw.any_plain(table, *rays),)
                second = run()
                check(all(torch.equal(a, b) and torch.equal(a, c)
                           for a, b, c in zip(first, plain, second)),
                      f"{label} launch {i} ({kind}) {name}: kernel equals plain version, twice")
            ms = cuda_ms(run, 5)
            print(f"{label} launch {i}{where} {kind} {name}: kernel {ms:.3f} ms"
                  + ("; equal in every field, twice" if check_plain else ""), flush=True)
            tot = totals[name][kind]
            tot[0] += ms
            tot[1] += bound_ms
            tot[2] += 1
            if name_of:
                grp = per_table[(name, name_of(bvh), kind)]
                grp[0] += ms
                grp[1] += bound_ms
                grp[2] += 1
    for name, per_kind in totals.items():
        print(f"{label} frame, {name}: " + "; ".join(
            f"{kind} {ms:.3f} ms over {n} launches"
            + (f" against a bound of {b:.4f} ms" if count else "")
            for kind, (ms, b, n) in per_kind.items()), flush=True)
    for (name, table, kind), (ms, b, n) in sorted(per_table.items()):
        print(f"{label} frame, {name} over the {table} table: {kind} {ms:.3f} ms over {n} "
              f"launches" + (f" against a bound of {b:.4f} ms" if count else ""), flush=True)
    print(f"{label} frame: replayed in {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: {kind: tuple(v) for kind, v in per_kind.items()}
            for name, per_kind in totals.items()}


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs: the stream is
    held back first (``torch.cuda._sleep``), so every run is queued before
    the first starts and the events time the device alone, not the host's
    launches."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(NEE_HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulps(a, b):
    """Distance in units in the last place between float32 tensors of one
    sign (0 where equal, NaN equal to NaN)."""
    same = (a == b) | (a.isnan() & b.isnan())
    d = (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()
    return torch.where(same, 0, d)


def nee_phase(render, lights, device) -> dict:
    """Phase 15: the point-light pick kernel (``ops.nee_select``) on one
    1080p frame's own picks.  Records the arguments of every
    ``sample_point_light`` call of one frame (``render()``), the normal
    rebuilt as a strided column of (R, 3, 3) frames as the integrator
    passes it; for each call: kernel = the plain body on the CPU in every
    output, bit for bit; kernel against the plain body on the card (the
    state equal; the lanes whose light differs, and the pdf's largest
    distance in ulps where it does not); each call's kernel ms and the
    plain body's ms on the card; then one frame profiled, whose ``vrt.nee``
    spans and ``vrt::nee_select`` ops must hold exactly its 4 kernels'
    device time.
    Returns the kernels line's entry."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vulkanraytracing_torch.ops import nee_select
    from vulkanraytracing_torch.pt import integrator

    calls = []
    pick = integrator.sample_point_light

    def record(lights_, n, p, s0, s1):
        calls.append(tuple(x.clone() for x in (n, p, s0, s1)))
        return pick(lights_, n, p, s0, s1)

    integrator.sample_point_light = record
    try:
        render()
        torch.cuda.synchronize()
    finally:
        integrator.sample_point_light = pick
    check(len(calls) == 4, f"a v1 frame picks {len(calls)} times, not once a bounce")
    cpu_lights = lights.to("cpu")
    frame_ms, plain_frame_ms, idx_diff, pdf_ulps = [], [], 0, 0
    for bounce, (n, p, s0, s1) in enumerate(calls):
        frames = torch.zeros((n.shape[0], 3, 3), device=device)
        frames[..., 2] = n
        n = frames[..., 2]
        args = (lights, n, p, s0, s1)
        kernel = nee_select.select_cuda(*args)
        again = nee_select.select_cuda(*args)
        on_cpu = integrator.sample_point_light_plain(
            cpu_lights, *(x.cpu() for x in (n, p, s0, s1)))
        on_card = integrator.sample_point_light_plain(*args)
        torch.cuda.synchronize()
        for field, a, b, c in zip(("idx", "pdf", "s0", "s1"), kernel, again, on_cpu):
            bits = (lambda x: x.view(torch.int32)) if a.dtype == torch.float32 else (lambda x: x)
            check(torch.equal(bits(a), bits(b)), f"nee bounce {bounce}: {field} differs twice")
            check(torch.equal(bits(a.cpu()), bits(c)),
                  f"nee bounce {bounce}: {field} differs from the plain body on the CPU")
        check(torch.equal(kernel[2], on_card[2]) and torch.equal(kernel[3], on_card[3]),
              f"nee bounce {bounce}: state differs from the plain body on the card")
        same = kernel[0] == on_card[0]
        idx_diff += int((~same).sum())
        pdf_ulps = max(pdf_ulps, int(ulps(kernel[1][same], on_card[1][same]).max()))
        frame_ms.append(device_ms(lambda: nee_select.select_cuda(*args), NEE_REPS))
        plain_frame_ms.append(device_ms(lambda: integrator.sample_point_light_plain(*args), 3))
        print(f"[15 nee] bounce {bounce}: {n.shape[0]} lanes, kernel {frame_ms[-1]:.4f} ms, "
              f"plain body {plain_frame_ms[-1]:.3f} ms; kernel = plain body on the CPU bit "
              f"for bit; against the plain body on the card: {int((~same).sum())} lanes "
              f"pick another light, pdf within "
              f"{int(ulps(kernel[1][same], on_card[1][same]).max())} ulp elsewhere",
              flush=True)
    lanes = calls[0][0].shape[0]
    bound_ms = lanes * NEE_BYTES_PER_LANE / PEAK_BYTES * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a whole frame, the device held back on both sides of it: the
        # session's first launch is booked twice (again under the profiler's
        # activity buffer request), and late in a long process a device
        # event near the session's edges can fall outside its window
        torch.cuda._sleep(NEE_HOLD_CYCLES // 10)
        render()
        torch.cuda._sleep(NEE_HOLD_CYCLES // 10)
        torch.cuda.synchronize()
    events = prof.events()
    ours = [e for e in events if e.device_type == DeviceType.CUDA
            and "nee_select_kernel" in e.name]
    ranges = {name: [e for e in events if e.device_type == DeviceType.CPU and e.name == name]
              for name in ("vrt.nee", "vrt::nee_select")}
    kernel_us = sum(e.time_range.elapsed_us() for e in ours)
    covered = {name: sum(e.device_time_total for e in rows) for name, rows in ranges.items()}
    check(len(ours) == 4 and all(len(rows) == 4 for rows in ranges.values()),
          f"a profiled frame: {len(ours)} nee_select kernels, ranges "
          f"{ {k: len(v) for k, v in ranges.items()} }")
    check(kernel_us > 0 and all(abs(us - kernel_us) <= 1e-3 * kernel_us
                                for us in covered.values()),
          f"profiled frame: kernels {kernel_us} us, ranges' device time {covered}")
    print(f"[15 nee] {lanes} lanes: kernel {frame_ms[0]:.4f} ms (mean of {NEE_REPS}), "
          f"bound {bound_ms:.4f} ms ({NEE_BYTES_PER_LANE} B a lane over 3.35 TB/s), plain "
          f"body {plain_frame_ms[0]:.3f} ms; a frame: 4 launches, {sum(frame_ms):.4f} ms "
          f"against the plain body's {sum(plain_frame_ms):.3f} ms; a profiled frame: "
          f"kernels {kernel_us:.1f} us, device time of their ranges " + ", ".join(
              f"{k} {v:.1f} us" for k, v in covered.items()), flush=True)
    return {"name": "nee_select", "route": "cuda",
            "source": "vulkanraytracing_torch/csrc/nee_select.cu", "replaces": None,
            "launches": len(calls), "ms": frame_ms[0], "plain_ms": plain_frame_ms[0],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "frame_ms": sum(frame_ms), "frame_launches": len(calls),
            "card_plain_idx_diff": idx_diff, "card_plain_pdf_max_ulp": pdf_ulps}


def lap(phase: str, since: float) -> float:
    """Print the wall seconds of ``phase`` (begun at ``since``) and return
    the time now, where the next phase begins."""
    now = time.perf_counter()
    print(f"[time] {phase}: {now - since:.1f} s", flush=True)
    return now


def allocator() -> tuple[int, int]:
    """The caching allocator's ``cudaMalloc`` calls so far and the bytes it
    holds reserved now."""
    stats = torch.cuda.memory_stats()
    return stats.get("segment.all.allocated", 0), stats.get("reserved_bytes.all.current", 0)


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


def time_sorts(render) -> list[float]:
    """Run ``render()`` (one frame) with CUDA events around every call of
    ``ops.reorder.sort_wavefront`` (the keys, the stable sort and every
    column's gather); returns each call's ms, read after the frame."""
    from vulkanraytracing_torch.ops import reorder

    events = []
    sort = reorder.sort_wavefront

    def timed_sort(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sort(*a)
        end.record()
        events.append((start, end))
        return out

    reorder.sort_wavefront = timed_sort
    try:
        render()
        torch.cuda.synchronize()
    finally:
        reorder.sort_wavefront = sort
    return [a.elapsed_time(b) for a, b in events]


def attribute_frame(render, spans: dict, label: str) -> None:
    """Run ``render()`` (one frame) under ``torch.profiler`` with host and
    device activity, each function of ``spans`` ({name: (module,
    attribute)}) wrapped in a ``record_function`` range, and print each
    range's calls and the device time of the kernels launched inside it
    (nested ranges are inside their parents'; a range inside one of the
    same name, a recursive call, is not counted again), then the
    traversal kernels' device time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for name, (module, attr) in spans.items():
        fn = getattr(module, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)

        saved.append((module, attr, fn))
        setattr(module, attr, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    def outermost(e):
        parent = e.cpu_parent
        while parent is not None:
            if parent.name == e.name:
                return False
            parent = parent.cpu_parent
        return True

    for name in spans:
        # a recursive call (a trace of the opaque view inside a trace) is
        # inside its caller's range: count the outermost ranges only
        rows = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU
                and outermost(e)]
        device_us = sum(getattr(e, "device_time_total", 0.0) or e.cuda_time_total for e in rows)
        print(f"{label} span {name}: {len(rows)} calls, device {device_us / 1e3:.3f} ms of "
              "PyTorch kernels", flush=True)
    # the traversal kernels are launched through ctypes, which the profiler
    # does not nest under the ranges: their time by kernel name
    ours = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "traverse_kernel" in e.name:
            key = e.name.split("(")[0].removeprefix("void ")
            ours[key][0] += e.time_range.elapsed_us()
            ours[key][1] += 1
    for name, (us, n) in sorted(ours.items()):
        print(f"{label} kernel {name}: {n} launches, device {us / 1e3:.3f} ms", flush=True)


def frames_alike(name, img, rays, ref_img, ref_rays, exact: bool) -> None:
    """A frame against another from the same state: ``exact`` asks for the
    image and ray count bit for bit; otherwise the packet kernels' tie
    gate (``FRAME_RAY_TOL``, ``FRAME_PIXEL_SHARE``)."""
    differ = (img != ref_img).any(dim=-1)
    far = ((img - ref_img).abs() > 1.0 / 255.0 + 1e-6).any(dim=-1)
    print(f"{name}: rays {rays} vs {ref_rays}; {int(differ.sum())} pixels differ, "
          f"{int(far.sum())} by more than 1/255", flush=True)
    if exact:
        check(not bool(differ.any()) and rays == ref_rays, f"{name}: bit-equal")
    else:
        check(abs(rays - ref_rays) <= FRAME_RAY_TOL * ref_rays
              and float(far.float().mean()) <= FRAME_PIXEL_SHARE, f"{name}: within the tie gate")


def timed_frame(render):
    """(render()'s result, its ms by the host clock, synchronized before
    and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def timed_calls(module, names, log: list):
    """Each call of ``module``'s functions ``names`` while inside, timed by
    the host clock with the card synchronized before and after, and the
    peak device memory over the call: (name, seconds, peak bytes) into
    ``log``."""
    saved = {name: getattr(module, name) for name in names}

    def timed_fn(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log.append((name, time.perf_counter() - t0, torch.cuda.max_memory_allocated()))
            return out
        return inner

    for name, fn in saved.items():
        setattr(module, name, timed_fn(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def kept_engines(cli):
    """The Engines that ``cli.main`` makes while inside, kept in a list,
    each with the ms of its draws (host clock, synchronized)."""
    made = []

    class Kept(cli.Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.draw_ms = []
            made.append(self)

        def draw(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().draw()
            torch.cuda.synchronize()
            self.draw_ms.append((time.perf_counter() - t0) * 1e3)

    saved, cli.Engine = cli.Engine, Kept
    try:
        yield made
    finally:
        cli.Engine = saved


def cli_stdout(cli, argv) -> tuple[int, str]:
    """``cli.main(argv)``'s exit code and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def pool_digest(pool) -> str:
    """sha256 over a texture pool's texels and its offset, width and height
    tables, as ``REAL_POOL_SHA256`` was taken."""
    digest = hashlib.sha256()
    for t in (pool.texels, pool.offset, pool.width, pool.height):
        digest.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())
    return digest.hexdigest()


def tool_run(tool: str, out_dir: Path) -> subprocess.Popen:
    """``python -m vulkanraytracing_torch.tools.<tool>`` in its small mode on
    the card, started from the checkout's root."""
    extra, argv = TOOL_RUNS[tool]
    return subprocess.Popen(
        [sys.executable, "-m", f"vulkanraytracing_torch.tools.{tool}", *argv,
         "--out-dir", str(out_dir / tool)],
        cwd=ROOT, env={**os.environ, **extra}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def tool_gates(tool: str, report: dict) -> bool:
    """The gates of a tool's report."""
    if tool == "parity_artifact":
        return report["all_pass"] and report["cases"]["cornell_parity"]["rmse"] == 0.0
    if tool == "measure_t1024":
        return report["measured_s"] > 0 and report["ratio"] > 0 and report["backend"] == "cuda"
    if tool == "hybrid_artifact":
        return report["rmse_pass_1e-3"]
    want = json.loads(ANISO_REPORT.read_text())
    return all(abs(report[k] - want[k]) <= ANISO_REL_TOL * want[k] for k in ANISO_KEYS)


def bench_command(extra_env: dict, *args: str) -> tuple[list[str], dict]:
    """``python -m vulkanraytracing_torch bench`` from the checkout's root
    with ``extra_env`` on top of this process's environment: the argv and
    env for ``subprocess``."""
    return ([sys.executable, "-m", "vulkanraytracing_torch", "bench", *args],
            {**os.environ, **extra_env})


def bench_run(label: str, extra_env: dict) -> tuple[dict, list, list, dict]:
    """Run the bench in a subprocess; its report, each measured frame's ms
    and rays, and its BVH8 launches over the measured frames.  Fails unless
    it exits with 0 and its last line has the JAX bench's keys."""
    argv, env = bench_command(extra_env)
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stderr.splitlines():
        print(f"[12 bench] {label}: {line}", flush=True)
    check(proc.returncode == 0, f"bench {label}: exit code {proc.returncode}")
    report = json.loads(proc.stdout.splitlines()[-1])
    check(set(report) == BENCH_KEYS, f"bench {label}: keys {sorted(report)}")
    frames = [m.groups() for m in re.finditer(r"^frame \d+: ([\d.]+) ms, (\d+) rays",
                                              proc.stderr, re.M)]
    check(len(frames) == report["frames"] > 0, f"bench {label}: {len(frames)} frame lines")
    found = re.search(r"bvh8 launches over the \d+ measured frames: closest (\d+), any (\d+)",
                      proc.stderr)
    check(found is not None, f"bench {label}: no launch line")
    launches = {"closest": int(found.group(1)), "any": int(found.group(2))}
    return report, [float(ms) for ms, _ in frames], [int(r) for _, r in frames], launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-dir", type=Path, default=None)
    args = parser.parse_args()
    script_start = time.perf_counter()

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
    try:  # the texture pool does not use it (phase 9 checks the pool's digest)
        pillow = f"Pillow {importlib.metadata.version('Pillow')} installed"
    except importlib.metadata.PackageNotFoundError:
        pillow = "no Pillow"
    print(f"[1 device] {pillow}", flush=True)

    # each kernel: its module and its LAUNCHES keys (closest, any-hit)
    kernels = {"bvh8": (tw, ("closest", "any")), "bvh2": (tw2, ("closest2", "any2")),
               "subpacket": (tsub, ("closest", "any")), "shared": (tpal, ("closest", "any"))}

    # -- 2. build -------------------------------------------------------
    t0 = phase_start = time.perf_counter()
    builds = [m.cuda_library for m, _ in kernels.values()] + [sah._library, bvh8._library]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = [future.result() for future in [pool.submit(build) for build in builds]]
    print(f"[2 build] the four traversal kernels (nvcc sm_90a) and the native "
          f"builders, in parallel: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, lib in zip(kernels, libs):
        for row in ptxas_report(lib):
            print(f"[2 build] ptxas {name} {row}", flush=True)
    for name, lib in zip(kernels, libs):
        for row in sass_loads(lib):
            print(f"[2 build] sass {name} {row}", flush=True)
    phase_start = lap("2 build", phase_start)

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
    phase_start = lap("3 kernel", phase_start)

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
    phase_start = lap("4 slice", phase_start)

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
    frame_ms, main_rays = [], []
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
        main_rays.append(rays)
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
    # frame 0 again with the wavefront sort off: the very same image
    with NoSort():
        (ref, ref_stats), ms = timed_frame(
            lambda: render_frame(v1, cfg, camera, create_render_state(cfg, device)))
    frames_alike(f"[5 main] frame 0 under VRT_DEBUG_NO_SORT=1 ({ms:.1f} ms) against "
                 "the sorted frame 0", ref.accumulation, int(ref_stats.rays), *first_frame,
                 exact=True)
    sorts = time_sorts(lambda: render_frame(v1, cfg, camera, state))
    print(f"[5 main] wavefront sort: {len(sorts)} calls a frame, "
          + " / ".join(f"{x:.3f}" for x in sorts) + f" ms, {sum(sorts):.3f} ms in all",
          flush=True)
    profile_frame(lambda: render_frame(v1, cfg, camera, state),
                  sum(frame_ms) / len(frame_ms), args.save_dir)
    # one more frame with every traversal launch recorded, then each alone;
    # and an unsorted frame's launches, timed only
    calls = record_frame(lambda: render_frame(v1, cfg, camera, state))
    in_frame = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[5 replay]")
    with NoSort():
        calls = record_frame(lambda: render_frame(v1, cfg, camera, state))
    unsorted = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[5 replay unsorted]",
                      check_plain=False, count=False)
    in_frame_unsorted = dict(unsorted)
    print("[5 main] BVH8 in frame, sorted / unsorted: " + "; ".join(
        f"{kind} {in_frame['bvh8'][kind][0]:.3f} / {unsorted['bvh8'][kind][0]:.3f} ms"
        for kind in ("closest", "any")), flush=True)
    del calls
    phase_start = lap("5 main", phase_start)

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
    phase_start = lap("6 bvh2", phase_start)

    # -- 7. the dynamic path through Engine -------------------------------
    cfg = Config(width=1920, height=1080, max_bounce_count=4,
                 camera=CameraConfig(**BENCH_CAMERA, aspect_ratio=1920 / 1080))

    def script(frame):
        """Frame 0 builds, 1-2 move, 3 holds still, later frames move."""
        return animation(frame if frame <= 2 else 2 if frame == 3 else frame - 1)

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
    for frame in range(4):
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
        moved = 1 <= frame <= 2
        check((len(refit_events) > n_refits) == moved, f"dynamic frame {frame}: refit")
        spp = eng.state.accum_index
        check(spp == (2 if frame == 3 else 1), f"dynamic frame {frame}: accum_index {spp}")
        kind_of = "build" if frame == 0 else "moving" if moved else "static"
        refit_txt = (f"refit {refit_events[-1][0].elapsed_time(refit_events[-1][1]):.2f} "
                     "ms, " if moved else "")
        print(f"[7 dynamic] frame {frame} ({kind_of}): {refit_txt}{ms:.1f} ms, "
              f"{int(rays)} rays, {rays / ms / 1e3:.2f} Mrays/s, accum_index {spp}; "
              f"launches bvh2 closest {n['closest2']}, any {n['any2']}, "
              f"bvh8 closest {n['closest']}, any {n['any']}", flush=True)
        if moved:
            moving_ms.append(ms)
        if frame == 2:
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
    geom, ref_bvh = build_bvh(tlas.world_geometry(inst, transforms(2)))
    ref, _ = render_frame(eng.scene._replace(geometry=geom, bvh=ref_bvh), cfg,
                          Camera(cfg.camera).to_device(device, cfg.reverse_depth),
                          create_render_state(cfg, device))
    differ = int((ref.accumulation != moved_img).any(dim=-1).sum())
    print(f"[7 dynamic] frame 2 over the refitted TLAS against a from-scratch "
          f"LBVH: {differ} pixels differ", flush=True)
    check(differ == 0, "refitted frame bit-equal to the rebuilt one")
    if args.save_dir is not None:
        np.save(args.save_dir / "dynamic_frame.npy", moved_img[::4, ::4].cpu().numpy())
    profile_frame(eng.draw, sum(moving_ms) / len(moving_ms), args.save_dir,
                  "dynamic_frame_trace.json")
    # one more moving frame with every traversal launch recorded, then each
    # alone over that frame's refitted tree
    calls = record_frame(eng.draw)
    in_frame.update(replay({"bvh2": tw2}, tw2, tw2.get_table2,
                           operator.attrgetter("records"), calls, "[7 replay]"))
    del calls
    phase_start = lap("7 dynamic", phase_start)

    # -- 8. the packet kernels ----------------------------------------------
    packet = {"subpacket": TraversalMode.BVH_SUBPACKET, "shared": TraversalMode.BVH_SHARED}
    soup_sah = build_scene_bvh(triangle_soup_scene(20000, seed=1, device=device), builder="sah")
    for tree, bvh in (("LBVH", soup_bvh), ("SAH", soup_sah.bvh)):
        for name in packet:
            compare(kernels[name][0], tw2.get_table2(bvh), *soup_rays,
                    f"[8 packet] soup20k {tree} {name}", reps=5)
    table2 = tw2.get_table2(v1.bvh)
    print(f"[8 packet] at the 1080p v1 frame's shapes, over the SAH tree's 2-wide "
          f"records ({table2.node.shape[0]} nodes, stack need {tw2.stack_need(v1.bvh)} "
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
            bounds[f"{name}_{kind}"] = bound(kind, rays[0].shape[0], table2.records,
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
            mallocs, reserved = allocator()
            t0 = time.perf_counter()
            state, stats = render_frame(v1, cfg, main_camera, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            mallocs_after, reserved_after = allocator()
            rays = int(stats.rays)
            n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
            check(n[f"{name}_closest"] >= 4 and n[f"{name}_any"] >= 4
                  and not any(c for k, c in n.items() if not k.startswith(name)),
                  f"{name} frame {frame}: launches {n}")
            print(f"[8 packet] {mode.name} frame {frame}: {ms:.1f} ms, {rays} rays, "
                  f"{rays / ms / 1e3:.2f} Mrays/s; launches "
                  + ", ".join(f"{k} {c}" for k, c in n.items())
                  + f"; {mallocs_after - mallocs} cudaMalloc calls, reserve "
                  f"{reserved / 2**30:.2f} -> {reserved_after / 2**30:.2f} GiB", flush=True)
            if frame == 0:
                img = state.accumulation
                frame_gate(mode.name, img, rays, ref_img, ref_rays)
                packet_first = (img.clone(), rays)
                if args.save_dir is not None:
                    np.save(args.save_dir / f"{name}_frame.npy", img[::4, ::4].cpu().numpy())
        launches.update({k: c for k, c in launch_counts(kernels).items() if k.startswith(name)})
        if name == "subpacket":
            # frame 0 again with the wavefront sort off
            with NoSort():
                (ref, ref_stats), ms = timed_frame(lambda: render_frame(
                    v1, cfg, main_camera, create_render_state(cfg, device)))
            frames_alike(f"[8 packet] {mode.name} frame 0 under VRT_DEBUG_NO_SORT=1 "
                         f"({ms:.1f} ms) against the sorted frame 0", ref.accumulation,
                         int(ref_stats.rays), *packet_first, exact=False)

    # one more BVH_SUBPACKET frame with every traversal launch recorded, then
    # each alone through both packet kernels, over the v1 tree's records:
    # at 1920x1080 kernel ms and bounds (sorted, then an unsorted frame's
    # kernel ms), and at 480x270 (1/16 of the rays) with the depth cut to 2
    # bounces (the primary rays and one incoherent bounce; the script's time
    # limit) kernel = plain version on every launch
    packet_modules = {name: kernels[name][0] for name in packet}
    records = operator.attrgetter("records")
    cfg = main_cfg.replace(traversal=TraversalMode.BVH_SUBPACKET)
    state = create_render_state(cfg, device)
    calls = record_frame(lambda: render_frame(v1, cfg, main_camera, state))
    in_frame.update(replay(packet_modules, tw2, tw2.get_table2, records, calls, "[8 replay]",
                           check_plain=False))
    with NoSort():
        calls = record_frame(lambda: render_frame(v1, cfg, main_camera, state))
    unsorted = replay(packet_modules, tw2, tw2.get_table2, records, calls,
                      "[8 replay unsorted]", check_plain=False, count=False)
    in_frame_unsorted.update(unsorted)
    for name in packet:
        print(f"[8 packet] {name} in frame, sorted / unsorted: " + "; ".join(
            f"{kind} {in_frame[name][kind][0]:.3f} / {unsorted[name][kind][0]:.3f} ms"
            for kind in ("closest", "any")), flush=True)
    small = cfg.replace(width=480, height=270, max_bounce_count=2)
    calls = record_frame(lambda: render_frame(v1, small, Camera(small.camera).to_device(device),
                                              create_render_state(small, device)))
    replay(packet_modules, tw2, tw2.get_table2, records, calls, "[8 replay 480x270]")
    del calls

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
    phase_start = lap("8 packet", phase_start)

    # -- 9. the real workload -------------------------------------------------
    from vulkanraytracing_torch.ops import reorder, trace
    from vulkanraytracing_torch.pt import integrator, surface

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real = sponza_like_scene(262144, workload="real", device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    real = build_scene_bvh(real, builder="sah")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    alpha = real.alpha
    n_cut = alpha.geometry.num_triangles
    check(n_cut > 0 and int(real.geometry.alpha_test.sum()) == n_cut, "real scene cutouts")
    pano = real.environment.panorama
    print(f"[9 real] real scene: {real.geometry.num_triangles} triangles, {n_cut} "
          f"alpha-tested (a subset tree of {alpha.bvh.nodes8.shape[0]} BVH8 nodes, stack "
          f"{bvh8._worst_case_stack(alpha.bvh.child8.cpu().numpy())}); texture pool of "
          f"{real.textures.count} textures, {real.textures.max_levels} levels, "
          f"{real.textures.nbytes / 2**20:.2f} MiB; panorama {pano.shape[0]}x{pano.shape[1]}; "
          f"scene {t1 - t0:.2f} s, SAH build + BVH8 collapse + cutout subset "
          f"{t2 - t1:.2f} s", flush=True)
    digest = pool_digest(real.textures)
    print(f"[9 real] texture pool sha256 {digest} (the JAX package's pool: "
          f"{REAL_POOL_SHA256})", flush=True)
    check(digest == REAL_POOL_SHA256, "real scene: the texture pool is not the JAX package's")
    tables = {id(real.bvh): "main", id(alpha.opaque_bvh): "opaque view", id(alpha.bvh): "subset"}

    def name_of(bvh):
        return tables.get(id(bvh), "other")

    cfg = main_cfg
    state = create_render_state(cfg, device)
    for module, _ in kernels.values():
        module.LAUNCHES.clear()
    real_ms, real_rays = [], []
    for frame in range(3):
        before = launch_counts(kernels)
        with TableCounts(name_of) as by_table:
            (state, stats), ms = timed_frame(
                lambda: render_frame(real, cfg, main_camera, state))
        real_ms.append(ms)
        rays = int(stats.rays)
        real_rays.append(rays)
        n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
        split = by_table.counts
        check(not any(c for k, c in n.items() if not k.startswith("bvh8")),
              f"real frame {frame}: other kernels launched: {n}")
        check(set(t for t, _ in split) == {"opaque view", "subset"},
              f"real frame {frame}: tables traversed {dict(split)}")
        for kind in ("closest", "any"):
            check(n[f"bvh8_{kind}"] == sum(c for (_, k), c in split.items() if k == kind),
                  f"real frame {frame}: {kind} launches {n} by table {dict(split)}")
        check(split[("opaque view", "closest")] >= 4 and split[("opaque view", "any")] >= 4
              and split[("subset", "closest")] >= 8,
              f"real frame {frame}: launches by table {dict(split)}")
        print(f"[9 real] frame {frame}: {ms:.1f} ms, {rays} rays, {rays / ms / 1e3:.2f} "
              f"Mrays/s; launches bvh8 closest {n['bvh8_closest']} (opaque view "
              f"{split[('opaque view', 'closest')]}, subset {split[('subset', 'closest')]}), "
              f"any {n['bvh8_any']} (opaque view {split[('opaque view', 'any')]}, subset "
              f"{split[('subset', 'any')]})", flush=True)
        if frame == 0:
            real_first = (state.accumulation.clone(), rays)
    real_launches = {k: c for k, c in launch_counts(kernels).items() if k.startswith("bvh8")}
    img = state.accumulation
    check(tuple(img.shape) == (1080, 1920, 3) and bool(torch.isfinite(img).all())
          and float(img.max()) > 0.0, "real image: shape, finite, not black")
    print(f"[9 real] image 1080x1920: mean {float(img.mean()):.4f}, max "
          f"{float(img.max()):.4f}", flush=True)
    if args.save_dir is not None:
        np.save(args.save_dir / "real_frame.npy", img[::4, ::4].cpu().numpy())
    profile_frame(lambda: render_frame(real, cfg, main_camera, state),
                  sum(real_ms[1:]) / len(real_ms[1:]), args.save_dir, "real_frame_trace.json")
    attribute_frame(lambda: render_frame(real, cfg, main_camera, state), {
        "shading: material unpack": (integrator, "unpack_material"),
        "shading: texture sampling": (surface, "sample_pool"),
        "trace_closest": (trace, "trace_closest"),
        "trace_any": (trace, "trace_any"),
        "cutout subset phase": (trace, "_closest_alpha_subset"),
        "alpha rounds (_resolve_alpha)": (trace, "_resolve_alpha"),
        "_hit_alpha": (trace, "_hit_alpha"),
        "_hit_alpha: texture sampling": (trace, "sample_pool"),
        "wavefront sort": (reorder, "sort_wavefront"),
    }, "[9 real]")

    # frame 0 again with the sort off
    with NoSort():
        (ref, ref_stats), ms = timed_frame(lambda: render_frame(
            real, cfg, main_camera, create_render_state(cfg, device)))
    frames_alike(f"[9 real] frame 0 under VRT_DEBUG_NO_SORT=1 ({ms:.1f} ms) against the "
                 "sorted frame 0", ref.accumulation, int(ref_stats.rays), *real_first,
                 exact=True)

    # one more frame with every traversal launch recorded, then each alone
    # over its table (the opaque view's or the subset's)
    calls = record_frame(lambda: render_frame(real, cfg, main_camera, state))
    real_in_frame = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[9 replay]",
                           name_of=name_of)["bvh8"]
    del calls

    # the kernels against brute force with the alpha re-trace, at the
    # 20,000-triangle target
    small_real = build_scene_bvh(sponza_like_scene(20000, workload="real", device=device),
                                 builder="sah")
    small = Config(width=128, height=72, max_bounce_count=4,
                   camera=CameraConfig(**BENCH_CAMERA, aspect_ratio=128 / 72))
    small_cam = Camera(small.camera).to_device(device)
    out = {}
    for mode in (TraversalMode.BVH_KERNEL, TraversalMode.BRUTE_FORCE):
        mcfg = small.replace(traversal=mode)
        (st, st_stats), ms = timed_frame(lambda: render_frame(
            small_real, mcfg, small_cam, create_render_state(mcfg, device)))
        out[mode] = (st.accumulation, int(st_stats.rays), ms)
    (a, ra, ma), (b, rb, mb) = out[TraversalMode.BVH_KERNEL], out[TraversalMode.BRUTE_FORCE]
    far = float(((a - b).abs() > 1.0 / 255.0 + 1e-6).float().mean())
    print(f"[9 real] 128x72 at the 20,000-triangle target ({small_real.geometry.num_triangles} "
          f"triangles, {small_real.alpha.geometry.num_triangles} alpha-tested): BVH_KERNEL "
          f"{ma:.1f} ms, {ra} rays; BRUTE_FORCE {mb:.1f} ms, {rb} rays; {far:.2e} of the "
          f"channels more than 1/255 apart, {int((a != b).any(dim=-1).sum())} pixels differ",
          flush=True)
    check(far <= 1e-3 and bool(torch.isfinite(a).all()) and float(a.max()) > 0.0,
          "real 128x72: BVH_KERNEL against BRUTE_FORCE")
    phase_start = lap("9 real", phase_start)

    # -- 10. the entry point: .glb and .hdr in, PNG out, both modes ---------
    from vulkanraytracing_torch.app import cli
    from vulkanraytracing_torch.app.events import EventType
    from vulkanraytracing_torch.app.hdr import write_hdr
    from vulkanraytracing_torch.app.image_io import read_png
    from vulkanraytracing_torch.env import ibl
    from vulkanraytracing_torch.hybrid import render_hybrid
    from vulkanraytracing_torch.scene.gltf import load_scene
    from vulkanraytracing_torch.scene.gltf_export import export_scene_glb
    from vulkanraytracing_torch.scene.procedural import sponza_real_images

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        # (a) phase 9's real scene through a .glb and an .hdr, and back
        t0 = time.perf_counter()
        glb = export_scene_glb(real, work / "real.glb", images=sponza_real_images())
        t1 = time.perf_counter()
        hdr = work / "sky.hdr"
        write_hdr(hdr, real.environment.panorama.cpu().numpy())
        t2 = time.perf_counter()
        loaded, _, pool = load_scene(glb, device=device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"[10 entry] exported real.glb ({glb.stat().st_size} bytes) in {t1 - t0:.2f} s "
              f"and sky.hdr ({hdr.stat().st_size} bytes) in {t2 - t1:.2f} s; loaded the .glb "
              f"in {t3 - t2:.2f} s: {loaded.geometry.num_triangles} triangles, "
              f"{int(loaded.geometry.alpha_test.sum())} alpha-tested, texture pool "
              f"{pool.nbytes} bytes", flush=True)
        check(loaded.geometry.num_triangles == real.geometry.num_triangles
              and int(loaded.geometry.alpha_test.sum()) == n_cut
              and pool.nbytes == real.textures.nbytes
              and torch.equal(pool.texels, real.textures.texels),
              "the .glb round trip keeps the triangles, the cutouts and the texture pool")
        # The exporter writes no TANGENT (as the JAX package's), so the
        # loader makes each triangle's tangents from its uvs, and 1-spp
        # path tracing maps the same random numbers through other frames:
        # that frame is printed.  The gate is held by the loaded scene with
        # the procedural shading frames put back, triangle by triangle (the
        # exporter writes the triangles grouped by material, culling and
        # alpha test, in their order within a group)
        g = real.geometry
        order = torch.from_numpy(np.lexsort((g.alpha_test.cpu().numpy(),
                                             g.cull_disable.cpu().numpy(),
                                             g.material_id.cpu().numpy()))).to(device)
        check(torch.equal(loaded.geometry.v0, g.v0[order])
              and torch.equal(loaded.geometry.e1, g.e1[order]),
              "the .glb keeps each triangle, grouped as the exporter writes them")
        frames_of = {name: getattr(g, name)[order] for name in ("n0", "n1", "n2", "t0", "t1", "t2")}
        differ = {name: float((getattr(loaded.geometry, name) != x).any(dim=-1).float().mean())
                  for name, x in frames_of.items() if name in ("n0", "t0")}
        loaded = loaded._replace(environment=real.environment, direct_light=real.direct_light)
        for label, scene in (("as loaded", loaded), (
                "with the procedural shading frames",
                loaded._replace(geometry=loaded.geometry._replace(**frames_of)))):
            scene = build_scene_bvh(scene, builder="sah")
            (st, st_stats), ms = timed_frame(lambda: render_frame(
                scene, cfg, main_camera, create_render_state(cfg, device)))
            a, b = st.accumulation, real_first[0]
            far = float(((a - b).abs() > 1.0 / 255.0 + 1e-6).float().mean())
            print(f"[10 entry] the loaded scene {label}: frame 0 {ms:.1f} ms, "
                  f"{int(st_stats.rays)} rays, against phase 9's frame 0 ({real_first[1]} rays): "
                  f"{far:.2e} of the channels more than 1/255 apart, bit-equal "
                  f"{bool(torch.equal(a, b))}", flush=True)
            check(bool(torch.isfinite(a).all()) and float(a.max()) > 0.0,
                  f"the .glb scene's frame ({label}): finite, not black")
        print(f"[10 entry] shares of the triangles whose loaded normal / tangent differ from "
              f"the procedural scene's: {differ['n0']:.4f} / {differ['t0']:.4f}", flush=True)
        check(far <= 1e-3, "the .glb scene's frame, with the procedural shading frames, "
                           "against phase 9's frame 0")
        del loaded, scene, st

        # (b) the hybrid mode through the CLI, then its Engine's frames
        png = work / "hybrid.png"
        bakes = []
        for module, _ in kernels.values():
            module.LAUNCHES.clear()
        with kept_engines(cli) as engines, timed_calls(ibl, (
                "compute_irradiance_cube", "compute_reflection_cube", "compute_brdf_lut"),
                bakes):
            t0 = time.perf_counter()
            rc = cli.main(["render", "--scene", str(glb), "--env", str(hdr), "--mode", "hybrid",
                           "--width", "1920", "--height", "1080", "--out", str(png)])
            cli_s = time.perf_counter() - t0
        cli_launches = launch_counts(kernels)
        eng = engines[-1]
        check(rc == 0 and eng.cfg.traversal == TraversalMode.BVH_KERNEL,
              "hybrid render through the CLI")
        for name, sec, peak in bakes:
            print(f"[10 hybrid] IBL bake {name}: {sec:.3f} s, peak device memory "
                  f"{peak / 2**30:.2f} GiB", flush=True)
        env = eng.scene.environment
        check(tuple(env.irradiance.shape) == (6, 128, 128, 3) and len(env.reflection) == 10
              and tuple(env.brdf_lut.shape) == (256, 256, 2)
              and all(bool(torch.isfinite(m).all()) for m in (env.irradiance, env.brdf_lut,
                                                               *env.reflection)),
              "the IBL bake's sizes and values")
        shown = read_png(png)
        check(np.array_equal(shown, eng.display_image()),
              "the hybrid PNG read back equals Engine.display_image()")
        check(cli_launches["bvh8_closest"] > 0 and cli_launches["bvh8_any"] > 0
              and not any(c for k, c in cli_launches.items() if not k.startswith("bvh8")),
              f"hybrid CLI frame launches {cli_launches}")
        print(f"[10 hybrid] CLI render --mode hybrid 1920x1080: {cli_s:.2f} s in all "
              f"(load, SAH build, sun, bake, {eng.draw_ms[0]:.1f} ms frame, PNG); launches "
              f"{cli_launches}; PNG {png.stat().st_size} bytes = display image; sun direction "
              f"{[round(x, 4) for x in eng.scene.direct_light.direction[:3].tolist()]}",
              flush=True)
        if args.save_dir is not None:
            shutil.copy(png, args.save_dir / "hybrid.png")

        # the Engine's frames from the bench camera (a camera move)
        eng.camera.set_position(BENCH_CAMERA["position"])
        eng.camera.set_target(BENCH_CAMERA["target"])
        eng.bus.trigger(EventType.CAMERA_UPDATE, None)
        h_tables = {id(eng.scene.alpha.opaque_bvh): "opaque view", id(eng.scene.alpha.bvh): "subset"}

        def h_name(bvh):
            return h_tables.get(id(bvh), "other")

        for module, _ in kernels.values():
            module.LAUNCHES.clear()
        hybrid_ms = []
        for frame in range(3):
            before = launch_counts(kernels)
            with TableCounts(h_name) as by_table:
                _, ms = timed_frame(eng.draw)
            hybrid_ms.append(ms)
            n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
            split = by_table.counts
            check(not any(c for k, c in n.items() if not k.startswith("bvh8"))
                  and set(t for t, _ in split) == {"opaque view", "subset"}
                  and all(n[f"bvh8_{kind}"] == sum(c for (_, k), c in split.items() if k == kind)
                          for kind in ("closest", "any")),
                  f"hybrid frame {frame}: launches {n} by table {dict(split)}")
            print(f"[10 hybrid] frame {frame}: {ms:.1f} ms; launches bvh8 closest "
                  f"{n['bvh8_closest']} (opaque view {split[('opaque view', 'closest')]}, subset "
                  f"{split[('subset', 'closest')]}), any {n['bvh8_any']} (opaque view "
                  f"{split[('opaque view', 'any')]}, subset {split[('subset', 'any')]})",
                  flush=True)
        hybrid_launches = {k: c for k, c in launch_counts(kernels).items() if k.startswith("bvh8")}
        img = eng.state.accumulation
        check(tuple(img.shape) == (1080, 1920, 3) and bool(torch.isfinite(img).all())
              and float(img.max()) > 0.0, "hybrid image: shape, finite, not black")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.draw()
        print(f"[10 hybrid] image 1080x1920: mean {float(img.mean()):.4f}; peak device memory "
              f"of a frame {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if args.save_dir is not None:
            np.save(args.save_dir / "hybrid_frame.npy", img[::4, ::4].cpu().numpy())
        profile_frame(eng.draw, sum(hybrid_ms[1:]) / len(hybrid_ms[1:]), args.save_dir,
                      "hybrid_frame_trace.json")
        from vulkanraytracing_torch.hybrid import renderer

        attribute_frame(eng.draw, {
            "G-buffer: trace_closest": (trace, "trace_closest"),
            "shadow rays: trace_any": (trace, "trace_any"),
            "cutout subset phase": (trace, "_closest_alpha_subset"),
            "_hit_alpha": (trace, "_hit_alpha"),
            "material unpack": (renderer, "unpack_material"),
            "material: texture sampling": (surface, "sample_pool"),
            "footprint": (renderer, "_footprint"),
            "IBL: irradiance cube": (renderer, "sample_cube"),
            "IBL: reflection mips": (renderer, "sample_cube_mips"),
            "sky": (renderer, "sample_environment"),
            "light spheres": (renderer, "intersect_point_light_spheres"),
        }, "[10 hybrid]")
        calls = record_frame(eng.draw)
        hybrid_in_frame = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[10 replay]",
                                 name_of=h_name)["bvh8"]
        del calls

        # (d) hybrid through the kernel against brute force, 128x72 at the
        # 20,000-triangle target, under the baked environment and its sun
        small_h = small_real._replace(environment=env, direct_light=eng.scene.direct_light)
        out = {}
        for mode in (TraversalMode.BVH_KERNEL, TraversalMode.BRUTE_FORCE):
            mcfg = small.replace(traversal=mode)
            out[mode], ms = timed_frame(lambda: render_hybrid(small_h, mcfg, small_cam))
        a, b = out[TraversalMode.BVH_KERNEL], out[TraversalMode.BRUTE_FORCE]
        far = float(((a - b).abs() > 1.0 / 255.0 + 1e-6).float().mean())
        print(f"[10 hybrid] 128x72 at the 20,000-triangle target: BVH_KERNEL against "
              f"BRUTE_FORCE {far:.2e} of the channels more than 1/255 apart, "
              f"{int((a != b).any(dim=-1).sum())} pixels differ", flush=True)
        check(far <= 1e-3 and bool(torch.isfinite(a).all()) and float(a.max()) > 0.0,
              "hybrid 128x72: BVH_KERNEL against BRUTE_FORCE")
        del eng, engines

        # (c) path tracing through the CLI, and compare
        pt_png = work / "pt.png"
        for module, _ in kernels.values():
            module.LAUNCHES.clear()
        with kept_engines(cli) as engines:
            rc = cli.main(["render", "--scene", str(glb), "--env", str(hdr), "--mode", "pt",
                           "--spp", "2", "--width", "1920", "--height", "1080",
                           "--out", str(pt_png)])
        pt_launches = launch_counts(kernels)
        eng = engines[-1]
        check(rc == 0 and eng.state.accum_index == 2 and pt_launches["bvh8_closest"] > 0,
              f"pt render through the CLI: launches {pt_launches}")
        print(f"[10 pt] CLI render --mode pt --spp 2 1920x1080: frames "
              + " / ".join(f"{x:.1f}" for x in eng.draw_ms) + f" ms, {eng.total_rays:.0f} rays, "
              f"{eng.total_rays / sum(eng.draw_ms) / 1e3:.2f} Mrays/s; launches {pt_launches}",
              flush=True)
        rc, said = cli_stdout(cli, ["compare", str(pt_png), str(pt_png)])
        check(rc == 0 and json.loads(said)["rmse"] == 0.0, f"compare of a PNG with itself: {said}")
        print(f"[10 pt] compare pt.png pt.png: {said.strip()}", flush=True)
        del eng, engines
    phase_start = lap("10 entry", phase_start)

    # -- 11. the rest: 1M-triangle scenes, sharding, spans, BVH_PER_RAY,
    # profiling ---------------------------------------------------------------
    from vulkanraytracing_torch.parallel import (
        make_render_mesh, replicate_scene, shard_render_frame, shard_render_frame_samples,
    )
    from vulkanraytracing_torch.pt.render import accumulate, render_span, trace_rows
    from vulkanraytracing_torch.utils.profiling import profile_to, trace_scope

    # (a) the v1 and real scenes at 1,048,576 triangles, each one BVH8 table
    big = {}
    for workload in ("v1", "real"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene = sponza_like_scene(1 << 20, workload=workload, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scene = build_scene_bvh(scene, builder="sah")
        # every table the frames read is packed here, not in a timed frame
        for bvh in ((scene.bvh,) if scene.alpha is None
                    else (scene.bvh, scene.alpha.opaque_bvh, scene.alpha.bvh)):
            tw.get_table8(bvh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        need = bvh8._worst_case_stack(scene.bvh.child8.cpu().numpy())
        check(need <= tw.STACK_DEPTH, f"1M {workload}: stack need {need}")
        cut = "" if scene.alpha is None else (
            f", {scene.alpha.geometry.num_triangles} alpha-tested (subset stack "
            f"{bvh8._worst_case_stack(scene.alpha.bvh.child8.cpu().numpy())})")
        print(f"[11 big] {workload} 1M: {scene.geometry.num_triangles} triangles{cut}; "
              f"{scene.bvh.nodes8.shape[0]} BVH8 nodes, stack need {need} of {tw.STACK_DEPTH} "
              f"(BVH2 {tw2.stack_need(scene.bvh)}); scene {t1 - t0:.2f} s, SAH build + BVH8 "
              f"collapse + tables {t2 - t1:.2f} s", flush=True)
        big[workload] = scene
    for module, _ in kernels.values():
        module.LAUNCHES.clear()
    big_ms = {}
    for workload, frames in (("v1", 2), ("real", 2)):
        scene = big[workload]
        tables = ({id(scene.alpha.opaque_bvh): "opaque view", id(scene.alpha.bvh): "subset"}
                  if scene.alpha is not None else {id(scene.bvh): "main"})
        state = create_render_state(main_cfg, device)
        big_ms[workload] = []
        for frame in range(frames):
            before = launch_counts(kernels)
            with TableCounts(lambda bvh, t=tables: t.get(id(bvh), "other")) as by_table:
                (state, stats), ms = timed_frame(
                    lambda: render_frame(scene, main_cfg, main_camera, state))
            big_ms[workload].append(ms)
            rays = int(stats.rays)
            n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
            check(n["bvh8_closest"] >= 4 and n["bvh8_any"] >= 4
                  and not any(c for k, c in n.items() if not k.startswith("bvh8")),
                  f"1M {workload} frame {frame}: launches {n}")
            split = ", ".join(f"{t} {k} {c}" for (t, k), c in sorted(by_table.counts.items()))
            print(f"[11 big] {workload} 1M frame {frame}: {ms:.1f} ms, {rays} rays, "
                  f"{rays / ms / 1e3:.2f} Mrays/s; launches bvh8 closest {n['bvh8_closest']}, "
                  f"any {n['bvh8_any']} (by table: {split})", flush=True)
        img = state.accumulation
        check(tuple(img.shape) == (1080, 1920, 3) and bool(torch.isfinite(img).all())
              and float(img.max()) > 0.0, f"1M {workload} image: shape, finite, not black")
    big_launches = {k: c for k, c in launch_counts(kernels).items() if k.startswith("bvh8")}
    # one more v1 frame recorded, each launch replayed alone against the
    # plain version in every field, with kernel ms and bound
    v1_big = big["v1"]
    calls = record_frame(lambda: render_frame(v1_big, main_cfg, main_camera,
                                              create_render_state(main_cfg, device)))
    big_in_frame = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[11 replay 1M]")["bvh8"]
    del calls, big, v1_big, scene, state, img
    torch.cuda.empty_cache()

    # (b) sharding on phase 5's v1 scene: two shards on the one card run one
    # after the other, so this checks correctness only
    mesh = make_render_mesh([device, device])
    replicas = replicate_scene(v1, mesh)
    check(list(replicas) == [device] and replicas[device] is v1, "one replica on one card")
    single, sharded = create_render_state(main_cfg, device), create_render_state(main_cfg, device)
    for frame in range(2):
        (single, s_stats), s_ms = timed_frame(
            lambda: render_frame(v1, main_cfg, main_camera, single))
        before = launch_counts(kernels)
        (sharded, m_stats), m_ms = timed_frame(
            lambda: shard_render_frame(replicas, main_cfg, main_camera, sharded, mesh))
        n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
        frames_alike(f"[11 shard] frame {frame} over [cuda:0, cuda:0] ({m_ms:.1f} ms; "
                     f"launches bvh8 closest {n['bvh8_closest']}, any {n['bvh8_any']}) against "
                     f"the unsharded frame ({s_ms:.1f} ms)", sharded.accumulation,
                     int(m_stats.rays), single.accumulation, int(s_stats.rays), exact=True)
        check(n["bvh8_closest"] >= 8 and n["bvh8_any"] >= 8, f"sharded frame launches {n}")
    (step, step_stats), ms = timed_frame(lambda: shard_render_frame_samples(
        replicas, main_cfg, main_camera, create_render_state(main_cfg, device), mesh))
    samples = [trace_rows(v1, main_cfg, main_camera, k, device) for k in range(2)]
    want = accumulate((samples[0][0] + samples[1][0]) / 2 * 2,
                      torch.zeros_like(step.accumulation), 0.0, 2.0, main_cfg)
    frames_alike(f"[11 shard] sample-parallel step over 2 shards ({ms:.1f} ms) against the "
                 "mean of the samples of 2 unsharded frames", step.accumulation,
                 int(step_stats.rays), want, sum(int(r) for _, r in samples), exact=True)
    eng = Engine(main_cfg, v1, mesh=mesh, device=device)
    before = launch_counts(kernels)
    _, ms = timed_frame(eng.draw)
    n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
    ref, ref_stats = render_frame(v1, main_cfg, eng._device_camera(),
                                  create_render_state(main_cfg, device))
    check(n["bvh8_closest"] >= 8 and n["bvh8_any"] >= 8, f"Engine(mesh=...) launches {n}")
    frames_alike(f"[11 shard] Engine(mesh=[cuda:0, cuda:0]) frame ({ms:.1f} ms, launches "
                 f"bvh8 closest {n['bvh8_closest']}, any {n['bvh8_any']}) against render_frame",
                 eng.state.accumulation, int(eng.total_rays), ref.accumulation,
                 int(ref_stats.rays), exact=True)
    too_many = torch.cuda.device_count() + 1
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            cli.main(["render", "--scene", "triangle", "--width", "16", "--height", "16",
                      "--devices", str(too_many), "--out", "/dev/null"])
        raise RuntimeError(f"--devices {too_many} did not exit")
    except SystemExit as exc:
        said = str(exc)
    check("available" in said, f"--devices {too_many}: {said}")
    print(f"[11 shard] --devices {too_many} on {torch.cuda.device_count()} card(s) exits: "
          f"{said}", flush=True)
    del eng, replicas, samples, step, single, sharded, ref

    # (c) a span, the per-ray reference backend, a profiled frame
    small = main_cfg.replace(width=480, height=270)
    small_cam = Camera(small.camera).to_device(device)
    (spanned, span_stats), span_ms = timed_frame(lambda: render_span(
        v1, small, small_cam, create_render_state(small, device), 4))
    state, rays = create_render_state(small, device), 0
    for _ in range(4):
        state, stats = render_frame(v1, small, small_cam, state)
        rays += int(stats.rays)
    check(spanned.accum_index == 4, "render_span(4) counts 4 frames")
    frames_alike(f"[11 span] render_span(4) at 480x270 ({span_ms:.1f} ms) against 4 "
                 "render_frame calls", spanned.accumulation, int(span_stats.rays),
                 state.accumulation, rays, exact=True)
    one = small.replace(max_bounce_count=1)
    ref, ref_stats = render_frame(v1, one, small_cam, create_render_state(one, device))
    before = launch_counts(kernels)
    (per_ray, per_ray_stats), ms = timed_frame(lambda: render_frame(
        v1, one.replace(traversal=TraversalMode.BVH_PER_RAY), small_cam,
        create_render_state(one, device)))
    n = {k: c - before[k] for k, c in launch_counts(kernels).items()}
    check(not any(n.values()), f"BVH_PER_RAY launched kernels: {n}")
    frames_alike(f"[11 per-ray] BVH_PER_RAY 480x270, 1 bounce ({ms:.1f} ms, plain torch, no "
                 "kernel) against BVH_KERNEL", per_ray.accumulation, int(per_ray_stats.rays),
                 ref.accumulation, int(ref_stats.rays), exact=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        with profile_to(tmp):
            with trace_scope("chip_smoke 480x270 frame"):
                render_frame(v1, small, small_cam, create_render_state(small, device))
        traces = list(Path(tmp).glob("*.json"))
        check(len(traces) == 1, f"profile_to wrote {len(traces)} traces")
        events = json.loads(traces[0].read_text())["traceEvents"]
        names = collections.Counter(str(e.get("name", "")) for e in events)
        found = names["chip_smoke 480x270 frame"]
        ours = sum(c for name, c in names.items() if "traverse_kernel" in name)
        check(found >= 1 and ours >= 8, f"profile_to trace: scope {found}, kernels {ours}")
        print(f"[11 profile] profile_to: {traces[0].stat().st_size} bytes, {len(events)} events, "
              f"the trace_scope range {found}x, {ours} traversal kernel events", flush=True)
    phase_start = lap("11 rest", phase_start)

    # -- 12. the bench entry point, in subprocesses -------------------------
    torch.cuda.empty_cache()
    too_many = str(torch.cuda.device_count() + 1)
    argv, env = bench_command({}, "--devices", too_many)
    refused = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    bench_launches = {}
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: refused.poll() is None and refused.kill())
        glb_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_bench_"))
        cases = (("v1", {"VRT_BENCH_FRAMES": "5", "VRT_BENCH_GLB_DIR": glb_dir},
                  frame_ms, main_rays, "phase 5"),
                 ("real", {"VRT_BENCH_WORKLOAD": "real", "VRT_BENCH_NO_LOADER": "1",
                           "VRT_BENCH_FRAMES": "3"}, real_ms, real_rays, "phase 9"))
        for workload, extra, ref_ms, ref_rays, ref in cases:
            report, ms, rays, n = bench_run(workload, extra)
            if workload == "v1":
                out, err = refused.communicate(timeout=300)
                check(refused.returncode != 0 and "requested but only" in err
                      and "scene:" not in err and json.loads(out.splitlines()[-1])["partial"],
                      f"bench --devices {too_many}: exit code {refused.returncode}, {err!r}")
                print(f"[12 bench] --devices {too_many} on {torch.cuda.device_count()} card(s) "
                      f"exits {refused.returncode} before building a scene: "
                      f"{err.strip().splitlines()[-1]}", flush=True)
            check(report["workload"] == workload, f"bench {workload}: {report['workload']}")
            check(n["closest"] > 0 and n["any"] > 0, f"bench {workload}: BVH8 launches {n}")
            median = float(np.median(ref_ms))
            check(min(ms) <= BENCH_MS_RATIO * median,
                  f"bench {workload}: best frame {min(ms):.1f} ms against {ref}'s median "
                  f"{median:.1f} ms")
            mean_rays = sum(ref_rays) / len(ref_rays)
            check(all(abs(r - mean_rays) <= BENCH_RAY_TOL * mean_rays for r in rays),
                  f"bench {workload}: rays {rays} against {ref}'s {ref_rays}")
            bench_launches[workload] = n
            print(f"[12 bench] {workload}: best {min(ms):.1f} ms, median "
                  f"{float(np.median(ms)):.1f} ms ({ref}: median {median:.1f} ms, ratio "
                  f"{min(ms) / median:.3f}); rays {min(rays)}-{max(rays)} ({ref}: "
                  f"{min(ref_rays)}-{max(ref_rays)}); BVH8 launches closest {n['closest']}, "
                  f"any {n['any']}", flush=True)
            print(f"[12 bench] {workload} report: {json.dumps(report)}", flush=True)
    print(f"[12 bench] {smi}", flush=True)
    phase_start = lap("12 bench", phase_start)

    # -- 13. the evidence tools' small modes, in subprocesses, all at once --
    tools_launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tools_dir:
        procs = {tool: tool_run(tool, Path(tools_dir)) for tool in TOOL_RUNS}
        try:
            for tool, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                for line in err.splitlines():
                    print(f"[13 tools] {tool}: {line}", flush=True)
                check(proc.returncode == 0, f"{tool}: exit code {proc.returncode}")
                report = json.loads(out.splitlines()[-1])
                check(report["device"] == smi, f"{tool}: device {report['device']!r}")
                check(tool_gates(tool, report), f"{tool}: gates of {json.dumps(report)}")
                found = re.search(r"bvh8 launches over [^:]+: closest (\d+), any (\d+)", err)
                check(found is not None, f"{tool}: no launch line")
                n = {"closest": int(found.group(1)), "any": int(found.group(2))}
                # the aniso plane is textured and has no cutouts, so its shadow
                # rays go through the closest-hit alpha loop: closest only
                check(n["closest"] + n["any"] > 0, f"{tool}: BVH8 launches {n}")
                tools_launches[tool] = n
                print(f"[13 tools] {tool}: exit 0, gates pass, BVH8 launches closest "
                      f"{n['closest']}, any {n['any']}; report {json.dumps(report)}",
                      flush=True)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    phase_start = lap("13 tools", phase_start)

    # -- 14. the plane (woop) leaf test -------------------------------------
    # (a) at the bounce-0 shapes, over the v1 tree's plane records: kernel =
    # plain version, twice; the bound; the Moller-Trumbore kernel timed
    # beside it in turns (MT, woop, woop, MT), and the two kernels' hits
    t0 = time.perf_counter()
    table8w = tw.get_table8(v1.bvh, woop=True)
    print(f"[14 woop] v1 plane records: {tuple(table8w.tri.shape)} in "
          f"{time.perf_counter() - t0:.2f} s ({table8w.tri.shape[1] * 4} B a triangle, "
          f"{tuple(table8.tri.shape)} for Moller-Trumbore)", flush=True)
    result.update({
        "bvh8woop_closest": compare(tw, table8w, *v1_closest, "[14 woop] frame primary",
                                    culls=(True,), any_hit=False, reps=5)["closest"],
        "bvh8woop_any": compare(tw, table8w, *v1_shadow, "[14 woop] frame shadow", culls=(),
                                reps=5)["any"]})
    work = per_ray_work(tw, table8w, v1_closest, v1_shadow)
    for kind, rays in (("closest", v1_closest), ("any", v1_shadow)):
        bounds[f"bvh8woop_{kind}"] = bound(kind, rays[0].shape[0], table8w, work[kind],
                                           TRI_OPS_WOOP)
    woop_ab = {}
    for kind, rays in (("closest", v1_closest), ("any", v1_shadow)):
        launch = tw.closest_cuda if kind == "closest" else tw.any_cuda
        turns = [cuda_ms(lambda t=t: launch(t, *rays), 5)
                 for t in (table8, table8w, table8w, table8)]
        woop_ab[kind] = {"mt_ms": [turns[0], turns[3]], "woop_ms": [turns[1], turns[2]]}
        print(f"[14 woop] bounce 0 {kind}, MT / woop / woop / MT: "
              + " / ".join(f"{x:.3f}" for x in turns) + " ms; woop bound "
              f"{bounds[f'bvh8woop_{kind}'][0]:.4f} ms ({bounds[f'bvh8woop_{kind}'][1]}), MT "
              f"{bounds[f'bvh8_{kind}'][0]:.4f} ms; tests: woop {work[kind]['tri_tests']} "
              f"triangles, MT {work8[kind]['tri_tests']}", flush=True)
    mt_hit, woop_hit = tw.closest_cuda(table8, *v1_closest), tw.closest_cuda(table8w, *v1_closest)
    both = mt_hit.is_hit & woop_hit.is_hit
    same = both & (mt_hit.tri == woop_hit.tri)
    rel = ((woop_hit.t - mt_hit.t).abs() / mt_hit.t.abs())[same]
    print(f"[14 woop] bounce-0 primary hits, woop against MT: "
          f"{int((mt_hit.is_hit != woop_hit.is_hit).sum())} of {both.numel()} rays differ in "
          f"hit or miss, {int((both & ~same).sum())} in the triangle; t on the same "
          f"triangle {float(rel.max()) if bool(same.any()) else 0.0:.3g} relative at most; occluded "
          f"shadow rays {int(tw.any_cuda(table8, *v1_shadow).sum())} / "
          f"{int(tw.any_cuda(table8w, *v1_shadow).sum())}", flush=True)
    del mt_hit, woop_hit, both, same, rel
    # (b) one v1 frame recorded under the switch, each launch replayed alone
    # through the woop kernel (kernel = plain version, twice, and the bound)
    # and then through the MT kernel over the MT tables (timed only)
    with Woop():
        calls = record_frame(lambda: render_frame(v1, main_cfg, main_camera,
                                                  create_render_state(main_cfg, device)))
    in_frame["bvh8woop"] = replay({"bvh8woop": tw}, tw, lambda b: tw.get_table8(b, woop=True),
                                  tuple, calls, "[14 replay]",
                                  tri_ops=TRI_OPS_WOOP)["bvh8woop"]
    mt_in_frame = replay({"bvh8": tw}, tw, tw.get_table8, tuple, calls, "[14 replay MT]",
                         check_plain=False, count=False)["bvh8"]
    print("[14 woop] v1 frame's launches, woop / MT: " + "; ".join(
        f"{kind} {in_frame['bvh8woop'][kind][0]:.3f} / {mt_in_frame[kind][0]:.3f} ms"
        for kind in ("closest", "any")), flush=True)
    del calls
    # (c) whole 1080p frames from a fresh state, MT / woop / woop / MT, for v1
    # and the real scene (its plane tables packed first: the opaque view's
    # and the cutout subset's); each woop frame held to phase 5's or 9's
    # frame 0 under the frame gate, each MT frame bit-equal to it; the
    # launches counted from 0, woop frames launching only the woop kernels
    for bvh in (real.alpha.opaque_bvh, real.alpha.bvh):
        tw.get_table8(bvh, woop=True)
    tw.LAUNCHES.clear()
    woop_launches = collections.Counter()
    woop_frames = {}
    for label, scene, (ref_img, ref_rays) in (("v1", v1, first_frame),
                                              ("real", real, real_first)):
        ms_turns = []
        for woop in (False, True, True, False):
            before = dict(tw.LAUNCHES)
            with Woop() if woop else contextlib.nullcontext():
                (st, st_stats), ms = timed_frame(lambda: render_frame(
                    scene, main_cfg, main_camera, create_render_state(main_cfg, device)))
            ms_turns.append(ms)
            n = {k: c - before.get(k, 0) for k, c in tw.LAUNCHES.items()}
            keys = {"woop_closest", "woop_any"} if woop else {"closest", "any"}
            check(all(n.get(k, 0) > 0 for k in keys)
                  and not any(c for k, c in n.items() if k not in keys),
                  f"[14 woop] {label} frame (woop {woop}): launches {n}")
            rays = int(st_stats.rays)
            print(f"[14 woop] {label} frame, {'woop' if woop else 'MT'}: {ms:.1f} ms, {rays} "
                  f"rays, {rays / ms / 1e3:.2f} Mrays/s; launches "
                  + ", ".join(f"{k} {c}" for k, c in sorted(n.items()) if c), flush=True)
            if woop:
                woop_launches.update(n)
                frame_gate(f"{label} VRT_WOOP=1", st.accumulation, rays, ref_img, ref_rays,
                           label="[14 woop]",
                           against=f"phase {5 if label == 'v1' else 9}'s MT frame 0")
            else:
                frames_alike(f"[14 woop] {label} MT frame 0 again", st.accumulation, rays,
                             ref_img, ref_rays, exact=True)
        woop_frames[label] = {"mt_ms": [ms_turns[0], ms_turns[3]],
                              "woop_ms": [ms_turns[1], ms_turns[2]]}
    launches.update({f"bvh8woop_{kind}": woop_launches[f"woop_{kind}"]
                     for kind in ("closest", "any")})
    phase_start = lap("14 woop", phase_start)

    # -- 15. the point-light pick ------------------------------------------
    nee_line = nee_phase(lambda: render_frame(v1, main_cfg, main_camera,
                                              create_render_state(main_cfg, device)),
                         v1.point_lights, device)
    phase_start = lap("15 nee", phase_start)
    print(f"[time] chip_smoke: {time.perf_counter() - script_start:.1f} s in all", flush=True)

    lines = []
    for key, (err, ms, plain_ms) in result.items():
        name = key.rsplit("_", 1)[0]
        bound_ms, bound_by = bounds[key]
        lines.append({"name": key, "route": "cuda", "source": SOURCES[name],
                      "replaces": replaces(SOURCES[name]), "launches": launches[key],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        in_frame_txt = ""
        kind = key.rsplit("_", 1)[1]
        if name in in_frame:
            f_ms, f_bound_ms, f_launches = in_frame[name][kind]
            lines[-1].update(frame_ms=f_ms, frame_bound_ms=f_bound_ms,
                             frame_launches=f_launches)
            in_frame_txt = (f"; {f_ms:.3f} ms over the {f_launches} launches of one "
                            f"replayed frame (bound {f_bound_ms:.4f} ms)")
        if name in in_frame_unsorted:
            lines[-1]["frame_ms_unsorted"] = in_frame_unsorted[name][kind][0]
            in_frame_txt += f", {in_frame_unsorted[name][kind][0]:.3f} ms unsorted"
        if name == "bvh8woop":
            lines[-1].update(mt_ms=woop_ab[kind]["mt_ms"], ms_turns=woop_ab[kind]["woop_ms"],
                             mt_frame_ms=mt_in_frame[kind][0], frames_ms=woop_frames)
            in_frame_txt += (f"; MT kernel {woop_ab[kind]['mt_ms'][0]:.3f} / "
                             f"{woop_ab[kind]['mt_ms'][1]:.3f} ms in turns with woop "
                             f"{woop_ab[kind]['woop_ms'][0]:.3f} / "
                             f"{woop_ab[kind]['woop_ms'][1]:.3f} ms, "
                             f"{mt_in_frame[kind][0]:.3f} ms over the same frame's launches")
        if name == "bvh8":
            r_ms, r_bound_ms, r_launches = real_in_frame[kind]
            lines[-1].update(real_launches=real_launches[key], real_frame_ms=r_ms,
                             real_frame_bound_ms=r_bound_ms, real_frame_launches=r_launches)
            in_frame_txt += (f"; real workload: {real_launches[key]} launches in its frames, "
                             f"{r_ms:.3f} ms over the {r_launches} launches of one replayed "
                             f"frame (bound {r_bound_ms:.4f} ms)")
            h_ms, h_bound_ms, h_launches = hybrid_in_frame[kind]
            lines[-1].update(hybrid_launches=hybrid_launches[key], hybrid_frame_ms=h_ms,
                             hybrid_frame_bound_ms=h_bound_ms)
            in_frame_txt += (f"; hybrid: {hybrid_launches[key]} launches in its frames, "
                             f"{h_ms:.3f} ms over the {h_launches} launches of one replayed "
                             f"frame (bound {h_bound_ms:.4f} ms)")
            b_ms, b_bound_ms, b_launches = big_in_frame[kind]
            lines[-1].update(big_launches=big_launches[key], big_frame_ms=b_ms,
                             big_frame_bound_ms=b_bound_ms)
            in_frame_txt += (f"; 1M scenes: {big_launches[key]} launches in their frames, "
                             f"{b_ms:.3f} ms over the {b_launches} launches of one replayed "
                             f"v1 frame (bound {b_bound_ms:.4f} ms)")
            lines[-1]["bench_launches"] = {w: n[kind] for w, n in bench_launches.items()}
            in_frame_txt += "; bench: " + ", ".join(
                f"{w} {n[kind]} launches" for w, n in bench_launches.items())
            lines[-1]["tools_launches"] = {t: n[kind] for t, n in tools_launches.items()}
            in_frame_txt += "; tools: " + ", ".join(
                f"{t} {n[kind]} launches" for t, n in tools_launches.items())
        print(f"[kernels] {key}: kernel {ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.1f} ms, {launches[key]} launches "
              f"in the frames of its path{in_frame_txt}", flush=True)
    lines.append(nee_line)
    print(smi)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
