#!/usr/bin/env python3
"""Worst-case traversal stack need of the benchmark scenes' trees.

    python3 -m vulkanraytracing_torch.tools.stack_need [TRIS ...] [--device cpu]

For each triangle target (default 262144, 1048576 and 2097152: the JAX
benchmark's ``VRT_BENCH_TRIS`` values), each workload (``v1``, ``real``)
and each builder (``sah``, ``lbvh``), builds ``sponza_like_scene`` and its
tree as ``accel.lbvh.build_scene_bvh`` does, and prints the triangle
count, the build seconds, the BVH8 collapse's worst-case stack need
(``accel.bvh8._worst_case_stack``), the 2-wide tree's
(``ops.traverse_wide.stack_need``) and the cutout subset's, against the
kernels' ``STACK_DEPTH``.  Runs on the card unless ``--device cpu``; a
multi-million-triangle build takes a few GiB of host memory.
"""

from __future__ import annotations

import sys
import time

import torch


def main(argv=None) -> int:
    from vulkanraytracing_torch.accel.bvh8 import _worst_case_stack
    from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
    from vulkanraytracing_torch.ops.traverse_wide import stack_need
    from vulkanraytracing_torch.ops.traverse_wide8 import STACK_DEPTH
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("stack_need: no CUDA device is available (--device cpu runs on the host)",
              file=sys.stderr)
        return 1
    targets = [int(a) for a in args] or [262144, 1048576, 2097152]
    worst = 0
    for target in targets:
        for workload in ("v1", "real"):
            scene = sponza_like_scene(target, workload=workload, device=device)
            for builder in ("sah", "lbvh"):
                t0 = time.perf_counter()
                built = build_scene_bvh(scene, builder=builder)
                if device.startswith("cuda"):
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                need8 = _worst_case_stack(built.bvh.child8.cpu().numpy())
                need2 = stack_need(built.bvh)
                sub = ""
                if built.alpha is not None:
                    sub8 = _worst_case_stack(built.alpha.bvh.child8.cpu().numpy())
                    sub = (f"; cutout subset {built.alpha.geometry.num_triangles} triangles, "
                           f"BVH8 {sub8}, BVH2 {stack_need(built.alpha.bvh)}")
                    need8 = max(need8, sub8)
                worst = max(worst, need8, need2)
                print(f"{workload} {target} {builder}: {built.geometry.num_triangles} triangles, "
                      f"build {seconds:.2f} s; stack need BVH8 "
                      f"{_worst_case_stack(built.bvh.child8.cpu().numpy())}, BVH2 {need2}{sub} "
                      f"(depth {STACK_DEPTH})", flush=True)
                del built
            del scene
    print(f"deepest need {worst} of {STACK_DEPTH}: "
          + ("every tree fits" if worst <= STACK_DEPTH else "a tree does NOT fit"), flush=True)
    return 0 if worst <= STACK_DEPTH else 1


if __name__ == "__main__":
    sys.exit(main())
