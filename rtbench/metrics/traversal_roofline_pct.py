"""The traversal kernels' share of their roofline in one frame: the least
time the card could take for the frame's traversal calls
(``yardstick.traversal_bound_ms``, summed over the calls) over the device
time of the kernels whose names match ``PATTERN`` in that frame.

The calls are recorded at ``ops/trace.py``'s ``traverse_closest`` and
``traverse_any``, through which every traversal of a tree goes; their
rays are replayed through the benchmark's own per-ray traversal over its
own trees (the cutout subset's calls over the cutouts' tree, the others
over the opaque triangles' tree) to count the box and triangle tests they
need, so that the count does not move with the program's kernel, leaf
test or table layout.

A moving configuration reads None: the replay holds one static tree,
and its frames run the BVH2 kernel over a refitted tree."""

from rtbench.reference import bvh
from rtbench.yardstick import traversal_bound_ms

PATTERN = "traverse_kernel<"
_T = "vulkanraytracing_torch.ops.trace."
RECORD = {"traverse_closest": _T + "traverse_closest", "traverse_any": _T + "traverse_any"}
CHUNK = 1 << 21


def read(run):
    if run.moving:
        return None
    rec = run.records
    kernel_ms = sum(e - s for name, s, e in rec["device"] if PATTERN in name) * 1e-3
    if kernel_ms <= 0.0 or not rec["calls"]:
        return None
    _, trees = run.reference()
    alpha = run.program_scene.alpha
    bound = 0.0
    for name, args, _ in rec["calls"]:
        bvh_, o, d, t_min, t_max = args[1:6]
        any_hit = name == "traverse_any"
        cull = False if any_hit else bool(args[6])
        subset = alpha is not None and bvh_ is alpha.bvh
        tree = trees.cutout if subset else trees.opaque
        counts = {}
        for s in range(0, o.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            dev = tree.v0.device
            bvh.traverse(tree, o[sl].to(dev), d[sl].to(dev), t_min[sl].to(dev),
                         t_max[sl].to(dev), cull, any_hit, counts)
        bound += traversal_bound_ms("any" if any_hit else "closest", o.shape[0],
                                    tree.v0.shape[0], counts.get("box_tests", 0),
                                    counts.get("tri_tests", 0))
    return 100.0 * bound / kernel_ms
