"""Packet lockstep in plain PyTorch: what the three packet backends share.

Rays are laid out as P packets of consecutive lanes, each packet with ONE
cursor and one stack over the 2-wide BVH, and every packet moves by one
node or leaf visit per step with no host synchronization inside a step.
``ops.traverse_pallas`` and ``ops.traverse_subpacket`` build their plain
versions from these helpers (held bit for bit against their CUDA kernels,
so each helper rounds as ``csrc/packet_common.cuh`` does), and
``ops.traverse_packet`` (``TraversalMode.BVH``) is made of them alone.
What the two kernels' wrappers share lives here too: the ctypes argument
lists, the build of a kernel or of its CPU twin from a source directory,
and one launch of either.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from vulkanraytracing_torch import native
from vulkanraytracing_torch.accel.lbvh import decode_leaf
from vulkanraytracing_torch.ops.intersect import BIG_T, Hit, moller_trumbore
from vulkanraytracing_torch.ops.traverse_wide import Table2
from vulkanraytracing_torch.ops.traverse_wide8 import (
    STACK_DEPTH,
    TINY,
    _canon_rays,
    _check,
    _ptrs,
    ray_queue,
)

DONE = -(1 << 30)  # a packet's cursor once it has nothing left to visit
CHECK_EVERY = 8  # lockstep steps between two looks at which packets run
_RESULTS = ("best", "hit", "tri", "u", "v", "bf")

# the packet kernels' ctypes arguments: Table2's packed records
# (``table_args``), then the rays
_P = ctypes.c_void_p
_I = ctypes.c_int
TABLE_ARGS = [_P, _P]            # node, tri
RAY_ARGS = [_P, _P, _P, _P, _I]  # o, d, t_min, t_max, n
HEADER_NAMES = ("packet_common.cuh", "traverse_common.cuh")


def table_args(table: Table2) -> list[int]:
    """``TABLE_ARGS`` of a table: the kernels and twins read ``node`` and
    ``tri`` with 16-byte loads (``_check`` holds both to contiguous,
    16-byte-aligned storage)."""
    node, tri = table.records
    if (node.dtype != torch.float32 or node.ndim != 2 or node.shape[1] != 16
            or tri.dtype != torch.float32 or tri.ndim != 2 or tri.shape[1] != 12):
        raise ValueError(f"need float32 (N, 16) node and (T, 12) triangle records, got "
                         f"{node.dtype} {tuple(node.shape)}, {tri.dtype} {tuple(tri.shape)}")
    return [node.data_ptr(), tri.data_ptr()]


def kernel_library(name: str, src=native.CSRC_DIR) -> ctypes.CDLL:
    """Build (nvcc, sm_90a) and load the packet kernel ``name``
    ("subpacket" or "shared") from the sources in ``src``."""
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS, f"-DVRT_STACK_DEPTH={STACK_DEPTH}",
           f"-I{src}"]
    path = native.build_library(f"{name}_traverse", cmd, [src / f"{name}_traverse.cu"],
                                tuple(src / h for h in HEADER_NAMES))
    return native.load_library(path, {
        f"vrt_{name}_closest": (_I, TABLE_ARGS + RAY_ARGS + [_I] + [_P] * 7),
        f"vrt_{name}_any": (_I, TABLE_ARGS + RAY_ARGS + [_P] * 3),
    })


def twin_library(name: str, extra: dict, src=native.CSRC_DIR) -> ctypes.CDLL:
    """The kernel's headers compiled by g++ for the host, from the sources
    in ``src``; ``extra`` declares the twin's own test entries."""
    cmd = [*native.GXX, "-ffp-contract=off", f"-DVRT_STACK_DEPTH={STACK_DEPTH}", f"-I{src}"]
    path = native.build_library(f"{name}_twin", cmd, [src / f"{name}_twin.cpp"],
                                tuple(src / h for h in HEADER_NAMES))
    return native.load_library(path, {
        f"vrt_{name}_closest_cpu": (None, TABLE_ARGS + RAY_ARGS + [_I] + [_P] * 5),
        f"vrt_{name}_any_cpu": (None, TABLE_ARGS + RAY_ARGS + [_P]),
        **extra,
    })


def _outputs(o: Tensor, any_hit: bool) -> tuple:
    r, dev = o.shape[0], o.device
    if any_hit:
        return (torch.empty((r,), dtype=torch.bool, device=dev),)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    return (t, torch.empty_like(t), torch.empty_like(t),
            torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.bool, device=dev))


def launch_kernel(library, name: str, table: Table2, o, d, t_min, t_max,
                  cull_backface: bool | None) -> tuple[tuple, bool]:
    """One launch of the packet kernel ``name`` from ``library()`` (built
    once the arguments have passed their checks) on the current stream:
    closest hit (t, u, v, tri, backface) with ``cull_backface``, or the
    any-hit verdicts for ``None``.  The launch gets a ray-queue counter
    of its own.  Returns the outputs and whether a kernel was launched (not
    for no rays); a failed launch raises."""
    any_hit = cull_backface is None
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cuda")
    lib = library()
    out = _outputs(o, any_hit)
    r = o.shape[0]
    if not r:
        return out, False
    kind = "any" if any_hit else "closest"
    mode = [] if any_hit else [int(cull_backface)]
    with torch.cuda.device(o.device):
        err = getattr(lib, f"vrt_{name}_{kind}")(
            *table_args(table), *_ptrs(o, d, t_min, t_max), r, *mode,
            *_ptrs(ray_queue(o.device), *out),
            torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} {kind} launch failed: cudaError {err}")
    return out, True


def run_twin(lib: ctypes.CDLL, name: str, table: Table2, o, d, t_min, t_max,
             cull_backface: bool | None) -> tuple:
    """The CPU twin of the packet kernel ``name``, with ``launch_kernel``'s
    arguments."""
    any_hit = cull_backface is None
    o, d, t_min, t_max = _canon_rays(o, d, t_min, t_max)
    _check(table, o, d, t_min, t_max, "cpu")
    out = _outputs(o, any_hit)
    kind = "any" if any_hit else "closest"
    mode = [] if any_hit else [int(cull_backface)]
    getattr(lib, f"vrt_{name}_{kind}_cpu")(
        *table_args(table), *_ptrs(o, d, t_min, t_max), o.shape[0], *mode, *_ptrs(*out))
    return out


def packet_state(o, d, t_min, t_max, lanes: int, tiny: float = TINY,
                 stack_depth: int = STACK_DEPTH) -> dict:
    """Rays laid out as P packets of ``lanes`` consecutive rays, padding
    lanes dead (o 0, d 1, t_min 1 > t_max 0, as the TPU kernels pad), each
    lane's running hit, and each packet's cursor (the root when some lane
    is live, else DONE), stack pointer and ``stack_depth``-entry stack.
    ``tiny`` guards the reciprocal direction."""
    r = o.shape[0]
    p = -(-r // lanes)
    pad = p * lanes - r

    def comp(x, fill):
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
        return x.reshape(p, lanes, *x.shape[1:])

    s = {"o": comp(o, 0.0), "d": comp(d, 1.0), "t_min": comp(t_min, 1.0)}
    t_max = comp(t_max, 0.0)
    s["inv"] = 1.0 / torch.where(s["d"].abs() < tiny,
                                 torch.where(s["d"] < 0, -tiny, tiny), s["d"])
    s["live0"] = s["t_min"] <= t_max
    s["best"] = torch.where(t_max < BIG_T, t_max, BIG_T)
    s["hit"] = torch.zeros_like(s["live0"])
    s["tri"] = torch.zeros_like(s["t_min"], dtype=torch.int32)
    s["u"] = torch.zeros_like(s["t_min"])
    s["v"] = torch.zeros_like(s["t_min"])
    s["bf"] = torch.zeros_like(s["live0"])
    s["cur"] = torch.where(s["live0"].any(dim=1), 0, DONE).to(torch.int64)
    s["sp"] = torch.zeros((p,), dtype=torch.int64, device=o.device)
    s["stack"] = torch.zeros((p, stack_depth), dtype=torch.int64, device=o.device)
    return s


def run_packets(s: dict, step, graphs: bool = False) -> dict:
    """Packet lockstep: ``step(sub)`` moves every packet of ``sub`` (a dict
    like ``s``) by one node or leaf visit without synchronizing with the
    host, and leaves a packet whose cursor is DONE as it is.  Every
    ``CHECK_EVERY`` steps the loop looks at which packets still run; once a
    quarter or more of ``sub`` has finished, the running packets are
    gathered into a new ``sub`` and the others' results written back into
    ``s``.  With ``graphs`` and CUDA tensors the ``CHECK_EVERY`` steps are
    one CUDA graph, captured again after each gather: the same launches,
    without the host's dispatch of each.  The kernels' plain versions ask
    for that, as they are held against the kernels on the card.  Returns
    ``s`` with every packet's results."""
    ids, sub, steps = None, s, None
    while True:
        keep = torch.nonzero(sub["cur"] != DONE).squeeze(1)
        if 4 * keep.numel() <= 3 * sub["cur"].shape[0]:
            if ids is not None:
                for k in _RESULTS:
                    s[k][ids] = sub[k]
            if keep.numel() == 0:
                return s
            ids = keep if ids is None else ids[keep]
            sub = {k: x[keep] for k, x in sub.items()}
            steps = None
        if steps is None:
            steps = (_graph(step, sub) if graphs and sub["cur"].is_cuda
                     else functools.partial(_eager, step, sub))
        steps()


def _eager(step, sub: dict) -> None:
    for _ in range(CHECK_EVERY):
        step(sub)


def _graph(step, sub: dict):
    """``CHECK_EVERY`` steps of ``sub`` captured as one CUDA graph whose
    replay reads and writes the tensors ``sub`` holds now.  Returns the
    replay."""
    inputs = dict(sub)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _eager(step, sub)
        for k, x in inputs.items():
            if sub[k] is not x:
                x.copy_(sub[k])
    sub.update(inputs)
    return graph.replay


def flat_hit(s: dict, r: int) -> Hit:
    def flat(x):
        return x.reshape(-1)[:r]

    return Hit(t=flat(torch.where(s["hit"], s["best"], BIG_T)), u=flat(s["u"]),
               v=flat(s["v"]), tri=flat(s["tri"]), backface=flat(s["bf"]))


def slab2(box: Tensor, s: dict):
    """Slab test of both child boxes of each packet's node, (P, 12) as
    c0.lo c0.hi c1.lo c1.hi, for every lane: (tn, tn <= tf), each (P, 2,
    L).  Minima and maxima are exact in any order, so reducing the axes
    with amin/amax rounds as ``csrc/packet_common.cuh::slab``."""
    box = box.view(-1, 2, 1, 6)
    o, inv = s["o"][:, None], s["inv"][:, None]
    a = (box[..., 0:3] - o) * inv
    b = (box[..., 3:6] - o) * inv
    tn = torch.maximum(torch.minimum(a, b).amax(dim=3), s["t_min"][:, None])
    tf = torch.minimum(torch.maximum(a, b).amin(dim=3), s["best"][:, None])
    return tn, tn <= tf


def max_leaf_count(table: Table2) -> int:
    c = table.child
    return int(torch.where(c < 0, (~c) & 15, 0).max())


def commit_leaves(table: Table2, s: dict, codes: Tensor, live: Tensor,
                  kmax: int, cull_backface: bool) -> None:
    """Each packet tests the leaves ``codes`` ((P, C), child 0's first;
    code -1 holds no triangle) for its ``live`` lanes, the triangles of a
    leaf in order, and commits into ``s`` as
    ``csrc/packet_common.cuh::test_leaf`` does one after another: a valid
    hit needs t < the running best, so the winner is the nearest, the
    first tested among equal t."""
    start, count = decode_leaf(codes)
    j = torch.arange(kmax, device=codes.device)
    in_leaf = j < count[..., None]                                  # (P, C, K)
    sid = torch.where(in_leaf, start[..., None] + j, 0).flatten(1)  # (P, CK)
    rec, flags = table.tri[sid], table.tri_flags[sid]
    t, mu, mv, det = moller_trumbore(
        s["o"][:, None], s["d"][:, None], rec[:, :, None, 0:3],
        rec[:, :, None, 3:6], rec[:, :, None, 6:9], det_eps=TINY)   # (P, CK, L)
    valid = (
        (in_leaf.flatten(1) & ((flags & 6) != 0))[..., None] & live[:, None]
        & (det.abs() > TINY) & (mu >= 0.0) & (mv >= 0.0) & (mu + mv <= 1.0)
        & (t >= s["t_min"][:, None]) & (t < s["best"][:, None])
    )
    if cull_backface:
        valid &= (det > TINY) | ((flags & 1) != 0)[..., None]
    t = torch.where(valid, t, BIG_T)
    new_t = t.amin(dim=1)
    order = torch.arange(sid.shape[1], device=codes.device)[:, None]
    first = torch.where(valid & (t == new_t[:, None]), order, sid.shape[1])
    first = first.amin(dim=1, keepdim=True).clamp_max(sid.shape[1] - 1)  # (P, 1, L)
    found = valid.any(dim=1)

    def pick(x):
        return torch.take_along_dim(x, first, dim=1).squeeze(1)

    s["best"] = torch.where(found, new_t, s["best"])
    s["hit"] = s["hit"] | found
    s["tri"] = torch.where(found, pick(sid[..., None]).to(torch.int32), s["tri"])
    s["u"] = torch.where(found, pick(mu), s["u"])
    s["v"] = torch.where(found, pick(mv), s["v"])
    s["bf"] = torch.where(found, pick(det) < 0.0, s["bf"])


def nearer_first(kids: Tensor, go0: Tensor, go1: Tensor, te: Tensor):
    """(the child to visit next, the child to push when both go): the
    nearer of two children by the packet's entry distances ``te`` (child 0
    on equal distances), else the one that goes."""
    near0 = te[:, 0] <= te[:, 1]
    nxt = torch.where(go0 & go1, torch.where(near0, kids[:, 0], kids[:, 1]),
                      torch.where(go0, kids[:, 0], kids[:, 1]))
    return nxt, torch.where(near0, kids[:, 1], kids[:, 0])


def advance(s: dict, nxt: Tensor, far: Tensor, push: Tensor, go: Tensor) -> Tensor:
    """The packets' next cursors: push ``far`` where ``push``, then ``nxt``
    where ``go``, else the top of the stack, or DONE when it is empty."""
    sp, stack = s["sp"], s["stack"]
    slot = sp.clamp_max(stack.shape[1] - 1)[:, None]
    stack.scatter_(1, slot, torch.where(push[:, None], far[:, None], stack.gather(1, slot)))
    sp = sp + push.long()
    can = sp > 0
    top = stack.gather(1, (sp - 1).clamp_min(0)[:, None]).squeeze(1)
    s["sp"] = torch.where(~go & can, sp - 1, sp)
    return torch.where(go, nxt, torch.where(can, top, DONE))


def descend(s: dict, act: Tensor, kids: Tensor, go: Tensor, te: Tensor,
            any_hit: bool) -> None:
    """The step of a packet whose hit leaf children were tested at once:
    of the interior children that ``go`` ((P, 2)), visit the nearer and
    push the other, else pop; in any-hit mode a packet ends once every
    live lane has a hit.  Packets that were not ``act`` stay DONE."""
    go0, go1 = go[:, 0], go[:, 1]
    nxt, far = nearer_first(kids, go0, go1, te)
    nxt = advance(s, nxt, far, go0 & go1, go0 | go1)
    if any_hit:
        nxt = torch.where((s["hit"] | ~s["live0"]).all(dim=1), DONE, nxt)
    s["cur"] = torch.where(act, nxt, DONE)
