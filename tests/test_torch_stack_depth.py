"""The traversal stack's depth (``ops.traverse_wide8.STACK_DEPTH``) against
a tree that a real build makes, not a hand-made chain: nested clusters
of 9 triangles (two leaves each) at halving distances along +x, built by
the SAH builder and collapsed to BVH8.  Its worst-case BVH8 stack need
lies past the old depth of 64 and within the new one, so ``build_table8``
accepts it, and the CPU twin (the kernel's code), the plain version and
brute force agree on its hits bit for bit.  A deeper nesting of the same
kind needs more than the depth and is still refused: there is no
overflow path.
"""

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.bvh8 import _worst_case_stack
from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
from vulkanraytracing_torch.ops import intersect as tint
from vulkanraytracing_torch.ops import traverse_wide8 as tw
from vulkanraytracing_torch.scene.procedural import cornell_box_scene
from vulkanraytracing_torch.scene.types import make_trace_geometry

torch.set_num_threads(1)

PER_LEVEL = 9


def _nested(levels: int):
    """``levels`` rings of ``PER_LEVEL`` small triangles around +x, ring
    ``k`` at x = 2^-k with radius and size scaled by 2^-k, SAH-built."""
    pos, idx = [], []
    for k in range(levels):
        s = 0.5 ** k
        for c in range(PER_LEVEL):
            a = 2.0 * np.pi * c / PER_LEVEL
            p = np.array([s, 0.2 * s * np.cos(a), 0.2 * s * np.sin(a)])
            pos += [p, p + [0.05 * s, 0.1 * s, 0.0], p + [0.05 * s, 0.0, 0.1 * s]]
            idx.append([len(pos) - 3, len(pos) - 2, len(pos) - 1])
    geom = make_trace_geometry(np.array(pos, np.float32), np.array(idx), cull_disable=True,
                               device="cpu")
    return build_scene_bvh(cornell_box_scene(device="cpu")._replace(geometry=geom),
                           builder="sah")


def _rays(scene, n=512, seed=3, rings=20):
    """Rays from around the chain, each aimed at the centroid of a random
    triangle of the outer ``rings`` rings (a triangle 2^-20 the size of
    the first is no longer a float32 target from this far: brute force
    then reports rounding noise as hits that no box holds)."""
    rng = np.random.default_rng(seed)
    g = scene.geometry
    outer = (scene.bvh.tri_order < rings * PER_LEVEL).numpy()
    centroid = (g.v0 + (g.e1 + g.e2) / 3.0).numpy()[outer]
    target = centroid[rng.integers(0, centroid.shape[0], n)]
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e3, np.float32)
    t_max[::13] = 0.0
    return [torch.from_numpy(x) for x in (o, d, np.zeros((n,), np.float32), t_max)]


def test_deep_tree_builds_and_traverses_alike():
    scene = _nested(50)
    need = _worst_case_stack(scene.bvh.child8.numpy())
    assert 64 < need <= tw.STACK_DEPTH, need
    table = tw.build_table8(scene.bvh)
    rays = _rays(scene)
    for cull in (True, False):
        plain = tw.closest_plain(table, *rays, cull_backface=cull)
        twin = tw.closest_twin(table, *rays, cull_backface=cull)
        brute = tint.intersect_closest_brute(scene.geometry, *rays, cull_backface=cull)
        assert plain.is_hit.float().mean() > 0.5
        for name, a, b, c in zip(plain._fields, twin, plain, brute):
            assert torch.equal(a, b), name
            assert torch.equal(a, c), name
    blocked = tw.any_plain(table, *rays)
    assert torch.equal(tw.any_twin(table, *rays), blocked)
    assert torch.equal(tint.intersect_any_brute(scene.geometry, *rays), blocked)


def test_tree_past_the_depth_is_refused():
    scene = _nested(72)
    need = _worst_case_stack(scene.bvh.child8.numpy())
    assert need > tw.STACK_DEPTH, need
    with pytest.raises(ValueError, match="stack"):
        tw.build_table8(scene.bvh)
