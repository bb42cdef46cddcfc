"""The traversal kernels on the card against their plain versions (BVH8,
BVH2, subpacket and shared cursor), the per-ray kernels' persistent warps
at odd ray counts and the subpacket kernel's persistent blocks run twice,
the plain packet backend on the card against the CPU, and the slice
through the BVH8 kernel against brute force.

Marked ``gpu``: the CUDA kernel has no CPU mode, so these skip where no
CUDA device is present (the CPU twin in ``test_torch_traverse.py`` covers
the kernels' logic there).  On the card:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

Kernel and plain version round every operation the same way (the kernel
is built with -fmad=false), so every field must be bit-equal.
"""

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_bvh, build_scene_bvh
from vulkanraytracing_torch.config import CameraConfig, Config, TraversalMode
from vulkanraytracing_torch.ops import traverse_packet as tpk
from vulkanraytracing_torch.ops import traverse_pallas as tpal
from vulkanraytracing_torch.ops import traverse_subpacket as tsub
from vulkanraytracing_torch.ops import traverse_wide as tw2
from vulkanraytracing_torch.ops import traverse_wide8 as tw
from vulkanraytracing_torch.pt.render import render_progressive
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.procedural import cornell_box_scene, triangle_soup_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rays(device, n=8192):
    gen = np.random.default_rng(2)
    o = gen.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = gen.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e3, np.float32)
    t_max[::7] = 0.0
    return [torch.from_numpy(x).to(device) for x in (o, d, np.zeros(n, np.float32), t_max)]


def _case(device):
    scene = build_scene_bvh(triangle_soup_scene(20000, seed=1, device=device))
    return tw.get_table8(scene.bvh), _rays(device)


@pytest.mark.parametrize("cull", [True, False])
def test_closest_kernel_matches_plain(cuda, cull):
    table, rays = _case(cuda)
    kernel = tw.closest_cuda(table, *rays, cull_backface=cull)
    plain = tw.closest_plain(table, *rays, cull_backface=cull)
    torch.cuda.synchronize()
    assert plain.is_hit.sum() > 100
    for name, a, b in zip(plain._fields, kernel, plain):
        assert torch.equal(a, b), name


def test_any_kernel_matches_plain_and_counts(cuda):
    table, rays = _case(cuda)
    before = tw.LAUNCHES["any"]
    kernel = tw.any_cuda(table, *rays)
    assert tw.LAUNCHES["any"] == before + 1
    assert torch.equal(kernel, tw.any_plain(table, *rays))


def _case2(device):
    """The same soup as an LBVH with no collapse: the BVH2 kernel's tree."""
    _, bvh = build_bvh(triangle_soup_scene(20000, seed=1, device=device).geometry)
    return tw2.get_table2(bvh), _rays(device)


@pytest.mark.parametrize("cull", [True, False])
def test_bvh2_closest_kernel_matches_plain(cuda, cull):
    table, rays = _case2(cuda)
    before = tw2.LAUNCHES["closest2"]
    kernel = tw2.closest_cuda(table, *rays, cull_backface=cull)
    assert tw2.LAUNCHES["closest2"] == before + 1
    plain = tw2.closest_plain(table, *rays, cull_backface=cull)
    torch.cuda.synchronize()
    assert plain.is_hit.sum() > 100
    for name, a, b in zip(plain._fields, kernel, plain):
        assert torch.equal(a, b), name


def test_bvh2_any_kernel_matches_plain_and_counts(cuda):
    table, rays = _case2(cuda)
    before = tw2.LAUNCHES["any2"]
    kernel = tw2.any_cuda(table, *rays)
    assert tw2.LAUNCHES["any2"] == before + 1
    assert torch.equal(kernel, tw2.any_plain(table, *rays))


PER_RAY = {"bvh8": (tw, _case, ("closest", "any")), "bvh2": (tw2, _case2, ("closest2", "any2"))}


@pytest.mark.parametrize("n", [1, 31, 33, 129, 8191])
@pytest.mark.parametrize("name", sorted(PER_RAY))
def test_per_ray_kernels_at_odd_ray_counts_twice(cuda, name, n):
    """The persistent warps take rays from a queue: one batch (n <= 32), a
    grid with more warps than batches (33, 129), and a count that fills no
    block evenly.  Every specialization equals its plain version in every
    field, is alike when run twice (which lane walks which ray changes,
    the results must not), and counts one launch per call."""
    module, case, (closest_key, any_key) = PER_RAY[name]
    table, rays = case(cuda)
    rays = [x[:n].contiguous() for x in rays]
    for cull in (True, False):
        before = module.LAUNCHES[closest_key]
        first = module.closest_cuda(table, *rays, cull_backface=cull)
        second = module.closest_cuda(table, *rays, cull_backface=cull)
        assert module.LAUNCHES[closest_key] == before + 2
        plain = module.closest_plain(table, *rays, cull_backface=cull)
        torch.cuda.synchronize()
        for field, a, b, c in zip(plain._fields, first, second, plain):
            assert a.shape == (n,) and torch.equal(a, c) and torch.equal(a, b), field
    before = module.LAUNCHES[any_key]
    first, second = module.any_cuda(table, *rays), module.any_cuda(table, *rays)
    assert module.LAUNCHES[any_key] == before + 2
    assert torch.equal(first, module.any_plain(table, *rays)) and torch.equal(first, second)


@pytest.mark.parametrize("name", sorted(PER_RAY))
def test_per_ray_kernels_with_dead_rays(cuda, name):
    """All rays dead: every result is a miss and the kernel still counts
    its launch; no rays: no launch, empty results."""
    module, case, (closest_key, any_key) = PER_RAY[name]
    table, rays = case(cuda)
    o, d, t_min, _ = rays
    dead = torch.full_like(t_min, -1.0)
    before = module.LAUNCHES[closest_key]
    hit = module.closest_cuda(table, o, d, t_min, dead)
    assert module.LAUNCHES[closest_key] == before + 1
    plain = module.closest_plain(table, o, d, t_min, dead)
    for field, a, b in zip(plain._fields, hit, plain):
        assert torch.equal(a, b), field
    assert not hit.is_hit.any() and not module.any_cuda(table, o, d, t_min, dead).any()
    before = dict(module.LAUNCHES)
    none = [x[:0] for x in rays]
    assert module.closest_cuda(table, *none).t.shape == (0,)
    assert module.any_cuda(table, *none).shape == (0,)
    assert dict(module.LAUNCHES) == before


PACKET = {"subpacket": tsub, "shared": tpal}


@pytest.mark.parametrize("name", sorted(PACKET))
@pytest.mark.parametrize("cull", [True, False])
def test_packet_closest_kernel_matches_plain(cuda, name, cull):
    """The packet kernels read the 2-wide arrays of the BVH (here an LBVH)."""
    module = PACKET[name]
    table, rays = _case2(cuda)
    before = module.LAUNCHES["closest"]
    kernel = module.closest_cuda(table, *rays, cull_backface=cull)
    assert module.LAUNCHES["closest"] == before + 1
    plain = module.closest_plain(table, *rays, cull_backface=cull)
    torch.cuda.synchronize()
    assert plain.is_hit.sum() > 100
    for field, a, b in zip(plain._fields, kernel, plain):
        assert torch.equal(a, b), field


@pytest.mark.parametrize("name", sorted(PACKET))
def test_packet_any_kernel_matches_plain_and_counts(cuda, name):
    module = PACKET[name]
    table, rays = _case2(cuda)
    before = module.LAUNCHES["any"]
    kernel = module.any_cuda(table, *rays)
    assert module.LAUNCHES["any"] == before + 1
    assert torch.equal(kernel, module.any_plain(table, *rays))


def test_subpacket_kernel_runs_alike_twice(cuda):
    """Which block takes which packet from the work counter changes from
    run to run; the results must not."""
    table, rays = _case2(cuda)
    for cull in (True, False):
        first = tsub.closest_cuda(table, *rays, cull_backface=cull)
        second = tsub.closest_cuda(table, *rays, cull_backface=cull)
        for field, a, b in zip(first._fields, first, second):
            assert torch.equal(a, b), field
    assert torch.equal(tsub.any_cuda(table, *rays), tsub.any_cuda(table, *rays))


def test_packet_backend_on_the_card_matches_the_cpu(cuda):
    """The plain packet backend (``TraversalMode.BVH``) runs its lockstep
    steps as CUDA graphs on the card and eagerly on the CPU: the same
    operations, so the same hits; t, u, v within rtol 1e-6."""
    _, host = build_bvh(triangle_soup_scene(20000, seed=1, device="cpu").geometry)
    bvh = host.to(cuda)
    rays = _rays(cuda, n=4096)
    got = tpk.intersect_closest_packet(bvh, *rays)
    want = tpk.intersect_closest_packet(host, *[x.cpu() for x in rays])
    assert want.is_hit.sum() > 100
    hit = want.is_hit
    assert torch.equal(got.is_hit.cpu(), hit) and torch.equal(got.tri.cpu()[hit], want.tri[hit])
    for name in ("t", "u", "v"):
        assert torch.allclose(getattr(got, name).cpu()[hit], getattr(want, name)[hit],
                              rtol=1e-6, atol=0.0), name
    assert torch.equal(tpk.intersect_any_packet(bvh, *rays).cpu(),
                       tpk.intersect_any_packet(host, *[x.cpu() for x in rays]))


def test_cornell_through_kernel_matches_brute_force(cuda):
    scene = build_scene_bvh(cornell_box_scene(device=cuda))
    cfg = Config(width=32, height=32, camera=CameraConfig(
        position=(0.0, 0.0, 3.2), aspect_ratio=1.0, x_fov=float(np.radians(60))))
    cam = Camera(cfg.camera).to_device(cuda)
    before = tw.LAUNCHES["closest"]
    kernel, rays_k = render_progressive(scene, cfg, cam, 2)
    assert tw.LAUNCHES["closest"] > before
    brute, rays_b = render_progressive(
        scene, cfg.replace(traversal=TraversalMode.BRUTE_FORCE), cam, 2)
    assert rays_k == rays_b
    assert torch.equal(kernel.accumulation, brute.accumulation)
