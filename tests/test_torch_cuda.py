"""The traversal kernels on the card against their plain versions (BVH8
with either leaf test, BVH2, subpacket and shared cursor), the per-ray kernels' persistent warps
and the packet kernels' persistent warps and blocks at odd ray counts, run
twice, with dead rays and with none, the plain packet backend on the card
against the CPU, and the slice through the BVH8 kernel against brute force.

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


@pytest.mark.parametrize("cull", [True, False])
def test_woop_kernel_matches_plain_and_counts(cuda, cull, monkeypatch):
    """The plane leaf test (``VRT_WOOP=1``): its kernels over the plane
    table, bit-equal to the plain version and counted under their own keys;
    the switch sends ``intersect_closest`` / ``intersect_any`` to them."""
    scene = build_scene_bvh(triangle_soup_scene(20000, seed=1, device=cuda))
    table, rays = tw.get_table8(scene.bvh, woop=True), _rays(cuda)
    before = dict(tw.LAUNCHES)
    kernel = tw.closest_cuda(table, *rays, cull_backface=cull)
    blocked = tw.any_cuda(table, *rays)
    plain = tw.closest_plain(table, *rays, cull_backface=cull)
    assert plain.is_hit.sum() > 100
    for name, a, b in zip(plain._fields, kernel, plain):
        assert torch.equal(a, b), name
    assert torch.equal(blocked, tw.any_plain(table, *rays))
    monkeypatch.setattr(tw, "WOOP_DEFAULT", True)
    tw.intersect_closest(scene.bvh, *rays, cull_backface=cull)
    tw.intersect_any(scene.bvh, *rays)
    assert {k: n - before.get(k, 0) for k, n in tw.LAUNCHES.items()
            if n != before.get(k, 0)} == {"woop_closest": 2, "woop_any": 2}


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


def _alike_twice(module, table, rays):
    for cull in (True, False):
        first = module.closest_cuda(table, *rays, cull_backface=cull)
        second = module.closest_cuda(table, *rays, cull_backface=cull)
        for field, a, b in zip(first._fields, first, second):
            assert torch.equal(a, b), field
    assert torch.equal(module.any_cuda(table, *rays), module.any_cuda(table, *rays))


def test_subpacket_kernel_runs_alike_twice(cuda):
    """Which warp takes which packet from the work counter changes from
    run to run; the results must not."""
    _alike_twice(tsub, *_case2(cuda))


def test_shared_cursor_kernel_runs_alike_twice(cuda):
    """Which block takes which packet changes from run to run, and two
    launches in a row each have a work counter of their own."""
    _alike_twice(tpal, *_case2(cuda))


@pytest.mark.parametrize("n", [1, 127, 129, 1023, 1025, 8191])
@pytest.mark.parametrize("name", sorted(PACKET))
def test_packet_kernels_at_odd_ray_counts_twice(cuda, name, n):
    """A last packet that is partly past the rays, fewer packets than the
    grid has warps or blocks, and a count that fills no packet evenly.
    Every specialization equals its plain version in every field, is alike
    when run twice, and counts one launch per call."""
    module = PACKET[name]
    table, rays = _case2(cuda)
    rays = [x[:n].contiguous() for x in rays]
    for cull in (True, False):
        before = module.LAUNCHES["closest"]
        first = module.closest_cuda(table, *rays, cull_backface=cull)
        second = module.closest_cuda(table, *rays, cull_backface=cull)
        assert module.LAUNCHES["closest"] == before + 2
        plain = module.closest_plain(table, *rays, cull_backface=cull)
        torch.cuda.synchronize()
        for field, a, b, c in zip(plain._fields, first, second, plain):
            assert a.shape == (n,) and torch.equal(a, c) and torch.equal(a, b), field
    before = module.LAUNCHES["any"]
    first, second = module.any_cuda(table, *rays), module.any_cuda(table, *rays)
    assert module.LAUNCHES["any"] == before + 2
    assert torch.equal(first, module.any_plain(table, *rays)) and torch.equal(first, second)


@pytest.mark.parametrize("name", sorted(PACKET))
def test_packet_kernels_with_dead_rays(cuda, name):
    """All rays dead: no packet starts, every result is a miss and the
    kernel still counts its launch; no rays: no launch, empty results."""
    module = PACKET[name]
    table, rays = _case2(cuda)
    o, d, t_min, _ = rays
    dead = torch.full_like(t_min, -1.0)
    before = module.LAUNCHES["closest"]
    hit = module.closest_cuda(table, o, d, t_min, dead)
    assert module.LAUNCHES["closest"] == before + 1
    plain = module.closest_plain(table, o, d, t_min, dead)
    for field, a, b in zip(plain._fields, hit, plain):
        assert torch.equal(a, b), field
    assert not hit.is_hit.any() and not module.any_cuda(table, o, d, t_min, dead).any()
    before = dict(module.LAUNCHES)
    none = [x[:0] for x in rays]
    assert module.closest_cuda(table, *none).t.shape == (0,)
    assert module.any_cuda(table, *none).shape == (0,)
    assert dict(module.LAUNCHES) == before


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


@pytest.fixture(scope="module")
def real_scene():
    """The real workload at its 20,000-triangle target on the card, with
    its opaque view and cutout subset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel has no CPU mode")
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene

    return build_scene_bvh(sponza_like_scene(20000, workload="real", device="cuda"),
                           builder="sah")


def _hall_rays(device, n=8192):
    gen = np.random.default_rng(6)
    o = gen.uniform([-19.0, 0.2, -9.5], [19.0, 7.5, 9.5], (n, 3)).astype(np.float32)
    d = gen.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e3, np.float32)
    t_max[::7] = 0.0
    return [torch.from_numpy(x).to(device) for x in (o, d, np.full(n, 1e-3, np.float32), t_max)]


@pytest.mark.parametrize("table", ["opaque view", "subset"])
@pytest.mark.parametrize("cull", [True, False])
def test_split_closest_launches_match_plain(real_scene, table, cull):
    """The BVH8 kernel over the real scene's opaque view and its cutout
    subset (each with its own packed table) against the plain version."""
    bvh = real_scene.alpha.opaque_bvh if table == "opaque view" else real_scene.alpha.bvh
    t8 = tw.get_table8(bvh)
    rays = _hall_rays(real_scene.geometry.v0.device)
    kernel = tw.closest_cuda(t8, *rays, cull_backface=cull)
    plain = tw.closest_plain(t8, *rays, cull_backface=cull)
    assert int(plain.is_hit.sum()) > (100 if table == "subset" else 4000)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table", ["opaque view", "subset"])
def test_split_any_launches_match_plain(real_scene, table):
    bvh = real_scene.alpha.opaque_bvh if table == "opaque view" else real_scene.alpha.bvh
    t8 = tw.get_table8(bvh)
    rays = _hall_rays(real_scene.geometry.v0.device)
    assert torch.equal(tw.any_cuda(t8, *rays), tw.any_plain(t8, *rays))


def test_opaque_view_has_no_cutout_candidates(real_scene):
    """Cutouts are no candidates in the opaque view's table (flags & 6 == 0
    on every alpha-tested triangle), and the main tree keeps them."""
    opaque = tw.get_table8(real_scene.alpha.opaque_bvh).tri_meta
    main = tw.get_table8(real_scene.bvh).tri_meta
    slots = opaque[:, 1] >= 0
    cut = real_scene.geometry.alpha_test[opaque[:, 1].clamp_min(0).long()] & slots
    assert int(cut.sum()) == real_scene.alpha.geometry.num_triangles
    assert not bool(((opaque[:, 0] & 6) != 0)[cut].any())
    assert bool(((main[:, 0] & 4) != 0)[cut].all())


def test_real_frame_on_the_card_sorted_equals_unsorted(real_scene, monkeypatch):
    """A 64x36 real frame through the kernels: the wavefront sort must not
    change it, in the image or the ray count."""
    cfg = Config(width=64, height=36, max_bounce_count=4, camera=CameraConfig(
        position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=64 / 36))
    cam = Camera(cfg.camera).to_device("cuda")
    sorted_, rays_s = render_progressive(real_scene, cfg, cam, 1)
    monkeypatch.setenv("VRT_DEBUG_NO_SORT", "1")
    unsorted, rays_u = render_progressive(real_scene, cfg, cam, 1)
    assert rays_s == rays_u
    assert torch.equal(sorted_.accumulation, unsorted.accumulation)
    assert float(sorted_.accumulation.max()) > 0.0


def test_ibl_bake_on_the_card_matches_the_cpu(cuda):
    """The bake's products on the card (TF32 off) against the CPU's: rtol
    1e-4 for the convolutions, 1e-5 for the BRDF table."""
    from vulkanraytracing_torch.env import ibl

    pano = torch.from_numpy(np.random.default_rng(3).uniform(0, 2, (64, 128, 3)).astype(np.float32))
    pano[16:24, 40:48] += 50.0
    torch.backends.cuda.matmul.allow_tf32 = True  # the bake must switch it off itself
    try:
        irr = ibl.compute_irradiance_cube(pano.to(cuda), 16)
        refl = ibl.compute_reflection_cube(pano.to(cuda), 32, 4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(irr.cpu(), ibl.compute_irradiance_cube(pano, 16), rtol=1e-4, atol=1e-6)
    for a, b in zip(refl, ibl.compute_reflection_cube(pano, 32, 4)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ibl.compute_brdf_lut(32, 1024, device=cuda).cpu(),
                               ibl.compute_brdf_lut(32, 1024, device="cpu"), rtol=1e-5, atol=1e-5)


def test_hybrid_frame_on_the_card_matches_the_cpu(real_scene):
    """A 64x36 hybrid frame of the real scene through the BVH8 kernel
    against the same frame on the CPU (the plain version): 99.9% of the
    channels within 1/255 (the card's sin, cos and pow round otherwise)."""
    from vulkanraytracing_torch.env.ibl import bake_ibl
    from vulkanraytracing_torch.hybrid import render_hybrid

    scene = real_scene._replace(environment=bake_ibl(real_scene.environment, 8, 16, 16))
    cfg = Config(width=64, height=36, camera=CameraConfig(
        position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=64 / 36))
    before = dict(tw.LAUNCHES)
    on_card = render_hybrid(scene, cfg, Camera(cfg.camera).to_device("cuda"))
    assert tw.LAUNCHES["closest"] > before.get("closest", 0)
    assert tw.LAUNCHES["any"] > before.get("any", 0)
    on_cpu = render_hybrid(scene.to("cpu"), cfg, Camera(cfg.camera).to_device("cpu"))
    close = (on_card.cpu() - on_cpu).abs() <= 1.0 / 255.0 + 1e-6
    assert float(close.float().mean()) >= 0.999
    assert float(on_cpu.mean()) > 0.05


def test_cli_renders_on_the_card_by_default(cuda, tmp_path):
    from vulkanraytracing_torch.app import cli
    from vulkanraytracing_torch.app.image_io import read_png

    out = tmp_path / "c.png"
    before = tw.LAUNCHES["closest"]
    assert cli.main(["render", "--scene", "cornell", "--mode", "hybrid", "--width", "32",
                     "--height", "32", "--out", str(out)]) == 0
    assert tw.LAUNCHES["closest"] > before and read_png(out).shape == (32, 32, 3)


# --- the point-light pick kernel (ops.nee_select) ---------------------------

NEE_LANES = 2_088_960  # a 1080p frame's wavefront (the tiled pixel grid)


def _nee_picks(device):
    """A 1080p wavefront's picks: unit normals as the integrator passes them
    (a strided column of (R, 3, 3) frames), points and 4 lights in the
    hall's box, the integrator's int64 state."""
    from vulkanraytracing_torch.scene.types import PointLights

    gen = np.random.default_rng(5)
    lo, hi = (-19.0, 0.5, -9.0), (19.0, 7.5, 9.0)
    pos = np.concatenate([gen.uniform(lo, hi, (4, 3)), np.ones((4, 1))], 1)
    col = np.concatenate([gen.uniform(5.0, 50.0, (4, 3)), np.ones((4, 1))], 1)
    n = gen.normal(0.0, 1.0, (NEE_LANES, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    frames = torch.zeros((NEE_LANES, 3, 3), device=device)
    frames[..., 2] = torch.from_numpy(n.astype(np.float32)).to(device)
    p = gen.uniform(lo, hi, (NEE_LANES, 3)).astype(np.float32)
    s0, s1 = gen.integers(0, 2**32, (2, NEE_LANES), dtype=np.int64)
    lights = PointLights(*(torch.from_numpy(x.astype(np.float32)).to(device) for x in (pos, col)))
    return (lights, frames[..., 2],
            *(torch.from_numpy(x).to(device) for x in (p, s0, s1)))


def test_nee_kernel_matches_the_plain_body(cuda):
    """The kernel rounds as the plain body does on the CPU: bit-equal to it
    in every output.  The plain body on the card takes the card's rsqrt
    (not correctly rounded) and a scan in another order, so against it the
    state is equal and idx and pdf may differ where a draw lies within
    rounding of a CDF boundary."""
    from vulkanraytracing_torch.ops import nee_select
    from vulkanraytracing_torch.pt import integrator

    lights, n, p, s0, s1 = _nee_picks(cuda)
    assert n.stride() == (9, 3)
    kernel = nee_select.select_cuda(lights, n, p, s0, s1)
    on_cpu = integrator.sample_point_light_plain(lights.to("cpu"),
                                                 *(x.cpu() for x in (n, p, s0, s1)))
    for field, a, b in zip(("idx", "pdf", "s0", "s1"), kernel, on_cpu):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), field
    on_card = integrator.sample_point_light_plain(lights, n, p, s0, s1)
    assert torch.equal(kernel[2], on_card[2]) and torch.equal(kernel[3], on_card[3])
    same = kernel[0] == on_card[0]
    # a draw within rounding of a boundary may pick the neighbour (none did
    # on an H100); the card's rsqrt, up to 2 ulp off, moves NoL most where
    # n.l cancels, and the pdf with it (up to 1.7e-4 of it on an H100)
    assert int((~same).sum()) <= NEE_LANES // 100_000
    torch.testing.assert_close(kernel[1][same], on_card[1][same], rtol=1e-3, atol=0.0)
    assert len(torch.unique(kernel[0])) == 4


def test_nee_kernel_time_lies_inside_its_ranges(cuda):
    """One pick profiled inside a ``record_function`` range: the kernel is
    launched under its op (``vrt::nee_select``), so the range, the op and
    the ``vrt.nee`` span all hold its device time, as the benchmark's NEE
    readers need."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vulkanraytracing_torch.pt import integrator

    args = _nee_picks(cuda)
    integrator.sample_point_light(*args)  # builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the session's first launch: the profiler books its kernel twice
        # (again under its activity buffer request, a child of the same op);
        # the device is held back on both sides of the pick, so no event of
        # it lies near the session's edges
        torch.ones(1, device=cuda).add_(1)
        torch.cuda._sleep(20_000_000)
        with record_function("nee_probe"):
            integrator.sample_point_light(*args)
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and "nee_select_kernel" in e.name]
    assert len(kernels) == 1
    kernel_us = kernels[0].time_range.elapsed_us()
    assert kernel_us > 0
    for name in ("nee_probe", "vrt.nee", "vrt::nee_select"):
        rows = [e for e in events if e.device_type == DeviceType.CPU and e.name == name]
        assert len(rows) == 1, name
        assert rows[0].device_time_total == pytest.approx(kernel_us, rel=1e-3), name


def test_card_frame_picks_through_the_kernel(cuda):
    """A small v1 frame on the card: one kernel pick a bounce over the
    whole wavefront, none through the plain body."""
    from vulkanraytracing_torch.app.engine import Engine
    from vulkanraytracing_torch.pt.render import tile_pixel_coords
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene
    from vulkanraytracing_torch.utils import profiling

    scene = build_scene_bvh(sponza_like_scene(2000, workload="v1", device=cuda), builder="sah")
    cfg = Config(width=32, height=32, camera=CameraConfig(
        position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0), aspect_ratio=1.0))
    engine = Engine(cfg, scene, device=cuda)
    engine.draw()
    counts = profiling.frame_counts()
    r = tile_pixel_coords(32, 32, device=cuda)[0].shape[0]
    bounces = cfg.max_bounce_count
    assert (counts["nee_calls.kernel"], counts["nee_lanes.kernel"]) == (bounces, bounces * r)
    assert "nee_calls.plain" not in counts
