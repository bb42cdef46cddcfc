"""The plain reference renderer: one path per (pixel, frame) and one hybrid
pixel at a time, in float32 torch over the reference's own scene, trees
and IBL.

It follows the reference renderer's estimator (``RayGen.rgen``): a camera
ray jittered within the pixel, up to ``max_bounces`` bounces, next-event
estimation toward the sun and toward one point light picked by a CDF over
their unshadowed estimates (traced from the light toward the surface after
the first bounce), Russian roulette from ``min_bounces``, the light
spheres seen by the camera ray, tone mapping, and the running average of
the frames in an RGBA8 image.  Cutout triangles pass a hit only where the
base color's alpha reaches the cutoff; a ray is re-traced from just past a
rejected cutout at most ``ALPHA_ROUNDS`` times, and a hit that still fails
is a miss.

The hybrid pixel is the deferred mode: the camera ray through the pixel's
centre, the texture filtered over the footprint that the uvs of the
pixel's left and upper neighbours give, GGX direct light from the sun and
each point light behind its shadow ray, the split-sum IBL baked here from
the panorama, the sky on a miss and the light spheres.

``low=True`` rounds every shading quantity to bfloat16 as it is made: the
benchmark's control, which its comparison has to reject.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from rtbench.reference import bvh
from rtbench.reference import shade as S
from rtbench.reference.assets import RefScene

ALPHA_ROUNDS = 4


class Trees(NamedTuple):
    """The opaque triangles' tree and the cutouts' tree (None without
    cutouts), each with its map to scene triangle ids."""

    opaque: bvh.Tree
    opaque_ids: Tensor
    cutout: bvh.Tree | None
    cutout_ids: Tensor | None


def build_trees(scene: RefScene) -> Trees:
    g = scene.geometry
    textured = scene.pool is not None

    def tree(mask):
        ids = torch.nonzero(mask).squeeze(1)
        return bvh.build(g.v0[ids], g.e1[ids], g.e2[ids], g.double_sided[ids]), ids

    cut = g.cutout if textured else torch.zeros_like(g.cutout)
    opaque, opaque_ids = tree(~cut)
    if not bool(cut.any()):
        return Trees(opaque, opaque_ids, None, None)
    cutout, cutout_ids = tree(cut)
    return Trees(opaque, opaque_ids, cutout, cutout_ids)


def _global(hit: bvh.Hit, ids: Tensor) -> bvh.Hit:
    return hit._replace(tri=ids[hit.tri])


def _alpha_fails(scene: RefScene, hit: bvh.Hit) -> Tensor:
    g, m = scene.geometry, scene.materials
    tri = hit.tri
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    uv = S.bary_lerp(g.uv[0][tri], g.uv[1][tri], g.uv[2][tri], bary)
    mid = g.material[tri]
    alpha = m.base_color[mid, 3]
    tex = m.texture[mid]
    sampled = S.sample_texture(scene.pool, tex, uv)
    alpha = alpha * torch.where(tex >= 0, sampled[:, 3], 1.0)
    return hit.is_hit & g.cutout[tri] & (alpha < m.cutoff[mid])


def _closest_cutout(scene, trees, o, d, t_min, t_max, cull, counts):
    """The nearest cutout hit that passes its alpha test, re-tracing past
    each rejected one at most ``ALPHA_ROUNDS`` times."""
    def trace(lo, hi, rows):
        h = bvh.traverse(trees.cutout, o[rows], d[rows], lo, hi, cull, False, counts)
        return _global(h, trees.cutout_ids)

    everyone = torch.arange(o.shape[0], device=o.device)
    hit = trace(t_min, t_max, everyone)
    for _ in range(ALPHA_ROUNDS):
        fail = torch.nonzero(_alpha_fails(scene, hit)).squeeze(1)
        if fail.numel() == 0:
            break
        nxt = trace(hit.t[fail] * 1.0001 + 1e-4, t_max[fail], fail)
        hit = bvh.Hit(*[h.index_put((fail,), n) for h, n in zip(hit, nxt)])
    return hit._replace(t=torch.where(_alpha_fails(scene, hit), bvh.BIG_T, hit.t))


def trace_closest(scene, trees, o, d, t_min, t_max, cull=True, counts=None) -> bvh.Hit:
    hit = _global(bvh.traverse(trees.opaque, o, d, t_min, t_max, cull, False, counts),
                  trees.opaque_ids)
    if trees.cutout is None:
        return hit
    cut = _closest_cutout(scene, trees, o, d, t_min, torch.minimum(t_max, hit.t), cull, counts)
    better = cut.is_hit & ((cut.t < hit.t) | ((cut.t == hit.t) & (cut.tri < hit.tri)))
    return bvh.Hit(*[torch.where(better, a, b) for a, b in zip(cut, hit)])


def trace_any(scene, trees, o, d, t_min, t_max, counts=None) -> Tensor:
    blocked = bvh.traverse(trees.opaque, o, d, t_min, t_max, False, True, counts).is_hit
    if trees.cutout is None:
        return blocked
    return blocked | _closest_cutout(scene, trees, o, d, t_min, t_max, False, counts).is_hit


# --- camera ----------------------------------------------------------------

class Camera(NamedTuple):
    inverse_view: Tensor
    inverse_proj: Tensor
    z_near: float
    z_far: float


def camera(position, target, width: int, height: int, device, x_fov=math.radians(90.0),
           z_near=0.01, z_far=1000.0) -> Camera:
    """glm lookAt and a reverse-depth perspective with Vulkan's flipped y,
    the vertical fov x_fov / aspect, inverted in float64."""
    pos = np.asarray(position, np.float64)
    f = np.asarray(target, np.float64) - pos
    f /= np.linalg.norm(f)
    s = np.cross(f, [0.0, 1.0, 0.0])
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[0, 3], view[1, 3], view[2, 3] = -s @ pos, -u @ pos, f @ pos
    aspect = width / height
    tan_half = np.tan(x_fov / aspect / 2.0)
    near, far = z_far, z_near  # reverse depth
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / (aspect * tan_half)
    proj[1, 1] = -1.0 / tan_half
    proj[2, 2] = far / (near - far)
    proj[2, 3] = -(far * near) / (far - near)
    proj[3, 2] = -1.0
    f32 = lambda m: torch.from_numpy(np.asarray(m, np.float32)).to(device)  # noqa: E731
    return Camera(f32(np.linalg.inv(view)), f32(np.linalg.inv(proj)),
                  float(np.float32(z_near)), float(np.float32(z_far)))


def _camera_rays(cam: Camera, px, py, width, height, offset):
    size = torch.tensor([width, height], dtype=torch.float32, device=px.device)
    pix = torch.stack([px, py], dim=-1).to(torch.float32)
    xy = (pix + offset) / size * 2.0 - 1.0
    target = S.mat4_vec4(cam.inverse_proj, torch.cat([xy, torch.ones_like(xy)], -1))
    t3 = S.normalize(target[..., :3])
    direction = S.mat4_vec4(cam.inverse_view, torch.cat([t3, torch.zeros_like(t3[..., :1])], -1))
    d = S.normalize(direction[..., :3])
    return cam.inverse_view[:3, 3].expand_as(d), d


def light_spheres(scene: RefScene, radius, o, d, t_min, t_max):
    """(t, colour) of the nearest light sphere, t = -1 on a miss."""
    oc = o[:, None, :] - scene.lights_pos[None]
    b = S.dot(oc, d[:, None, :])
    cc = S.dot(oc, oc) - radius * radius
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = torch.where(-b - sq > t_min[:, None], -b - sq, -b + sq)
    ok = (disc > 0.0) & (t > t_min[:, None]) & (t < t_max[:, None])
    t = torch.where(ok, t, 3.0e38)
    first = torch.argmin(t, dim=1)
    tb = t.gather(1, first[:, None]).squeeze(1)
    return torch.where(tb < 3.0e38, tb, -1.0), scene.lights_color[first]


def _attributes(scene: RefScene, hit: bvh.Hit):
    g = scene.geometry
    tri = hit.tri
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    n = S.normalize(S.bary_lerp(g.n[0][tri], g.n[1][tri], g.n[2][tri], bary))
    n = torch.where(hit.back[..., None], -n, n)
    t = S.normalize(S.bary_lerp(g.t[0][tri], g.t[1][tri], g.t[2][tri], bary))
    uv = S.bary_lerp(g.uv[0][tri], g.uv[1][tri], g.uv[2][tri], bary)
    return n, t, uv, g.material[tri]


def _surface(scene: RefScene, n, t, uv, mid, footprint, q):
    m = scene.materials
    base = m.base_color[mid, :3]
    if scene.pool is not None:
        tex = m.texture[mid]
        c = S.sample_texture(scene.pool, tex, uv, footprint)
        base = base * torch.where((tex >= 0)[:, None], S.to_linear(c[:, :3]), 1.0)
    emission = torch.zeros_like(base)
    s = S.make_surface(q(base), q(m.roughness[mid]), q(m.metallic[mid]), emission)
    return {k: q(v) for k, v in s.items()}, S.tbn_from_nt(n, t)


def _rounding(low: bool):
    if not low:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(torch.float32)


def _pick_light(scene: RefScene, n, p, s0, s1):
    delta = scene.lights_pos[None] - p[:, None, :]
    dist_sq = S.dot(delta, delta)
    l_dir = delta * torch.rsqrt(torch.clamp_min(dist_sq, 1e-20))[..., None]
    nol = torch.clamp_min(S.dot(n[:, None, :], l_dir), 0.0)
    est = S.luminance(scene.lights_color[None]) * nol / torch.clamp_min(dist_sq, 1e-20)
    cdf = torch.cumsum(est, dim=1)
    total = cdf[:, -1:]
    cdf = torch.where(total > 0.0, cdf / torch.where(total > 0.0, total, 1.0),
                      torch.ones_like(cdf))
    cdf[:, -1] = 1.0
    x, s0, s1 = S.next_float(s0, s1)
    idx = (x[:, None] >= cdf[:, :-1]).sum(dim=1)
    cdf_lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=1)
    return idx, (cdf - cdf_lo).gather(1, idx[:, None]).squeeze(1), s0, s1


def path_samples(scene: RefScene, trees: Trees, rcfg: dict, cam: Camera, px: Tensor,
                 py: Tensor, frame: Tensor, width: int, height: int, low: bool = False,
                 counts: dict | None = None) -> Tensor:
    """One tone-mapped sample (R, 3) of pixel (px, py) in frame ``frame``,
    each row its own path."""
    q = _rounding(low)
    r = px.shape[0]
    dev = px.device
    full = lambda v: torch.full((r,), v, dtype=torch.float32, device=dev)  # noqa: E731
    s0, s1 = S.pixel_seed(px, py, frame)
    j0, a0, a1 = S.next_float(s0, s1)
    j1, _, _ = S.next_float(a0, a1)
    o, d = _camera_rays(cam, px, py, width, height, torch.stack([j0, j1], dim=-1))
    t_min, t_max = full(cam.z_near), full(cam.z_far)
    hit = trace_closest(scene, trees, o, d, t_min, t_max, True, counts)
    irradiance = torch.zeros((r, 3), device=dev)
    throughput = torch.ones((r, 3), device=dev)
    ray_pdf = torch.ones(r, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    pl_t, pl_color = light_spheres(scene, rcfg["point_light_radius"], o, d, t_min, t_max)
    sun_d = S.normalize(-scene.sun_dir).expand(r, 3).contiguous()
    lights = scene.lights_pos.shape[0] > 0
    bounces = rcfg["max_bounces"]
    for bounce in range(bounces):
        if bounce == 0:
            seen = (pl_t >= 0.0) & (~hit.is_hit | (pl_t < hit.t)) & alive
            irradiance = torch.where(seen[:, None], pl_color, irradiance)
            alive &= ~seen
        env = q(S.sample_panorama(scene.panorama, S.panorama_uv(d)))
        miss = ~hit.is_hit & alive
        irradiance = q(irradiance + torch.where(miss[:, None], env * throughput / ray_pdf[:, None], 0.0))
        alive &= ~miss
        n, t, uv, mid = _attributes(scene, hit)
        surf, tbn = _surface(scene, n, t, uv, mid, None, q)
        n_sh = tbn[..., 2]
        irradiance = q(irradiance + torch.where(alive[:, None], surf["emission"] * throughput
                                                / ray_pdf[:, None], 0.0))
        p = o + d * hit.t[:, None]
        wo = S.normalize(S.world_to_tangent(-d, tbn))
        shadow_o = p + n_sh * S.BIAS
        sun_tmax = torch.where(alive, S.RAY_MAX_T, 0.0)
        if lights:
            idx, light_pdf, s0, s1 = _pick_light(scene, n_sh, p, s0, s1)
            delta = scene.lights_pos[idx] - p
            dist_sq = S.dot(delta, delta)
            ldir = S.normalize(delta)
            wi_l = S.world_to_tangent(ldir, tbn)
            f_l = S.evaluate_bsdf(surf, wo, wi_l, S.normalize(wo + wi_l))
            pl = (f_l * S.cos_theta(wi_l)[:, None] * scene.lights_color[idx]
                  * (S.rcp(dist_sq) / torch.clamp_min(light_pdf, 1e-20))[:, None])
            pl = q(torch.where(alive[:, None], pl * throughput / ray_pdf[:, None], 0.0))
            pl_tmax = torch.where(alive, torch.sqrt(dist_sq), 0.0)
        wi_s = S.world_to_tangent(sun_d, tbn)
        f_s = S.evaluate_bsdf(surf, wo, wi_s, S.normalize(wo + wi_s))
        sun = f_s * S.cos_theta(wi_s)[:, None] * scene.sun_color
        sun = q(torch.where(alive[:, None], sun * throughput / ray_pdf[:, None], 0.0))
        f, wi, pdf, s0, s1 = S.sample_bsdf(surf, wo, s0, s1)
        f, pdf = q(f), q(pdf)
        alive &= ~((pdf < S.EPSILON) | (S.dot(f, f) < S.EPSILON))
        throughput = q(torch.where(alive[:, None], throughput * (f * S.cos_theta(wi)[:, None]),
                                   throughput))
        ray_pdf = q(torch.where(alive, ray_pdf * pdf, ray_pdf))
        if bounce >= rcfg["min_bounces"]:
            threshold = torch.clamp_min(1.0 - torch.amax(throughput, dim=-1), rcfg["rr_min"])
            rr, s0, s1 = S.next_float(s0, s1)
            alive &= ~(rr < threshold)
            throughput = q(torch.where(alive[:, None], throughput / (1.0 - threshold)[:, None],
                                       throughput))
        o = p
        d = S.tangent_to_world(wi, tbn)
        t_min = full(S.RAY_MIN_T)
        t_max = torch.where(alive, S.RAY_MAX_T, 0.0)
        # shadow rays; after the first bounce the light's from the light
        if lights:
            if bounce == 0:
                l_o, l_d, l_lo, l_hi = shadow_o, ldir, full(S.RAY_MIN_T), pl_tmax
            else:
                l_o, l_d = shadow_o + ldir * pl_tmax[:, None], -ldir
                l_lo = full(0.0)
                l_hi = torch.where(pl_tmax > 0.0, torch.clamp_min(pl_tmax - S.RAY_MIN_T, 0.0), -1.0)
            occ = trace_any(scene, trees, torch.cat([l_o, shadow_o]), torch.cat([l_d, sun_d]),
                            torch.cat([l_lo, full(S.RAY_MIN_T)]), torch.cat([l_hi, sun_tmax]),
                            counts)
            irradiance = q(irradiance + torch.where(occ[:r, None], 0.0, pl))
            sun_occ = occ[r:]
        else:
            sun_occ = trace_any(scene, trees, shadow_o, sun_d, full(S.RAY_MIN_T), sun_tmax, counts)
        irradiance = q(irradiance + torch.where(sun_occ[:, None], 0.0, sun))
        if bounce + 1 < bounces:
            hit = trace_closest(scene, trees, o, d, t_min, t_max, True, counts)
    return q(S.tone_map(irradiance))


def accumulate(samples: Tensor) -> Tensor:
    """(N, P, 3) samples of frames 0..N-1 -> the (P, 3) running average,
    rounded to RGBA8 after every frame."""
    acc = torch.zeros_like(samples[0])
    for k in range(samples.shape[0]):
        acc = (samples[k] + float(k) * acc) / (float(k) + 1.0)
        acc = torch.round(torch.clamp(acc, 0.0, 1.0) * 255.0) / 255.0
    return acc


def path_pixels(scene, trees, rcfg, cam, px, py, frames: int, width, height, low=False,
                rows: int = 1 << 18) -> Tensor:
    """The accumulated image at pixels (px, py) after ``frames`` frames,
    traced in blocks of about ``rows`` paths."""
    p = px.shape[0]
    frame = torch.arange(frames, device=px.device).repeat_interleave(p)
    fx, fy = px.repeat(frames), py.repeat(frames)
    out = []
    for s in range(0, fx.shape[0], rows):
        sl = slice(s, s + rows)
        out.append(path_samples(scene, trees, rcfg, cam, fx[sl], fy[sl], frame[sl], width,
                                height, low))
    return accumulate(torch.cat(out).reshape(frames, p, 3))


# --- the hybrid mode -------------------------------------------------------

@contextlib.contextmanager
def _full_fp32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


_BLOCK = 1 << 27
_LUT_BLOCK = 1 << 25


def _env_samples(pano: Tensor, height: int):
    h, w = height, height * 2
    ph, pw = pano.shape[0], pano.shape[1]
    fy, fx = max(ph // h, 1), max(pw // w, 1)
    small = pano[: (ph // fy) * fy, : (pw // fx) * fx].reshape(
        ph // fy, fy, pw // fx, fx, 3).mean(dim=(1, 3))
    sh, sw = small.shape[0], small.shape[1]
    dev = pano.device
    v = (torch.arange(sh, dtype=torch.float32, device=dev) + 0.5) / sh
    u = (torch.arange(sw, dtype=torch.float32, device=dev) + 0.5) / sw
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    theta = (uu - 0.5) / 0.1591
    lat = (vv - 0.5) / 0.3183
    c = torch.cos(lat)
    dirs = torch.stack([c * torch.cos(theta), -torch.sin(lat), c * torch.sin(theta)], -1)
    omega = (2.0 * S.PI / sw) * (S.PI / sh) * torch.clamp_min(c, 0.0)
    return dirs.reshape(-1, 3), small.reshape(-1, 3), omega.reshape(-1)


def _cube_dirs(size: int, dev) -> Tensor:
    ji = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    v, u = torch.meshgrid(ji, ji, indexing="ij")
    uv = torch.stack([u, v], dim=-1)
    return torch.stack([S.cube_direction(f, uv) for f in range(6)], dim=0)


def _blocks(rows: int, width: int):
    step = max(1, _BLOCK // width)
    return (slice(i, min(i + step, rows)) for i in range(0, rows, step))


def bake_ibl(pano: Tensor, irradiance_size: int, reflection_size: int, lut_size: int,
             env_height: int = 64, lut_samples: int = 4096):
    """(irradiance cube, reflection mips, split-sum table) of the
    panorama: cosine and GGX convolutions over its downsampled texels
    (float32 products), the table by Hammersley GGX samples."""
    dirs_in, radiance, omega = _env_samples(pano, env_height)
    weighted = radiance * omega[:, None]
    out_dirs = _cube_dirs(irradiance_size, pano.device).reshape(-1, 3)
    irr = torch.empty_like(out_dirs)
    with _full_fp32():
        for rows in _blocks(out_dirs.shape[0], dirs_in.shape[0]):
            irr[rows] = (torch.clamp_min(out_dirs[rows] @ dirs_in.T, 0.0) @ weighted) / S.PI
    mips = []
    n_mips = int(math.log2(reflection_size)) + 1
    for m in range(n_mips):
        s = max(reflection_size >> m, 1)
        rough = m / max(n_mips - 1, 1)
        a = rough * rough
        a2 = max(a * a, S.EPSILON)
        out_dirs = _cube_dirs(s, pano.device).reshape(-1, 3)
        if m == 0:
            out = S.sample_panorama(pano, S.panorama_uv(out_dirs))
        else:
            out = torch.empty_like(out_dirs)
            with _full_fp32():
                for rows in _blocks(out_dirs.shape[0], dirs_in.shape[0]):
                    cos_rl = out_dirs[rows] @ dirs_in.T
                    cos_h = torch.sqrt(torch.clamp_min((1.0 + cos_rl) * 0.5, 0.0))
                    dd = (cos_h * a2 - cos_h) * cos_h + 1.0
                    w = (a2 / (S.PI * dd * dd)) * torch.clamp_min(cos_rl, 0.0)
                    out[rows] = (w @ weighted) / torch.clamp_min(w @ omega, 1e-20)[:, None]
        mips.append(out.reshape(6, s, s, 3))
    return irr.reshape(6, irradiance_size, irradiance_size, 3), tuple(mips), \
        _brdf_lut(lut_size, lut_samples, pano.device)


def _brdf_lut(size: int, samples: int, dev) -> Tensor:
    uv = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    nov, rough = torch.meshgrid(uv, uv, indexing="xy")
    nov, rough = nov.reshape(-1), rough.reshape(-1)
    v = torch.stack([torch.sqrt(torch.clamp_min(1.0 - nov * nov, 0.0)),
                     torch.zeros_like(nov), nov], dim=-1)
    a = rough * rough
    a2 = torch.clamp_min(a * a, 0.0)
    acc = torch.zeros((2, nov.shape[0]), device=dev)
    step = max(1, _LUT_BLOCK // (2 * nov.shape[0]))
    for start in range(0, samples, step):
        i = torch.arange(start, min(start + step, samples), device=dev)
        bits = i.to(torch.int64) & S.M32
        bits = ((bits << 16) | (bits >> 16)) & S.M32
        bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
        bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
        bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
        bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
        e0 = torch.remainder(i.to(torch.float32) / samples, 1.0)[:, None]
        e1 = (bits.to(torch.float32) * 2.3283064365386963e-10)[:, None]
        # GGX half vectors, 1 + (a2 - 1) e1 rounded once (a fused multiply-add)
        phi = 2.0 * S.PI * e0
        denom = (1.0 + (a2 - 1.0).double() * e1.double()).float()
        cos2 = torch.clamp_min((1.0 - e1) / denom, 0.0)
        ct = torch.sqrt(cos2)
        st = torch.sqrt(torch.clamp_min(1.0 - cos2, 0.0))
        h = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
        voh_raw = S.dot(v, h)
        l = 2.0 * voh_raw[..., None] * h - v
        nol = torch.clamp_min(l[..., 2], 0.0)
        noh = torch.clamp_min(h[..., 2], 0.0)
        voh = torch.clamp_min(voh_raw, 0.0)
        vis_nol_pdf = S.vis_schlick(a, nov, nol) * nol * (4.0 * voh / torch.clamp_min(noh, 1e-20))
        fc = S.pow5(1.0 - voh)
        ok = nol > 0.0
        terms = torch.stack([torch.where(ok, (1.0 - fc) * vis_nol_pdf, 0.0),
                             torch.where(ok, fc * vis_nol_pdf, 0.0)], dim=1)
        for term in terms:
            acc = acc + term
    return (acc / samples).T.reshape(size, size, 2).contiguous()


def _direct(s, n, v, l, nov):
    h = S.normalize(l + v)
    nol = torch.clamp_min(S.dot(n, l), 0.0)
    noh = torch.clamp_min(S.dot(n, h), 0.0)
    voh = torch.clamp_min(S.dot(v, h), 0.0)
    f = S.f_schlick(s["f0"], voh)
    kd = (1.0 - f) * (1.0 - s["metallic"][:, None])
    spec = (S.d_ggx(s["a2"], noh) * S.vis_schlick(s["a"], nov, nol))[:, None] * f
    return kd * s["base_color"] * S.INVERSE_PI + spec, nol


def hybrid_pixels(scene: RefScene, trees: Trees, rcfg: dict, cam: Camera, ibl, px: Tensor,
                  py: Tensor, width: int, height: int, low: bool = False) -> Tensor:
    """The hybrid mode's display colour (P, 3) at pixels (px, py)."""
    q = _rounding(low)
    p = px.shape[0]
    dev = px.device
    # the pixel, its left and its upper neighbour (the image wraps)
    ax = torch.cat([px, torch.remainder(px - 1, width), px])
    ay = torch.cat([py, py, torch.remainder(py - 1, height)])
    o3, d3 = _camera_rays(cam, ax, ay, width, height, 0.5)
    r3 = ax.shape[0]
    t_min3 = torch.full((r3,), cam.z_near, device=dev)
    t_max3 = torch.full((r3,), cam.z_far, device=dev)
    hit3 = trace_closest(scene, trees, o3, d3, t_min3, t_max3, True)
    n3, t3, uv3, mid3 = _attributes(scene, hit3)
    hit = bvh.Hit(*[x[:p] for x in hit3])
    o, d, t_min, t_max = o3[:p], d3[:p], t_min3[:p], t_max3[:p]
    n, t, uv, mid = n3[:p], t3[:p], uv3[:p], mid3[:p]
    footprint = (uv - uv3[p:2 * p], uv - uv3[2 * p:], rcfg["aniso_taps"])
    s, tbn = _surface(scene, n, t, uv, mid, footprint, q)
    n = tbn[..., 2]
    position = o + d * hit.t[:, None]
    v = S.normalize(cam.inverse_view[:3, 3] - position)
    nov = torch.clamp_min(S.dot(n, v), 0.0)
    shadow_o = position + n * S.BIAS
    sun_l = S.normalize(-scene.sun_dir).expand(p, 3)
    dirs, tmax, per_light = [sun_l], [torch.where(hit.is_hit, S.RAY_MAX_T, 0.0)], []
    for i in range(scene.lights_pos.shape[0]):
        lcol = scene.lights_color[i]
        delta = scene.lights_pos[i] - position
        dist_sq = S.dot(delta, delta)
        att = S.rcp(dist_sq)
        l = S.normalize(delta)
        irr = att * torch.clamp_min(S.dot(n, l), 0.0) * S.luminance(lcol)
        per_light.append((l, att, lcol, irr))
        dirs.append(l)
        tmax.append(torch.where(hit.is_hit & (irr > S.EPSILON), torch.sqrt(dist_sq), 0.0))
    sets = len(dirs)
    occ = trace_any(scene, trees, shadow_o.repeat(sets, 1), torch.cat(dirs).contiguous(),
                    torch.full((sets * p,), S.RAY_MIN_T, device=dev),
                    torch.cat(tmax)).reshape(sets, p)
    point = torch.zeros((p, 3), device=dev)
    for i, (l, att, lcol, irr) in enumerate(per_light):
        f, nol = _direct(s, n, v, l, nov)
        lit = nol[:, None] * lcol * (~occ[1 + i])[:, None] * att[:, None]
        point = q(point + torch.where((irr > S.EPSILON)[:, None], q(f * lit), 0.0))
    f, nol = _direct(s, n, v, sun_l, nov)
    direct = q(f * nol[:, None] * scene.sun_color * (~occ[0])[:, None])
    irr_cube, refl, lut = ibl
    irradiance = S.sample_cube(irr_cube, n)
    fc = S.pow5(1.0 - nov)
    ks = s["f0"] + (torch.maximum(1.0 - s["roughness"][..., None], s["f0"]) - s["f0"]) * fc[..., None]
    kd = (1.0 - ks) * (1.0 - s["metallic"][:, None])
    reflection = S.sample_cube_mips(refl, 2.0 * S.dot(v, n)[:, None] * n - v,
                                    s["roughness"] * (len(refl) - 1))
    size = lut.shape[0]
    lx = torch.clamp((nov * size).long(), 0, size - 1)
    ly = torch.clamp((s["roughness"] * size).long(), 0, size - 1)
    so = lut[ly, lx]
    ambient = q(kd * irradiance * s["base_color"]
                + (s["f0"] * so[:, 0:1] + so[:, 1:2]) * reflection)
    shaded = q(S.tone_map(ambient + direct + point + s["emission"]))
    sky = S.tone_map(S.sample_panorama(scene.panorama, S.panorama_uv(d)))
    color = torch.where(hit.is_hit[:, None], shaded, sky)
    pl_t, pl_color = light_spheres(scene, rcfg["point_light_radius"], o, d, t_min, t_max)
    seen = (pl_t >= 0.0) & (~hit.is_hit | (pl_t < hit.t))
    return torch.where(seen[:, None], S.tone_map(pl_color), color)
