"""Shading arithmetic of the reference: vector helpers, the per-pixel
random stream, the metallic-roughness BSDF, texture filtering, the sky and
the cube lookups, the tone curve.

Written to the reference renderer's formulas (xoroshiro64** seeded by
Wang hashes, GGX with Schlick visibility at k = a/2 and the linear lobe
mix, the Hejl/Burgess-Dawson curve, textures filtered in sRGB space) with
every dot and cross product summed left to right, so that it rounds as
the program is meant to.  Everything is elementwise over leading axes.
"""

from __future__ import annotations

import torch

EPSILON = 1e-6
BIAS = 5e-3
PI = 3.141592654
INVERSE_PI = 0.31830988618
RAY_MIN_T = 1e-3
RAY_MAX_T = 1e3
M32 = 0xFFFFFFFF


# --- vectors ---------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def rcp(x):
    zero = x == 0.0
    return torch.where(zero, 1e10, 1.0 / torch.where(zero, 1.0, x))


def luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def bary_lerp(a, b, c, bary):
    return a * bary[..., 0:1] + b * bary[..., 1:2] + c * bary[..., 2:3]


def tbn_from_nt(n, t):
    t = normalize(t - dot(t, n)[..., None] * n)
    return torch.stack([t, cross(n, t), n], dim=-1)


def tangent_to_world(v, tbn):
    return tbn[..., :, 0] * v[..., 0:1] + tbn[..., :, 1] * v[..., 1:2] + tbn[..., :, 2] * v[..., 2:3]


def world_to_tangent(v, tbn):
    return tbn[..., 0, :] * v[..., 0:1] + tbn[..., 1, :] * v[..., 1:2] + tbn[..., 2, :] * v[..., 2:3]


def cos_theta(v):
    return torch.clamp_min(v[..., 2], 0.0)


def to_linear(srgb):
    return torch.where(srgb < 0.04045, srgb / 12.92, torch.pow((srgb + 0.055) / 1.055, 2.4))


def tone_map(x):
    x = torch.clamp_min(x - 0.004, 0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def mat4_vec4(m, v):
    return (m[:, 0] * v[..., 0:1] + m[:, 1] * v[..., 1:2]
            + m[:, 2] * v[..., 2:3] + m[:, 3] * v[..., 3:4])


# --- random numbers: xoroshiro64** on int64 lanes holding uint32 -----------

def _mul32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x, k):
    return ((x << k) & M32) | (x >> (32 - k))


def wang_hash(x):
    x = x.to(torch.int64) & M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & M32
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def rand_uint(s0, s1):
    result = _mul32(_rotl(_mul32(s0, 0x9E3779BB), 5), 5)
    s1 = s1 ^ s0
    s0 = _rotl(s0, 26) ^ s1 ^ ((s1 << 9) & M32)
    return result, s0, _rotl(s1, 13)


def next_float(s0, s1):
    bits, s0, s1 = rand_uint(s0, s1)
    return (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32) - 1.0, s0, s1


def pixel_seed(x, y, frame):
    """The stream of pixel (x, y) in frame ``frame`` (tensors)."""
    s0 = wang_hash((((x.to(torch.int64) & M32) << 16) & M32) | (y.to(torch.int64) & M32))
    s1 = wang_hash(frame.to(torch.int64) & M32)
    _, s0, s1 = rand_uint(s0, s1)
    return s0, s1


# --- BSDF ------------------------------------------------------------------

def make_surface(base_color, roughness, metallic, emission):
    dielectric = torch.full_like(base_color, 0.04)
    f0 = dielectric + (base_color - dielectric) * metallic[..., None]
    a = roughness * roughness
    a2 = torch.clamp_min(a * a, EPSILON)
    diffuse_lum = luminance(base_color) * (1.0 - metallic)
    spec_lum = luminance(f0)
    sw = torch.clamp_max(spec_lum / (spec_lum + diffuse_lum), 1.0)
    return dict(base_color=base_color, roughness=roughness, metallic=metallic,
                emission=emission, f0=f0, a=a, a2=a2, sw=sw)


def d_ggx(a2, noh):
    d = (noh * a2 - noh) * noh + 1.0
    return a2 / (PI * d * d)


def f_schlick(f0, voh):
    return f0 + (1.0 - f0) * pow5(1.0 - voh)[..., None]


def vis_schlick(a, nov, nol):
    k = a * 0.5
    return 0.25 * rcp((nov * (1.0 - k) + k) * (nol * (1.0 - k) + k))


def evaluate_bsdf(s, wo, wi, wh):
    nov, nol, noh = cos_theta(wo), cos_theta(wi), cos_theta(wh)
    voh = torch.clamp_min(dot(wo, wh), 0.0)
    f = f_schlick(s["f0"], voh)
    kd = (1.0 - f) * (1.0 - s["metallic"][..., None])
    return kd * s["base_color"] * INVERSE_PI + (d_ggx(s["a2"], noh) * vis_schlick(s["a"], nov, nol))[..., None] * f


def sample_ggx(e, a2):
    phi = 2.0 * PI * e[..., 0]
    e1 = e[..., 1]
    ct = torch.sqrt(torch.clamp_min((1.0 - e1) / (1.0 + (a2 - 1.0) * e1), 0.0))
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def sample_bsdf(s, wo, s0, s1):
    a, s0, s1 = next_float(s0, s1)
    b, s0, s1 = next_float(s0, s1)
    c, s0, s1 = next_float(s0, s1)
    e = torch.stack([a, b, c], dim=-1)
    exy = e[..., :2]
    wh_spec = sample_ggx(exy, s["a2"])
    wi_spec = 2.0 * dot(wh_spec, wo)[..., None] * wh_spec - wo
    phi = 2.0 * PI * exy[..., 0]
    ct = torch.sqrt(exy[..., 1])
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    wi_diff = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    wh_diff = normalize(wo + wi_diff)
    use_spec = (e[..., 2] < s["sw"])[..., None]
    wi = torch.where(use_spec, wi_spec, wi_diff)
    wh = torch.where(use_spec, wh_spec, wh_diff)
    diffuse_pdf = cos_theta(wi) * INVERSE_PI
    noh = cos_theta(wh)
    spec_pdf = noh * d_ggx(s["a2"], noh) / torch.clamp_min(4.0 * dot(wi, wh), EPSILON)
    pdf = diffuse_pdf + (spec_pdf - diffuse_pdf) * s["sw"]
    return evaluate_bsdf(s, wo, wi, wh), wi, pdf, s0, s1


# --- textures --------------------------------------------------------------

def _bilinear(pool, base, w, h, uv):
    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    xi, yi = x0f.to(torch.int64), y0f.to(torch.int64)
    x0, x1 = torch.remainder(xi, w), torch.remainder(xi + 1, w)   # repeat addressing
    y0, y1 = torch.remainder(yi, h), torch.remainder(yi + 1, h)

    def fetch(yy, xx):
        return pool.texels[base + yy * w + xx].to(torch.float32) * (1.0 / 255.0)

    top = fetch(y0, x0) * (1.0 - fx) + fetch(y0, x1) * fx
    bot = fetch(y1, x0) * (1.0 - fx) + fetch(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def _trilinear(pool, tid, uv, lod):
    lmax = pool.offset.shape[1] - 1
    lod = torch.clamp(lod, 0.0, float(lmax))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp_max(l0 + 1, lmax)
    frac = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilinear(pool, pool.offset[tid, l0], pool.width[tid, l0], pool.height[tid, l0], uv)
    c1 = _bilinear(pool, pool.offset[tid, l1], pool.width[tid, l1], pool.height[tid, l1], uv)
    return c0 * (1.0 - frac) + c1 * frac


def sample_texture(pool, tex_id, uv, footprint=None):
    """(R, 4) in [0, 1]: the base level bilinearly (``footprint`` None,
    the ray tracer's implicit lod) or ``taps`` trilinear taps along the
    major axis of the footprint ``(duvdx, duvdy, taps)`` at the lod of its
    minor axis, the ratio clamped to ``taps``."""
    tid = torch.clamp_min(tex_id, 0)
    if footprint is None:
        return _bilinear(pool, pool.offset[tid, 0], pool.width[tid, 0], pool.height[tid, 0], uv)
    duvdx, duvdy, taps = footprint
    wh = torch.stack([pool.width[tid, 0].to(torch.float32),
                      pool.height[tid, 0].to(torch.float32)], dim=1)
    ex, ey = duvdx * wh, duvdy * wh
    lx = torch.sqrt(torch.clamp_min(ex[:, 0] * ex[:, 0] + ex[:, 1] * ex[:, 1], 1e-16))
    ly = torch.sqrt(torch.clamp_min(ey[:, 0] * ey[:, 0] + ey[:, 1] * ey[:, 1], 1e-16))
    maj, mnr = torch.maximum(lx, ly), torch.minimum(lx, ly)
    lod = torch.log2(torch.clamp_min(torch.maximum(mnr, maj / float(taps)), 1e-8))
    major = torch.where((lx >= ly)[:, None], duvdx, duvdy)
    acc = None
    for i in range(taps):
        c = _trilinear(pool, tid, uv + major * ((i + 0.5) / taps - 0.5), lod)
        acc = c if acc is None else acc + c
    return acc * (1.0 / taps)


# --- environment -----------------------------------------------------------

def panorama_uv(d):
    u = torch.atan2(d[..., 2], d[..., 0]) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(-d[..., 1], -1.0, 1.0)) * 0.3183 + 0.5
    return torch.stack([u, v], dim=-1)


def sample_panorama(image, uv):
    """Bilinear, wrapping in u and clamped in v (v = 0 the top row)."""
    h, w = image.shape[0], image.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    top = image[y0i, x0i] * (1.0 - fx) + image[y0i, x1i] * fx
    bot = image[y1i, x0i] * (1.0 - fx) + image[y1i, x1i] * fx
    return top * (1.0 - fy) + bot * fy


FACES_N = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
FACES_T = ((0, 0, -1), (0, 0, 1), (1, 0, 0), (1, 0, 0), (1, 0, 0), (-1, 0, 0))
FACES_B = ((0, -1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1), (0, -1, 0), (0, -1, 0))


def cube_direction(face, uv):
    st = uv * 2.0 - 1.0
    n, t, b = (torch.tensor(rows[face], dtype=torch.float32, device=uv.device)
               for rows in (FACES_N, FACES_T, FACES_B))
    d = n + st[..., 0:1] * t + st[..., 1:2] * b
    return d / torch.sqrt(dot(d, d))[..., None]


def sample_cube(cube, d):
    """Bilinear lookup of a (6, S, S, C) cube, clamped at each face."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    xm = (ax >= ay) & (ax >= az)
    ym = ay >= az
    face = torch.where(xm, torch.where(x >= 0, 0, 1),
                       torch.where(ym, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    major = torch.where(xm, ax, torch.where(ym, ay, az))
    dn = d * (1.0 / torch.clamp_min(major, 1e-20))[..., None]
    ft = torch.tensor(FACES_T, dtype=torch.float32, device=d.device)[face]
    fb = torch.tensor(FACES_B, dtype=torch.float32, device=d.device)[face]
    uv = torch.stack([(dot(dn, ft) + 1.0) * 0.5, (dot(dn, fb) + 1.0) * 0.5], dim=-1)
    s = cube.shape[1]
    px = uv[..., 0] * s - 0.5
    py = uv[..., 1] * s - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[..., None], (py - y0)[..., None]
    x0i = torch.clamp(x0.long(), 0, s - 1)
    x1i = torch.clamp(x0i + 1, 0, s - 1)
    y0i = torch.clamp(y0.long(), 0, s - 1)
    y1i = torch.clamp(y0i + 1, 0, s - 1)
    flat = cube.reshape(-1, cube.shape[-1])
    base = face * (s * s)
    top = flat[base + y0i * s + x0i] * (1.0 - fx) + flat[base + y0i * s + x1i] * fx
    bot = flat[base + y1i * s + x0i] * (1.0 - fx) + flat[base + y1i * s + x1i] * fx
    return top * (1.0 - fy) + bot * fy


def sample_cube_mips(mips, d, lod):
    n = len(mips)
    lod = torch.clamp(lod, 0.0, float(n - 1))
    lo = torch.floor(lod).long()
    frac = (lod - lo.to(torch.float32))[..., None]
    samples = torch.stack([sample_cube(m, d) for m in mips], dim=0)

    def take(i):
        return samples.gather(0, i[None, ..., None].expand(1, *samples.shape[1:]))[0]

    return take(lo) * (1.0 - frac) + take(torch.clamp_max(lo + 1, n - 1)) * frac
