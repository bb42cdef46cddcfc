"""Image-based-lighting precomputation (split-sum IBL) for the hybrid mode.

Counterpart of ``vulkanraytracing_tpu/env/ibl.py``.  The irradiance and
reflection convolutions are dense weighted products, as in the JAX
package: for every output direction o the integral over the (downsampled)
panorama's texels t is

    out[o] = sum_t W(dot(N_o, d_t)) * L_t * omega_t / norm,

an (OUT, 3) @ (3, T) product for the cosines, the kernel W elementwise,
then (OUT, T) @ (T, 3).  They stay ``torch.matmul``: the JAX package
computes them outside any Pallas kernel.  Two things differ from it:

- The output rows go in blocks of ``BLOCK_ELEMENTS / T`` rows, so that
  the (OUT, T) matrices never exist whole (6 * 256^2 x 8,192 float32 is
  12.9 GB at the reflection's mip 1); each row's sums are the same.
- The products run in full float32: TF32 is switched off around them
  (``_full_fp32``), whatever the caller's setting.

The BRDF table keeps the JAX package's estimator (Hammersley points, GGX,
Schlick visibility with k = a/2).  Its 4,096-step scan becomes blocks of
samples evaluated at once and then added one sample at a time, so that
each table entry sums its samples in the scan's order.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.core.math3d import EPSILON, PI
from vulkanraytracing_torch.env.panorama import (
    cube_direction,
    cube_face_uvs,
    panorama_uv,
    sample_bilinear_wrap,
)
from vulkanraytracing_torch.pt.bsdf import importance_sample_ggx, vis_schlick
from vulkanraytracing_torch.scene.types import Environment

# float32 elements of one (rows, T) block of the convolutions (512 MiB)
BLOCK_ELEMENTS = 1 << 27
# float32 elements of one (samples, 2, P) block of the BRDF table's terms
LUT_BLOCK_ELEMENTS = 1 << 25


@contextlib.contextmanager
def _full_fp32():
    """Float32 products on the card: TF32 off inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _equirect_samples(panorama: Tensor, height: int) -> tuple[Tensor, Tensor, Tensor]:
    """The panorama box-downsampled to about (height, 2 * height) texels:
    their directions (T, 3), radiance (T, 3) and solid angles (T,)."""
    h, w = height, height * 2
    ph, pw = panorama.shape[0], panorama.shape[1]
    fy = max(ph // h, 1)
    fx = max(pw // w, 1)
    crop = panorama[: (ph // fy) * fy, : (pw // fx) * fx]
    small = crop.reshape(ph // fy, fy, pw // fx, fx, 3).mean(dim=(1, 3))
    sh, sw = small.shape[0], small.shape[1]

    device = panorama.device
    v = (torch.arange(sh, dtype=torch.float32, device=device) + 0.5) / sh
    u = (torch.arange(sw, dtype=torch.float32, device=device) + 0.5) / sw
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    # invert panorama_uv: u = atan2(z, x) * 0.1591 + 0.5, v = asin(-y) * 0.3183 + 0.5
    theta = (uu - 0.5) / 0.1591
    lat = (vv - 0.5) / 0.3183
    y = -torch.sin(lat)
    c = torch.cos(lat)
    x = c * torch.cos(theta)
    z = c * torch.sin(theta)
    dirs = torch.stack([x, y, z], dim=-1).reshape(-1, 3)

    # an equirect texel's solid angle: (2 pi / W)(pi / H) cos(latitude)
    omega = (2.0 * PI / sw) * (PI / sh) * torch.clamp_min(c, 0.0)
    return dirs, small.reshape(-1, 3), omega.reshape(-1)


def _cube_dirs(size: int, device) -> Tensor:
    uv = cube_face_uvs(size, device)
    return torch.stack([cube_direction(f, uv) for f in range(6)], dim=0)  # (6, S, S, 3)


def _row_blocks(rows: int, width: int):
    step = max(1, BLOCK_ELEMENTS // width)
    return (slice(i, min(i + step, rows)) for i in range(0, rows, step))


def compute_irradiance_cube(panorama: Tensor, size: int = 128, env_height: int = 64) -> Tensor:
    """Cosine-convolved irradiance cube (6, size, size, 3): (1/pi) times the
    integral of L(d) max(N.d, 0) over the sphere."""
    dirs_out = _cube_dirs(size, panorama.device).reshape(-1, 3)
    dirs_in, radiance, omega = _equirect_samples(panorama, env_height)
    weighted = radiance * omega[:, None]
    out = torch.empty_like(dirs_out)
    with _full_fp32():
        for rows in _row_blocks(dirs_out.shape[0], dirs_in.shape[0]):
            cos = torch.clamp_min(dirs_out[rows] @ dirs_in.T, 0.0)
            out[rows] = (cos @ weighted) / PI
    return out.reshape(6, size, size, 3)


def _ggx_reflected_kernel(cos_rl: Tensor, a2: float) -> Tensor:
    """Weight of radiance arriving acos(cos_rl) off the reflection
    direction: D_GGX at the half angle (N = V = R) times NoL."""
    cos_h = torch.sqrt(torch.clamp_min((1.0 + cos_rl) * 0.5, 0.0))
    nol = torch.clamp_min(cos_rl, 0.0)
    d = (cos_h * a2 - cos_h) * cos_h + 1.0
    return (a2 / (PI * d * d)) * nol


def compute_reflection_cube(panorama: Tensor, size: int = 512, mip_count: int = 10,
                            env_height: int = 64) -> tuple[Tensor, ...]:
    """GGX-prefiltered reflection mips, mip m at roughness m / (mips - 1):
    mip 0 is the mirror lookup of the full panorama, the others the
    convolution normalized by the summed kernel."""
    dirs_in, radiance, omega = _equirect_samples(panorama, env_height)
    weighted = radiance * omega[:, None]
    mips = []
    for m in range(mip_count):
        s = max(size >> m, 1)
        roughness = m / max(mip_count - 1, 1)
        a = roughness * roughness
        a2 = max(a * a, EPSILON)
        dirs_out = _cube_dirs(s, panorama.device).reshape(-1, 3)
        if m == 0:
            out = sample_bilinear_wrap(panorama, panorama_uv(dirs_out))
        else:
            out = torch.empty_like(dirs_out)
            with _full_fp32():
                for rows in _row_blocks(dirs_out.shape[0], dirs_in.shape[0]):
                    w = _ggx_reflected_kernel(dirs_out[rows] @ dirs_in.T, a2)
                    norm = w @ omega
                    out[rows] = (w @ weighted) / torch.clamp_min(norm, 1e-20)[:, None]
        mips.append(out.reshape(6, s, s, 3))
    return tuple(mips)


def compute_brdf_lut(size: int = 256, sample_count: int = 4096,
                     device: torch.device | str = "cuda") -> Tensor:
    """Split-sum specular BRDF table (size, size, 2): x = NoV, y =
    roughness, (scale, offset) averaged over ``sample_count`` Hammersley
    GGX samples."""
    uv = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    nov, roughness = torch.meshgrid(uv, uv, indexing="xy")
    nov = nov.reshape(-1)  # (P,)
    roughness = roughness.reshape(-1)
    v = torch.stack([torch.sqrt(torch.clamp_min(1.0 - nov * nov, 0.0)),
                     torch.zeros_like(nov), nov], dim=-1)
    a = roughness * roughness
    a2 = torch.clamp_min(a * a, 0.0)

    acc = torch.zeros((2, nov.shape[0]), dtype=torch.float32, device=device)
    step = max(1, LUT_BLOCK_ELEMENTS // (2 * nov.shape[0]))
    for start in range(0, sample_count, step):
        i = torch.arange(start, min(start + step, sample_count), device=device)
        xi = math3d.hammersley(i, sample_count)[:, None, :]  # (B, 1, 2)
        h = importance_sample_ggx(xi, a2, fused=True)  # (B, P, 3)
        voh_raw = math3d.dot(v, h)
        l = 2.0 * voh_raw[..., None] * h - v
        nol = torch.clamp_min(l[..., 2], 0.0)
        noh = torch.clamp_min(h[..., 2], 0.0)
        voh = torch.clamp_min(voh_raw, 0.0)
        vis = vis_schlick(a, nov, nol)
        vis_nol_pdf = vis * nol * (4.0 * voh / torch.clamp_min(noh, 1e-20))
        fc = math3d.pow5(1.0 - voh)
        ok = nol > 0.0
        terms = torch.stack([torch.where(ok, (1.0 - fc) * vis_nol_pdf, 0.0),
                             torch.where(ok, fc * vis_nol_pdf, 0.0)], dim=1)  # (B, 2, P)
        for term in terms:  # one sample at a time: the scan's order
            acc = acc + term
    return (acc / sample_count).T.reshape(size, size, 2).contiguous()


def bake_ibl(env: Environment, irradiance_size: int = 128, reflection_size: int = 512,
             brdf_size: int = 256) -> Environment:
    """The environment with its IBL fields filled, on the panorama's
    device: irradiance cube, reflection mips down to 1x1 and the BRDF
    table."""
    mip_count = int(math.log2(reflection_size)) + 1
    return env._replace(
        irradiance=compute_irradiance_cube(env.panorama, irradiance_size),
        reflection=compute_reflection_cube(env.panorama, reflection_size, mip_count),
        brdf_lut=compute_brdf_lut(brdf_size, device=env.panorama.device),
    )
