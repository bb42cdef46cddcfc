"""PBR metallic-roughness BSDF.

Counterpart of ``vulkanraytracing_tpu/pt/bsdf.py``, with the same
formulas and the same preserved quirks (Schlick visibility with k = a/2,
the lobe-selection weight ``sw`` mixing the two pdfs linearly).  All
directions are in tangent space (+Z = shading normal), vectorized over
leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.core import math3d, rng
from vulkanraytracing_torch.core.math3d import EPSILON, PI

DIELECTRIC_F0 = 0.04


class Surface(NamedTuple):
    """Shading point; the TBN frame is kept beside it by the integrator."""

    base_color: Tensor  # (..., 3)
    roughness: Tensor   # (...)
    metallic: Tensor    # (...)
    emission: Tensor    # (..., 3)
    f0: Tensor          # (..., 3)
    a: Tensor           # (...) roughness^2
    a2: Tensor          # (...) max(a^2, EPSILON)
    sw: Tensor          # (...) specular lobe selection weight


def make_surface(base_color: Tensor, roughness: Tensor, metallic: Tensor,
                 emission: Tensor) -> Surface:
    f0 = math3d.mix(
        torch.full_like(base_color, DIELECTRIC_F0), base_color, metallic[..., None]
    )
    a = roughness * roughness
    a2 = torch.clamp_min(a * a, EPSILON)
    sw = get_specular_weight(base_color, f0, metallic)
    return Surface(base_color=base_color, roughness=roughness, metallic=metallic,
                   emission=emission, f0=f0, a=a, a2=a2, sw=sw)


def get_specular_weight(base_color: Tensor, f0: Tensor, metallic: Tensor) -> Tensor:
    diffuse_lum = math3d.luminance(base_color) * (1.0 - metallic)
    specular_lum = math3d.luminance(f0)
    return torch.clamp_max(specular_lum / (specular_lum + diffuse_lum), 1.0)


def d_ggx(a2: Tensor, noh: Tensor) -> Tensor:
    d = (noh * a2 - noh) * noh + 1.0
    return a2 / (PI * d * d)


def f_schlick(f0: Tensor, voh: Tensor) -> Tensor:
    fc = math3d.pow5(1.0 - voh)
    return f0 + (1.0 - f0) * fc[..., None]


def f_schlick_roughness(f0: Tensor, voh: Tensor, roughness: Tensor) -> Tensor:
    """Fresnel with roughness (the hybrid renderer's IBL term)."""
    fc = math3d.pow5(1.0 - voh)
    return f0 + (torch.maximum(1.0 - roughness[..., None], f0) - f0) * fc[..., None]


def vis_schlick(a: Tensor, nov: Tensor, nol: Tensor) -> Tensor:
    """Schlick visibility with k = a/2."""
    k = a * 0.5
    vis_v = nov * (1.0 - k) + k
    vis_l = nol * (1.0 - k) + k
    return 0.25 * math3d.rcp(vis_v * vis_l)


def importance_sample_ggx(e: Tensor, a2: Tensor, fused: bool = False) -> Tensor:
    """GGX half-vector sample in tangent space.

    ``fused=True`` rounds as XLA compiles the JAX package's jitted BRDF
    table: 1 + (a2 - 1) e1 as one fused multiply-add (the float32 product
    is exact in float64) and the squared cosine reused for the sine
    (sqrt(x)^2 -> x).  Where a2 is near 0 the denominator cancels, and
    those roundings decide the table's grazing entries.  The default
    rounds each operation alone, as the JAX function does op by op.
    """
    phi = 2.0 * PI * e[..., 0]
    e1 = e[..., 1]
    if fused:
        denom = (1.0 + (a2 - 1.0).double() * e1.double()).float()
        cos2_theta = torch.clamp_min((1.0 - e1) / denom, 0.0)
        cos_theta = torch.sqrt(cos2_theta)
    else:
        cos_theta = torch.sqrt(torch.clamp_min((1.0 - e1) / (1.0 + (a2 - 1.0) * e1), 0.0))
        cos2_theta = cos_theta * cos_theta
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos2_theta, 0.0))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def importance_pdf_ggx(cos_theta: Tensor, a2: Tensor) -> Tensor:
    return cos_theta * d_ggx(a2, cos_theta)


def specular_pdf(noh: Tensor, a2: Tensor, voh: Tensor) -> Tensor:
    return importance_pdf_ggx(noh, a2) / torch.clamp_min(4.0 * voh, EPSILON)


def evaluate_bsdf(surface: Surface, wo: Tensor, wi: Tensor, wh: Tensor) -> Tensor:
    """kD * Lambert + D*F*Vis."""
    nov = math3d.cos_theta_tangent(wo)
    nol = math3d.cos_theta_tangent(wi)
    noh = math3d.cos_theta_tangent(wh)
    voh = torch.clamp_min(math3d.dot(wo, wh), 0.0)
    d = d_ggx(surface.a2, noh)
    f = f_schlick(surface.f0, voh)
    vis = vis_schlick(surface.a, nov, nol)
    kd = (1.0 - f) * (1.0 - surface.metallic[..., None])
    diffuse = kd * surface.base_color * math3d.INVERSE_PI
    specular = (d * vis)[..., None] * f
    return diffuse + specular


def pdf_bsdf(surface: Surface, wo: Tensor, wi: Tensor, wh: Tensor) -> Tensor:
    """mix(cosine pdf, specular pdf, sw); dot(wi, wh) is fed unclamped."""
    diffuse_pdf = math3d.cosine_pdf_hemisphere(math3d.cos_theta_tangent(wi))
    spec_pdf = specular_pdf(
        math3d.cos_theta_tangent(wh), surface.a2, math3d.dot(wi, wh)
    )
    return math3d.mix(diffuse_pdf, spec_pdf, surface.sw)


def sample_bsdf(surface: Surface, wo: Tensor, s0: Tensor, s1: Tensor):
    """Draw wi; returns (bsdf, wi, pdf, s0', s1').  One NextVec3: .xy for
    the lobe sample, .z for lobe selection (specular if < sw)."""
    e, s0, s1 = rng.next_vec3(s0, s1)
    exy = e[..., :2]
    wh_spec = importance_sample_ggx(exy, surface.a2)
    wi_spec = 2.0 * math3d.dot(wh_spec, wo)[..., None] * wh_spec - wo
    wi_diff = math3d.cosine_sample_hemisphere(exy)
    wh_diff = math3d.normalize(wo + wi_diff)
    use_spec = (e[..., 2] < surface.sw)[..., None]
    wi = torch.where(use_spec, wi_spec, wi_diff)
    wh = torch.where(use_spec, wh_spec, wh_diff)
    pdf = pdf_bsdf(surface, wo, wi, wh)
    bsdf = evaluate_bsdf(surface, wo, wi, wh)
    return bsdf, wi, pdf, s0, s1
