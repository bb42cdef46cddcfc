"""The progressive path-tracing integrator.

Counterpart of ``vulkanraytracing_tpu/pt/integrator.py``: the whole
wavefront of R rays advances bounce by bounce as tensors with aliveness
masks, with the same estimator and the same random stream per pixel
(seeding, jitter from a copy of the seed, throughput over accumulated pdf,
Russian roulette from bounce ``min_bounce_count``, back-face culling on
material rays only, the primary point-light sphere short-circuit).

From bounce 1 on, point-light shadow rays are traced from the light
toward the surface, as the JAX package does: the same segment, with the
window [0, dist - RAY_MIN_T]; dead lanes get the inverted window
[0, -1].

The wavefront sort (``ops.reorder``) runs on every bounce over a BVH
unless the mode is ``BRUTE_FORCE`` or ``VRT_DEBUG_NO_SORT`` is set, as in
the JAX package: the whole live state rides one stable permutation into
coherence order.  Bounce 0's shadow rays are traced before the sort (in
pixel-tile order their origins are already coherent); every later
bounce's shadow rays ride the sort and are traced after it.  Each ray's
slot rides too, and one scatter restores pixel order at the end.  Every
step is per ray, so the sort must not change the image.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.config import Config, TraversalMode
from vulkanraytracing_torch.core import math3d, rng
from vulkanraytracing_torch.core.math3d import BIAS, EPSILON, RAY_MAX_T, RAY_MIN_T
from vulkanraytracing_torch.env.panorama import sample_environment
from vulkanraytracing_torch.ops import reorder, trace
from vulkanraytracing_torch.ops.intersect import fetch_surface_attributes
from vulkanraytracing_torch.pt import bsdf as bsdf_mod
from vulkanraytracing_torch.pt.surface import texture_slots_used, unpack_material
from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import PointLights, Scene
from vulkanraytracing_torch.utils.profiling import host_sync, span, trace_scope

BIG_T = 3.0e38


class TraceStats(NamedTuple):
    """Ray count for the Mrays/s metric: material plus visibility rays."""

    rays: Tensor  # () int64


def _mat4_vec4(m: Tensor, v: Tensor) -> Tensor:
    """m @ v for a (4, 4) matrix and (..., 4) vectors, summed left to right."""
    return (m[:, 0] * v[..., 0:1] + m[:, 1] * v[..., 1:2]
            + m[:, 2] * v[..., 2:3] + m[:, 3] * v[..., 3:4])


def primary_rays(camera: CameraPT, px: Tensor, py: Tensor, width: int,
                 height: int, s0: Tensor, s1: Tensor) -> tuple[Tensor, Tensor]:
    """Camera rays with sub-pixel jitter.  The jitter draws from a copy of
    the RNG state: the caller keeps its (s0, s1)."""
    jitter, _, _ = rng.next_vec2(s0, s1)
    with host_sync("pixel_size"):  # a copy from pageable host memory
        size = torch.tensor([width, height], dtype=torch.float32, device=px.device)
    pix = torch.stack([px, py], dim=-1).to(torch.float32)
    uv = (pix + jitter) / size
    xy = uv * 2.0 - 1.0
    target = _mat4_vec4(camera.inverse_proj, torch.cat([xy, torch.ones_like(xy)], -1))
    t3 = math3d.normalize(target[..., :3])
    direction = _mat4_vec4(
        camera.inverse_view, torch.cat([t3, torch.zeros_like(t3[..., :1])], -1)
    )
    d = math3d.normalize(direction[..., :3])
    o = camera.inverse_view[:3, 3].expand_as(d)
    return o, d


def intersect_point_light_spheres(
    lights: PointLights, radius: float, o: Tensor, d: Tensor, t_min: Tensor,
    t_max: Tensor,
) -> tuple[Tensor, Tensor]:
    """Closest light-gizmo sphere hit.  Returns (t, color); t = -1 on a
    miss.  Ties go to the lowest light index (first minimum)."""
    c = lights.position[None, :, :3]
    oc = o[:, None, :] - c
    b = math3d.dot(oc, d[:, None, :])
    cc = math3d.dot(oc, oc) - radius * radius
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min[:, None], t0, t1)
    valid = (disc > 0.0) & (t > t_min[:, None]) & (t < t_max[:, None])
    t = torch.where(valid, t, BIG_T)
    first = torch.argmin(t, dim=1)
    t_best = t.gather(1, first[:, None]).squeeze(1)
    color = lights.color[first, :3]
    return torch.where(t_best < BIG_T, t_best, -1.0), color


def _estimate_point_lights(lights: PointLights, n: Tensor, p: Tensor) -> Tensor:
    """Per-light unshadowed irradiance estimate lum * NoL / d^2, (R, L)."""
    delta = lights.position[None, :, :3] - p[:, None, :]
    dist_sq = math3d.dot(delta, delta)
    l_dir = delta * torch.rsqrt(torch.clamp_min(dist_sq, 1e-20))[..., None]
    nol = torch.clamp_min(math3d.dot(n[:, None, :], l_dir), 0.0)
    lum = math3d.luminance(lights.color[None, :, :3])
    return lum * nol / torch.clamp_min(dist_sq, 1e-20)


@span("vrt.nee")
def sample_point_light(lights: PointLights, n: Tensor, p: Tensor, s0: Tensor,
                       s1: Tensor):
    """Irradiance-proportional CDF selection, one uniform draw per call.
    Returns (light index, pdf, s0', s1')."""
    est = _estimate_point_lights(lights, n, p)
    cdf = torch.cumsum(est, dim=1)
    total = cdf[:, -1:]
    # all lights below the horizon: the forced last light gets pdf 1 and
    # its NoL = 0 zeroes the contribution
    safe_total = torch.where(total > 0.0, total, 1.0)
    cdf = torch.where(total > 0.0, cdf / safe_total, torch.ones_like(cdf))
    cdf[:, -1] = 1.0
    x, s0, s1 = rng.next_float(s0, s1)
    idx = (x[:, None] >= cdf[:, :-1]).sum(dim=1)
    cdf_lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=1)
    pdf = (cdf - cdf_lo).gather(1, idx[:, None]).squeeze(1)
    return idx, pdf, s0, s1


def pathtrace(
    scene: Scene, cfg: Config, camera: CameraPT, px: Tensor, py: Tensor,
    width: int, height: int, accum_index: int, valid: Tensor | None = None,
) -> tuple[Tensor, TraceStats]:
    """Trace one sample for each pixel (px, py); returns the tone-mapped
    color (R, 3) and the ray count.  ``valid`` masks padding lanes: they
    neither trace nor count."""
    r = px.shape[0]
    dev = px.device
    f32 = torch.float32
    if valid is None:
        valid = torch.ones((r,), dtype=torch.bool, device=dev)

    def full(value) -> Tensor:
        return torch.full((r,), value, dtype=f32, device=dev)

    # the texture slots in use: read back once a call, before its work is
    # queued, so the read waits for nothing of this frame
    slots = None if scene.textures is None else texture_slots_used(scene.materials)

    s0, s1 = rng.pixel_seed(px, py, accum_index)
    o, d = primary_rays(camera, px, py, width, height, s0, s1)
    t_min = full(camera.z_near)
    t_max = torch.where(valid, camera.z_far, 0.0)

    n_valid = valid.sum()
    rays_cast = n_valid.clone()
    hit = trace.trace_closest(scene, cfg, o, d, t_min, t_max, cull_backface=True)

    irradiance = torch.zeros((r, 3), dtype=f32, device=dev)
    throughput = torch.ones((r, 3), dtype=f32, device=dev)
    ray_pdf = torch.ones((r,), dtype=f32, device=dev)
    alive = valid.clone()
    # each ray's original slot rides every permutation of the sort
    ray_slot = torch.arange(r, device=dev)
    do_sort = (
        scene.bvh is not None
        and cfg.traversal != TraversalMode.BRUTE_FORCE
        # the sort only permutes rays and restores their order, so turning
        # it off must not change the image: a debugging switch
        and not os.environ.get("VRT_DEBUG_NO_SORT")
    )

    if scene.has_point_lights:
        pl_t, pl_color = intersect_point_light_spheres(
            scene.point_lights, cfg.point_light_radius, o, d, t_min, t_max
        )
        rays_cast += n_valid

    geom = scene.geometry
    sun_dir = math3d.normalize(-scene.direct_light.direction[:3])
    sun_color = scene.direct_light.color[:3]
    sun_d = sun_dir.expand(r, 3).contiguous()

    for bounce in range(cfg.max_bounce_count):
        with trace_scope("vrt.bounce"):
            with trace_scope("vrt.shade"):
                if bounce == 0 and scene.has_point_lights:
                    pl_hit = (pl_t >= 0.0) & (hit.is_miss | (pl_t < hit.t)) & alive
                    irradiance = torch.where(pl_hit[:, None], pl_color, irradiance)
                    alive &= ~pl_hit

                env_col = sample_environment(scene.environment, d)
                miss = hit.is_miss & alive
                irradiance += torch.where(
                    miss[:, None], env_col * throughput / ray_pdf[:, None], 0.0
                )
                alive &= ~miss

                attrs = fetch_surface_attributes(geom, hit)
                unpacked = unpack_material(scene, attrs, slots=slots)
                surface, tbn = unpacked.surface, unpacked.tbn
                n_shading = tbn[..., 2]

                irradiance += torch.where(
                    alive[:, None], surface.emission * throughput / ray_pdf[:, None], 0.0
                )

                p = o + d * hit.t[:, None]
                wo = math3d.normalize(math3d.world_to_tangent(-d, tbn))
                shadow_origin = p + n_shading * BIAS

                # next-event estimation: contributions use the pre-BSDF-update
                # throughput and pdf; the visibility rays are traced below
                sh_tmax_sun = torch.where(alive, RAY_MAX_T, 0.0)
                if scene.has_point_lights:
                    lights = scene.point_lights
                    idx, light_pdf, s0, s1 = sample_point_light(
                        lights, n_shading, p, s0, s1
                    )
                    lpos = lights.position[idx, :3]
                    lcol = lights.color[idx, :3]
                    delta = lpos - p
                    dist_sq = math3d.dot(delta, delta)
                    attenuation = math3d.rcp(dist_sq)
                    ldir = math3d.normalize(delta)
                    wi_l = math3d.world_to_tangent(ldir, tbn)
                    wh_l = math3d.normalize(wo + wi_l)
                    pl_bsdf = bsdf_mod.evaluate_bsdf(surface, wo, wi_l, wh_l)
                    pl_contrib = (
                        pl_bsdf
                        * math3d.cos_theta_tangent(wi_l)[:, None]
                        * lcol
                        * (attenuation / torch.clamp_min(light_pdf, 1e-20))[:, None]
                    )
                    pl_contrib = torch.where(
                        alive[:, None], pl_contrib * throughput / ray_pdf[:, None], 0.0
                    )
                    sh_tmax_pl = torch.where(alive, torch.sqrt(dist_sq), 0.0)
                wi_s = math3d.world_to_tangent(sun_d, tbn)
                wh_s = math3d.normalize(wo + wi_s)
                sun_bsdf = bsdf_mod.evaluate_bsdf(surface, wo, wi_s, wh_s)
                sun_contrib = sun_bsdf * math3d.cos_theta_tangent(wi_s)[:, None] * sun_color
                sun_contrib = torch.where(
                    alive[:, None], sun_contrib * throughput / ray_pdf[:, None], 0.0
                )

                b, wi, pdf, s0, s1 = bsdf_mod.sample_bsdf(surface, wo, s0, s1)
                dead = (pdf < EPSILON) | (math3d.dot(b, b) < EPSILON)
                alive &= ~dead
                step_throughput = b * math3d.cos_theta_tangent(wi)[:, None]
                throughput = torch.where(alive[:, None], throughput * step_throughput,
                                         throughput)
                ray_pdf = torch.where(alive, ray_pdf * pdf, ray_pdf)

                if bounce >= cfg.min_bounce_count:
                    threshold = torch.clamp_min(
                        1.0 - math3d.max_component(throughput), cfg.rr_min_threshold
                    )
                    rr, s0, s1 = rng.next_float(s0, s1)
                    alive &= ~(rr < threshold)
                    throughput = torch.where(
                        alive[:, None], throughput / (1.0 - threshold)[:, None], throughput
                    )

                o = p
                d = math3d.tangent_to_world(wi, tbn)
                t_min = full(RAY_MIN_T)
                # dead rays get a zero-length window so traversal exits at once
                t_max = torch.where(alive, RAY_MAX_T, 0.0)

            @span("vrt.trace.any")
            def nee_trace(flip_pl: bool) -> tuple[Tensor, Tensor]:
                """Trace the visibility rays of the current state (gated by the
                pre-roulette aliveness); returns the irradiance with the
                unshadowed contributions they pass added, and the ray count."""
                nee_alive = sh_tmax_sun > 0.0
                if scene.has_point_lights:
                    if flip_pl:
                        pl_o = shadow_origin + ldir * sh_tmax_pl[:, None]
                        pl_d = -ldir
                        pl_tmax = torch.where(
                            sh_tmax_pl > 0.0,
                            torch.clamp_min(sh_tmax_pl - RAY_MIN_T, 0.0),
                            -1.0,
                        )
                        pl_tmin = full(0.0)
                    else:
                        pl_o, pl_d, pl_tmax = shadow_origin, ldir, sh_tmax_pl
                        pl_tmin = full(RAY_MIN_T)
                    occ = trace.trace_any(
                        scene, cfg,
                        torch.cat([pl_o, shadow_origin]),
                        torch.cat([pl_d, sun_d]),
                        torch.cat([pl_tmin, full(RAY_MIN_T)]),
                        torch.cat([pl_tmax, sh_tmax_sun]),
                    )
                    occluded, sun_occluded = occ[:r], occ[r:]
                    lit = irradiance + torch.where(occluded[:, None], 0.0, pl_contrib)
                    cast = rays_cast + 2 * nee_alive.sum()
                else:
                    sun_occluded = trace.trace_any(
                        scene, cfg, shadow_origin, sun_d, full(RAY_MIN_T), sh_tmax_sun
                    )
                    lit, cast = irradiance, rays_cast + nee_alive.sum()
                return lit + torch.where(sun_occluded[:, None], 0.0, sun_contrib), cast

            if bounce == 0:
                irradiance, rays_cast = nee_trace(flip_pl=False)

            if do_sort:
                lo, hi = trace.root_bounds(scene.bvh)
                core = (o, d, t_min, t_max, irradiance, throughput, ray_pdf,
                        s0, s1, alive, valid, ray_slot)
                if bounce == 0:
                    shadow_cols = ()
                elif scene.has_point_lights:
                    shadow_cols = (shadow_origin, sh_tmax_sun, sun_contrib,
                                   ldir, sh_tmax_pl, pl_contrib)
                else:
                    shadow_cols = (shadow_origin, sh_tmax_sun, sun_contrib)
                out = reorder.sort_wavefront(o, d, t_min, t_max, lo, hi,
                                             (*core, *shadow_cols))
                (o, d, t_min, t_max, irradiance, throughput, ray_pdf,
                 s0, s1, alive, valid, ray_slot) = out[:12]
                if bounce > 0:
                    if scene.has_point_lights:
                        (shadow_origin, sh_tmax_sun, sun_contrib,
                         ldir, sh_tmax_pl, pl_contrib) = out[12:]
                    else:
                        shadow_origin, sh_tmax_sun, sun_contrib = out[12:]

            if bounce > 0:
                irradiance, rays_cast = nee_trace(flip_pl=True)

            if bounce + 1 < cfg.max_bounce_count:
                hit = trace.trace_closest(scene, cfg, o, d, t_min, t_max,
                                          cull_backface=True)
                rays_cast += alive.sum()

    if cfg.tone_map_before_accumulation:
        color = math3d.tone_mapping(irradiance)
    else:
        color = irradiance
    if do_sort:
        # restore pixel order: ray_slot carried each ray's original index
        # through every permutation, and the slots are unique
        color = torch.empty_like(color).index_copy_(0, ray_slot, color)
    return color, TraceStats(rays=rays_cast)
