"""The hybrid (deferred) render mode.

Counterpart of ``vulkanraytracing_tpu/hybrid/renderer.py``: the
reference's second render mode, a raster G-buffer, a deferred lighting
pass with ray-queried shadows, and a forward pass for the skybox and the
point lights' spheres.  The G-buffer is a closest-hit trace of one ray
through each pixel centre (culling back faces, no jitter, not sorted);
then, per pixel:

- the material with its textures filtered over the pixel's footprint
  (``cfg.hybrid_aniso_taps`` anisotropic taps, from screen-space uv
  differences);
- GGX direct lighting from the sun and every point light, whose shadow
  rays (the sun's set and one set a light) go through ONE any-hit trace;
- IBL ambient: the irradiance cube, the prefiltered reflection mips and
  the split-sum table, scaled by occlusion (none before ``env.ibl.bake_ibl``);
- the sky on a miss, and a point light's sphere where it is nearer.

The output is the tone-mapped display image: the mode does not
accumulate.  The JAX package keeps a cache of compiled executables per
call signature here, a workaround for a JAX dispatch fault; the port has
nothing to compile.
"""

from __future__ import annotations

import torch
from torch import Tensor

from vulkanraytracing_torch.config import Config
from vulkanraytracing_torch.core import math3d
from vulkanraytracing_torch.core.math3d import BIAS, EPSILON, RAY_MAX_T, RAY_MIN_T
from vulkanraytracing_torch.env.panorama import sample_cube, sample_cube_mips, sample_environment
from vulkanraytracing_torch.ops import trace
from vulkanraytracing_torch.ops.intersect import fetch_surface_attributes
from vulkanraytracing_torch.ops.texture import AnisoFootprint
from vulkanraytracing_torch.pt import bsdf as B
from vulkanraytracing_torch.pt.integrator import _mat4_vec4, intersect_point_light_spheres
from vulkanraytracing_torch.pt.render import TILE, tile_pixel_coords, untile_image
from vulkanraytracing_torch.pt.surface import texture_slots_used, unpack_material
from vulkanraytracing_torch.scene.camera import CameraPT
from vulkanraytracing_torch.scene.types import Scene
from vulkanraytracing_torch.utils.profiling import host_sync, trace_scope


def _direct_term(surface, n, v, l, nov, f0, metallic, albedo):
    """The GGX direct-lighting term shared by the sun and the point
    lights: (brdf (R, 3), NoL)."""
    h = math3d.normalize(l + v)
    nol = torch.clamp_min(math3d.dot(n, l), 0.0)
    noh = torch.clamp_min(math3d.dot(n, h), 0.0)
    voh = torch.clamp_min(math3d.dot(v, h), 0.0)
    d = B.d_ggx(surface.a2, noh)
    f = B.f_schlick(f0, voh)
    vis = B.vis_schlick(surface.a, nov, nol)
    kd = (1.0 - f) * (1.0 - metallic[:, None])
    diffuse = kd * albedo * math3d.INVERSE_PI
    specular = (d * vis)[:, None] * f
    return diffuse + specular, nol


def _center_rays(camera: CameraPT, px: Tensor, py: Tensor, width: int, height: int):
    """Primary rays through the pixel centres (raster sampling)."""
    with host_sync("pixel_size"):  # a copy from pageable host memory
        size = torch.tensor([width, height], dtype=torch.float32, device=px.device)
    pix = torch.stack([px, py], dim=-1).to(torch.float32)
    xy = (pix + 0.5) / size * 2.0 - 1.0
    target = _mat4_vec4(camera.inverse_proj, torch.cat([xy, torch.ones_like(xy)], -1))
    t3 = math3d.normalize(target[..., :3])
    direction = _mat4_vec4(camera.inverse_view, torch.cat([t3, torch.zeros_like(t3[..., :1])], -1))
    d = math3d.normalize(direction[..., :3])
    return camera.inverse_view[:3, 3].expand_as(d), d


def _footprint(uv: Tensor, taps: int, width: int, height: int, ty: int, tx: int):
    """Each pixel's uv change toward its left and upper neighbours, from
    the G-buffer's uvs as an image, back in tile order: an
    ``AnisoFootprint`` of ``taps`` taps, or with one tap the larger change
    as a trilinear footprint."""
    uv3 = torch.cat([uv, torch.zeros_like(uv[:, :1])], dim=1)
    uv_img = untile_image(uv3, width, height, ty, tx)[..., :2]
    ddx = uv_img - torch.roll(uv_img, 1, dims=1)
    ddy = uv_img - torch.roll(uv_img, 1, dims=0)

    def retile(img):  # (h, w, c) -> (r, c) in tile order
        c = img.shape[-1]
        img = torch.nn.functional.pad(img, (0, 0, 0, tx * TILE - width, 0, ty * TILE - height))
        return img.reshape(ty, TILE, tx, TILE, c).permute(0, 2, 1, 3, 4).reshape(-1, c)

    if taps > 1:
        return AnisoFootprint(duvdx=retile(ddx), duvdy=retile(ddy), taps=taps)
    fp = torch.maximum(ddx.abs().amax(dim=-1), ddy.abs().amax(dim=-1))
    return retile(fp[..., None])[:, 0]


def render_hybrid(scene: Scene, cfg: Config, camera: CameraPT) -> Tensor:
    """One hybrid frame -> (H, W, 3) display image, on the camera's
    device."""
    h, w = cfg.height, cfg.width
    device = camera.inverse_view.device
    slots = texture_slots_used(scene.materials) if scene.textures is not None else None
    px, py, valid, ty, tx = tile_pixel_coords(w, h, device=device)
    r = px.shape[0]

    with trace_scope("vrt.hybrid.gbuffer"):
        # G-buffer: primary visibility at the pixel centres
        o, d = _center_rays(camera, px, py, w, h)
        t_min = torch.full((r,), camera.z_near, dtype=torch.float32, device=device)
        t_max = torch.where(valid, camera.z_far, 0.0)
        hit = trace.trace_closest(scene, cfg, o, d, t_min, t_max, cull_backface=True)

        attrs = fetch_surface_attributes(scene.geometry, hit)
        footprint = None
        if scene.textures is not None:
            footprint = _footprint(attrs.uv, int(cfg.hybrid_aniso_taps), w, h, ty, tx)
        unpacked = unpack_material(scene, attrs, with_occlusion=True, footprint=footprint,
                                   slots=slots)
        surface = unpacked.surface
        n = unpacked.tbn[..., 2]
        albedo = surface.base_color
        metallic = surface.metallic
        f0 = surface.f0

        position = o + d * hit.t[:, None]
        v = math3d.normalize(camera.inverse_view[:3, 3] - position)
        nov = torch.clamp_min(math3d.dot(n, v), 0.0)
        shadow_origin = position + n * BIAS

    with trace_scope("vrt.hybrid.shadow"):
        # shadow rays: the sun's and every point light's in one any-hit trace
        sun_l = math3d.normalize(-scene.direct_light.direction[:3]).expand(r, 3)
        shadow_dirs = [sun_l]
        shadow_tmax = [torch.where(hit.is_hit, RAY_MAX_T, 0.0)]
        per_light = []
        if scene.has_point_lights:
            lights = scene.point_lights
            for i in range(lights.count):
                lcol = lights.color[i, :3]
                delta = lights.position[i, :3] - position
                dist_sq = math3d.dot(delta, delta)
                attenuation = math3d.rcp(dist_sq)
                l = math3d.normalize(delta)
                irr = attenuation * torch.clamp_min(math3d.dot(n, l), 0.0) * math3d.luminance(lcol)
                per_light.append((l, attenuation, lcol, irr))
                shadow_dirs.append(l)
                shadow_tmax.append(torch.where(hit.is_hit & (irr > EPSILON), torch.sqrt(dist_sq),
                                               0.0))

        sets = len(shadow_dirs)
        occ = trace.trace_any(
            scene, cfg, shadow_origin.repeat(sets, 1), torch.cat(shadow_dirs).contiguous(),
            torch.full((sets * r,), RAY_MIN_T, dtype=torch.float32, device=device),
            torch.cat(shadow_tmax),
        ).reshape(sets, r)

    with trace_scope("vrt.hybrid.lights"):
        point_lighting = torch.zeros((r, 3), dtype=torch.float32, device=device)
        for i, (l, attenuation, lcol, irr) in enumerate(per_light):
            brdf, nol = _direct_term(surface, n, v, l, nov, f0, metallic, albedo)
            lighting = nol[:, None] * lcol * (~occ[1 + i])[:, None] * attenuation[:, None]
            point_lighting = point_lighting + torch.where((irr > EPSILON)[:, None],
                                                          brdf * lighting, 0.0)

        brdf, nol = _direct_term(surface, n, v, sun_l, nov, f0, metallic, albedo)
        direct_lighting = (brdf * nol[:, None] * scene.direct_light.color[:3]
                           * (~occ[0])[:, None])

    with trace_scope("vrt.hybrid.ibl"):
        env = scene.environment
        if env.irradiance is not None and env.reflection is not None and env.brdf_lut is not None:
            irradiance = sample_cube(env.irradiance, n)
            ks = B.f_schlick_roughness(f0, nov, surface.roughness)
            kd = (1.0 - ks) * (1.0 - metallic[:, None])
            refl_dir = 2.0 * math3d.dot(v, n)[:, None] * n - v  # -reflect(V, N)
            lod = surface.roughness * (len(env.reflection) - 1)
            reflection = sample_cube_mips(env.reflection, refl_dir, lod)
            lut_size = env.brdf_lut.shape[0]
            lx = torch.clamp((nov * lut_size).long(), 0, lut_size - 1)
            ly = torch.clamp((surface.roughness * lut_size).long(), 0, lut_size - 1)
            scale_offset = env.brdf_lut[ly, lx]
            diffuse = kd * irradiance * albedo
            specular = (f0 * scale_offset[:, 0:1] + scale_offset[:, 1:2]) * reflection
            ambient = (diffuse + specular) * unpacked.occlusion[:, None]
        else:  # IBL not baked: no ambient term
            ambient = torch.zeros((r, 3), dtype=torch.float32, device=device)

    with trace_scope("vrt.hybrid.sky"):
        shaded = math3d.tone_mapping(ambient + direct_lighting + point_lighting + surface.emission)

        # forward pass: the sky on a miss, and the point lights' spheres
        sky = math3d.tone_mapping(sample_environment(env, d))
        color = torch.where(hit.is_hit[:, None], shaded, sky)
        if scene.has_point_lights:
            pl_t, pl_color = intersect_point_light_spheres(
                scene.point_lights, cfg.point_light_radius, o, d, t_min, t_max)
            gizmo = (pl_t >= 0.0) & (hit.is_miss | (pl_t < hit.t))
            color = torch.where(gizmo[:, None], math3d.tone_mapping(pl_color), color)
        return untile_image(color, w, h, ty, tx)
