"""Procedural test and benchmark scenes.

Counterpart of ``vulkanraytracing_tpu/scene/procedural.py``.  Every scene
is assembled on the host with numpy's ``default_rng(seed)`` in the same
call order as the JAX package, so the arrays match it bit for bit, and is
then moved to ``device`` once (``animated_instances_demo`` also returns
an instance soup and its animation).  ``device`` defaults to the card, as
every entry point of the port does: a CPU scene is asked for with
``device="cpu"``.  The texture and sky generators are numpy on the host,
the port's own copies of the JAX package's: the same seed gives bit-equal
geometry, textures and panorama.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkanraytracing_torch.scene.types import (
    DirectLight,
    PointLights,
    Scene,
    TraceGeometry,
    black_environment,
    concat_geometry,
    constant_environment,
    make_environment,
    make_materials,
    make_trace_geometry,
    no_direct_light,
)


def generate_sphere(radius: float = 1.0, lat: int = 16, lon: int = 32):
    """UV sphere (positions, indices), front faces out."""
    phis = np.linspace(0.0, np.pi, lat + 1)
    thetas = np.linspace(0.0, 2.0 * np.pi, lon, endpoint=False)
    verts = []
    for phi in phis:
        for theta in thetas:
            verts.append(
                [
                    radius * np.sin(phi) * np.cos(theta),
                    radius * np.cos(phi),
                    radius * np.sin(phi) * np.sin(theta),
                ]
            )
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            idx.append([a, b, c])
            idx.append([b, d, c])
    return verts, np.asarray(idx, np.int32)


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for the quad p0-p1-p2-p3."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def _f32(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=device)


def single_triangle_scene(env_color=(0.1, 0.1, 0.1), device="cuda") -> Scene:
    """One emissive triangle facing the default camera, under a constant
    environment: the smallest end-to-end scene."""
    positions = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    return Scene(
        geometry=make_trace_geometry(positions, np.array([[0, 1, 2]], np.int32), device=device),
        materials=make_materials(
            base_color_factors=[(0.8, 0.2, 0.2, 1.0)],
            emission_factors=[(0.5, 0.1, 0.1, 1.0)],
            roughness_factors=[0.8],
            metallic_factors=[0.0],
            device=device,
        ),
        environment=constant_environment(env_color, device=device),
        direct_light=no_direct_light(device),
        point_lights=None,
        bvh=None,
    )


def cornell_box_scene(
    light_intensity: float = 20.0, with_point_lights: bool = True, device="cuda"
) -> Scene:
    """Cornell box sized [-1, 1]^3, open on +Z: white walls, red left, green
    right, an emissive ceiling panel, a metal and a blue diffuse sphere."""
    parts: list[tuple[np.ndarray, np.ndarray, int]] = []
    v, i = _quad([-1, -1, -1], [-1, -1, 1], [1, -1, 1], [1, -1, -1])
    parts.append((v, i, 0))  # floor
    v, i = _quad([-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1])
    parts.append((v, i, 0))  # ceiling
    v, i = _quad([-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1])
    parts.append((v, i, 0))  # back wall
    v, i = _quad([-1, -1, -1], [-1, 1, -1], [-1, 1, 1], [-1, -1, 1])
    parts.append((v, i, 1))  # left wall, red
    v, i = _quad([1, -1, -1], [1, -1, 1], [1, 1, 1], [1, 1, -1])
    parts.append((v, i, 2))  # right wall, green
    v, i = _quad(
        [-0.4, 0.98, -0.4], [0.4, 0.98, -0.4], [0.4, 0.98, 0.4], [-0.4, 0.98, 0.4]
    )
    parts.append((v, i, 3))  # emissive panel
    sv, si = generate_sphere(0.35, lat=12, lon=24)
    parts.append((sv + np.array([0.35, -0.65, -0.3], np.float32), si, 4))
    sv, si = generate_sphere(0.3, lat=12, lon=24)
    parts.append((sv + np.array([-0.45, -0.7, 0.2], np.float32), si, 5))

    geometry = concat_geometry([
        make_trace_geometry(v, i, material_id=m, cull_disable=True, device="cpu")
        for v, i, m in parts
    ]).to(device)
    li = light_intensity
    materials = make_materials(
        base_color_factors=[
            (0.73, 0.73, 0.73, 1.0),
            (0.65, 0.05, 0.05, 1.0),
            (0.12, 0.45, 0.15, 1.0),
            (1.0, 1.0, 1.0, 1.0),
            (0.9, 0.8, 0.6, 1.0),
            (0.2, 0.3, 0.8, 1.0),
        ],
        emission_factors=[
            (0, 0, 0, 1), (0, 0, 0, 1), (0, 0, 0, 1),
            (li, li, li, 1), (0, 0, 0, 1), (0, 0, 0, 1),
        ],
        roughness_factors=[1.0, 1.0, 1.0, 1.0, 0.25, 0.8],
        metallic_factors=[0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
        device=device,
    )
    point_lights = None
    if with_point_lights:
        point_lights = PointLights(
            position=_f32([[0.0, 0.6, 0.6, 1.0], [-0.6, -0.2, 0.6, 1.0]], device),
            color=_f32([[4.0, 3.5, 3.0, 1.0], [1.0, 1.5, 3.0, 1.0]], device),
        )
    return Scene(
        geometry=geometry,
        materials=materials,
        environment=black_environment(device=device),
        direct_light=no_direct_light(device),
        point_lights=point_lights,
        bvh=None,
    )


def triangle_soup_scene(
    num_triangles: int, seed: int = 0, extent: float = 10.0,
    tri_size: float = 0.25, device="cuda",
) -> Scene:
    """Random triangle soup — BVH stress geometry."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (num_triangles, 3)).astype(np.float32)
    offsets = rng.normal(0.0, tri_size, (num_triangles, 3, 3)).astype(np.float32)
    positions = (centers[:, None, :] + offsets).reshape(-1, 3)
    indices = np.arange(num_triangles * 3, dtype=np.int32).reshape(-1, 3)
    return Scene(
        geometry=make_trace_geometry(positions, indices, cull_disable=True,
                                     device=device),
        materials=make_materials(
            base_color_factors=[(0.7, 0.7, 0.7, 1.0)], roughness_factors=[0.9],
            metallic_factors=[0.0], device=device,
        ),
        environment=constant_environment((1.0, 1.0, 1.0), device=device),
        direct_light=no_direct_light(device),
        point_lights=None,
        bvh=None,
    )


def _value_noise(size: int, rng, octaves: int = 5) -> np.ndarray:
    """Tileable multi-octave value noise in [0, 1] (float32, size x size)."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = 4 << o
        if cells > size:
            break
        grid = rng.random((cells, cells)).astype(np.float32)
        # bilinear upsample with wrap (tileable)
        gx = np.linspace(0, cells, size, endpoint=False)
        x0 = np.floor(gx).astype(int) % cells
        x1 = (x0 + 1) % cells
        fx = (gx - np.floor(gx)).astype(np.float32)
        fx = fx * fx * (3 - 2 * fx)  # smoothstep
        row = grid[:, x0] * (1 - fx) + grid[:, x1] * fx      # (cells, size)
        col = row[x0, :] * (1 - fx[:, None]) + row[x1, :] * fx[:, None]
        out += amp * col
        total += amp
        amp *= 0.5
    return out / total


def _stone_texture(size: int, rng, base, veins) -> np.ndarray:
    """Marble-like RGBA8: low-frequency value noise and vein modulation."""
    n = _value_noise(size, rng)
    v = _value_noise(size, rng, octaves=7)
    vein = 0.5 + 0.5 * np.sin(8.0 * np.pi * (v + 0.35 * n))
    base = np.asarray(base, np.float32)
    veins = np.asarray(veins, np.float32)
    rgb = base[None, None] * (0.75 + 0.5 * n[..., None]) \
        + veins[None, None] * (0.25 * vein[..., None])
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = 255
    return img


def _checker_texture(size: int, rng, a, b, cells: int = 16) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size + yy * cells // size) % 2).astype(bool)
    n = _value_noise(size, rng)
    img = np.zeros((size, size, 4), np.uint8)
    rgb = np.where(mask[..., None], np.asarray(a, np.float32),
                   np.asarray(b, np.float32)) * (0.8 + 0.4 * n[..., None])
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = 255
    return img


def _foliage_texture(size: int, rng) -> np.ndarray:
    """Alpha-cutout leaf cluster: green leaf blobs on a transparent
    background, so hits on it must run the alpha test."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alpha = np.zeros((size, size), np.float32)
    rgb = np.zeros((size, size, 3), np.float32)
    for _ in range(60):
        cx, cy = rng.random(2)
        rx = rng.uniform(0.02, 0.09)
        ry = rx * rng.uniform(0.4, 0.9)
        ang = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        d = (u / rx) ** 2 + (v / ry) ** 2
        leaf = d < 1.0
        alpha[leaf] = 1.0
        shade = rng.uniform(0.5, 1.0)
        col = np.array([0.12 * shade, 0.45 * shade, 0.10 * shade], np.float32)
        rgb[leaf] = col
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)
    img[..., 3] = (alpha * 255 + 0.5).astype(np.uint8)
    return img


def procedural_sky_panorama(height: int = 512, seed: int = 11,
                            sun_dir=(0.3, -1.0, 0.2)) -> np.ndarray:
    """HDR equirectangular sky (height x 2*height x 3, float32 radiance):
    a horizon gradient, a sun disc along the scene's sun and low-frequency
    clouds."""
    rng = np.random.default_rng(seed)
    h, w = height, height * 2
    phi = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi       # 0..pi
    theta = (np.arange(w, dtype=np.float32) + 0.5) / w * 2 * np.pi
    # direction per texel (y up; the env.panorama mapping)
    sp = np.sin(phi)[:, None]
    dirs = np.stack(
        [sp * np.cos(theta)[None, :],
         np.broadcast_to(np.cos(phi)[:, None], (h, w)),
         sp * np.sin(theta)[None, :]], axis=-1)
    up = dirs[..., 1]
    horizon = np.clip(1.0 - np.abs(up), 0.0, 1.0) ** 3
    sky = (np.array([0.25, 0.45, 0.9], np.float32)[None, None]
           * (0.6 + 0.8 * np.clip(up, 0, 1))[..., None]
           + np.array([0.9, 0.7, 0.5], np.float32)[None, None]
           * horizon[..., None] * 0.8)
    ground = np.array([0.18, 0.14, 0.10], np.float32)[None, None] \
        * (0.4 + 0.3 * np.clip(-up, 0, 1))[..., None]
    img = np.where(up[..., None] >= 0, sky, ground).astype(np.float32)
    # clouds: low-frequency noise in the upper hemisphere
    clouds = _value_noise(h, rng, octaves=4)
    clouds = np.concatenate([clouds, clouds], axis=1)[:, :w]
    img += (np.clip(clouds - 0.55, 0, 1) * 4.0 * np.clip(up, 0, 1))[..., None] \
        * np.array([1.0, 1.0, 1.0], np.float32)
    # the sun disc toward -sun_dir (the light travels along sun_dir)
    s = -np.asarray(sun_dir, np.float32)
    s /= np.linalg.norm(s)
    cosang = np.clip(np.einsum("hwc,c->hw", dirs, s), -1, 1)
    img += (np.exp((cosang - 1.0) * 4000.0) * 800.0)[..., None] \
        * np.array([1.0, 0.95, 0.85], np.float32)
    img += (np.exp((cosang - 1.0) * 40.0) * 1.5)[..., None] \
        * np.array([1.0, 0.9, 0.7], np.float32)  # halo
    return img.astype(np.float32)


def _sphere_uvs(verts: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Spherical uv per vertex from its direction relative to ``center``."""
    d = verts - center[None, :]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    u = (np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5).astype(np.float32)
    v = (np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi).astype(np.float32)
    return np.stack([u, v], axis=-1)


def sponza_like_scene(target_triangles: int = 262144, seed: int = 7,
                      workload: str = "v1", device="cuda") -> Scene:
    """Sponza-scale colonnaded hall (the bench's workloads): floor, walls
    and ceiling, two rows of column spheroids, and clutter spheres up to
    the triangle budget, with a sun and 4 point lights.

    ``workload="v1"`` has factor-only materials and a constant sky.
    ``workload="real"`` adds the per-hit costs of the reference's default
    workload (Modern Sponza with the SunnyHills panorama): mipped ~1k^2
    textures on the major materials, alpha-tested foliage and an HDR sky
    panorama (``_sponza_real_scene``)."""
    if workload == "real":
        return _sponza_real_scene(target_triangles, seed, device)
    if workload != "v1":
        raise ValueError(f"workload must be 'v1' or 'real', got {workload!r}")
    rng = np.random.default_rng(seed)
    parts: list[TraceGeometry] = []
    hall = (20.0, 8.0, 10.0)

    def add_quad(p0, p1, p2, p3, mat):
        v, i = _quad(p0, p1, p2, p3)
        parts.append(make_trace_geometry(v, i, material_id=mat, cull_disable=True,
                                         device="cpu"))

    add_quad([-hall[0], 0, -hall[2]], [-hall[0], 0, hall[2]],
             [hall[0], 0, hall[2]], [hall[0], 0, -hall[2]], 0)      # floor
    add_quad([-hall[0], hall[1], -hall[2]], [hall[0], hall[1], -hall[2]],
             [hall[0], hall[1], hall[2]], [-hall[0], hall[1], hall[2]], 0)
    add_quad([-hall[0], 0, -hall[2]], [hall[0], 0, -hall[2]],
             [hall[0], hall[1], -hall[2]], [-hall[0], hall[1], -hall[2]], 1)
    add_quad([-hall[0], 0, hall[2]], [-hall[0], hall[1], hall[2]],
             [hall[0], hall[1], hall[2]], [hall[0], 0, hall[2]], 1)
    add_quad([-hall[0], 0, -hall[2]], [-hall[0], hall[1], -hall[2]],
             [-hall[0], hall[1], hall[2]], [-hall[0], 0, hall[2]], 1)
    add_quad([hall[0], 0, -hall[2]], [hall[0], 0, hall[2]],
             [hall[0], hall[1], hall[2]], [hall[0], hall[1], -hall[2]], 1)

    lat, lon = 24, 48
    n_cols = 16
    for k in range(n_cols):
        x = -hall[0] + (k % (n_cols // 2) + 0.5) * (2 * hall[0] / (n_cols // 2))
        z = -hall[2] * 0.5 if k < n_cols // 2 else hall[2] * 0.5
        sv, si = generate_sphere(0.8, lat=lat, lon=lon)
        sv = sv * np.array([1.0, 5.0, 1.0], np.float32)
        sv = sv + np.array([x, 4.0, z], np.float32)
        parts.append(make_trace_geometry(sv, si, material_id=2, device="cpu"))

    used = sum(g.num_triangles for g in parts)
    remaining = max(target_triangles - used, 0)
    clutter_lat, clutter_lon = 8, 16
    n_clutter = remaining // (2 * clutter_lat * clutter_lon)
    for _ in range(n_clutter):
        sv, si = generate_sphere(float(rng.uniform(0.1, 0.5)),
                                 lat=clutter_lat, lon=clutter_lon)
        pos = np.array(
            [rng.uniform(-hall[0], hall[0]), rng.uniform(0.2, hall[1] - 0.5),
             rng.uniform(-hall[2], hall[2])], np.float32,
        )
        parts.append(make_trace_geometry(sv + pos, si, material_id=int(rng.integers(0, 5)),
                                         device="cpu"))

    materials = make_materials(
        base_color_factors=[
            (0.65, 0.62, 0.58, 1.0),  # stone floor/ceiling
            (0.55, 0.5, 0.45, 1.0),   # walls
            (0.7, 0.68, 0.6, 1.0),    # columns
            (0.6, 0.3, 0.2, 1.0),     # clutter a
            (0.3, 0.4, 0.6, 1.0),     # clutter b
        ],
        roughness_factors=[0.9, 0.85, 0.7, 0.5, 0.3],
        metallic_factors=[0.0, 0.0, 0.0, 0.0, 0.8],
        device=device,
    )
    return Scene(
        geometry=concat_geometry(parts).to(device),
        materials=materials,
        environment=constant_environment((2.0, 2.2, 2.5), size=16, device=device),
        direct_light=DirectLight(
            direction=_f32([0.3, -1.0, 0.2, 0.0], device),
            color=_f32([8.0, 7.5, 7.0, 1.0], device),
        ),
        point_lights=PointLights(
            position=_f32([[-8.0, 2.0, 0.0, 1.0], [8.0, 2.0, 0.0, 1.0],
                           [0.0, 3.0, -4.0, 1.0], [0.0, 3.0, 4.0, 1.0]], device),
            color=_f32([[30.0, 25.0, 20.0, 1.0], [20.0, 25.0, 30.0, 1.0],
                        [25.0, 25.0, 25.0, 1.0], [28.0, 22.0, 18.0, 1.0]], device),
        ),
        bvh=None,
    )


def sponza_real_images(seed: int = 7) -> list:
    """The real workload's texture images in pool order (deterministic
    per seed)."""
    tex_rng = np.random.default_rng(seed + 100)
    return [
        _checker_texture(1024, tex_rng, (0.75, 0.72, 0.66), (0.45, 0.42, 0.4),
                         cells=24),                                    # 0 floor
        _stone_texture(1024, tex_rng, (0.55, 0.5, 0.44), (0.3, 0.26, 0.22)),  # 1 walls
        _stone_texture(1024, tex_rng, (0.72, 0.7, 0.62), (0.5, 0.46, 0.4)),   # 2 columns
        _foliage_texture(512, tex_rng),                                # 3 foliage
    ]


def _sponza_real_scene(target_triangles: int, seed: int, device) -> Scene:
    """The real workload of ``sponza_like_scene``: every closest hit of
    the shell and the columns samples a mipped texture, about 4% of the
    triangle budget is alpha-tested foliage (bushes of crossed quads on a
    jittered grid along the walls, so their boxes stay apart), and misses
    sample a 512x1024 HDR panorama."""
    from vulkanraytracing_torch.ops.texture import build_texture_pool

    rng = np.random.default_rng(seed)
    hall = (20.0, 8.0, 10.0)
    images = sponza_real_images(seed)

    parts: list[TraceGeometry] = []

    def add_quad(p0, p1, p2, p3, mat, uv_scale=(1.0, 1.0), **flags):
        v, i = _quad(p0, p1, p2, p3)
        su, sv = uv_scale
        uvs = np.array([[0, 0], [su, 0], [su, sv], [0, sv]], np.float32)
        parts.append(make_trace_geometry(
            v, i, uvs=uvs, material_id=mat, cull_disable=True, device="cpu", **flags
        ))

    # shell (floor and ceiling tiled 8x4, walls 8x2 and 4x2)
    add_quad([-hall[0], 0, -hall[2]], [-hall[0], 0, hall[2]],
             [hall[0], 0, hall[2]], [hall[0], 0, -hall[2]], 0, (8, 4))
    add_quad([-hall[0], hall[1], -hall[2]], [hall[0], hall[1], -hall[2]],
             [hall[0], hall[1], hall[2]], [-hall[0], hall[1], hall[2]], 0, (8, 4))
    add_quad([-hall[0], 0, -hall[2]], [hall[0], 0, -hall[2]],
             [hall[0], hall[1], -hall[2]], [-hall[0], hall[1], -hall[2]], 1, (8, 2))
    add_quad([-hall[0], 0, hall[2]], [-hall[0], hall[1], hall[2]],
             [hall[0], hall[1], hall[2]], [hall[0], 0, hall[2]], 1, (8, 2))
    add_quad([-hall[0], 0, -hall[2]], [-hall[0], hall[1], -hall[2]],
             [-hall[0], hall[1], hall[2]], [-hall[0], 0, hall[2]], 1, (4, 2))
    add_quad([hall[0], 0, -hall[2]], [hall[0], 0, hall[2]],
             [hall[0], hall[1], hall[2]], [hall[0], hall[1], -hall[2]], 1, (4, 2))

    # columns (textured marble)
    lat, lon = 24, 48
    n_cols = 16
    for k in range(n_cols):
        x = -hall[0] + (k % (n_cols // 2) + 0.5) * (2 * hall[0] / (n_cols // 2))
        z = -hall[2] * 0.5 if k < n_cols // 2 else hall[2] * 0.5
        sv, si = generate_sphere(0.8, lat=lat, lon=lon)
        sv = sv * np.array([1.0, 5.0, 1.0], np.float32)
        center = np.array([x, 4.0, z], np.float32)
        sv = sv + center
        parts.append(make_trace_geometry(
            sv, si, uvs=_sphere_uvs(sv, center) * np.array([4.0, 4.0], np.float32),
            material_id=2, device="cpu",
        ))

    # foliage: bushes of crossed cutout quads, each inside a ~0.5 m radius,
    # on a jittered grid along the walls
    fol_budget = target_triangles // 25
    quads_per_bush = 10
    n_bush = max(fol_budget // (quads_per_bush * 2), 1)
    uvs_leaf = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    slots = []
    spacing = 1.6
    for side in (-1.0, 1.0):
        x = -hall[0] + 1.0
        while x < hall[0] - 1.0:
            slots.append((x, side * (hall[2] - 1.1)))
            x += spacing
    rng.shuffle(slots)
    for b in range(n_bush):
        bx, bz = slots[b % len(slots)]
        bx += rng.uniform(-0.3, 0.3)
        bz += rng.uniform(-0.2, 0.2)
        by = rng.uniform(0.5, 0.9)
        for _ in range(quads_per_bush):
            s = rng.uniform(0.25, 0.5)
            ang = rng.uniform(0, np.pi)
            tilt = rng.uniform(-0.3, 0.3)
            ox = rng.uniform(-0.35, 0.35)
            oy = rng.uniform(-0.3, 0.5)
            oz = rng.uniform(-0.35, 0.35)
            ca, sa = np.cos(ang) * s, np.sin(ang) * s
            cx, cy, cz = bx + ox, by + oy, bz + oz
            v, i = _quad(
                [cx - ca, cy - s + tilt, cz - sa],
                [cx + ca, cy - s - tilt, cz + sa],
                [cx + ca, cy + s - tilt, cz + sa],
                [cx - ca, cy + s + tilt, cz - sa],
            )
            parts.append(make_trace_geometry(
                v, i, uvs=uvs_leaf, material_id=5, cull_disable=True,
                opaque=False, alpha_test=True, device="cpu",
            ))

    used = sum(g.num_triangles for g in parts)
    remaining = max(target_triangles - used, 0)
    clutter_lat, clutter_lon = 8, 16
    n_clutter = remaining // (2 * clutter_lat * clutter_lon)
    for _ in range(n_clutter):
        r = float(rng.uniform(0.1, 0.5))
        sv, si = generate_sphere(r, lat=clutter_lat, lon=clutter_lon)
        pos = np.array(
            [rng.uniform(-hall[0], hall[0]), rng.uniform(0.2, hall[1] - 0.5),
             rng.uniform(-hall[2], hall[2])], np.float32,
        )
        mat = int(rng.integers(0, 5))
        parts.append(make_trace_geometry(
            sv + pos, si, uvs=_sphere_uvs(sv + pos, pos), material_id=mat, device="cpu",
        ))

    materials = make_materials(
        base_color_factors=[
            (1.0, 1.0, 1.0, 1.0),     # 0 floor and ceiling (the texture's color)
            (1.0, 1.0, 1.0, 1.0),     # 1 walls
            (1.0, 1.0, 1.0, 1.0),     # 2 columns
            (0.6, 0.3, 0.2, 1.0),     # 3 clutter a (factor-only)
            (0.3, 0.4, 0.6, 1.0),     # 4 clutter b (metallic)
            (1.0, 1.0, 1.0, 1.0),     # 5 foliage (cutout)
        ],
        roughness_factors=[0.9, 0.85, 0.7, 0.5, 0.3, 0.8],
        metallic_factors=[0.0, 0.0, 0.0, 0.0, 0.8, 0.0],
        alpha_cutoffs=[0.5] * 6,
        base_color_textures=[0, 1, 2, -1, -1, 3],
        device=device,
    )
    sun_dir = (0.3, -1.0, 0.2)
    pano = procedural_sky_panorama(512, seed=seed + 200, sun_dir=sun_dir)
    return Scene(
        geometry=concat_geometry(parts).to(device),
        materials=materials,
        environment=make_environment(torch.from_numpy(pano).to(device)),
        direct_light=DirectLight(
            direction=_f32([*sun_dir, 0.0], device),
            color=_f32([8.0, 7.5, 7.0, 1.0], device),
        ),
        point_lights=PointLights(
            position=_f32([[-8.0, 2.0, 0.0, 1.0], [8.0, 2.0, 0.0, 1.0],
                           [0.0, 3.0, -4.0, 1.0], [0.0, 3.0, 4.0, 1.0]], device),
            color=_f32([[30.0, 25.0, 20.0, 1.0], [20.0, 25.0, 30.0, 1.0],
                        [25.0, 25.0, 25.0, 1.0], [28.0, 22.0, 18.0, 1.0]], device),
        ),
        bvh=None,
        textures=build_texture_pool(images, device=device),
    )


def animated_instances_demo(orbiters: int = 4, device="cuda"):
    """Two-level animated scene: a static ground quad BLAS and one sphere
    BLAS instanced ``orbiters`` times, which the animation callback orbits
    around the y axis.  Returns (scene_template, soup, animation) for
    ``app.engine.Engine``; ``animation(frame)`` is an (I, 4, 4) float32
    numpy array of world transforms, instance 0 the ground."""
    import math

    from vulkanraytracing_torch.accel.tlas import make_instances

    gv, gi = _quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6])
    ground = make_trace_geometry(gv, gi, material_id=0, device=device)
    sv, si = generate_sphere(radius=0.6)
    sphere = make_trace_geometry(sv, si, material_id=1, device=device)

    soup = make_instances(
        blases=[ground, sphere],
        blas_ids=[0] + [1] * orbiters,
        material_offsets=[0] + [i % 2 for i in range(orbiters)],
    )

    materials = make_materials(
        base_color_factors=[
            (0.7, 0.7, 0.7, 1.0),   # ground
            (0.8, 0.3, 0.2, 1.0),   # orbiter A
            (0.2, 0.4, 0.8, 1.0),   # orbiter B
        ],
        roughness_factors=[0.9, 0.4, 0.2],
        metallic_factors=[0.0, 0.1, 0.8],
        device=device,
    )

    def animation(frame_index: int) -> np.ndarray:
        t = frame_index * (2.0 * math.pi / 96.0)
        mats = [np.eye(4, dtype=np.float32)]  # ground static
        for i in range(orbiters):
            phase = t + i * (2.0 * math.pi / orbiters)
            m = np.eye(4, dtype=np.float32)
            m[0, 3] = 3.0 * math.cos(phase)
            m[1, 3] = 1.2 + 0.4 * math.sin(2.0 * phase)
            m[2, 3] = 3.0 * math.sin(phase)
            mats.append(m)
        return np.stack(mats, axis=0)

    scene = Scene(
        geometry=ground,  # placeholder; the Engine replaces it via build_tlas
        materials=materials,
        environment=constant_environment((0.6, 0.7, 0.9), device=device),
        direct_light=no_direct_light(device),
        point_lights=None,
        bvh=None,
    )
    return scene, soup, animation
