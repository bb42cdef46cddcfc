"""Procedural test and benchmark scenes.

Counterpart of ``vulkanraytracing_tpu/scene/procedural.py``.  Every scene
is assembled on the host with numpy's ``default_rng(seed)`` in the same
call order as the JAX package, so the arrays match it bit for bit, and is
then moved to ``device`` once (``animated_instances_demo`` also returns
an instance soup and its animation).  ``device`` defaults to the card, as
every entry point of the port does: a CPU scene is asked for with
``device="cpu"``.  Only the factor-only workloads are ported:
``sponza_like_scene(workload="real")`` needs textures and alpha-tested
foliage, which the port does not have yet.
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


def sponza_like_scene(target_triangles: int = 262144, seed: int = 7,
                      workload: str = "v1", device="cuda") -> Scene:
    """Sponza-scale colonnaded hall (the bench's v1 workload): floor, walls
    and ceiling, two rows of column spheroids, and clutter spheres up to
    the triangle budget; factor-only materials, a sun and 4 point lights."""
    if workload != "v1":
        raise NotImplementedError(
            f"workload={workload!r}: textures and alpha-tested foliage are "
            "not ported yet"
        )
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
