"""The frame loop's remaining pieces against the JAX package and against
``render_frame``:

- ``tile_pixel_coords(width, rows, row0)`` equals the JAX package's for
  several widths, row counts and first rows (tile padding included);
- ``render_span(n)`` equals ``n`` calls of ``render_frame`` bit for bit,
  image, frame count and ray count;
- ``render_progressive`` dispatches one span of ``spp`` frames and equals
  ``spp`` frames (a span here is a loop of frames, so the JAX package's
  ``VRT_SPAN`` length would change nothing and has no counterpart);
- ``accel.sah.build_scene_bvh_sah`` equals ``build_scene_bvh(builder=
  "sah")``, and its 2-wide tree and geometry equal the JAX
  ``build_scene_bvh_sah``'s.
"""

import jax
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
from vulkanraytracing_torch.accel.sah import build_scene_bvh_sah
from vulkanraytracing_torch.config import CameraConfig, Config
from vulkanraytracing_torch.pt import render
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.convert import scene_from_numpy
from vulkanraytracing_torch.scene.procedural import cornell_box_scene, sponza_like_scene
from vulkanraytracing_tpu.accel.sah import build_scene_bvh_sah as j_build_sah
from vulkanraytracing_tpu.pt.render import tile_pixel_coords as j_tiles
from vulkanraytracing_tpu.scene.procedural import cornell_box_scene as j_cornell

torch.set_num_threads(1)


@pytest.mark.parametrize("width,rows,row0", [(32, 32, 0), (24, 10, 0), (24, 10, 30),
                                             (40, 17, 5), (1, 1, 7), (100, 36, 64)])
def test_tile_pixel_coords_match_jax(width, rows, row0):
    got = render.tile_pixel_coords(width, rows, row0, device="cpu")
    want = j_tiles(width, rows, row0)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
    assert tuple(got[3:]) == tuple(int(x) for x in want[3:])


def _cornell(size=16):
    cfg = Config(width=size, height=size, max_bounce_count=2, camera=CameraConfig(
        position=(0.0, 0.0, 3.2), aspect_ratio=1.0, x_fov=float(np.radians(60))))
    scene = build_scene_bvh(cornell_box_scene(device="cpu"), builder="sah")
    return scene, cfg, Camera(cfg.camera).to_device("cpu")


def _frames(scene, cfg, camera, n, state=None):
    state = render.create_render_state(cfg, "cpu") if state is None else state
    rays = 0
    for _ in range(n):
        state, stats = render.render_frame(scene, cfg, camera, state)
        rays += int(stats.rays)
    return state, rays


def test_render_span_equals_frames():
    scene, cfg, camera = _cornell()
    start = render.RenderState(
        accumulation=torch.full((cfg.height, cfg.width, 3), 0.25), accum_index=5)
    got, stats = render.render_span(scene, cfg, camera, start, 3)
    want, rays = _frames(scene, cfg, camera, 3, start)
    assert torch.equal(got.accumulation, want.accumulation)
    assert got.accum_index == want.accum_index == 8
    assert stats.rays.dtype == torch.int64 and int(stats.rays) == rays > 0


def test_render_progressive_dispatches_spans(monkeypatch):
    scene, cfg, camera = _cornell()
    spans = []
    span = render.render_span

    def counted(*a):
        spans.append(a[-1])
        return span(*a)

    monkeypatch.setattr(render, "render_span", counted)
    spp = 5
    got, rays = render.render_progressive(scene, cfg, camera, spp=spp)
    assert spans == [spp]
    want, want_rays = _frames(scene, cfg, camera, spp)
    assert torch.equal(got.accumulation, want.accumulation)
    assert got.accum_index == spp and rays == want_rays


@pytest.mark.parametrize("name", ["cornell", "hall"])
def test_build_scene_bvh_sah(name):
    make = {"cornell": cornell_box_scene,
            "hall": lambda device: sponza_like_scene(3000, workload="real", device=device)}[name]
    got = build_scene_bvh_sah(make(device="cpu"))
    want = build_scene_bvh(make(device="cpu"), builder="sah")
    for field in got.geometry._fields:
        assert torch.equal(getattr(got.geometry, field), getattr(want.geometry, field)), field
    for field in ("nodes", "child_index", "tris", "tri_flags", "tri_order", "nodes8",
                  "child8", "tri_perm8"):
        assert torch.equal(getattr(got.bvh, field), getattr(want.bvh, field)), field
    assert (got.alpha is None) == (want.alpha is None) == (name == "cornell")
    if name == "hall":
        assert torch.equal(got.alpha.tri_map, want.alpha.tri_map)


def test_build_scene_bvh_sah_matches_jax():
    js = j_build_sah(j_cornell())
    want = scene_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    got = build_scene_bvh_sah(cornell_box_scene(device="cpu"))
    for field in ("v0", "e1", "e2", "material_id"):
        assert torch.equal(getattr(got.geometry, field), getattr(want.geometry, field)), field
    for field in ("nodes", "child_index", "tris", "tri_flags", "tri_order"):
        assert torch.equal(getattr(got.bvh, field), getattr(want.bvh, field)), field
