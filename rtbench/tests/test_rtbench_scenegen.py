"""The frozen scene generator against the program's, and the files it
writes against the program's loader (CPU, a small triangle count)."""

import hashlib

import numpy as np
import pytest
import torch

from rtbench import scenegen

TRIS = 4000


@pytest.mark.parametrize("kind", ["v1", "real"])
def test_generator_equals_program_at_default_seed(kind):
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene, sponza_real_images

    ours = scenegen.sponza(kind, TRIS, 7)
    theirs = sponza_like_scene(TRIS, seed=7, workload=kind, device="cpu")
    g = theirs.geometry
    assert ours.count == g.num_triangles
    for mine, field in ((ours.v0, g.v0), (ours.e1, g.e1), (ours.e2, g.e2),
                        (ours.normal, g.n0), (ours.normal, g.n2),
                        (ours.uv[0], g.uv0), (ours.uv[1], g.uv1), (ours.uv[2], g.uv2)):
        assert np.array_equal(mine, field.numpy())
    assert np.array_equal(ours.material, g.material_id.numpy())
    assert np.array_equal(ours.double_sided, g.cull_disable.numpy())
    assert np.array_equal(ours.cutout, g.alpha_test.numpy())
    m = theirs.materials
    assert np.array_equal(np.asarray(ours.materials["base_color"], np.float32),
                          m.base_color_factor.numpy())
    assert np.array_equal(np.asarray(ours.materials["roughness"], np.float32),
                          m.roughness_factor.numpy())
    assert np.array_equal(np.asarray(ours.materials["metallic"], np.float32),
                          m.metallic_factor.numpy())
    assert list(ours.materials["base_color_texture"]) == m.base_color_texture.tolist()
    assert np.array_equal(ours.sky, theirs.environment.panorama.numpy())
    if kind == "real":
        for a, b in zip(ours.images, sponza_real_images(7)):
            assert np.array_equal(a, b)
        assert int(ours.cutout.sum()) > 0


def test_glb_loads_as_the_program_exports(tmp_path):
    """The frozen writer's .glb, read by the program's loader, is the
    program's own export of the same scene read back."""
    from vulkanraytracing_torch.scene.gltf import load_scene
    from vulkanraytracing_torch.scene.gltf_export import export_scene_glb
    from vulkanraytracing_torch.scene.procedural import sponza_like_scene, sponza_real_images

    glb, hdr = scenegen.scene_files(tmp_path / "cache", "real", TRIS, 7)
    export_scene_glb(sponza_like_scene(TRIS, seed=7, workload="real", device="cpu"),
                     tmp_path / "theirs.glb", images=sponza_real_images(7))
    a, _, pool_a = load_scene(glb, device="cpu")
    b, _, pool_b = load_scene(tmp_path / "theirs.glb", device="cpu")
    for x, y in zip(a.geometry, b.geometry):
        assert torch.equal(x, y)
    for x, y in zip(a.materials, b.materials):
        assert torch.equal(x, y)
    for x, y in zip(pool_a, pool_b):
        assert torch.equal(x, y)
    for x, y in zip(a.point_lights, b.point_lights):
        assert torch.equal(x, y)
    from vulkanraytracing_torch.app.hdr import read_hdr, write_hdr

    write_hdr(tmp_path / "theirs.hdr", scenegen.sky_panorama(512, seed=207))
    assert np.array_equal(read_hdr(hdr), read_hdr(tmp_path / "theirs.hdr"))


def test_scene_files_are_written_once(tmp_path):
    glb, hdr = scenegen.scene_files(tmp_path, "v1", 2000, 3)
    stamp = glb.stat().st_mtime_ns
    assert scenegen.scene_files(tmp_path, "v1", 2000, 3) == (glb, hdr)
    assert glb.stat().st_mtime_ns == stamp
    assert not list(tmp_path.rglob("*.tmp"))


# sha256 of (scene.glb, sky.hdr) at 4,000 triangles asked, seed 2147483659,
# as the generator wrote them before moving scenes came in: a static
# configuration's files stay byte for byte what they were.  The textured
# scene's PNGs are zlib's level 6; another zlib may pack them otherwise.
DIGESTS = {
    "v1": ("7d4712ba0198c6da3341928054a90a887c4f8872a03457411355b77aea127e02",
           "190882e6fb0236b78f924f43575c9619df7ce94e8eb492db68b05c6c915d60ae"),
    "real": ("bb392935963ef36b4d020ecd189c61bfe03440799b53ef92de9fcbf7d5be6229",
             "c0f73a12c28674fd12f7a8bbb84f1addc63c1b2889e8d80f55b241e75a5110fb"),
}


@pytest.mark.parametrize("kind", ["v1", "real"])
def test_static_scene_files_are_unchanged(kind, tmp_path):
    files = scenegen.scene_files(tmp_path, kind, TRIS, 2147483659)
    assert tuple(hashlib.sha256(f.read_bytes()).hexdigest() for f in files) == DIGESTS[kind]
