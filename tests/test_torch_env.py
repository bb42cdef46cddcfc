"""The port's environment modules against the JAX package's on the CPU:
cube maps, the sun extracted from a panorama, and the IBL bake.

Inputs come from numpy seeds.  Gates: the cube functions and the sun
within 1e-5 (XLA:CPU fuses multiply-adds and has its own transcendental
functions, so elementwise code agrees to an ulp or so, not bit for bit);
the irradiance and reflection cubes within rtol 1e-4 (sums of 8,192
products in another order); the BRDF table within 1e-5 of a float64
evaluation of its estimator, and of the JAX package's table wherever that
table is itself that close (see ``test_brdf_lut_matches_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.core import math3d as tm
from vulkanraytracing_torch.env import ibl as tibl
from vulkanraytracing_torch.env import panorama as tpan
from vulkanraytracing_torch.env.sun import extract_direct_light as t_sun
from vulkanraytracing_torch.scene.types import Environment
from vulkanraytracing_tpu.core import math3d as jm
from vulkanraytracing_tpu.env import ibl as jibl
from vulkanraytracing_tpu.env import panorama as jpan
from vulkanraytracing_tpu.env.sun import extract_direct_light as j_sun
from vulkanraytracing_tpu.scene.types import Environment as JEnvironment

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _panorama(h=32, w=64, seed=3):
    """A random HDR panorama with one bright 8x8 block (the sun)."""
    rng = np.random.default_rng(seed)
    pano = rng.uniform(0.0, 2.0, (h, w, 3)).astype(np.float32)
    pano[8:16, 40:48] += np.float32(50.0)
    return pano


def _directions(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("face", range(6))
def test_cube_direction_and_face_uv_match_jax(face):
    uv = np.random.default_rng(face).uniform(0.0, 1.0, (500, 2)).astype(np.float32)
    d_j = np.asarray(jpan.cube_direction(face, jnp.asarray(uv)))
    d_t = tpan.cube_direction(face, _t(uv)).numpy()
    np.testing.assert_allclose(d_t, d_j, **TOL)
    # the inverse finds the face and the uv back
    f_t, uv_t = tpan.cube_face_uv(_t(d_j))
    f_j, uv_j = jpan.cube_face_uv(jnp.asarray(d_j))
    assert np.array_equal(f_t.numpy(), np.asarray(f_j)) and (f_t.numpy() == face).all()
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), **TOL)
    np.testing.assert_allclose(uv_t.numpy(), uv, atol=1e-5)


def test_cube_sampling_matches_jax():
    rng = np.random.default_rng(7)
    mips = tuple(rng.uniform(0.0, 4.0, (6, s, s, 3)).astype(np.float32) for s in (16, 8, 4))
    d = _directions(3000, 8)
    lod = rng.uniform(-0.5, 3.0, (3000,)).astype(np.float32)
    np.testing.assert_allclose(tpan.sample_cube(_t(mips[0]), _t(d)).numpy(),
                               np.asarray(jpan.sample_cube(jnp.asarray(mips[0]), jnp.asarray(d))),
                               **TOL)
    got = tpan.sample_cube_mips(tuple(_t(m) for m in mips), _t(d), _t(lod)).numpy()
    want = jpan.sample_cube_mips(tuple(jnp.asarray(m) for m in mips), jnp.asarray(d),
                                 jnp.asarray(lod))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_panorama_to_cube_matches_jax():
    pano = _panorama()
    got = tpan.panorama_to_cube(Environment(panorama=_t(pano)), 8).numpy()
    want = np.asarray(jpan.panorama_to_cube(JEnvironment(panorama=jnp.asarray(pano)), 8))
    assert got.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_extract_direct_light_matches_jax(seed):
    """The same block wins, and the direction and colour agree within
    1e-6 relative; the panorama's sun block is the brightest."""
    pano = _panorama(seed=seed)
    got = t_sun(_t(pano))
    want = j_sun(jnp.asarray(pano))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    # the sun lies toward the bright block: luminance clamped to 25
    assert abs(float(tm.luminance(got.color[:3])) - 25.0) < 1e-3


def test_extract_direct_light_first_block_wins_a_tie():
    pano = np.zeros((16, 32, 3), np.float32)
    pano[0:8, 8:16] = 1.0
    pano[8:16, 0:8] = 1.0
    got, want = t_sun(_t(pano)), j_sun(jnp.asarray(pano))
    np.testing.assert_allclose(got.direction.numpy(), np.asarray(want.direction), rtol=1e-6,
                               atol=1e-7)


def test_hammersley_matches_jax():
    i = np.arange(0, 4096, 7, dtype=np.uint32)
    got = tm.hammersley(torch.from_numpy(i.astype(np.int64)), 4096).numpy()
    assert np.array_equal(got, np.asarray(jm.hammersley(jnp.asarray(i), 4096)))
    bits = np.random.default_rng(2).integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    rev = tm.reverse_bits32(torch.from_numpy(bits.astype(np.int64))).numpy()
    assert np.array_equal(rev.astype(np.uint32), np.asarray(jm.reverse_bits32(jnp.asarray(bits))))


def test_tone_curves_and_power_heuristic_match_jax():
    x = np.random.default_rng(5).uniform(0.0, 20.0, 1000).astype(np.float32)
    y = np.random.default_rng(6).uniform(0.01, 5.0, 1000).astype(np.float32)
    np.testing.assert_allclose(tm.uncharted_tone_mapping(_t(x)).numpy(),
                               np.asarray(jm.uncharted_tone_mapping(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tm.power_heuristic(_t(x), _t(y)).numpy(),
                               np.asarray(jm.power_heuristic(jnp.asarray(x), jnp.asarray(y))),
                               **TOL)


def test_irradiance_cube_matches_jax():
    pano = _panorama()
    got = tibl.compute_irradiance_cube(_t(pano), 8).numpy()
    want = np.asarray(jibl.compute_irradiance_cube(jnp.asarray(pano), 8))
    assert got.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_irradiance_rows_in_blocks_are_the_same_rows(monkeypatch):
    """Blocking the output rows changes no row's sums."""
    pano = _t(_panorama())
    whole = tibl.compute_irradiance_cube(pano, 8)
    monkeypatch.setattr(tibl, "BLOCK_ELEMENTS", 100 * 64 * 128)
    assert torch.equal(tibl.compute_irradiance_cube(pano, 8), whole)


def test_reflection_cube_matches_jax():
    pano = _panorama()
    got = tibl.compute_reflection_cube(_t(pano), 16, 3)
    want = jibl.compute_reflection_cube(jnp.asarray(pano), 16, 3)
    assert [tuple(m.shape) for m in got] == [(6, 16, 16, 3), (6, 8, 8, 3), (6, 4, 4, 3)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def _brdf_lut_float64(size, n):
    """The BRDF table's estimator in float64 (the JAX package's formulas)."""
    uv = (np.arange(size) + 0.5) / size
    nov, rough = (g.reshape(-1) for g in np.meshgrid(uv, uv, indexing="xy"))
    i = np.arange(n)
    rev = np.array([int(f"{x:032b}"[::-1], 2) for x in i]) * 2.3283064365386963e-10
    a = rough * rough
    a2 = a * a
    phi = 2 * np.pi * (i / n)
    ct = np.sqrt(np.maximum((1 - rev[:, None]) / (1 + (a2 - 1) * rev[:, None]), 0))
    st = np.sqrt(np.maximum(1 - ct * ct, 0))
    h = np.stack([st * np.cos(phi)[:, None], st * np.sin(phi)[:, None], ct], -1)
    v = np.stack([np.sqrt(1 - nov * nov), 0 * nov, nov], -1)
    voh_raw = (h * v).sum(-1)
    nol = np.maximum((2 * voh_raw[..., None] * h - v)[..., 2], 0)
    noh, voh = np.maximum(h[..., 2], 0), np.maximum(voh_raw, 0)
    k = a * 0.5
    vis = 0.25 / ((nov * (1 - k) + k) * (nol * (1 - k) + k))
    vis_nol_pdf = vis * nol * (4 * voh / np.maximum(noh, 1e-20))
    fc = (1 - voh) ** 5
    terms = [np.where(nol > 0, (1 - fc) * vis_nol_pdf, 0), np.where(nol > 0, fc * vis_nol_pdf, 0)]
    return np.stack([t.mean(0) for t in terms], -1).reshape(size, size, 2)


def test_brdf_lut_matches_jax():
    """Within 1e-5 of the JAX package's table at every entry (the same
    GGX samples, ``pt.bsdf.importance_sample_ggx``), and of a float64
    evaluation of the estimator wherever the JAX table is itself within
    1e-5 of it: at NoV = roughness = 1/32 (a2 ~ 1e-6) the float32
    1 + (a2 - 1) e1 cancels and leaves both tables 2.3e-5 off."""
    got = tibl.compute_brdf_lut(16, 512, device="cpu").numpy()
    want = np.asarray(jibl.compute_brdf_lut(16, 512))
    exact = _brdf_lut_float64(16, 512)
    assert got.shape == (16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jax_ok = np.abs(want - exact) <= 1e-5 + 1e-5 * np.abs(exact)
    assert jax_ok.sum() == 511 and not jax_ok[0, 0, 1]
    np.testing.assert_allclose(got[jax_ok], exact[jax_ok], rtol=1e-5, atol=1e-5)


def test_brdf_lut_sample_blocks_keep_the_sums(monkeypatch):
    """Blocks of any size add the samples in the same order."""
    whole = tibl.compute_brdf_lut(8, 96, device="cpu")
    monkeypatch.setattr(tibl, "LUT_BLOCK_ELEMENTS", 2 * 64 * 5)
    assert torch.equal(tibl.compute_brdf_lut(8, 96, device="cpu"), whole)


def test_bake_ibl_fills_the_environment():
    env = tibl.bake_ibl(Environment(panorama=_t(_panorama())), irradiance_size=4,
                        reflection_size=8, brdf_size=8)
    assert env.irradiance.shape == (6, 4, 4, 3) and env.brdf_lut.shape == (8, 8, 2)
    assert [m.shape[1] for m in env.reflection] == [8, 4, 2, 1]
    moved = env.to("cpu")
    assert all(a is not None for a in moved) and len(moved.reflection) == 4
