"""The port's RNG, shading math and BSDF against the JAX package.

The same seeded numpy inputs go through ``vulkanraytracing_tpu`` (jnp on
the CPU) and ``vulkanraytracing_torch``.  Tolerances:

- RNG streams are integer arithmetic: bit-equal.
- Shading math and the BSDF: rtol 1e-6 plus atol 1e-6.  The JAX package
  reduces dot products with ``jnp.sum`` and matrix products with
  ``einsum``, whose summation order XLA chooses, and XLA:CPU has its own
  sin, cos and pow; the port writes sums left to right and uses
  PyTorch's functions, so the last bit may differ (about 1e-7 relative),
  and a cancelling difference near zero may differ absolutely.  Inputs
  are kept well conditioned, as the renderer's are: tangents orthogonal
  to their normals, and roughness >= 0.3 where a GGX sample is drawn (a
  near-mirror lobe turns a one-ulp difference in cos(phi) into a 1e-4
  relative difference in the sampled BSDF value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.core import math3d as tm
from vulkanraytracing_torch.core import rng as trng
from vulkanraytracing_torch.pt import bsdf as tbsdf
from vulkanraytracing_tpu.core import math3d as jm
from vulkanraytracing_tpu.core import rng as jrng
from vulkanraytracing_tpu.pt import bsdf as jbsdf

torch.set_num_threads(1)

RTOL = 1e-6
ATOL = 1e-6


def _u32(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.uint32
                            else np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_wang_hash_bit_equal():
    xs = np.concatenate([
        np.array([0, 1, 2, 61, 12345, 0xDEADBEEF, 0xFFFFFFFF], np.uint32), _u32(0, 500)
    ])
    want = np.asarray(jrng.wang_hash(jnp.asarray(xs)))
    got = trng.wang_hash(_t(xs)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_xoroshiro_stream_bit_equal():
    s0, s1 = _u32(1, 64), _u32(2, 64)
    j0, j1 = jnp.asarray(s0), jnp.asarray(s1)
    t0, t1 = _t(s0), _t(s1)
    for _ in range(16):
        jb, j0, j1 = jrng.rand_uint(j0, j1)
        tb, t0, t1 = trng.rand_uint(t0, t1)
        for a, b in ((tb, jb), (t0, j0), (t1, j1)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("draw", ["next_float", "next_vec2", "next_vec3"])
def test_uniform_draws_bit_equal(draw):
    s0, s1 = _u32(3, 256), _u32(4, 256)
    j0, j1 = jnp.asarray(s0), jnp.asarray(s1)
    t0, t1 = _t(s0), _t(s1)
    for _ in range(4):
        jf, j0, j1 = getattr(jrng, draw)(j0, j1)
        tf, t0, t1 = getattr(trng, draw)(t0, t1)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert tf.dtype == torch.float32


def test_pixel_seed_bit_equal():
    # the golden recipe of tests/test_rng.py (x 100, y 200, frame 7) and a
    # spread of 1080p pixels
    x = np.concatenate([[100], np.arange(0, 1920, 7)]).astype(np.uint32)
    y = np.concatenate([[200], (x[1:] * 3 + 5) % 1080]).astype(np.uint32)
    for frame in (0, 7, 0xFFFFFFFF):
        j0, j1 = jrng.pixel_seed(jnp.asarray(x), jnp.asarray(y), frame)
        t0, t1 = trng.pixel_seed(_t(x), _t(y), frame)
        np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


def _vecs(seed, n=512, k=3, scale=2.0):
    return np.random.default_rng(seed).normal(0, scale, (n, k)).astype(np.float32)


def _unit(seed, n=512):
    v = _vecs(seed, n)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _tangent_of(n):
    """A unit tangent orthogonal to each row of ``n``."""
    t = np.cross(n, _unit(13, n.shape[0]))
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)


MATH_CASES = {
    "dot": lambda m, a, b, c: m.dot(a, b),
    "normalize": lambda m, a, b, c: m.normalize(a),
    "cross": lambda m, a, b, c: m.cross(a, b),
    "reflect": lambda m, a, b, c: m.reflect(a, b),
    "rcp": lambda m, a, b, c: m.rcp(a[..., 0]),
    "luminance": lambda m, a, b, c: m.luminance(abs(a)),
    "to_srgb": lambda m, a, b, c: m.to_srgb(abs(a)),
    "to_linear": lambda m, a, b, c: m.to_linear(abs(a)),
    "tone_mapping": lambda m, a, b, c: m.tone_mapping(abs(a)),
    "tbn_from_nt": lambda m, a, b, c: m.get_tbn_from_nt(m.normalize(a), b),
    "tbn_from_n": lambda m, a, b, c: m.get_tbn_from_n(m.normalize(a)),
    "tangent_to_world": lambda m, a, b, c: m.tangent_to_world(
        c, m.get_tbn_from_nt(m.normalize(a), b)),
    "world_to_tangent": lambda m, a, b, c: m.world_to_tangent(
        c, m.get_tbn_from_nt(m.normalize(a), b)),
    "cosine_sample_hemisphere": lambda m, a, b, c: m.cosine_sample_hemisphere(
        abs(a[..., :2]) % 1.0),
}


# Same elementwise sequence on both sides (XLA reduces a 3-element sum
# left to right too): these must match bit for bit.
BIT_EQUAL = {"dot", "luminance", "rcp", "reflect", "tone_mapping"}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math3d_matches_jnp(name):
    a, c = _vecs(10), _vecs(12)
    a[::17, 0] = 0.0  # exercise rcp's zero branch
    b = _tangent_of(a)
    fn = MATH_CASES[name]
    want = np.asarray(fn(jm, *(jnp.asarray(x) for x in (a, b, c))))
    got = _np(fn(tm, *(torch.from_numpy(x) for x in (a, b, c))))
    assert got.dtype == np.float32
    if name in BIT_EQUAL:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _surfaces(mod, seed, n=512, min_roughness=0.02):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = rng.uniform(min_roughness, 1, n).astype(np.float32)
    metal = rng.choice([0.0, 0.3, 1.0], n).astype(np.float32)
    emis = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    conv = jnp.asarray if mod is jbsdf else torch.from_numpy
    return mod.make_surface(*(conv(x) for x in (base, rough, metal, emis)))


def _tangent_dirs(seed, n=512):
    v = _unit(seed, n)
    v[:, 2] = np.abs(v[:, 2])
    return v


@pytest.mark.parametrize("fn", ["evaluate_bsdf", "pdf_bsdf"])
def test_bsdf_eval_and_pdf_match_jnp(fn):
    wo, wi = _tangent_dirs(20), _tangent_dirs(21)
    wh = wo + wi
    wh = (wh / np.linalg.norm(wh, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(getattr(jbsdf, fn)(
        _surfaces(jbsdf, 22), *(jnp.asarray(x) for x in (wo, wi, wh))))
    got = getattr(tbsdf, fn)(
        _surfaces(tbsdf, 22), *(torch.from_numpy(x) for x in (wo, wi, wh))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sample_bsdf_matches_jnp():
    wo = _tangent_dirs(30)
    s0, s1 = _u32(31, 512), _u32(32, 512)
    jout = jbsdf.sample_bsdf(_surfaces(jbsdf, 33, min_roughness=0.3),
                             jnp.asarray(wo), jnp.asarray(s0), jnp.asarray(s1))
    tout = tbsdf.sample_bsdf(_surfaces(tbsdf, 33, min_roughness=0.3),
                             torch.from_numpy(wo),
                             _t(s0), _t(s1))
    for name, a, b in zip(("bsdf", "wi", "pdf"), tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the random stream advances identically
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]).astype(np.int64))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]).astype(np.int64))


BSDF_TERMS = {
    "d_ggx": lambda m, x, y, z, c: m.d_ggx(x * x, y),
    "f_schlick": lambda m, x, y, z, c: m.f_schlick(c, y),
    "f_schlick_roughness": lambda m, x, y, z, c: m.f_schlick_roughness(c, y, x),
    "vis_schlick": lambda m, x, y, z, c: m.vis_schlick(x, y, z),
    "specular_pdf": lambda m, x, y, z, c: m.specular_pdf(y, x * x, z),
    "importance_sample_ggx": lambda m, x, y, z, c: m.importance_sample_ggx(
        c[..., :2], x * x),
}


@pytest.mark.parametrize("name", sorted(BSDF_TERMS))
def test_bsdf_terms_match_jnp(name):
    rng = np.random.default_rng(40)
    x = rng.uniform(0.3, 1.0, 512).astype(np.float32)   # roughness
    y, z = (rng.uniform(0.0, 1.0, 512).astype(np.float32) for _ in range(2))
    c = rng.uniform(0.0, 1.0, (512, 3)).astype(np.float32)
    fn = BSDF_TERMS[name]
    want = np.asarray(fn(jbsdf, *(jnp.asarray(a) for a in (x, y, z, c))))
    got = fn(tbsdf, *(torch.from_numpy(a) for a in (x, y, z, c))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
