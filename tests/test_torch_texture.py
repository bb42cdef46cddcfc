"""The port's texture pool and sampler (``ops.texture``) against the JAX
package's: the real workload's pool bit for bit, and ``sample_pool``
within 1e-6 for the base level, a trilinear footprint and 4 anisotropic
taps, under repeat, clamp and mirror wraps.  The JAX pool of an all-repeat
pool samples through its footprint table, the others through four taps;
the port always takes four taps, with the same values.

The mip chains: the port's ``_resize`` (numpy) equals Pillow's BILINEAR
resize byte for byte, its pool built with Pillow blocked equals the JAX
package's (built with Pillow), and no module of the port imports Pillow
but the glTF loader's fallback for images that are not 8-bit PNGs."""

import ast
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.ops import texture as ttex
from vulkanraytracing_torch.scene import procedural as tproc
from vulkanraytracing_tpu.ops import texture as jtex
from vulkanraytracing_tpu.scene import procedural as jproc

torch.set_num_threads(1)

POOL_FIELDS = ("texels", "offset", "width", "height", "wrap_s", "wrap_t")


@pytest.fixture(scope="module")
def real_pools():
    images = tproc.sponza_real_images(7)
    for got, want in zip(images, jproc.sponza_real_images(7)):
        np.testing.assert_array_equal(got, want)
    return ttex.build_texture_pool(images, device="cpu"), jtex.build_texture_pool(images)


@pytest.fixture(scope="module")
def wrapped_pools():
    """Small textures (one not square) under every pair of wrap modes."""
    gen = np.random.default_rng(4)
    images = [gen.integers(0, 256, (h, w, 4), dtype=np.uint8)
              for h, w in ((16, 16), (8, 32), (32, 8), (13, 21))]
    wraps = [(ttex.WRAP_REPEAT, ttex.WRAP_CLAMP), (ttex.WRAP_CLAMP, ttex.WRAP_MIRROR),
             (ttex.WRAP_MIRROR, ttex.WRAP_REPEAT), (ttex.WRAP_MIRROR, ttex.WRAP_CLAMP)]
    return (ttex.build_texture_pool(images, wraps, device="cpu"),
            jtex.build_texture_pool(images, wraps))


def test_real_pool_matches_jax(real_pools):
    got, want = real_pools
    for name in POOL_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.count == 4 and got.max_levels == 11
    assert want.quad is not None  # the JAX pool samples through its table


def _queries(pool, n=4096, seed=0):
    """Texture ids (a few -1) and uvs spread over several periods."""
    gen = np.random.default_rng(seed)
    tex = gen.integers(-1, pool.count, n).astype(np.int32)
    uv = gen.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    fp = np.exp(gen.uniform(-9.0, 0.0, n)).astype(np.float32)
    dx = (gen.normal(size=(n, 2)) * np.exp(gen.uniform(-8, -2, (n, 1)))).astype(np.float32)
    dy = (gen.normal(size=(n, 2)) * np.exp(gen.uniform(-8, -2, (n, 1)))).astype(np.float32)
    return tex, uv, fp, dx, dy


FOOTPRINTS = ["base", "trilinear", "aniso4"]


def _sample(mod, pool, tex, uv, fp, dx, dy, kind, to):
    foot = {"base": None, "trilinear": to(fp),
            "aniso4": mod.AnisoFootprint(duvdx=to(dx), duvdy=to(dy), taps=4)}[kind]
    return np.asarray(mod.sample_pool(pool, to(tex), to(uv), foot))


@pytest.mark.parametrize("kind", FOOTPRINTS)
@pytest.mark.parametrize("pools", ["real_pools", "wrapped_pools"])
def test_sample_pool_matches_jax(pools, kind, request):
    tpool, jpool = request.getfixturevalue(pools)
    q = _queries(tpool, seed=len(kind))
    got = _sample(ttex, tpool, *q, kind, torch.from_numpy)
    want = _sample(jtex, jpool, *q, kind, jnp.asarray)
    assert got.shape == (q[0].shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wrap_modes_match_jax():
    x = torch.arange(-40, 41, dtype=torch.int64)
    for n in (1, 2, 7, 16):
        for mode in (ttex.WRAP_REPEAT, ttex.WRAP_CLAMP, ttex.WRAP_MIRROR):
            got = ttex._apply_wrap(x, torch.tensor(n), torch.tensor(mode))
            want = jtex._apply_wrap(jnp.asarray(x.numpy(), jnp.int32), jnp.int32(n),
                                    jnp.int32(mode))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert ((got >= 0) & (got < n)).all()


def test_sky_panorama_and_its_sampling_match_jax():
    """The real workload's 512x1024 sky, bit for bit, and the miss lookup
    over it against the JAX package's footprint table
    (``make_environment``): on the same uvs the port's four taps equal it
    bit for bit.  From directions, ``atan2`` and ``asin`` of PyTorch and
    XLA may differ by an ulp, which moves a uv by 1.2e-7: 99.9% of the
    channels stay within 1e-6, all within a relative 1e-4 (the sun disc is
    steep)."""
    from vulkanraytracing_torch.env import panorama as tpan
    from vulkanraytracing_torch.scene.types import make_environment as t_env
    from vulkanraytracing_tpu.env import panorama as jpan
    from vulkanraytracing_tpu.scene.types import make_environment as j_env

    pano = tproc.procedural_sky_panorama(512, seed=207)
    np.testing.assert_array_equal(pano, jproc.procedural_sky_panorama(512, seed=207))
    gen = np.random.default_rng(9)
    d = gen.normal(size=(65536, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1],
             [1e-7, 1, 0], [0, -1, 1e-7]]
    jenv = j_env(jnp.asarray(pano))
    assert jenv.quad is not None
    want = np.asarray(jpan.sample_environment(jenv, jnp.asarray(d)))

    uv = np.array(jpan.panorama_uv(jnp.asarray(d)))
    same_uv = tpan.sample_bilinear_wrap(torch.from_numpy(pano), torch.from_numpy(uv))
    np.testing.assert_array_equal(same_uv.numpy(), want)

    got = tpan.sample_environment(t_env(torch.from_numpy(pano)), torch.from_numpy(d)).numpy()
    assert (np.abs(got - want) <= 1e-6).mean() >= 0.999
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# -- the mip chains without Pillow ------------------------------------------

def _alpha(kind, shape, gen):
    return {"opaque": np.full(shape, 255, np.uint8),
            "zero": np.zeros(shape, np.uint8),
            "partial": gen.integers(0, 256, shape, dtype=np.uint8),
            "mixed": gen.choice(np.array([0, 7, 255], np.uint8), shape)}[kind]


RESIZES = [  # (h, w) -> (h, w), alpha
    ((64, 64), (32, 32), "opaque"),        # an even halving
    ((63, 37), (31, 18), "partial"),       # an odd halving
    ((5, 5), (2, 2), "mixed"),
    ((1, 9), (1, 4), "partial"),           # 1-pixel edges
    ((9, 1), (4, 1), "zero"),
    ((2, 1), (1, 1), "mixed"),
    ((1, 1), (3, 2), "partial"),
    ((20, 30), (47, 71), "partial"),       # non-integer upscales
    ((3, 2), (7, 5), "mixed"),
    ((50, 70), (23, 31), "mixed"),         # non-integer downscales
    ((17, 5), (40, 3), "zero"),
    ((100, 7), (33, 7), "opaque"),         # one side only
    ((2500, 40), (2048, 33), "partial"),   # the 2048 cap's scale (2048 / 2500)
    ((4096, 24), (2048, 12), "mixed"),     # the cap's halving of a 4096 side
]


@pytest.mark.parametrize("src,dst,alpha", RESIZES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}-{a}" for s, d, a in RESIZES])
def test_resize_equals_pillow_bilinear(src, dst, alpha):
    """``_resize`` (numpy) equals Pillow's BILINEAR resize of an RGBA image
    byte for byte, and so equals the JAX package's ``_resize`` where Pillow
    is installed."""
    from PIL import Image

    gen = np.random.default_rng(src[0] * 1000 + dst[1])
    img = gen.integers(0, 256, src + (4,), dtype=np.uint8)
    img[..., 3] = _alpha(alpha, src, gen)
    pil = Image.fromarray(img)
    assert pil.mode == "RGBA"
    want = np.asarray(pil.resize((dst[1], dst[0]), Image.BILINEAR))
    got = ttex._resize(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == dst + (4,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jtex._resize(img, dst[1], dst[0]))


def test_pool_without_pillow_matches_jax(monkeypatch):
    """With Pillow blocked from import, the port's pool of a few images
    (odd sizes, a grey and an RGB image, one past ``max_size``) equals the
    JAX package's pool, which resizes with Pillow, in every texel of every
    mip."""
    gen = np.random.default_rng(12)
    images = [gen.integers(0, 256, (37, 23, 4), dtype=np.uint8),
              gen.integers(0, 256, (16, 64, 3), dtype=np.uint8),
              gen.uniform(0.0, 1.0, (9, 9)).astype(np.float32),
              gen.integers(0, 256, (80, 50, 4), dtype=np.uint8)]
    images[0][..., 3] = _alpha("mixed", (37, 23), gen)
    with monkeypatch.context() as blocked:
        blocked.setitem(sys.modules, "PIL", None)
        blocked.setitem(sys.modules, "PIL.Image", None)
        with pytest.raises(ImportError):
            from PIL import Image  # noqa: F401
        got = ttex.build_texture_pool(images, max_size=64, device="cpu")
    want = jtex.build_texture_pool(images, max_size=64)
    assert got.max_levels == 7 and int(got.width[3, 0]) == 40
    for name in POOL_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_no_pillow_in_the_port_but_the_gltf_image_fallback():
    """No module of the port imports Pillow, except the glTF loader's
    decoder of images other than 8-bit PNGs (a JPEG)."""
    port = Path(__file__).resolve().parent.parent / "vulkanraytracing_torch"
    found = []
    for path in sorted(port.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        scopes = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for inner in ast.walk(node):
                    scopes.setdefault(id(inner), node.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(n.split(".")[0] == "PIL" for n in names):
                found.append((str(path.relative_to(port)), scopes.get(id(node))))
    assert found == [("scene/gltf.py", "image_pixels")]
