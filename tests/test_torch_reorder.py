"""The port's wavefront reorder (``ops.reorder``) against the JAX
package's: the coherence keys, the global order, and permutations that
round-trip every dtype bit for bit.

Keys: bit for bit, except that ``atan2`` of PyTorch and of XLA may differ
by an ulp, so a ray within an ulp of a theta or phi bin edge may land one
bin over in that 5-bit field only; at most 0.1% of rays may.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanraytracing_torch.ops import reorder as treorder
from vulkanraytracing_tpu.ops import reorder as jreorder

torch.set_num_threads(1)

THETA = 0x1F << 14
PHI = 0x1F << 9


def _rays(n, seed=0, dead_every=5):
    gen = np.random.default_rng(seed)
    o = gen.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)  # some outside the box
    d = gen.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full((n,), 1e-3, np.float32)
    t_max = np.full((n,), 1e3, np.float32)
    t_max[::dead_every] = 0.0
    lo = np.array([-10.0, -5.0, -8.0], np.float32)
    hi = np.array([10.0, 5.0, 8.0], np.float32)
    return o, d, t_min, t_max, lo, hi


def _jax_keys(*arrays):
    return np.asarray(jreorder.ray_sort_keys(*[jnp.asarray(a) for a in arrays])).astype(np.int64)


def _port_keys(*arrays):
    return treorder.ray_sort_keys(*[torch.from_numpy(a) for a in arrays]).numpy()


def test_sort_keys_match_jax():
    rays = _rays(65536)
    want, got = _jax_keys(*rays), _port_keys(*rays)
    assert got.min() >= 0 and got.max() < 2**32
    differ = got != want
    # only the direction bins may differ, by one bin
    assert not ((got ^ want)[differ] & ~(THETA | PHI)).any()
    for mask, shift in ((THETA, 14), (PHI, 9)):
        step = np.abs(((got & mask) >> shift) - ((want & mask) >> shift))
        assert step.max() <= 1
    assert differ.mean() <= 1e-3, f"{differ.sum()} keys differ"
    # the dead bit is set exactly where t_min > t_max
    assert np.array_equal(got >> 31, (rays[2] > rays[3]).astype(np.int64))


@pytest.mark.parametrize("n", [256, 4096, 128 * 37])
def test_order_matches_jax_make_order(n):
    """Given JAX's keys, the port's stable sort is JAX's order exactly;
    dead rays go to the tail."""
    rays = _rays(n, seed=n)
    want = np.asarray(jreorder.make_order(*[jnp.asarray(a) for a in rays], probe=None).fwd)
    keys = torch.from_numpy(_jax_keys(*rays))
    fwd = treorder.sort_permutation(keys).numpy()
    np.testing.assert_array_equal(fwd, want)
    dead = rays[2] > rays[3]
    assert dead[fwd].tolist() == sorted(dead.tolist())
    # the port's own order is stable and ascending in its own keys
    order = treorder.make_order(*[torch.from_numpy(a) for a in rays])
    own = _port_keys(*rays)[order.fwd.numpy()]
    assert (np.diff(own) >= 0).all()
    np.testing.assert_array_equal(order.inv.numpy()[order.fwd.numpy()], np.arange(n))


def _payload(n, seed):
    gen = np.random.default_rng(seed)
    return (
        torch.from_numpy(gen.normal(size=(n, 3)).astype(np.float32)),
        torch.from_numpy(gen.normal(size=(n,)).astype(np.float32)),
        torch.from_numpy(gen.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)),
        torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.int64)),  # uint32 in int64
        torch.from_numpy(gen.random(n) < 0.5),
        torch.tensor(np.where(gen.random(n) < 0.1, np.inf, np.nan), dtype=torch.float32),
    )


@pytest.mark.parametrize("n", [1, 127, 128, 4097])
def test_permutations_round_trip_every_dtype(n):
    rays = [torch.from_numpy(a) for a in _rays(n, seed=3 + n)]
    payload = _payload(n, seed=n)
    order = treorder.make_order(*rays)
    moved = treorder.apply_order(order, *payload)
    riding = treorder.sort_wavefront(*rays, payload)
    back = treorder.unapply_order(order, *moved)
    for a, b, c, orig in zip(moved, riding, back, payload):
        assert a.dtype == orig.dtype and a.shape == orig.shape
        # bit for bit, NaN and inf payloads included
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float32 else a,
                           b.view(torch.uint8) if b.dtype == torch.float32 else b)
        assert torch.equal(c.view(torch.uint8) if c.dtype == torch.float32 else c,
                           orig.view(torch.uint8) if orig.dtype == torch.float32 else orig)
