"""Wavefront reordering: a coherence key per ray and one stable permutation.

Counterpart of ``vulkanraytracing_tpu/ops/reorder.py``.  Bounce rays of a
pixel tile scatter over the hemisphere; sorting the wavefront by (dead,
coarse origin cell, direction bin, finer origin bits) before tracing puts
rays that walk the same part of the tree next to each other, and sends
dead rays to the tail.  The key is the JAX package's bit for bit; uint32
values are held in int64 masked to 32 bits, as ``core.rng`` does.

The permutation is ``torch.sort(stable=True)`` of the keys, and every
state column rides it by ``index_select``: the JAX package also sorts with
a library sort (``lax.sort``) outside any kernel.

Not ported, because they are TPU devices rather than features:
- ``SegOrder``, ``seg_ranks``, ``_apply_columns`` and ``_permute``: the
  one-hot matmul transport for wavefronts that are not a whole number of
  128-ray rows.  Here every size is sorted globally.
- ``probe_ray_mask``, ``probe_row_cost`` and, with them,
  ``accel/lbvh.py::probe_cut``: they regroup 128-lane rows so that a TPU
  wave fills with rows of like cost.  ``BVH.probe`` is not carried across.
- The 16-operand grouping of ``sort_wavefront``: it works around an XLA
  compile limit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from vulkanraytracing_torch.accel.lbvh import morton_codes
from vulkanraytracing_torch.utils.profiling import span


class GlobalOrder(NamedTuple):
    """A wavefront's coherence order."""

    fwd: Tensor  # (R,) i64 — output slot i takes input element fwd[i]
    inv: Tensor  # (R,) i64 — the inverse permutation


def ray_sort_keys(o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
                  root_lo: Tensor, root_hi: Tensor) -> Tensor:
    """32-bit coherence key (int64 in [0, 2^32)): dead(1) | morton_hi(12) |
    theta(5) | phi(5) | morton_mid(9).  Position-major, with 10 direction
    bits below the coarse cell and finer position bits as the tie-break."""
    dead = (t_min > t_max).to(torch.int64)
    morton = morton_codes(o, root_lo, root_hi) >> 2   # 28 bits
    m_hi = morton >> 16                                # 12 bits
    m_mid = (morton >> 7) & 0x1FF                      # the next 9 bits
    # theta bin: equal-z slices; phi bin: atan2; 5 bits each
    tb = torch.clamp(((d[:, 2] + 1.0) * 16.0).to(torch.int32), 0, 31).to(torch.int64)
    phi = torch.atan2(d[:, 1], d[:, 0])
    pb = torch.clamp((phi * (16.0 / math.pi) + 16.0).to(torch.int32), 0, 31).to(torch.int64)
    return (dead << 31) | (m_hi << 19) | (tb << 14) | (pb << 9) | m_mid


def sort_permutation(keys: Tensor) -> Tensor:
    """Stable ascending argsort (int64) of 32-bit keys held in int64.  The
    keys are sorted as int32 (shifted by 2^31, which keeps their order):
    half the bytes of an int64 sort, the same permutation."""
    return torch.sort((keys - 2**31).to(torch.int32), stable=True).indices


def make_order(o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
               root_lo: Tensor, root_hi: Tensor) -> GlobalOrder:
    """The wavefront's coherence order and its inverse."""
    fwd = sort_permutation(ray_sort_keys(o, d, t_min, t_max, root_lo, root_hi))
    inv = torch.empty_like(fwd).scatter_(
        0, fwd, torch.arange(fwd.shape[0], device=fwd.device))
    return GlobalOrder(fwd=fwd, inv=inv)


def apply_order(order: GlobalOrder, *arrays: Tensor) -> tuple[Tensor, ...]:
    """Permute (R, ...) arrays of any dtype into coherence order."""
    return tuple(a.index_select(0, order.fwd) for a in arrays)


def unapply_order(order: GlobalOrder, *arrays: Tensor) -> tuple[Tensor, ...]:
    """Permute coherence-ordered arrays back to their original order."""
    return tuple(a.index_select(0, order.inv) for a in arrays)


@span("vrt.sort")
def sort_wavefront(o: Tensor, d: Tensor, t_min: Tensor, t_max: Tensor,
                   root_lo: Tensor, root_hi: Tensor, arrays) -> tuple[Tensor, ...]:
    """Coherence-sort a wavefront: every array of ``arrays`` ((R,) or
    (R, k), any dtype) rides one stable permutation of the rays' keys.
    Returns the sorted arrays in input order."""
    perm = sort_permutation(ray_sort_keys(o, d, t_min, t_max, root_lo, root_hi))
    return tuple(a.index_select(0, perm) for a in arrays)
