"""The point-light pick kernel's CPU twin (``ops.nee_select.select_twin``:
``csrc/nee_select.cuh`` built by g++) against the plain body
(``pt/integrator.py::sample_point_light_plain``), bit for bit in every
output, and ``sample_point_light``'s choice of path.

The cases cover the plain body's edges: random lanes, every light below the
horizon (the total > 0 guard), NaN and inf normals and points, draws that
land exactly on a CDF boundary, 1, 4 and 7 lights, and the shading normal as
the integrator passes it, a strided column of the TBN frames.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.ops import nee_select
from vulkanraytracing_torch.pt import integrator
from vulkanraytracing_torch.scene.types import PointLights
from vulkanraytracing_torch.utils import profiling

M32 = 0xFFFFFFFF
R = 4096
# the boundary case's draws, and the lights they pick
BOUNDARY_X = (0.0, 0.25 - 2**-23, 0.25, 0.5 - 2**-23, 0.5)
BOUNDARY_IDX = (0, 0, 1, 1, 2)


def _lights(gen, count):
    pos = gen.uniform(-6.0, 6.0, (count, 4)).astype(np.float32)
    col = gen.uniform(0.0, 20.0, (count, 4)).astype(np.float32)
    return PointLights(torch.from_numpy(pos), torch.from_numpy(col))


def _lanes(gen, r=R):
    """Unit normals (a contiguous copy) and points in the lights' box."""
    n = gen.normal(0.0, 1.0, (r, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    p = gen.uniform(-8.0, 8.0, (r, 3))
    return torch.from_numpy(n.astype(np.float32)), torch.from_numpy(p.astype(np.float32))


def _state(gen, r=R):
    return (torch.from_numpy(gen.integers(0, 2**32, r, dtype=np.int64)),
            torch.from_numpy(gen.integers(0, 2**32, r, dtype=np.int64)))


def _seed_for(x: float) -> int:
    """An s0 whose next draw (``core/rng.py::next_float``) is exactly x,
    for x a multiple of 2^-23 in [0, 1): the draw's bits inverted."""
    bits = round(x * 2**23) << 9
    rotated = (bits * pow(5, -1, 2**32)) & M32
    return (((rotated >> 5) | (rotated << 27)) & M32) * pow(0x9E3779BB, -1, 2**32) & M32


def _case(name):
    gen = np.random.default_rng(17)
    count = {"lights_1": 1, "lights_7": 7}.get(name, 4)
    lights = _lights(gen, count)
    n, p = _lanes(gen)
    s0, s1 = _state(gen)
    if name == "below_horizon":
        # every light above the points, every normal pointing straight down
        lights.position[:, 1] = 9.0
        p[:, 1] = torch.from_numpy(gen.uniform(-8.0, 0.0, R).astype(np.float32))
        n[:] = torch.tensor([0.0, -1.0, 0.0])
    elif name == "nan_inf":
        bad = torch.tensor([float("nan"), float("inf"), -float("inf")])
        for k, x in enumerate((n, p)):
            x[k::5, k % 3] = bad[torch.arange(x[k::5].shape[0]) % 3]
        p[4::9] = float("inf")
        n[3::11] = float("nan")
    elif name == "boundary":
        # four equal lights straight above: the normalised CDF is exactly
        # 0.25 and 0.5 at its first two boundaries, and the draws land on
        # them and one step under them
        lights.position[:] = torch.tensor([0.5, 7.0, -0.25, 1.0])
        lights.color[:] = lights.color[0]
        n[:] = torch.tensor([0.0, 1.0, 0.0])
        p[:, 1] = 0.0
        s0 = torch.tensor([_seed_for(BOUNDARY_X[k % 5]) for k in range(R)], dtype=torch.int64)
    if name == "strided_normal":
        # the integrator's n_shading: tbn[..., 2] of (R, 3, 3) frames, rows
        # 9 floats apart, components 3 apart
        tbn = torch.from_numpy(gen.normal(0.0, 1.0, (R, 3, 3)).astype(np.float32))
        tbn[..., 2] = n
        n = tbn[..., 2]
        assert n.stride() == (9, 3)
    return lights, n, p, s0, s1


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


CASES = ["random", "below_horizon", "nan_inf", "boundary", "lights_1", "lights_4",
         "lights_7", "strided_normal"]


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_plain_bit_for_bit(name):
    lights, n, p, s0, s1 = _case(name)
    twin = nee_select.select_twin(lights, n, p, s0, s1)
    plain = integrator.sample_point_light_plain(lights, n, p, s0, s1)
    for field, a, b in zip(("idx", "pdf", "s0", "s1"), twin, plain):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(_bits(a), _bits(b)), field
    idx, pdf = plain[:2]
    assert int(idx.min()) >= 0 and int(idx.max()) < lights.count
    if name == "below_horizon":
        assert torch.equal(idx, torch.zeros_like(idx)) and bool((pdf == 1.0).all())
    if name == "nan_inf":
        assert bool(pdf.isnan().any()) and bool(pdf.isfinite().any())
    if name == "boundary":
        # a draw on a boundary picks the next light, a draw a step under it
        # this one
        want = torch.tensor(BOUNDARY_IDX).repeat(R // 5 + 1)[:R]
        assert torch.equal(idx, want)
        assert bool((pdf[idx < 2] == 0.25).all())
    if name == "lights_1":
        assert torch.equal(idx, torch.zeros_like(idx)) and bool((pdf == 1.0).all())
    if name in ("random", "lights_4", "lights_7"):
        assert len(torch.unique(idx)) == lights.count


def test_twin_takes_no_lanes_and_refuses_bad_inputs():
    lights, n, p, s0, s1 = _case("random")
    out = nee_select.select_twin(lights, n[:0], p[:0], s0[:0], s1[:0])
    assert [x.shape[0] for x in out] == [0] * 4
    with pytest.raises(ValueError, match="p: need"):
        nee_select.select_twin(lights, n, p[:, :2], s0, s1)
    with pytest.raises(ValueError, match="s0: need"):
        nee_select.select_twin(lights, n, p, s0.to(torch.int32), s1)
    with pytest.raises(ValueError, match="light_pos: need"):
        nee_select.select_twin(PointLights(lights.position[:0], lights.color[:0]), n, p, s0, s1)


def test_cpu_tensors_take_the_plain_body_and_count_it():
    lights, n, p, s0, s1 = _case("random")
    profiling.begin_frame()
    got = integrator.sample_point_light(lights, n, p, s0, s1)
    profiling.end_frame()
    want = integrator.sample_point_light_plain(lights, n, p, s0, s1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    counts = profiling.frame_counts()
    assert (counts["nee_calls.plain"], counts["nee_lanes.plain"]) == (1, R)
    assert not any(k.endswith(".kernel") for k in counts)


def test_the_op_is_registered_for_cuda_only():
    schema = torch.ops.vrt.nee_select.default._schema
    assert [a.name for a in schema.arguments] == ["light_pos", "light_col", "n", "p", "s0", "s1"]
    assert len(schema.returns) == 4
    lights, n, p, s0, s1 = _case("random")
    with pytest.raises(NotImplementedError):
        torch.ops.vrt.nee_select(lights.position, lights.color, n, p, s0, s1)
