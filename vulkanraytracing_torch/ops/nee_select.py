"""The point-light pick of ``pt/integrator.py::sample_point_light`` as one
hand-written CUDA kernel, and its CPU twin.

- The CUDA kernel (``csrc/nee_select.cu``, one thread a lane, built with
  nvcc for ``sm_90a`` on first use) reads each lane's normal, point and
  RNG state, and writes the light index, its pdf and the advanced state:
  the estimates, their CDF and the draw stay in registers.  It is launched
  through the dispatcher op ``vrt::nee_select`` (``select_cuda``), so a
  profiler session records an op range around the launch: the profiler
  gives a kernel launched through ctypes to the innermost op open at its
  launch, and a user range (a ``vrt.*`` span, a ``record_function``) is not
  one, so without the op the kernel's device time would be credited to no
  range that encloses the call.
- The CPU twin (``select_twin``): the kernel's header compiled by g++, used
  only by the tests.

The plain PyTorch body is ``pt/integrator.py::sample_point_light_plain``;
all three round every operation the same way as that body on the CPU, so
they agree bit for bit there (torch's own CUDA ops round its rsqrt and
order its cumsum otherwise, so the plain body on the card can differ from
the kernel in the last bits of the pdf).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from vulkanraytracing_torch import native
from vulkanraytracing_torch.scene.types import PointLights

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


class _Args(ctypes.Structure):
    """``csrc/nee_select.cuh::NeeArgs``, field for field."""

    _fields_ = [
        ("light_pos", _P), ("light_pos_row", _LL),
        ("light_col", _P), ("light_col_row", _LL), ("lights", ctypes.c_int),
        ("n", _P), ("n_row", _LL), ("n_col", _LL),
        ("p", _P), ("p_row", _LL), ("p_col", _LL),
        ("s0", _P), ("s0_step", _LL), ("s1", _P), ("s1_step", _LL),
        ("lanes", _LL),
        ("out_idx", _P), ("out_pdf", _P), ("out_s0", _P), ("out_s1", _P),
    ]


def _sources() -> tuple[list, tuple]:
    return [native.CSRC_DIR / "nee_select.cu"], (native.CSRC_DIR / "nee_select.cuh",)


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """Build (nvcc, sm_90a) and load the kernel."""
    sources, headers = _sources()
    cmd = [native.nvcc_path(), *native.NVCC_FLAGS, f"-I{native.CSRC_DIR}"]
    path = native.build_library("nee_select", cmd, sources, headers)
    return native.load_library(path, {"vrt_nee_select": (ctypes.c_int, [_P, _P])})


@functools.cache
def twin_library() -> ctypes.CDLL:
    """The kernel's header compiled by g++ for the host."""
    _, headers = _sources()
    cmd = [*native.GXX, "-ffp-contract=off", f"-I{native.CSRC_DIR}"]
    path = native.build_library("nee_twin", cmd, [native.CSRC_DIR / "nee_twin.cpp"], headers)
    return native.load_library(path, {"vrt_nee_select_cpu": (ctypes.c_int, [_P])})


def _check(light_pos, light_col, n, p, s0, s1) -> None:
    want = {"light_pos": (light_pos, torch.float32, 2), "light_col": (light_col, torch.float32, 2),
            "n": (n, torch.float32, 2), "p": (p, torch.float32, 2),
            "s0": (s0, torch.int64, 1), "s1": (s1, torch.int64, 1)}
    for name, (x, dtype, dims) in want.items():
        if x.device != n.device or x.dtype != dtype or x.dim() != dims:
            raise ValueError(f"{name}: need {dims}-d {dtype} on {n.device}, got "
                             f"{x.dim()}-d {x.dtype} on {x.device}")
    r = n.shape[0]
    for name, x in (("n", n), ("p", p)):
        if tuple(x.shape) != (r, 3):
            raise ValueError(f"{name}: need ({r}, 3), got {tuple(x.shape)}")
    for name, x in (("s0", s0), ("s1", s1)):
        if x.shape[0] != r:
            raise ValueError(f"{name}: need ({r},), got {tuple(x.shape)}")
    lights = light_pos.shape[0]
    for name, x in (("light_pos", light_pos), ("light_col", light_col)):
        if lights < 1 or x.shape[0] != lights or x.shape[1] < 3 or x.stride(1) != 1:
            raise ValueError(f"{name}: need ({lights} >= 1, >= 3) with unit column "
                             f"stride, got {tuple(x.shape)}, strides {x.stride()}")


def _select(light_pos, light_col, n, p, s0, s1, run) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Check the inputs, allocate the outputs and ``run`` the pick over the
    call's arguments (a ``_Args``) unless there are no lanes."""
    _check(light_pos, light_col, n, p, s0, s1)
    r = n.shape[0]
    idx = torch.empty((r,), dtype=torch.int64, device=n.device)
    pdf = torch.empty((r,), dtype=torch.float32, device=n.device)
    out_s0, out_s1 = torch.empty_like(idx), torch.empty_like(idx)
    if r:
        run(_Args(
            light_pos.data_ptr(), light_pos.stride(0), light_col.data_ptr(), light_col.stride(0),
            light_pos.shape[0], n.data_ptr(), *n.stride(), p.data_ptr(), *p.stride(),
            s0.data_ptr(), s0.stride(0), s1.data_ptr(), s1.stride(0), r,
            idx.data_ptr(), pdf.data_ptr(), out_s0.data_ptr(), out_s1.data_ptr(),
        ))
    return idx, pdf, out_s0, out_s1


def _nee_select_cuda(light_pos, light_col, n, p, s0, s1):
    """The op's CUDA implementation: one launch on the current stream."""
    lib = cuda_library()

    def launch(args: _Args) -> None:
        with torch.cuda.device(n.device):
            err = lib.vrt_nee_select(ctypes.byref(args),
                                     torch.cuda.current_stream(n.device).cuda_stream)
        if err:
            raise RuntimeError(f"nee_select launch failed: cudaError {err}")

    return _select(light_pos, light_col, n, p, s0, s1, launch)


# the op: a module-level Library keeps its registrations alive
_OPS = torch.library.Library("vrt", "FRAGMENT")
_OPS.define("nee_select(Tensor light_pos, Tensor light_col, Tensor n, Tensor p, "
            "Tensor s0, Tensor s1) -> (Tensor, Tensor, Tensor, Tensor)")
_OPS.impl("nee_select", _nee_select_cuda, "CUDA")


def select_cuda(lights: PointLights, n: Tensor, p: Tensor, s0: Tensor,
                s1: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(light index, pdf, s0', s1') for CUDA tensors: one kernel launch."""
    return torch.ops.vrt.nee_select(lights.position, lights.color, n, p, s0, s1)


def select_twin(lights: PointLights, n: Tensor, p: Tensor, s0: Tensor,
                s1: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(light index, pdf, s0', s1') for CPU tensors through the CPU twin."""
    lib = twin_library()
    return _select(lights.position, lights.color, n, p, s0, s1,
                   lambda args: lib.vrt_nee_select_cpu(ctypes.byref(args)))
