"""Compile-on-first-use shared libraries, loaded with ctypes.

Every native piece of the port is a shared library with a plain C
interface, built from the port's own ``csrc/``: the SAH builder and the
BVH8 collapse (byte-equal copies of the JAX package's C++ sources, built
with g++), the traversal kernels (built with nvcc for ``sm_90a``) and
their CPU twins (the same headers built with g++, used by the tests).

A library is written to ``vulkanraytracing_torch/build/`` under a name
keyed by a hash of its sources and its command line, so a changed source
or flag builds a new file and a stale one is never loaded.  Parallel test
workers may build the same library at once: each compiles to its own
temporary name and ``os.replace`` moves the result into place atomically.
A failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from vulkanraytracing_torch.utils.profiling import trace_scope

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "build"
CSRC_DIR = PACKAGE_DIR / "csrc"

GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: the kernel then rounds every multiply and add
    # as PyTorch's separate elementwise ops do, so it can match its plain
    # version bit for bit on the card
    "-fmad=false",
    # ptxas reports each kernel's registers, stack frame and spills; the
    # report is kept beside the library (``build_log``)
    "-Xptxas", "-v",
]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library(
    name: str,
    command: list[str],
    sources: list[Path],
    headers: tuple[Path, ...] = (),
) -> Path:
    """Build ``sources`` with ``command`` into ``BUILD_DIR`` unless a build
    of the same sources and command exists; return the library's path."""
    digest = hashlib.sha256(" ".join(command).encode())
    for path in (*sources, *headers):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [*command, "-o", str(tmp), *(str(s) for s in sources)]
    with trace_scope("vrt.setup.build_library"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    log = proc.stdout + proc.stderr
    if log:
        build_log(out).write_text(log)
    os.replace(tmp, out)
    return out


def build_log(library: Path) -> Path:
    """Where the compiler's output of a successful build is kept."""
    return library.with_suffix(".log")


def load_library(path: Path, functions: dict) -> ctypes.CDLL:
    """Load a library and declare ``{name: (restype, argtypes)}``."""
    lib = ctypes.CDLL(str(path))
    for fn_name, (restype, argtypes) in functions.items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
