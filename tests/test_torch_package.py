"""The port stands on its own and runs on the card by default.

- Its native builders are its own copies, byte-equal to the JAX package's
  originals (so drift shows here), and are built from ``csrc/``.
- No module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
  package or names the JAX package's files in a string other than a
  docstring; every module imports with ``jax`` and the JAX package
  blocked.
- No entry point defaults to the CPU: a call that leaves out ``device``
  builds on the card, and on a machine without one it raises instead of
  handing back CPU tensors.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vulkanraytracing_torch import native
from vulkanraytracing_torch.config import CameraConfig, Config
from vulkanraytracing_torch.pt.render import create_render_state
from vulkanraytracing_torch.scene.camera import Camera
from vulkanraytracing_torch.scene.procedural import cornell_box_scene, sponza_like_scene

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vulkanraytracing_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("name", ["sah_builder.cpp", "bvh8_collapse.cpp"])
def test_native_builders_are_own_byte_equal_copies(name):
    copy = native.CSRC_DIR / name
    assert copy.read_bytes() == (ROOT / "vulkanraytracing_tpu" / "native" / name).read_bytes()
    assert not hasattr(native, "JAX_NATIVE_DIR")


def _docstrings(tree) -> set:
    nodes = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, nodes) and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_the_port(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "vulkanraytracing_tpu"), (path, node.lineno)
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            assert "vulkanraytracing_tpu" not in node.value, (path, node.lineno)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vulkanraytracing_tpu'] = None\n"
        "import vulkanraytracing_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 20, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_no_device_parameter_defaults_to_the_cpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        positional = args.posonlyargs + args.args
        pairs = list(zip(positional[len(positional) - len(args.defaults):], args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None]
        for arg, default in pairs:
            if arg.arg == "device" and isinstance(default, ast.Constant):
                assert default.value != "cpu", (path.name, node.name)


def _load_scene():
    import tempfile

    from vulkanraytracing_torch.scene.gltf import load_scene
    from vulkanraytracing_torch.scene.gltf_export import export_scene_glb

    with tempfile.TemporaryDirectory() as tmp:
        return load_scene(export_scene_glb(cornell_box_scene(device="cpu"), Path(tmp) / "c.glb"))


def _bake_ibl():
    from vulkanraytracing_torch.env.ibl import bake_ibl
    from vulkanraytracing_torch.scene.types import constant_environment

    return bake_ibl(constant_environment((1.0, 0.5, 0.25)), 4, 8, 8)


def _render_hybrid():
    from vulkanraytracing_torch.hybrid import render_hybrid

    return render_hybrid(cornell_box_scene(), Config(width=8, height=8),
                         Camera(CameraConfig(aspect_ratio=1.0)).to_device())


def _brdf_lut():
    from vulkanraytracing_torch.env.ibl import compute_brdf_lut

    return compute_brdf_lut(8, 16)


ENTRY_POINTS = {
    "load_scene": _load_scene,
    "bake_ibl": _bake_ibl,
    "render_hybrid": _render_hybrid,
    "compute_brdf_lut": _brdf_lut,
    "sponza_like_scene": lambda: sponza_like_scene(4000),
    "cornell_box_scene": lambda: cornell_box_scene(),
    "create_render_state": lambda: create_render_state(Config(width=8, height=8)),
    "Camera.to_device": lambda: Camera(CameraConfig(aspect_ratio=1.0)).to_device(),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_asked(name):
    """Without ``device`` the result lies on the card; on a machine with no
    card the call raises, as PyTorch does, and never falls back."""
    if torch.cuda.is_available():
        got = list(_tensors(ENTRY_POINTS[name]()))
        assert got and all(t.device.type == "cuda" for t in got)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ENTRY_POINTS[name]()


def test_cpu_is_asked_for_by_name():
    scene = cornell_box_scene(device="cpu")
    assert scene.geometry.v0.device.type == "cpu"
    assert np.isfinite(scene.geometry.v0.numpy()).all()
