"""The port's command line and terminal viewer, on the CPU (``--device cpu``).

Ports of ``tests/test_engine.py``'s ``test_cli_render_and_compare`` and
``test_terminal_viewer_headless`` (the toggle's next frame now draws in
hybrid mode), and the whole ``render`` path of a user's files: a .glb
written by the exporter and an .hdr panorama, rendered in hybrid mode
(the IBL baked, the sun extracted) and in path-tracing mode, the PNG read
back equal to the Engine's display image.  The hybrid bake runs at small
sizes here (``bake_ibl``'s sizes are its arguments; the CLI takes the
defaults, which take seconds on this CPU: ``tests/test_torch_env.py``
holds the bake to the JAX package's).
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
import torch

from vulkanraytracing_torch.app import cli
from vulkanraytracing_torch.app.engine import Engine
from vulkanraytracing_torch.app.hdr import write_hdr
from vulkanraytracing_torch.app.image_io import read_png
from vulkanraytracing_torch.config import CameraConfig, Config, RenderMode, TraversalMode
from vulkanraytracing_torch.env import ibl
from vulkanraytracing_torch.scene.gltf_export import export_scene_glb
from vulkanraytracing_torch.scene.procedural import cornell_box_scene

torch.set_num_threads(1)


def _compare(a, b) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["compare", str(a), str(b)]) == 0
    return json.loads(out.getvalue())


@pytest.fixture
def engines(monkeypatch):
    """The Engines the CLI makes, kept for the test to read."""
    made = []

    class Kept(Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(cli, "Engine", Kept)
    return made


def test_cli_render_and_compare(tmp_path):
    out = tmp_path / "tri.png"
    rc = cli.main(["render", "--scene", "triangle", "--out", str(out), "--spp", "2",
                   "--width", "16", "--height", "16", "--brute", "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert _compare(out, out) == {"rmse": 0.0, "passes_1e-3": True}


def test_cli_glb_and_hdr_in_both_modes(tmp_path, engines, monkeypatch):
    glb = export_scene_glb(cornell_box_scene(device="cpu"), tmp_path / "cornell.glb")
    pano = np.random.default_rng(1).uniform(0.0, 1.0, (16, 32, 3)).astype(np.float32)
    pano[0:8, 8:16] += 40.0  # the sun
    write_hdr(tmp_path / "sky.hdr", pano)
    monkeypatch.setattr(ibl, "bake_ibl", functools.partial(
        ibl.bake_ibl, irradiance_size=4, reflection_size=8, brdf_size=8))
    common = ["render", "--scene", str(glb), "--env", str(tmp_path / "sky.hdr"),
              "--width", "24", "--height", "16", "--device", "cpu"]

    rc = cli.main(common + ["--mode", "hybrid", "--out", str(tmp_path / "h.png")])
    eng = engines[-1]
    assert rc == 0 and eng.render_mode == RenderMode.HYBRID
    assert eng.cfg.traversal == TraversalMode.BVH_KERNEL and eng.scene.bvh.nodes8 is not None
    env = eng.scene.environment
    assert env.irradiance.shape == (6, 4, 4, 3) and len(env.reflection) == 4
    assert float(eng.scene.direct_light.color[:3].max()) > 0.0  # extracted from the sky
    hybrid = read_png(tmp_path / "h.png")
    assert np.array_equal(hybrid, eng.display_image()) and hybrid.shape == (16, 24, 3)

    rc = cli.main(common + ["--spp", "2", "--out", str(tmp_path / "p.png"),
                            "--checkpoint", str(tmp_path / "c.npz")])
    eng = engines[-1]
    assert rc == 0 and eng.state.accum_index == 2 and eng.total_rays > 0
    assert np.array_equal(read_png(tmp_path / "p.png"), eng.display_image())
    assert _compare(tmp_path / "p.png", tmp_path / "p.png")["rmse"] == 0.0
    assert _compare(tmp_path / "p.png", tmp_path / "h.png")["rmse"] > 0.0

    # resume the checkpoint for one more frame, and write radiance
    rc = cli.main(common + ["--spp", "1", "--resume", str(tmp_path / "c.npz"),
                            "--out", str(tmp_path / "p.npy")])
    assert rc == 0 and engines[-1].state.accum_index == 3
    assert np.load(tmp_path / "p.npy").shape == (16, 24, 3)


def test_cli_needs_the_card_unless_told(tmp_path):
    """``--device`` defaults to the card; without one the CLI fails rather
    than render on the host.  ``--devices`` shards rows over host shards
    with ``--device cpu``; the height must divide over them."""
    argv = ["render", "--scene", "triangle", "--out", str(tmp_path / "t.png"),
            "--width", "8", "--height", "8", "--spp", "1", "--brute"]
    if torch.cuda.is_available():
        assert cli.main(argv) == 0
    else:
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv)
    assert cli.main(argv + ["--device", "cpu", "--devices", "2"]) == 0
    with pytest.raises(SystemExit, match="divisible"):
        cli.main(argv + ["--device", "cpu", "--devices", "3"])
    with pytest.raises(SystemExit, match="not found"):
        cli.main(["render", "--scene", str(tmp_path / "missing.glb"), "--device", "cpu"])


def _engine():
    cfg = Config(width=16, height=16, traversal=TraversalMode.BRUTE_FORCE,
                 camera=CameraConfig(position=(0.0, 0.0, 3.2), aspect_ratio=1.0))
    return Engine(cfg, cornell_box_scene(device="cpu"), device="cpu")


def test_terminal_viewer_headless():
    """TerminalViewer.frame drives the Engine without a tty: keys inject,
    the camera moves (the accumulation resets), the mode toggles and the
    next frame draws in hybrid mode, ANSI out renders."""
    from vulkanraytracing_torch.app.viewer import TerminalViewer

    eng = _engine()
    v = TerminalViewer(eng, cols=24, rows=10)
    out = v.frame([])
    assert "\x1b[38;2;" in out and "spp" in out
    spp0 = eng.state.accum_index
    v.frame([])
    assert eng.state.accum_index == spp0 + 1
    v.frame(["w"])  # camera move -> accumulation reset
    assert eng.state.accum_index == 1
    out = v.frame(["t"])
    assert eng.render_mode == RenderMode.HYBRID and "\x1b[38;2;" in out
    assert eng.state.accum_index == 1  # a hybrid frame does not accumulate
    assert eng.display_image().shape == (16, 16, 3)


def test_viewer_sgr_mouse_decode():
    from vulkanraytracing_torch.app.viewer import _decode_input

    assert _decode_input("\x1b[<35;10;5M") == ([("MOUSE", 10, 5, True)], "")
    assert _decode_input("w\x1b[<0;3;4M\x1b[A") == (["w", ("MOUSE", 3, 4, True), "UP"], "")
    toks, rem = _decode_input("a\x1b[<35;1")
    assert toks == ["a"] and rem == "\x1b[<35;1"
    assert _decode_input(rem + "2;7M") == ([("MOUSE", 12, 7, True)], "")
    assert _decode_input("\x1b[<1;xM q") == ([" ", "q"], "")
