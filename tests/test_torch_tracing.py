"""The port's spans and per-frame counters (``utils.profiling``) through
``Engine.draw`` on the CPU, and the benchmark readers that use them.

Two tiny scenes: the textured hall with alpha-tested foliage (its cutout
subset attached) and the factor-only hall.  Under a CPU ``torch.profiler``
session a frame emits every span that a reader in ``rtbench/metrics/``
reads, nested as documented; with no session open no span opens a
profiler range.  ``frame_counts`` gives the frame's host waits,
traversal lanes and point-light picks as counted by hand from
``pt/integrator.py`` and ``ops/trace.py``: with R lanes a wavefront, one
pick of R lanes a bounce, 4 closest calls of R lanes and 4 any-hit
calls of 2R a factor-only frame (12R), and 24
closest calls of R plus 24 of 2R a frame with cutouts (each trace an
opaque pass and a subset pass of 1 + ``MAX_ALPHA_ITERS`` rounds: 72R,
60R of them the subset's).  ``tools.idle_by_span`` puts a trace's idle
time down to its spans.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rtbench import probes
from vulkanraytracing_torch.accel.lbvh import build_scene_bvh
from vulkanraytracing_torch.app import cli
from vulkanraytracing_torch.app.engine import Engine
from vulkanraytracing_torch.config import CameraConfig, Config
from vulkanraytracing_torch.ops.trace import MAX_ALPHA_ITERS
from vulkanraytracing_torch.pt.render import tile_pixel_coords
from vulkanraytracing_torch.scene.procedural import sponza_like_scene
from vulkanraytracing_torch.tools import idle_by_span
from vulkanraytracing_torch.utils import profiling

METRICS = Path(__file__).resolve().parents[1] / "rtbench" / "metrics"
SPAN_READERS = ("nee_span_ms", "sort_span_ms", "texture_span_ms", "alpha_span_ms",
                "shade_span_ms")
W, H = 16, 16


def _metric(name: str):
    spec = importlib.util.spec_from_file_location(f"test_metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _engine(workload: str) -> Engine:
    scene = build_scene_bvh(sponza_like_scene(2000, workload=workload, device="cpu"),
                            builder="sah")
    cfg = Config(width=W, height=H, alpha_visibility=workload == "real",
                 camera=CameraConfig(position=(-16.0, 3.0, 0.0), target=(0.0, 3.0, 0.0),
                                     aspect_ratio=W / H))
    engine = Engine(cfg, scene, device="cpu")
    engine.draw()  # builds the tables: the frames below are steady
    return engine


@pytest.fixture(scope="module", params=["real", "v1"])
def traced(request):
    """(workload, engine, the spans of one profiled frame as
    [(name, [ancestors' names])], the frame's counts)."""
    engine = _engine(request.param)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.draw()
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        ancestors, parent = [], e.cpu_parent
        while parent is not None:
            ancestors.append(parent.name)
            parent = parent.cpu_parent
        spans.append((e.name, ancestors))
    return request.param, engine, spans, profiling.frame_counts()


def _names(spans) -> set[str]:
    return {name for name, _ in spans if name.startswith("vrt.")}


def test_every_span_a_reader_reads_is_emitted(traced):
    workload, _, spans, _ = traced
    names = _names(spans)
    for reader in SPAN_READERS:
        module = _metric(reader)
        read = set(module.SPANS) | set(getattr(module, "INNER", ()))
        expected = read if workload == "real" else read - {"vrt.texture", "vrt.alpha"}
        assert expected <= names, (reader, expected - names)
    if workload == "v1":  # the texture and alpha layers are bypassed
        assert not names & {"vrt.texture", "vrt.alpha"}


def test_spans_nest_as_documented(traced):
    workload, _, spans, _ = traced
    inner_vrt = {}
    for name, ancestors in spans:
        if name.startswith("vrt.") and name != "vrt.frame":
            # every span of a frame lies inside that frame's vrt.frame
            assert "vrt.frame" in ancestors, name
            parent = next((a for a in ancestors if a.startswith("vrt.")), None)
            inner_vrt.setdefault(name, set()).add(parent)
    assert inner_vrt["vrt.nee"] == {"vrt.shade"}
    assert inner_vrt["vrt.shade"] == {"vrt.bounce"}
    assert inner_vrt["vrt.bounce"] == {"vrt.render"}
    assert inner_vrt["vrt.render"] == {"vrt.frame"}
    assert inner_vrt["vrt.sort"] == {"vrt.bounce"}
    assert inner_vrt["vrt.traverse"] <= {"vrt.trace.closest", "vrt.trace.any", "vrt.alpha"}
    if workload == "real":
        assert inner_vrt["vrt.texture"] == {"vrt.shade", "vrt.alpha"}
        assert inner_vrt["vrt.alpha"] <= {"vrt.trace.closest", "vrt.trace.any", "vrt.alpha"}
    bounces = [1 for name, _ in spans if name == "vrt.bounce"]
    assert len(bounces) == Config().max_bounce_count


def test_no_span_takes_a_probe_range_name(traced):
    _, _, spans, _ = traced
    probe_names = set()
    for path in METRICS.glob("*.py"):
        module = _metric(path.stem)
        for key in ("RANGES", "TIMERS", "RECORD"):
            probe_names |= set(getattr(module, key, {}))
    assert probe_names and not any(n.startswith("vrt.") for n in probe_names)
    assert not _names(spans) & probe_names


def test_frame_counts_match_the_hand_count(traced):
    workload, _, _, counts = traced
    r = tile_pixel_coords(W, H, device="cpu")[0].shape[0]
    if workload == "v1":
        assert counts["traversal_calls"] == 8
        assert (counts["traversal_calls.closest"], counts["traversal_calls.any"]) == (4, 4)
        assert counts["traversal_lanes"] == 12 * r
        assert "traversal_lanes.cutout" not in counts
        # the ray count read back, and the pixel size copied from pageable
        # host memory (the copy waits for the stream)
        assert counts["syncs"] == 2
        assert (counts["syncs.rays"], counts["syncs.pixel_size"]) == (1, 1)
    else:
        rounds = 1 + MAX_ALPHA_ITERS
        assert counts["traversal_calls"] == 48
        assert (counts["traversal_calls.closest"], counts["traversal_calls.any"]) == (44, 4)
        assert counts["traversal_lanes"] == 72 * r
        assert counts["traversal_calls.cutout"] == rounds * 8
        assert counts["traversal_lanes.cutout"] == rounds * (4 * r + 4 * 2 * r)
        # the rest go through the opaque view
        assert counts["traversal_lanes"] - counts["traversal_lanes.cutout"] == 4 * r + 4 * 2 * r
        assert counts["syncs"] == 3
        assert counts["syncs.texture_slots"] == 1
    assert not any(k.startswith("syncs.table") for k in counts)  # tables are built


def test_nee_counts_match_the_hand_count(traced):
    """One point-light pick a bounce over the whole wavefront, on the plain
    body for CPU tensors and never on the kernel."""
    _, engine, _, counts = traced
    r = tile_pixel_coords(W, H, device="cpu")[0].shape[0]
    bounces = engine.cfg.max_bounce_count
    assert (counts["nee_calls.plain"], counts["nee_lanes.plain"]) == (bounces, bounces * r)
    assert "nee_calls.kernel" not in counts and "nee_lanes.kernel" not in counts


def test_frame_counts_are_the_last_finished_frame(traced):
    _, engine, _, counts = traced
    engine.draw()
    again = profiling.frame_counts()
    assert again == counts
    again["syncs"] += 100  # a copy: the kept counts do not move
    assert profiling.frame_counts() == counts


def test_spans_cost_no_record_function_when_nothing_records(monkeypatch, traced):
    _, engine, _, _ = traced

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "RANGE", refuse)
    engine.draw()
    assert profiling.trace_scope("vrt.a") is profiling.trace_scope("vrt.b")


def test_counter_readers_read_the_program():
    syncs, lanes = _metric("host_syncs_per_frame"), _metric("traversal_mlanes_per_frame")
    profiling.begin_frame()
    with profiling.host_sync("rays"):
        pass
    profiling.count_traversal("closest", 2_000_000)
    profiling.count_traversal("any", 500_000)
    profiling.end_frame()
    assert syncs.read(None) == 1
    assert lanes.read(None) == pytest.approx(2.5)


def test_counter_readers_read_none_without_the_count(monkeypatch):
    monkeypatch.delattr(profiling, "frame_counts")
    assert _metric("host_syncs_per_frame").read(None) is None
    assert _metric("traversal_mlanes_per_frame").read(None) is None


def _host(*rows):
    """A ``probes.profile_ranges`` host list: (name, ancestors, device ms)."""
    return [{"name": n, "start": 0, "end": 1, "ancestors": list(a), "device_us": ms * 1e3}
            for n, a, ms in rows]


def _run(host, frames=1):
    return SimpleNamespace(ranges={"host": host, "device": [], "wall_s": 1.0,
                                   "frames": frames, "ranges": []})


# one frame's spans: the device ms of a span includes its children's
FRAME = _host(
    ("vrt.frame", [], 100.0),
    ("vrt.shade", ["vrt.bounce", "vrt.frame"], 30.0),
    ("vrt.nee", ["vrt.shade", "vrt.bounce", "vrt.frame"], 8.0),
    ("sample_point_light", ["vrt.nee", "vrt.shade", "vrt.bounce", "vrt.frame"], 8.0),
    ("vrt.texture", ["vrt.shade", "vrt.bounce", "vrt.frame"], 5.0),
    ("vrt.shade", ["vrt.bounce", "vrt.frame"], 10.0),
    ("vrt.alpha", ["vrt.trace.closest", "vrt.bounce", "vrt.frame"], 12.0),
    ("vrt.alpha", ["vrt.alpha", "vrt.trace.closest", "vrt.bounce", "vrt.frame"], 9.0),
    ("vrt.texture", ["vrt.alpha", "vrt.alpha", "vrt.trace.closest", "vrt.bounce",
                     "vrt.frame"], 4.0),
    ("vrt.texture", ["vrt.texture", "vrt.alpha", "vrt.trace.closest", "vrt.frame"], 4.0),
    ("vrt.sort", ["vrt.bounce", "vrt.frame"], 1.5),
    ("vrt.sort", ["vrt.bounce", "vrt.frame"], 1.5),
)


@pytest.mark.parametrize("reader, frames, want", [
    ("nee_span_ms", 1, 8.0),
    ("sort_span_ms", 1, 3.0),
    ("texture_span_ms", 1, 9.0),            # outermost: the nested tap once
    ("alpha_span_ms", 1, 12.0 - 4.0),       # less the taps inside
    ("shade_span_ms", 1, 40.0 - 8.0 - 5.0),  # less NEE and the taps inside
    ("shade_span_ms", 2, (40.0 - 8.0 - 5.0) / 2),
])
def test_span_readers_subtract_nested_spans(reader, frames, want):
    assert _metric(reader).read(_run(FRAME, frames)) == pytest.approx(want)


@pytest.mark.parametrize("reader", SPAN_READERS)
def test_span_readers_read_none_without_their_span(reader):
    without = [row for row in FRAME if row["name"] not in _metric(reader).SPANS]
    assert _metric(reader).read(_run(without)) is None


@pytest.mark.parametrize("path", sorted(p.name for p in METRICS.glob("*.py")))
def test_every_probe_target_resolves(path):
    """Each dotted path a reader's probes wrap (``RANGES``, ``TIMERS``,
    ``RECORD``) names a function of the program, so a rename cannot empty
    its layer unseen."""
    module = _metric(Path(path).stem)
    for key in ("RANGES", "TIMERS", "RECORD"):
        for target in getattr(module, key, {}).values():
            fn = probes.resolve(target)
            assert callable(fn), target
            assert probes.bindings(fn), target


def test_render_profile_writes_a_trace_with_the_spans(tmp_path):
    out = tmp_path / "trace"
    rc = cli.main(["render", "--scene", "cornell", "--device", "cpu", "--width", "16",
                   "--height", "16", "--spp", "2", "--out", str(tmp_path / "x.png"),
                   "--profile", str(out)])
    assert rc == 0 and (tmp_path / "x.png").exists()
    (trace,) = out.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "vrt.frame" in names
    assert {"vrt.setup.build_scene_bvh", "vrt.setup.build_scene_bvh.sah",
            "vrt.setup.build_scene_bvh.collapse", "vrt.systems", "vrt.render"} <= names


def _x(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_by_span_puts_each_gap_down_to_the_innermost_span():
    events = [
        # a first frame, skipped below
        _x("vrt.frame", 0, 50), _x("vrt.shade", 5, 40),
        # the frame read: device busy over [110, 130] and [150, 190]
        _x("vrt.frame", 100, 100), _x("vrt.render", 102, 96),
        _x("vrt.shade", 120, 40), _x("vrt.nee", 122, 6),
        _x("vrt.sync.rays", 185, 14), _x("vrt.frame", 150, 40, "gpu_user_annotation"),
        _x("k0", 110, 20, "kernel"), _x("copy", 150, 10, "gpu_memcpy"),
        _x("k1", 160, 30, "kernel"), _x("aten::mul", 130, 5),
        {"ph": "i", "name": "vrt.mark", "ts": 140},
    ]
    out = idle_by_span.idle_by_span(events, skip=1)
    assert out["frames"] == 1 and out["wall_ms"] == pytest.approx(0.1)
    # gaps [100, 110) in vrt.frame then vrt.render from 102, [130, 150) in
    # vrt.shade (vrt.nee closed at 128), [190, 200) in vrt.sync.rays
    assert out["idle_ms_by_span"] == pytest.approx(
        {"vrt.frame": 0.010, "vrt.shade": 0.020, "vrt.sync.rays": 0.010})
    assert out["idle_ms"] == pytest.approx(0.040)
    assert idle_by_span.idle_by_span(events)["frames"] == 2


def test_idle_by_span_reads_a_written_trace(tmp_path, capsys):
    """A CPU run's trace has no device activity: every frame is idle, all of
    it put down to spans of the frame."""
    out = tmp_path / "trace"
    assert cli.main(["render", "--scene", "cornell", "--device", "cpu", "--width", "16",
                     "--height", "16", "--spp", "3", "--out", str(tmp_path / "x.png"),
                     "--profile", str(out)]) == 0
    (trace,) = out.glob("*.json")
    assert idle_by_span.main([str(trace), "--skip", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["frames"] == 2
    assert result["idle_ms"] == pytest.approx(result["wall_ms"])
    assert sum(result["idle_ms_by_span"].values()) == pytest.approx(result["idle_ms"])
    assert all(name.startswith("vrt.") for name in result["idle_ms_by_span"])


def test_hybrid_frame_emits_its_stage_spans():
    from vulkanraytracing_torch.app.events import Key
    from vulkanraytracing_torch.scene.procedural import cornell_box_scene

    scene = build_scene_bvh(cornell_box_scene(device="cpu"), builder="sah")
    cfg = Config(width=W, height=H, camera=CameraConfig(position=(0.0, 0.0, 3.2),
                                                        aspect_ratio=1.0))
    engine = Engine(cfg, scene, device="cpu")
    engine.inject_key(Key.T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.draw()
    stages = {e.name: e.cpu_parent.name for e in prof.events()
              if e.name.startswith("vrt.hybrid.")}
    assert stages == {f"vrt.hybrid.{s}": "vrt.render"
                      for s in ("gbuffer", "shadow", "lights", "ibl", "sky")}
    assert profiling.frame_counts()["syncs.pixel_size"] == 1
