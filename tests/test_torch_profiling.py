"""``utils.profiling`` on the CPU: ``trace_scope``'s name is a range in a
``torch.profiler`` trace and ``log=True`` logs its milliseconds as a
``[TIME]`` line on stderr (as the JAX package's ``trace_scope`` does
through its ``log_t``); ``profile_to`` writes a Chrome trace holding the
ranges and the operators run inside it."""

import json

import torch

from vulkanraytracing_torch.utils.profiling import profile_to, trace_scope


def test_trace_scope_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_scope("vrt test scope"):
            torch.ones(64).cumsum(0)
    assert "vrt test scope" in {e.name for e in prof.events()}


def test_trace_scope_logs(capsys):
    with trace_scope("quiet scope"):
        pass
    assert "quiet scope" not in capsys.readouterr().err
    with trace_scope("timed scope", log=True):
        torch.zeros(8).sum()
    err = capsys.readouterr().err
    assert "[TIME] timed scope:" in err and " ms" in err


def test_profile_to_writes_a_trace(tmp_path):
    out = tmp_path / "traces"
    with profile_to(out) as prof:
        with trace_scope("vrt frame"):
            (torch.arange(1000.0) * 2.0).sum()
    assert prof is not None
    files = list(out.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "vrt frame" in names
    assert any(str(n).startswith("aten::") for n in names)
