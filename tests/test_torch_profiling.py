"""``utils.profiling`` on the CPU: ``trace_scope``'s name is a range in a
``torch.profiler`` trace while a session records and a shared no-op
context otherwise, and ``span`` is the same around a whole function;
``profile_to`` writes a Chrome trace holding the ranges and the
operators run inside it."""

import json

import torch

from vulkanraytracing_torch.utils import profiling
from vulkanraytracing_torch.utils.profiling import profile_to, span, trace_scope


def test_trace_scope_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_scope("vrt test scope"):
            torch.ones(64).cumsum(0)
    assert "vrt test scope" in {e.name for e in prof.events()}


def test_trace_scope_off_path(monkeypatch):
    """With no profiler session a span is the shared no-op context: no
    ``record_function``, nothing timed, nothing logged."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "RANGE", refuse)
    span = trace_scope("quiet scope")
    assert span is trace_scope("another scope")
    with span:
        torch.zeros(8).sum()


def test_span_wraps_a_whole_function(monkeypatch):
    @span("vrt test function")
    def add(x, y=1):
        """Adds."""
        return x + y

    assert (add.__name__, add.__doc__) == ("add", "Adds.")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert add(1, y=2) == 3
    (event,) = [e for e in prof.events() if e.name == "vrt test function"]

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler session")

    monkeypatch.setattr(profiling, "RANGE", refuse)
    assert add(2) == 3


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
