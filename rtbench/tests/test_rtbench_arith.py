"""The benchmark's arithmetic on synthetic events (CPU)."""

import json
import statistics
import types
from pathlib import Path

import pytest

from rtbench import run, yardstick

ROOT = Path(run.__file__).resolve().parent


def test_percentile_is_the_inclusive_order_statistic():
    values = [float(v) for v in range(1, 101)]          # 1..100
    assert yardstick.percentile(values, 90) == pytest.approx(90.1)
    assert yardstick.percentile([5.0], 90) == 5.0
    shuffled = [3.0, 1.0, 2.0, 10.0, 4.0]
    assert yardstick.percentile(shuffled, 90) == pytest.approx(
        statistics.quantiles(shuffled, n=10, method="inclusive")[8])


def test_busy_union_and_gaps():
    intervals = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0), (30.0, 30.0)]
    assert yardstick.busy_union(intervals) == 17.0
    assert yardstick.idle_gaps(intervals, 0.0, 40.0) == [(12.0, 20.0), (25.0, 30.0), (30.0, 40.0)]
    assert yardstick.idle_gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_traversal_bound_takes_the_larger_side():
    # 1e6 rays closest: 49 MB; 1000 triangles: 48 kB; bytes bound 0.01464 ms
    by_bytes = yardstick.traversal_bound_ms("closest", 10**6, 1000, 0, 0)
    assert by_bytes == pytest.approx((49e6 + 48e3) / 3.35e12 * 1e3)
    # 1e9 box tests: 25e9 operations over 67e12 = 0.3731 ms
    by_ops = yardstick.traversal_bound_ms("any", 10, 10, 10**9, 0)
    assert by_ops == pytest.approx(25e9 / 67e12 * 1e3)
    assert yardstick.traversal_bound_ms("any", 0, 0, 0, 10**6) == pytest.approx(56e6 / 67e12 * 1e3)


def _host(name, device_us, ancestors=()):
    return {"name": name, "start": 0.0, "end": 1.0, "ancestors": list(ancestors),
            "device_us": device_us}


def test_ranges_count_outermost_calls_once():
    host = [
        _host("_closest_alpha_subset", 1000.0),
        _host("_resolve_alpha", 800.0, ["_closest_alpha_subset"]),
        _host("_hit_alpha", 300.0, ["_resolve_alpha", "_closest_alpha_subset"]),
        _host("sample_pool", 200.0, ["_hit_alpha", "_resolve_alpha", "_closest_alpha_subset"]),
        _host("_hit_alpha", 50.0, ["trace_any"]),
        _host("sample_pool", 40.0, ["_hit_alpha"]),
        _host("sample_pool", 70.0, ["unpack_material"]),
        _host("sample_pool", 5.0, ["sample_pool"]),
    ]
    alpha = ("_hit_alpha", "_resolve_alpha", "_closest_alpha_subset")
    assert yardstick.range_device_ms(host, alpha) == pytest.approx(1.05)
    assert yardstick.range_device_ms(host, ["sample_pool"]) == pytest.approx(0.31)
    assert yardstick.range_device_ms(host, ["sample_pool"], inside=alpha) == pytest.approx(0.24)


def test_readers_on_a_synthetic_run():
    r = types.SimpleNamespace(
        frame_s=[0.1, 0.2, 0.3, 0.4], window_s=1.0, setup_s=12.5, window_rays=5e8,
        setup_stages={"scene_load": 1.5, "bvh_build": 2.0},
        device_profile={"events": [("k", 0.0, 100.0), ("k", 50.0, 150.0), ("c", 300.0, 400.0)],
                        "wall_s": 500e-6, "frames": 2})

    def read(name):
        return run.load_module(ROOT / "metrics" / f"{name}.py").read(r)

    assert read("frame_ms") == pytest.approx(250.0)
    assert read("frame_ms_p90") == pytest.approx(370.0)
    assert read("setup_s") == 12.5
    assert read("mrays_per_s") == pytest.approx(500.0)
    assert read("device_idle_pct") == pytest.approx(100.0 * (1.0 - 250.0 / 500.0))
    assert read("device_ops_per_frame") == 1.5
    assert read("scene_load_s") == 1.5
    assert read("ibl_bake_s") is None


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    for entry in bench["end_to_end"] + bench["per_layer"]:
        module = run.load_module(ROOT / "metrics" / f"{entry['name']}.py")
        assert callable(module.read), entry["name"]


def test_kernel_labels_keep_the_template():
    where = ("void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)"
             "::where_kernel_impl(at::TensorIterator&)::{lambda()#1}>(int, float)")
    assert run.kernel_label(where) == ("void at::native::vectorized_elementwise_kernel<2, "
                                       "at::native::{anonymous}::where_kernel_impl")
    assert run.kernel_label("void vrt::traverse_kernel<vrt::Bvh8, true, false>(int*)") == \
        "void vrt::traverse_kernel<vrt::Bvh8, true, false>"
    assert len(run.kernel_label("k" * 500)) == 200


def _event(name, device, start, end):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(name=name, device_type=getattr(DeviceType, device),
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_device_events_leave_out_the_annotations_of_host_ranges():
    """kineto's device-side copy of a host range (named as the range) is no
    work: with it, ``vrt.frame`` would cover every idle gap of the frame."""
    from rtbench import probes

    events = [_event("vrt.frame", "CPU", 0.0, 100.0), _event("vrt.sort", "CPU", 10.0, 40.0),
              _event("cudaLaunchKernel", "CPU", 11.0, 12.0),
              _event("vrt.frame", "CUDA", 15.0, 90.0), _event("vrt.sort", "CUDA", 15.0, 30.0),
              _event("sort_kernel", "CUDA", 15.0, 20.0), _event("gather", "CUDA", 60.0, 90.0)]
    prof = types.SimpleNamespace(events=lambda: events)
    kept = probes._device_events(prof)
    assert kept == [("sort_kernel", 15.0, 20.0), ("gather", 60.0, 90.0)]
    assert yardstick.idle_gaps([(s, e) for _, s, e in kept], 0.0, 100.0) == \
        [(0.0, 15.0), (20.0, 60.0), (90.0, 100.0)]
    # a device-only profile has no host ranges: every device event stays
    device_only = types.SimpleNamespace(events=lambda: events[3:])
    assert len(probes._device_events(device_only)) == 4
