"""The per-layer metrics read from the program's spans and counters: a
traced run of each cell on the CPU at a tiny size reports every one as a
finite number beside the metrics the benchmark had; each reader divides
what it names; and against a program without the spans (the System's
timers alone) each reader is silent instead of raising."""

import json
import math

import pytest

from slambench.lib.catalog import metric_reader
from slambench.tests.tiny import REPO, cpu_run, short_init, tiny_root

SPAN_METRICS = {
    "tracking.launch_ms_per_iter": ("program_span", "ms"),
    "tracking.wait_ms_per_iter": ("program_span", "ms"),
    "tracking.bins_ms_per_frame": ("program_span", "ms"),
    "mapping.launch_ms_per_iter": ("program_span", "ms"),
    "mapping.wait_ms_per_frame": ("program_span", "ms"),
    "mapping.splats_added_per_frame": ("program_counter", "splats"),
    "frontend.loop_ms_per_frame": ("program_span", "ms"),
    "system.waits_per_frame": ("program_counter", "reads"),
}
# The per-layer metrics the benchmark had before them, and their sources.
EARLIER = {
    "tracking.ms_per_iter": "program_span",
    "tracking.iters_per_frame": "program_counter",
    "mapping.ms_per_frame": "program_span",
    "frontend.ms_per_frame": "program_span",
    "system.frame_ms.p90": "host_clock",
    "kernels.track_roofline": "device_trace",
    "kernels.map_roofline": "device_trace",
    "device.idle": "device_trace",
}
# Counters read after them (the mapping graphs' replays).
LATER = {"mapping.graph_replay_share": ("program_counter", "%")}
CELLS = ["tum1.desk", "replica.room0"]


def reader(name):
    return metric_reader(REPO, name)


def test_entries_in_the_benchmark():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = bench["per_layer"]
    assert {m["name"]: m["source"] for m in per_layer[:len(EARLIER)]} == EARLIER
    new = {m["name"]: m for m in per_layer[len(EARLIER):]}
    assert set(new) == set(SPAN_METRICS) | set(LATER)
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for name, (source, unit) in {**SPAN_METRICS, **LATER}.items():
        m = new[name]
        assert (m["source"], m["unit"], m["moves"], m["workloads"]) == (source, unit, "fps",
                                                                         CELLS)


def test_readers_divide_what_they_name():
    t = {"track": 3.0, "n_track": 4, "track.iter": 1.0, "n_track.iter": 500,
         "track.wait": 1.5, "track.bins": 0.2, "map": 8.0, "n_map": 4, "map.iter": 2.0,
         "n_map.iter": 400, "map.wait": 0.8, "splats_added": 1000, "kf.loop": 5.0,
         "n_frame.wait": 8, "n_frontend.wait": 5, "n_track.wait": 500, "n_kf.wait": 3,
         "n_map.wait": 40}
    ctx = {"window": {"frames": 5, "timings": t}}
    want = {
        "tracking.launch_ms_per_iter": 2.0, "tracking.wait_ms_per_iter": 3.0,
        "tracking.bins_ms_per_frame": 50.0, "mapping.launch_ms_per_iter": 5.0,
        "mapping.wait_ms_per_frame": 200.0, "mapping.splats_added_per_frame": 250.0,
        "frontend.loop_ms_per_frame": 1000.0, "system.waits_per_frame": 111.2,
    }
    for name, value in want.items():
        assert math.isclose(reader(name)(ctx), value), name


def test_readers_silent_on_the_timers_alone():
    """A System with the four timers only (no spans) reads as no value."""
    t = {"track": 3.0, "map": 8.0, "n_track": 4, "n_map": 4, "frontend": 1.0, "kf": 2.0,
         "n_kf": 4}
    ctx = {"window": {"frames": 5, "timings": t}}
    for name in SPAN_METRICS:
        assert reader(name)(ctx) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(tmp_path, monkeypatch, cell):
    short_init(monkeypatch)
    res = cpu_run(tiny_root(tmp_path, cell), cell, trace=True)
    metrics = res["metrics"]
    for name, (_source, unit) in SPAN_METRICS.items():
        assert name in metrics, name
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["unit"] == unit
    assert metrics["tracking.launch_ms_per_iter"]["value"] > 0
    assert metrics["system.waits_per_frame"]["value"] > 0
    for name in ("tracking.ms_per_iter", "tracking.iters_per_frame", "mapping.ms_per_frame",
                 "frontend.ms_per_frame", "system.frame_ms.p90"):
        assert name in metrics, name
    assert res["correct"] is True
