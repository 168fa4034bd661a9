"""``tracking.graph_replay_share``: its entry in ``BENCHMARK.json`` (all three
cells), and its reader, which divides the program's ``track_graph_replays``
counter by the tracking iterations and is silent where the program lacks
the counter or ran no iteration."""

import math

from slambench.lib.catalog import load_benchmark, metric_reader
from slambench.tests.tiny import REPO

NAME = "tracking.graph_replay_share"


def test_entry_in_the_benchmark():
    bench = load_benchmark(REPO)
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "pose tracking, slam/tracking.py", "moves": "fps",
                 "workloads": [w["name"] for w in bench["workloads"]]}


def test_reader_divides_replays_by_iterations():
    read = metric_reader(REPO, NAME)
    ctx = lambda t: {"window": {"frames": 4, "timings": t}}
    assert math.isclose(read(ctx({"n_track.iter": 400, "track_graph_replays": 398})), 99.5)
    assert read(ctx({"n_track.iter": 400, "track.iter": 1.0})) is None
    assert read(ctx({"n_track.iter": 0, "track_graph_replays": 0})) is None
