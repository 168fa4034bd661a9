"""``mapping.ssim_kernel_share``: its entry in ``BENCHMARK.json`` (all three
cells), and its reader, which divides the program's ``map_ssim_kernels``
counter by the mapping iterations and is silent where the program lacks
the counter or ran no iteration."""

import math

from slambench.lib.catalog import load_benchmark, metric_reader
from slambench.tests.tiny import REPO

NAME = "mapping.ssim_kernel_share"


def test_entry_in_the_benchmark():
    bench = load_benchmark(REPO)
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "map phase, slam/system.py map block and slam/mapping.py",
                 "moves": "fps", "workloads": [w["name"] for w in bench["workloads"]]}


def test_reader_divides_launches_by_iterations():
    read = metric_reader(REPO, NAME)
    ctx = lambda t: {"window": {"frames": 4, "timings": t}}
    assert math.isclose(read(ctx({"n_map.iter": 400, "map_ssim_kernels": 400})), 100.0)
    assert math.isclose(read(ctx({"n_map.iter": 400, "map_ssim_kernels": 0})), 0.0)
    assert read(ctx({"n_map.iter": 400, "map_prep_kernels": 400})) is None
    assert read(ctx({"n_map.iter": 0, "map_ssim_kernels": 0})) is None
