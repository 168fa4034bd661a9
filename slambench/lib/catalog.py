"""Finding a cell's pieces by name: everything that belongs to one
configuration, traffic mix, cell or metric is a file of its own.

- ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
- ``slambench/configs/<config>.json``: the settings passed to ``System``,
  the tiling and optimizer the reference follows, the stated precision;
- ``slambench/traffic/<traffic>.json``: scene, path, shake, sensor, frame
  counts;
- ``slambench/scenes/<scene>.json``: the room the generator ray-casts;
- ``slambench/limits/<cell>.json``: the check's numbers and their limits;
- ``slambench/metrics/<metric>.py``: a reader ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def _json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / "slambench" / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"missing {path.relative_to(root)}")
    return json.loads(path.read_text())


def config(root: Path, name: str) -> dict:
    return _json(root, "configs", name)


def traffic(root: Path, name: str) -> dict:
    return _json(root, "traffic", name)


def scene_path(root: Path, name: str) -> Path:
    return Path(root) / "slambench" / "scenes" / f"{name}.json"


def limits(root: Path, cell: str) -> dict[str, float]:
    return {k: float(v["limit"]) for k, v in _json(root, "limits", cell)["numbers"].items()}


def metric_reader(root: Path, name: str) -> Callable[[dict], Any]:
    path = Path(root) / "slambench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"missing metric reader {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    without ``--trace``, its per-layer metrics with it (a metric with a
    ``workloads`` list only in the cells it lists)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
