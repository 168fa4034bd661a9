"""A configuration, a traffic mix, a cell and a metric reader dropped into a
checkout are found by name, with no edit to the harness: a whole run on the
CPU at a tiny size. The same run's process holds no JAX module."""

import json
import shutil

from slambench.lib.harness import forbidden_modules
from slambench.tests.tiny import cpu_run, short_init, tiny_root


def test_new_files_make_a_new_cell(tmp_path, monkeypatch):
    short_init(monkeypatch)
    root = tiny_root(tmp_path)
    sb = root / "slambench"
    cfg = json.loads((sb / "configs" / "tum1.json").read_text())
    cfg["name"] = "tum1b"
    (sb / "configs" / "tum1b.json").write_text(json.dumps(cfg))
    shutil.copy(sb / "traffic" / "desk.json", sb / "traffic" / "desk2.json")
    shutil.copy(sb / "limits" / "tum1.desk.json", sb / "limits" / "tum1b.desk2.json")
    (sb / "metrics" / "frames.count.py").write_text(
        "def read(ctx):\n    return ctx['window']['frames']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tum1b.desk2", "config": "tum1b", "traffic": "desk2",
                               "chips": 1, "why": "a cell made of new files only"})
    bench["end_to_end"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tum1b.desk2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = cpu_run(root, "tum1b.desk2")
    assert res["metrics"]["frames.count"]["value"] == res["attempted"] >= 1
    assert {"fps", "psnr_db", "setup_s"} <= set(res["metrics"])
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert forbidden_modules() == []
