"""The ``kitti00.street`` cell on the CPU at a tiny size: its files load,
the configuration carries KITTI00-02.yaml's values and runs through the
stereo entry point, a traced run is judged correct and reports both stereo
metrics, and the plain reference of ComputeStereoMatches agrees with the
program on the run's own frames."""

import json

import numpy as np

from slambench.lib.catalog import metric_reader
from slambench.lib.sequence import sensor_of
from slambench.reference import stereo as RS
from slambench.tests.tiny import REPO, cpu_run, short_init, tiny_root

CELL = "kitti00.street"
NEW = ("frontend.stereo_ms_per_frame", "frontend.stereo_match_share")


def test_configuration_is_the_source():
    cfg = json.loads((REPO / "slambench" / "configs" / "kitti00.json").read_text())
    s = cfg["system"]
    assert sensor_of(cfg) == "stereo" and cfg["reduced"] == []
    assert s["Camera"] == {"width": 1241, "height": 376, "fx": 718.856, "fy": 718.856,
                           "cx": 607.1928, "cy": 185.2157, "fps": 10.0, "RGB": 1}
    assert (s["Camera.bf"], s["ThDepth"]) == (386.1448, 35.0)
    assert abs(s["Camera.bf"] / s["Camera"]["fx"] - 0.537) < 1e-3
    assert [s[f"ORBextractor.{k}"] for k in ("nFeatures", "scaleFactor", "nLevels",
                                             "iniThFAST", "minThFAST")] == [2000, 1.2, 8, 20, 7]
    assert s["Debug"]["useLoop"] is True
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kitti00", "street", 1)
    for m in bench["per_layer"]:
        assert CELL in m["workloads"]
    assert [m["name"] for m in bench["per_layer"][-2:]] == list(NEW)


def _tiny_kitti(tmp_path):
    """``tiny_root``'s 128 px cut of the cell, 64 rows tall (39 would leave
    ORB's 19 px border no room) and the baseline kept (``Camera.bf`` cut
    with fx)."""
    root = tiny_root(tmp_path, CELL)
    path = root / "slambench" / "configs" / "kitti00.json"
    cfg = json.loads(path.read_text())
    cam = cfg["system"]["Camera"]
    s = 128.0 / 1241.0
    cfg["system"]["Camera.bf"] *= s
    cam["cy"] += (64 - cam["height"]) / 2.0
    cam["height"] = 64
    path.write_text(json.dumps(cfg))
    return root


def test_tiny_kitti_run(tmp_path, monkeypatch):
    import gsorb_slam_tpu_torch.slam.system as S

    short_init(monkeypatch)
    calls = []
    orig = S.compute_stereo_matches

    def keep(fL, fR, bf, min_z, scale_factors, levels_l, levels_r, **kw):
        out = orig(fL, fR, bf, min_z=min_z, scale_factors=scale_factors, levels_l=levels_l,
                   levels_r=levels_r, **kw)
        calls.append((fL, fR, bf, min_z, scale_factors, levels_l, levels_r, out))
        return out

    monkeypatch.setattr(S, "compute_stereo_matches", keep)
    res = cpu_run(_tiny_kitti(tmp_path), CELL, trace=True)
    assert res["correct"] is True, res["checks"]
    for name in NEW:
        assert name in res["metrics"] and np.isfinite(res["metrics"][name]["value"]), name
    assert 0 < res["metrics"]["frontend.stereo_match_share"]["value"] <= 100
    assert res["metrics"]["frontend.stereo_ms_per_frame"]["value"] > 0
    assert len(calls) >= res["attempted"] + 2
    n_valid = 0
    for fL, fR, bf, min_z, sf, lv_l, lv_r, out in calls[:4]:
        ref = RS.compute_stereo_matches(fL, fR, lv_l, lv_r, bf, min_z, sf)
        for k in ("u_right", "depth", "valid"):
            np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k].numpy())
        n_valid += int(out.valid.sum())
    assert n_valid > 0


def test_stereo_metrics_silent_without_the_spans():
    t = {"frontend": 1.0, "kf": 0.5}
    ctx = {"window": {"frames": 3, "timings": t}}
    for name in NEW:
        assert metric_reader(REPO, name)(ctx) is None
    t.update({"fe.stereo_depth": 0.3, "fe.stereo_orb": 0.2, "fe.stereo_match": 0.1,
              "stereo_keypoints": 400, "stereo_matches": 100})
    assert abs(metric_reader(REPO, NEW[0])(ctx) - 200.0) < 1e-9
    assert metric_reader(REPO, NEW[1])(ctx) == 25.0
    t["stereo_keypoints"] = 0
    assert metric_reader(REPO, NEW[1])(ctx) is None
