"""A tiny copy of a cell for the CPU: a checkout root in a temporary
directory with ``BENCHMARK.json`` and the benchmark's data files, the
configuration cut to 128x96 and a few iterations."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, cell: str = "tum1.desk", track_iters: int = 12, map_iters: int = 6,
              eval_frames: int = 4) -> Path:
    root = Path(tmp)
    sb = root / "slambench"
    for d in ("configs", "traffic", "scenes", "limits", "metrics"):
        shutil.copytree(REPO / "slambench" / d, sb / d, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    cfg_path = sb / "configs" / f"{w['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    cam = cfg["system"]["Camera"]
    s = 128.0 / cam["width"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] * s
    cam["width"], cam["height"] = 128, int(round(cam["height"] * s))
    cfg["raster"]["dilate_px"] = 2.0  # the System's tiling below 400 px of width
    cfg["system"]["Tracking"]["numIters"] = track_iters
    cfg["system"]["Mapping"]["numIters"] = map_iters
    cfg_path.write_text(json.dumps(cfg))
    tr_path = sb / "traffic" / f"{w['traffic']}.json"
    tr = json.loads(tr_path.read_text())
    tr.update(n_frames=eval_frames + 12, eval_frames=eval_frames)
    tr_path.write_text(json.dumps(tr))
    return root


STEREO_CELL = "tiny_stereo.desk_stereo"


def tiny_stereo_root(tmp: Path, gray: bool = True, **kw) -> Path:
    """``tiny_root``'s ``tum1.desk`` and beside it a stereo cell
    (``STEREO_CELL``) written into the temporary root only: ``tum1`` cut to
    128 px as a rectified pair (``"sensor": "stereo"``, no distortion, the
    baseline of ``Camera.bf / fx`` kept), the desk traffic with a gray
    sensor, ``tum1.desk``'s limits."""
    root = tiny_root(tmp, "tum1.desk", **kw)
    sb = root / "slambench"
    cfg = json.loads((sb / "configs" / "tum1.json").read_text())
    sysc = cfg["system"]
    sysc["Camera.bf"] = sysc["Camera.bf"] * 128.0 / 640.0
    for k in ("k1", "k2", "p1", "p2", "k3"):
        sysc[f"Camera.{k}"] = 0.0
    cfg.update(name="tiny_stereo", sensor="stereo")
    (sb / "configs" / "tiny_stereo.json").write_text(json.dumps(cfg))
    tr = json.loads((sb / "traffic" / "desk.json").read_text())
    tr["sensor"] = dict(tr["sensor"], gray=gray)
    (sb / "traffic" / "desk_stereo.json").write_text(json.dumps(tr))
    shutil.copy(sb / "limits" / "tum1.desk.json", sb / "limits" / f"{STEREO_CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": STEREO_CELL, "config": "tiny_stereo",
                               "traffic": "desk_stereo", "chips": 1,
                               "why": "the stereo entry point at a tiny size"})
    for m in bench["per_layer"]:
        m["workloads"].append(STEREO_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def short_init(monkeypatch, iters: int = 10) -> None:
    """Frame 0's warm-up mapping cut to ``iters`` iterations (the System's
    ``init_iters`` is not a configuration key), so a CPU run takes seconds."""
    import dataclasses

    import gsorb_slam_tpu_torch.slam.system as S

    orig = S.load_config

    def load(x):
        c = orig(x)
        return dataclasses.replace(c, mapping=dataclasses.replace(c.mapping, init_iters=iters))

    monkeypatch.setattr(S, "load_config", load)


def cpu_run(root: Path, cell: str = "tum1.desk", seed: int = 2**31 + 12345, trace: bool = False,
            control: bool = False) -> dict:
    import torch

    from slambench.lib.harness import run_cell

    return run_cell(root, cell, seed, 0.5, trace, torch.device("cpu"), control=control)
