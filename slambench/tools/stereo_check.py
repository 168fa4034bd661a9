#!/usr/bin/env python3
"""The program's ComputeStereoMatches on the card against the plain
reference (``slambench/reference/stereo.py``), on every frame of a run of
a stereo cell:

    python3 slambench/tools/stereo_check.py --workload kitti00.street --seed <n> \\
        [--seconds <s>] [--out <dir>]

The cell runs as ``slambench/run.py`` runs it (``run_cell``: the cell's
traffic, seed and window), with ``compute_stereo_matches`` wrapped where
``track_stereo`` calls it: each call's inputs (keypoints, descriptors,
both pyramids, ``bf``, ``minZ``, the scale factors) and outputs are copied
to the host. After the run the reference recomputes every call on the CPU
from the same inputs. Per frame, and over the window's (timed) frames:

- the match sets: ``valid`` equal, except on keypoints whose decision sits
  within rounding of its threshold (the two least SAD distances within
  1e-5 of each other, the distance within 1e-5 of the median filter's
  threshold, or the disparity within 1e-4 px of 0 or maxD), which are
  counted and reported, never dropped from the count of disagreements;
- the largest ``|u_right|`` gap over keypoints valid on both sides, at
  most 1e-3 px;
- the 90th percentile of the relative depth gap, at most 1e-5.

Why these tolerances: both sides compute in float32 from the same
pyramid, and the only rounding that can differ is the order of the SAD
sums (float64 on both sides, then float32): one float32 unit in a
distance moves ``deltaR`` by ~1e-6 and ``uR`` by under 1e-5 px at the
coarsest octave (scale 3.58), so 1e-3 px leaves a hundredfold margin.
Dropping the parabola moves ``uR`` by ``scale * deltaR``, up to 0.5 level
pixels: the run reports that gap and its depth gap beside the tolerances
("without the parabola"), so the check's power shows in every run.

Each frame's row also gives the stereo spans' milliseconds (with the
host copies of the recording inside ``fe.stereo_match``, so they time the
check, not the program). Exit 0 when every frame is within the
tolerances, 1 otherwise; the last line of standard output is a JSON
summary, also written under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# The environment of a benchmark run (slambench/run.py).
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = "4"
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

UR_TOL = 1e-3  # px
DEPTH_TOL = 1e-5  # relative, 90th percentile
NEAR_SAD = 1e-5  # relative: an argmin or a median decision within rounding
NEAR_DISP = 1e-4  # px: a disparity gate within rounding


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if hasattr(x, "_replace"):
        return type(x)(*(_host(v) if torch.is_tensor(v) else v for v in x))
    if isinstance(x, list):
        return [_host(v) for v in x]
    return x


def compare(call: dict) -> dict:
    """One call: the program's output against the reference's."""
    from slambench.reference import stereo as RS

    ref = RS.compute_stereo_matches(call["fL"], call["fR"], call["levels_l"], call["levels_r"],
                                    call["bf"], call["min_z"], call["scale_factors"])
    out = call["out"]
    v_p, v_r = out.valid.numpy(), ref["valid"].numpy()
    dist, second = ref["dist"].numpy(), ref["second"].numpy()
    disp = ref["disparity"].numpy()
    max_d = float(np.float32(call["bf"]) / np.float32(call["min_z"]))
    with np.errstate(invalid="ignore"):
        near = ((np.abs(second - dist) <= NEAR_SAD * np.maximum(dist, 1e-30))
                | (np.abs(dist - ref["th_dist"]) <= NEAR_SAD * ref["th_dist"])
                | (np.abs(disp) <= NEAR_DISP) | (np.abs(disp - max_d) <= NEAR_DISP))
    differ = v_p != v_r
    both = v_p & v_r
    u_p, u_r = out.u_right.numpy(), ref["u_right"].numpy()
    z_p, z_r = out.depth.numpy(), ref["depth"].numpy()
    ur_gap = float(np.abs(u_p - u_r)[both].max()) if both.any() else 0.0
    rel = np.abs(z_p - z_r)[both] / np.maximum(z_r[both], 1e-12)
    depth_p90 = float(np.quantile(rel, 0.9)) if both.any() else 0.0
    # Without the parabola: uR at the best whole shift.
    sf = torch.as_tensor(call["scale_factors"]).cpu().numpy()
    octave = call["fL"].octave.numpy()
    delta = np.nan_to_num(ref["delta"].numpy())
    u_flat = u_r - sf[np.clip(octave, 0, len(sf) - 1)] * delta
    u_l = call["fL"].uv[:, 0].numpy()
    flat_gap = np.abs(u_flat - u_r)[v_r]
    flat_rel = np.abs(call["bf"] / np.maximum(u_l - u_flat, 0.01) - z_r)[v_r] / z_r[v_r]
    return dict(keypoints=int(call["fL"].valid.sum()), program=int(v_p.sum()),
                reference=int(v_r.sum()), differ=int(differ.sum()),
                differ_near=int((differ & near).sum()), differ_far=int((differ & ~near).sum()),
                ur_gap=ur_gap, depth_p90=depth_p90,
                flat_ur_gap=float(flat_gap.max()) if v_r.any() else 0.0,
                flat_depth_p90=float(np.quantile(flat_rel, 0.9)) if v_r.any() else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kitti00.street")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--out", default=str(ROOT / "build" / "stereo_check"),
                    help="where the summary and per-frame rows go")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose BENCHMARK.json and slambench/ files define the cell")
    args = ap.parse_args(argv)
    root = Path(args.root)
    torch.set_num_threads(4)

    import gsorb_slam_tpu_torch.slam.system as S
    from slambench.lib import catalog
    from slambench.lib.harness import run_cell

    bench = catalog.load_benchmark(root)
    seconds = float(bench["run_seconds"]) if args.seconds is None else args.seconds
    traffic = catalog.traffic(root, catalog.workload(bench, args.workload)["traffic"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    calls: list[dict] = []
    orig = S.compute_stereo_matches

    def recorded(fL, fR, bf, min_z, scale_factors, levels_l, levels_r, **kw):
        out = orig(fL, fR, bf, min_z=min_z, scale_factors=scale_factors, levels_l=levels_l,
                   levels_r=levels_r, **kw)
        calls.append(dict(fL=_host(fL), fR=_host(fR), bf=float(bf), min_z=float(min_z),
                          scale_factors=_host(scale_factors), levels_l=_host(levels_l),
                          levels_r=_host(levels_r), out=_host(out)))
        return out

    spans = ("fe.stereo_depth", "fe.stereo_orb", "fe.stereo_match")
    stage_ms: list[dict] = []  # per call: the stereo spans' ms
    track_stereo = S.System.track_stereo

    def timed_stage(system, *a, **kw):
        before = {k: system.timings.get(k, 0.0) for k in spans}
        T = track_stereo(system, *a, **kw)
        stage_ms.append({k: 1000.0 * (system.timings.get(k, 0.0) - before[k]) for k in spans})
        return T

    S.compute_stereo_matches = recorded
    S.System.track_stereo = timed_stage
    try:
        result = run_cell(root, args.workload, args.seed, seconds, False, device)
    finally:
        S.compute_stereo_matches = orig
        S.System.track_stereo = track_stereo
    warm = int(traffic["warmup_frames"])
    timed = range(warm, warm + int(result["attempted"]))
    t0 = time.perf_counter()
    frames = []
    for i, call in enumerate(calls):
        row = dict(frame=i, timed=i in timed, **compare(call),
                   **(stage_ms[i] if i < len(stage_ms) else {}))
        frames.append(row)
        print(json.dumps(row), flush=True)
    t_ref = time.perf_counter() - t0
    in_window = [f for f in frames if f["timed"]]
    worst = lambda key, rows: max((r[key] for r in rows), default=0.0)  # noqa: E731
    ok = (len(in_window) == len(timed) and all(r["differ_far"] == 0 for r in in_window)
          and worst("ur_gap", in_window) <= UR_TOL and worst("depth_p90", in_window) <= DEPTH_TOL)
    summary = dict(
        workload=args.workload, seed=args.seed, device=str(device),
        card=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        correct=result["correct"], frames=len(frames), timed_frames=len(in_window),
        keypoints=sum(r["keypoints"] for r in in_window),
        matches=sum(r["program"] for r in in_window),
        differ=sum(r["differ"] for r in in_window),
        differ_near=sum(r["differ_near"] for r in in_window),
        differ_far=sum(r["differ_far"] for r in in_window),
        ur_gap=worst("ur_gap", in_window), ur_tol=UR_TOL,
        depth_p90=worst("depth_p90", in_window), depth_tol=DEPTH_TOL,
        flat_ur_gap=worst("flat_ur_gap", in_window),
        flat_depth_p90=min((r["flat_depth_p90"] for r in in_window), default=0.0),
        reference_s=round(t_ref, 3), within=bool(ok),
        stage_ms={k: float(np.mean([r.get(k, np.nan) for r in in_window])) for k in spans})
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}_{args.seed}.json").write_text(
        json.dumps(dict(summary=summary, frames=frames), indent=1))
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
