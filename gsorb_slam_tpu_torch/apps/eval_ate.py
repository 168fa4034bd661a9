"""Standalone ATE evaluation between two TUM-format trajectories
(counterpart of ``gsorb_slam_tpu/apps/eval_ate.py``; the
``scripts/tum_ate.py`` / ``scripts/eval_ate.py`` equivalent). Host numpy
only: it runs the same on every machine.

Usage: python -m gsorb_slam_tpu_torch.apps.eval_ate gt.txt estimate.txt [--scale]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--scale", action="store_true", help="Sim3 (monocular) alignment")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    from gsorb_slam_tpu_torch.eval.ate import ate_rmse
    from gsorb_slam_tpu_torch.eval.trajectory import load_tum
    from gsorb_slam_tpu_torch.slam.dataset import associate_timestamps

    gt = load_tum(args.gt)
    est = load_tum(args.est)
    gt_ts = np.array([t for t, _ in gt])
    est_ts = np.array([t for t, _ in est])
    pairs = associate_timestamps(est_ts, gt_ts, args.max_dt)
    if len(pairs) < 3:
        print("error: fewer than 3 associated pose pairs")
        return 1
    e = [est[i][1] for i, _ in pairs]
    g = [gt[j][1] for _, j in pairs]
    rmse = ate_rmse(e, g, with_scale=args.scale)
    print(f"compared_pose_pairs {len(pairs)} pairs")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
