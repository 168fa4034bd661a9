"""Monocular sequence driver (counterpart of ``gsorb_slam_tpu/apps/run_mono.py``,
the ``Examples/Monocular/mono_tum.cc`` / ``mono_kitti.cc`` equivalent over
``System.track_monocular``).

Usage:
    python -m gsorb_slam_tpu_torch.apps.run_mono --config configs/tum1.yaml \\
        [--dataset /path/to/sequence] [--type tum|kitti|synthetic] \\
        [--vocab ORBvoc.txt] [--max-frames N] [--out DIR] [--cpu] \\
        [--min-matches 40] [--min-inliers 30]

Runs ``System(frontend="orb")`` on the card (``--cpu``: on the CPU) and
writes the trajectory in the TUM and KITTI formats (poses up to the
monocular run's arbitrary global scale, as in the reference) and the
shutdown summary with ``frames_tracked`` / ``frames_total`` as one JSON
line appended to ``result.txt``. ``tum`` reads ``rgb.txt``, ``kitti``
``image_0/`` and ``times.txt``; ``synthetic`` is the procedural scene at
the config's camera (sharp mid-scale splats, seed 7). A YAML ``--config``
needs PyYAML; a ``.json`` file with the same keys does not.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", default=None, help="overrides Dataset.path")
    ap.add_argument("--type", default=None, help="tum | kitti | synthetic")
    ap.add_argument("--vocab", default=None, help="ORBvoc.txt for loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--min-matches", type=int, default=40,
                    help="bootstrap descriptor matches required")
    ap.add_argument("--min-inliers", type=int, default=30,
                    help="bootstrap H/F-RANSAC inliers required")
    args = ap.parse_args(argv)

    import numpy as np

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval import trajectory as TRAJ
    from gsorb_slam_tpu_torch.slam.dataset import (
        KittiStereoDataset,
        MonoTumDataset,
        SyntheticDataset,
    )
    from gsorb_slam_tpu_torch.slam.system import System

    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.config)
    ds_type = (args.type or cfg.dataset.type or "tum").lower()
    ds_path = args.dataset or cfg.dataset.path
    out_dir = args.out or os.path.join(cfg.eval.save_root_path, cfg.dataset.name + "_mono")
    os.makedirs(out_dir, exist_ok=True)

    if ds_type == "synthetic":
        cc = cfg.camera
        cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
        ds = SyntheticDataset(cam, n_frames=args.max_frames or 12, n_splats=6000,
                              motion_scale=0.35, scale_range=(0.02, 0.05), seed=7,
                              device=device)
    elif ds_type == "kitti":
        ds = KittiStereoDataset(ds_path, mono=True)
    else:
        ds = MonoTumDataset(ds_path)

    vocab = None
    if args.vocab:
        from gsorb_slam_tpu_torch.frontend.vocab import load_orbvoc_text

        vocab = load_orbvoc_text(args.vocab)

    system = System(cfg, frontend="orb", vocabulary=vocab, mono_min_matches=args.min_matches,
                    mono_min_inliers=args.min_inliers, device=device)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    print(f"tracking {n} monocular frames ({ds_type}, {device}) ...")
    latencies, n_tracked = [], 0
    t_start = time.perf_counter()
    for i in range(n):
        fr = ds[i]
        t0 = time.perf_counter()
        T = system.track_monocular(fr.rgb, fr.timestamp)
        latencies.append(time.perf_counter() - t0)
        n_tracked += T is not None
        if i % 25 == 0:
            print(f"  frame {i}/{n}  ({latencies[-1] * 1e3:.0f} ms)  state={system._mono_state}")
    total = time.perf_counter() - t_start

    traj = system.get_trajectory()
    TRAJ.save_tum(os.path.join(out_dir, "CameraTrajectory_TUM.txt"), traj)
    TRAJ.save_kitti(os.path.join(out_dir, "CameraTrajectory_KITTI.txt"), traj)

    summary = system.shutdown_summary()
    summary.update(
        median_frame_s=float(np.median(latencies)),
        mean_frame_s=float(np.mean(latencies)),
        total_s=total,
        frames_tracked=int(n_tracked),
        frames_total=int(n),
    )
    print("--- shutdown summary ---")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    with open(os.path.join(out_dir, "result.txt"), "a") as f:
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
