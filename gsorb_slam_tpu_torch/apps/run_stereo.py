"""Stereo sequence driver (counterpart of ``gsorb_slam_tpu/apps/run_stereo.py``,
the ``Examples/Stereo/stereo_kitti.cc`` equivalent over
``System.track_stereo``).

Usage:
    python -m gsorb_slam_tpu_torch.apps.run_stereo --config configs/tum1.yaml \\
        [--dataset /path/to/kitti/sequences/00] [--type kitti|synthetic] \\
        [--baseline B_m] [--vocab ORBvoc.txt] [--max-frames N] [--out DIR] [--cpu]

Runs ``System(frontend="orb")`` on the card (``--cpu``: on the CPU, through
the kernels' plain versions). ``Camera.bf`` from the config is the stereo
baseline times fx for both the row-wise ORB matching
(``Frame::ComputeStereoMatches``) and the SGBM depth; ``--baseline``
overrides it as ``bf = baseline * fx``. Writes the trajectory in the TUM
and KITTI formats and the shutdown summary as one JSON line appended to
``result.txt``. ``kitti`` reads ``image_0/``, ``image_1/`` and
``times.txt``; ``synthetic`` renders rectified pairs of the procedural
scene at the config's camera. A YAML ``--config`` needs PyYAML; a
``.json`` file with the same keys does not.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", default=None, help="overrides Dataset.path")
    ap.add_argument("--type", default=None, help="kitti | synthetic")
    ap.add_argument("--baseline", type=float, default=None,
                    help="stereo baseline in meters (overrides Camera.bf)")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval import trajectory as TRAJ
    from gsorb_slam_tpu_torch.slam.dataset import KittiStereoDataset, StereoSyntheticDataset
    from gsorb_slam_tpu_torch.slam.system import System

    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.config)
    if args.baseline is not None:
        cfg = cfg.replace(camera=dataclasses.replace(cfg.camera,
                                                     bf=args.baseline * cfg.camera.fx))
    ds_type = (args.type or cfg.dataset.type or "kitti").lower()
    ds_path = args.dataset or cfg.dataset.path
    out_dir = args.out or os.path.join(cfg.eval.save_root_path, cfg.dataset.name + "_stereo")
    os.makedirs(out_dir, exist_ok=True)

    if ds_type == "synthetic":
        cc = cfg.camera
        cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
        baseline = cc.bf / cc.fx if cc.bf > 0 else 0.08
        ds = StereoSyntheticDataset(cam, baseline, n_frames=args.max_frames or 10,
                                    n_splats=4000, motion_scale=0.1, device=device)
    else:
        ds = KittiStereoDataset(ds_path)

    vocab = None
    if args.vocab:
        from gsorb_slam_tpu_torch.frontend.vocab import load_orbvoc_text

        vocab = load_orbvoc_text(args.vocab)

    system = System(cfg, frontend="orb", vocabulary=vocab, device=device)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    print(f"tracking {n} stereo frames ({ds_type}, bf={cfg.camera.bf:.2f}, {device}) ...")
    latencies = []
    t_start = time.perf_counter()
    for i in range(n):
        fr = ds[i]
        t0 = time.perf_counter()
        system.track_stereo(fr.left, fr.right, fr.timestamp)
        latencies.append(time.perf_counter() - t0)
        if i % 25 == 0:
            print(f"  frame {i}/{n}  ({latencies[-1] * 1e3:.0f} ms)")
    total = time.perf_counter() - t_start

    traj = system.get_trajectory()
    TRAJ.save_tum(os.path.join(out_dir, "CameraTrajectory_TUM.txt"), traj)
    TRAJ.save_kitti(os.path.join(out_dir, "CameraTrajectory_KITTI.txt"), traj)

    summary = system.shutdown_summary()
    summary.update(
        median_frame_s=float(np.median(latencies)),
        mean_frame_s=float(np.mean(latencies)),
        total_s=total,
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
