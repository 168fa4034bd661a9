"""RGB-D sequence driver (counterpart of ``gsorb_slam_tpu/apps/run_rgbd.py``,
the ``Examples/RGB-D/rgbd_tum.cc`` equivalent).

Usage:
    python -m gsorb_slam_tpu_torch.apps.run_rgbd --config configs/tum1.yaml \\
        [--dataset /path/to/sequence] [--type tum|replica|scannet|synthetic|tumlike] \\
        [--max-frames N] [--out DIR] [--cpu]

Runs the System over a sequence on the card (``--cpu``: on the CPU, through
the kernels' plain versions) and writes the reference's output contract
into ``--out``: the trajectory (TUM format, and the dataset's own format
as ``CameraTrajectory.txt``), ``GaussianModel.ply`` (replay.py compatible),
``result.txt`` metrics and the shutdown summary (``SavePlyAndPrintTime``,
``src/Render.cc:167-174``). ``tum``, ``replica`` and ``scannet`` read a
recorded sequence from ``--dataset`` (default: the config's
``Dataset.path``); ``synthetic`` is the procedural scene at the config's
camera; ``tumlike`` the TUM-fr1-like room at the config's resolution with
TUM1's intrinsics, undistorted. A YAML ``--config`` needs PyYAML; a
``.json`` file with the same keys does not. The ORB frontend
(``--frontend orb``) and loop closing's vocabulary (``--vocab``) raise
until the ORB slice is ported.
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
    ap.add_argument("--type", default=None, help="overrides Dataset.type")
    ap.add_argument("--frontend", default="render", choices=["render", "orb"])
    ap.add_argument("--vocab", default=None, help="ORBvoc.txt for loop closing")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-stride", type=int, default=5)
    ap.add_argument("--no-eval", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    if args.frontend == "orb" or args.vocab:
        raise NotImplementedError(
            "--frontend orb and --vocab need the ORB frontend and loop closing, which come "
            "with the ORB slice; the port runs --frontend render"
        )

    import numpy as np

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval import trajectory as TRAJ
    from gsorb_slam_tpu_torch.eval.evaluate import evaluate_sequence
    from gsorb_slam_tpu_torch.eval.ply import save_gaussian_ply
    from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset, TUMLikeDataset, open_dataset
    from gsorb_slam_tpu_torch.slam.system import System

    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.config)
    ds_type = args.type or cfg.dataset.type
    out_dir = args.out or os.path.join(cfg.eval.save_root_path, cfg.dataset.name)
    os.makedirs(out_dir, exist_ok=True)

    cc = cfg.camera
    if ds_type == "synthetic":
        cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
        ds = SyntheticDataset(cam, n_frames=args.max_frames or 30, motion_scale=0.2,
                              device=device)
    elif ds_type == "tumlike":
        ds = TUMLikeDataset(n_frames=args.max_frames or 100, width=cc.width, height=cc.height,
                            apply_distortion=False, device=device)
        c = ds.cam
        cfg = cfg.replace(camera=dataclasses.replace(cc, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy))
    else:
        ds = open_dataset(ds_type, args.dataset or cfg.dataset.path, cc.depth_map_factor)

    system = System(cfg, frontend="render", device=device)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    print(f"tracking {n} frames ({ds_type}, {device}) ...")
    latencies = []
    t_start = time.perf_counter()
    for i in range(n):
        fr = ds[i]
        t0 = time.perf_counter()
        system.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        latencies.append(time.perf_counter() - t0)
        if i % 25 == 0:
            print(f"  frame {i}/{n}  ({latencies[-1] * 1e3:.0f} ms)")
    total = time.perf_counter() - t_start

    traj = system.get_trajectory()
    TRAJ.save_tum(os.path.join(out_dir, "CameraTrajectory_TUM.txt"), traj)
    if ds_type == "replica":
        TRAJ.save_replica(os.path.join(out_dir, "CameraTrajectory.txt"), traj)
    elif ds_type == "scannet":
        TRAJ.save_scannet(os.path.join(out_dir, "CameraTrajectory.txt"), traj)
    else:
        TRAJ.save_tum(os.path.join(out_dir, "CameraTrajectory.txt"), traj)

    gm = system.gm
    if cfg.eval.save_ply:
        host = lambda x: x.detach().cpu().numpy()
        n_splats = save_gaussian_ply(
            os.path.join(out_dir, "GaussianModel.ply"), host(gm.means), host(gm.rgb),
            host(gm.logit_opacities), host(gm.log_scales), host(gm.quats), host(gm.active),
        )
        print(f"saved GaussianModel.ply ({n_splats} splats)")

    summary = system.shutdown_summary()
    summary["median_frame_s"] = float(np.median(latencies))
    summary["mean_frame_s"] = float(np.mean(latencies))
    summary["total_s"] = total
    print("--- shutdown summary (SavePlyAndPrintTime contract) ---")
    for k, v in summary.items():
        print(f"  {k}: {v}")

    if not args.no_eval and cfg.eval.enable:
        print("evaluating ...")
        result = evaluate_sequence(system, ds, stride=args.eval_stride)
        result.update(summary)
        with open(os.path.join(out_dir, "result.txt"), "a") as f:
            f.write(json.dumps(result) + "\n")
        print("--- evaluation ---")
        for k in ("ate_rmse", "psnr", "ssim", "ms_ssim", "depth_l1"):
            if k in result:
                print(f"  {k}: {result[k]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
