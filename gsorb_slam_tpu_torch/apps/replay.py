"""Offline replay: re-render a saved PLY along a trajectory and score it
(counterpart of ``gsorb_slam_tpu/apps/replay.py``; ``scripts/replay.py``
``:250-374``).

Loads ``GaussianModel.ply`` and a TUM-format trajectory, renders every
``--stride``-th frame with :func:`~gsorb_slam_tpu_torch.raster.render` at
the JAX package's replay raster configuration (tile 16, capacity 1024,
max_dup 16, chunk 128; K3 on the card, its plain version with ``--cpu``)
and reports PSNR / SSIM / depth L1 against the dataset as one JSON line: an
independent check of a run's artifacts. ``--lpips`` adds LPIPS
(``ops.lpips``, on the render's device) where its AlexNet weights exist
(``GSORB_LPIPS_WEIGHTS``); the repository does not hold them, and without
them the result says so.

Usage:
    python -m gsorb_slam_tpu_torch.apps.replay --ply out/GaussianModel.ply \\
        --traj out/CameraTrajectory_TUM.txt --config cfg.json \\
        --dataset /path --type tum [--stride 5] [--cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--traj", required=True, help="TUM-format trajectory")
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--type", default=None)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--lpips", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU (plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval.ply import load_gaussian_ply
    from gsorb_slam_tpu_torch.eval.trajectory import load_tum
    from gsorb_slam_tpu_torch.ops import metrics as MM
    from gsorb_slam_tpu_torch.raster import RasterConfig, render
    from gsorb_slam_tpu_torch.slam.dataset import open_dataset

    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config)
    cc = cfg.camera
    cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
    model = load_gaussian_ply(args.ply)
    n = len(model["means"])
    print(f"loaded {n} splats from {args.ply}")
    traj = load_tum(args.traj)
    ds = open_dataset(args.type or cfg.dataset.type, args.dataset or cfg.dataset.path,
                      cc.depth_map_factor)

    rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128)
    p = {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in model.items()}
    active = torch.ones(n, dtype=torch.bool, device=dev)
    host = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)

    psnrs, ssims, dl1s, lpipss = [], [], [], []
    for i in range(0, min(len(traj), len(ds)), args.stride):
        _, T_cw = traj[i]
        fr = ds[i]
        with torch.no_grad():
            out = render(p["means"], p["rgb"], p["quats"], p["logit_opacities"],
                         p["log_scales"], active, host(T_cw), cam, rcfg)
            pred = torch.clamp(out.color, 0.0, 1.0)
            rgb, depth = host(fr.rgb), host(fr.depth)
            mask = depth > 0
            psnrs.append(float(MM.psnr(pred, rgb, mask)))
            ssims.append(float(MM.ssim(pred, rgb)))
            dl1s.append(float(MM.depth_l1(out.median_depth, depth, mask)))
        if args.lpips:
            lpipss.append(MM.lpips(pred, rgb))

    result = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "depth_l1": float(np.mean(dl1s)),
        "frames": len(psnrs),
    }
    # np.nanmean of all-NaN is NaN too: the same branch.
    lp = float(np.nanmean(lpipss)) if lpipss else float("nan")
    if args.lpips and np.isfinite(lp):
        result["lpips"] = lp
    elif args.lpips:
        result["lpips"] = None
        result["lpips_note"] = (
            "unavailable: pretrained AlexNet weights not present (zero-egress environment)"
        )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
