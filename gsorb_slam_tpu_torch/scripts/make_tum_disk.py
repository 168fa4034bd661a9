"""Export a TUM-like (or synthetic) sequence to disk in a real dataset
layout, so the disk paths run end to end on files (counterpart of
``scripts/make_tum_disk.py``):

    python -m gsorb_slam_tpu_torch.scripts.make_tum_disk \\
        --out datasets/TUM_RGBD/rgbd_dataset_freiburg1_desk --frames 40 [--width 640 --height 480]
    DATA_ROOT=datasets/TUM_RGBD ROUNDS=1 gsorb_slam_tpu_torch/scripts/run_tum.sh --max-frames 40

    python -m gsorb_slam_tpu_torch.scripts.make_tum_disk --format replica \\
        --out datasets/Replica/room0 --frames 40
    python -m gsorb_slam_tpu_torch.scripts.make_tum_disk --format scannet \\
        --out datasets/Scannet/scene0000_00 --frames 40

TUM: 8-bit rgb PNG, 16-bit depth PNG x5000, rgb.txt / depth.txt with
jittered timestamps, groundtruth.txt; Replica: results/frame*.jpg +
depth*.png x6553.5 + traj.txt rows of T_wc; ScanNet: color / depth / pose
directories, millimetre PNG16. The sequence is generated on the card, or on
the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kind", default="tumlike", choices=["tumlike", "synthetic"])
    ap.add_argument("--format", default="tum", choices=["tum", "replica", "scannet"],
                    help="on-disk layout to write")
    ap.add_argument("--no-noise", action="store_true")
    ap.add_argument("--cache-dir", default=None,
                    help="TUMLike render cache (reuse across exports)")
    ap.add_argument("--cpu", action="store_true", help="generate on the CPU")
    args = ap.parse_args(argv)

    from gsorb_slam_tpu_torch.slam.dataset import (
        SyntheticDataset,
        TUMLikeDataset,
        export_replica_format,
        export_scannet_format,
        export_tum_format,
    )

    device = "cpu" if args.cpu else "cuda"
    if args.kind == "tumlike":
        ds = TUMLikeDataset(n_frames=args.frames, seed=args.seed, width=args.width,
                            height=args.height, noise=not args.no_noise,
                            cache_dir=args.cache_dir, device=device)
    else:
        from gsorb_slam_tpu_torch.core.camera import Camera

        cam = Camera(fx=90.0, fy=90.0, cx=args.width / 2, cy=args.height / 2,
                     width=args.width, height=args.height)
        ds = SyntheticDataset(cam, n_frames=args.frames, seed=args.seed, device=device)

    if args.format == "tum":
        export_tum_format(ds, args.out, seed=args.seed)
    elif args.format == "replica":
        export_replica_format(ds, args.out)
    else:
        export_scannet_format(ds, args.out)
    print(f"wrote {len(ds)} frames to {args.out} ({args.format} layout)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
