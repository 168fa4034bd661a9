"""Host-cost attribution of the ORB frontend and its keyframe chain
(counterpart of ``scripts/profile_frontend.py``).

Drives ``GeometricFrontend.process_frame`` and ``create_keyframe`` over a
generated TUM-like sequence with TUM1's lens distortion, at the
ground-truth poses, and prints (a) the ``fe.*`` / ``kf.*`` phase wall-time
accumulators per frame and (b) cProfile's top cumulative functions. The
frontend's tensor work runs on the card (``--cpu``: on the host); its map
bookkeeping is host numpy either way.

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_frontend
[--frames 10] [--width 320 --height 240] [--kf-every 1] [--cpu]``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

import numpy as np
import torch

from gsorb_slam_tpu_torch.core.camera import Distortion
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.slam.dataset import TUMLikeDataset
from gsorb_slam_tpu_torch.slam.geometric import GeometricFrontend


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (times are the CPU's, not the card's)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--kf-every", type=int, default=1,
                    help="create a keyframe every N frames (a System run: ~1)")
    ap.add_argument("--splat-spacing", type=float, default=0.02,
                    help="the generated room's splat spacing in m")
    args = ap.parse_args(argv)
    dev = common.device_of(args)

    ds = TUMLikeDataset(n_frames=args.frames, width=args.width, height=args.height,
                        apply_distortion=True, splat_spacing=args.splat_spacing, device=dev)
    fe = GeometricFrontend(ds.cam, dist=Distortion(*TUMLikeDataset.DIST), device=dev)

    def gray(fr):
        rgb = torch.as_tensor(fr.rgb, device=dev)
        return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]

    # Frame 0: the first extraction (and, on the card, the native build)
    # and the first keyframe, outside the profile.
    fr0 = ds[0]
    t_c = time.perf_counter()
    feats0 = fe._extract(gray(fr0))
    first_s = time.perf_counter() - t_c
    print(f"first extraction: {first_s:.3f}s", flush=True)
    fe.create_keyframe(feats0, fr0.depth, fr0.gt_T_cw, 0)
    fe.timings.clear()

    prof = cProfile.Profile()
    t_all = time.perf_counter()
    prof.enable()
    for i in range(1, len(ds)):
        fr = ds[i]
        res = fe.process_frame(gray(fr), fr.gt_T_cw)
        if i % args.kf_every == 0:
            fe.create_keyframe(res.feats, fr.depth, fr.gt_T_cw, i)
    common.sync(dev)
    prof.disable()
    wall = time.perf_counter() - t_all
    n = len(ds) - 1

    info = common.device_info(dev)
    print(f"\n== {n} frames, {wall:.2f}s total, {wall / n * 1e3:.0f} ms/frame "
          f"({info['name']}) ==")
    print("-- phase accumulators (s total | ms/frame) --")
    for k, v in sorted(fe.timings.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<18} {v:8.3f}  {v / n * 1e3:8.1f}")
    # fe.total already holds the fe.* phases.
    other = wall - fe.timings.get("fe.total", 0.0) - sum(
        v for k, v in fe.timings.items() if k.startswith("kf."))
    print(f"  {'(unattributed)':<18} {other:8.3f}  {other / n * 1e3:8.1f}")
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(args.top)
    print(s.getvalue())
    return {**info, "frames": n, "first_extract_s": first_s, "ms_per_frame": wall / n * 1e3,
            "phase_ms_per_frame": {k: v / n * 1e3 for k, v in fe.timings.items()},
            "n_points": int(np.count_nonzero(fe.pt_valid)), "n_keyframes": len(fe.keyframes)}


if __name__ == "__main__":
    main()
