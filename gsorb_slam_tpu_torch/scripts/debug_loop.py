"""Diagnose the loop-closing pipeline on the revisiting trajectory: per
keyframe the BoW retrieval candidates and consistency streaks, every
``verify``'s match and inlier counts, then a post-run probe of keyframe
pairs (counterpart of ``scripts/debug_loop.py``).

The scene is ``tests/test_loop_e2e.py``'s (96x72, 16 frames out and back,
poses injected under accumulating drift) on the port's ORB ``System``, on
the card, or on the CPU with ``--cpu``.

Usage:
    python -m gsorb_slam_tpu_torch.scripts.debug_loop [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def trajectory():
    """Out along +x, back, then a dwell near the start."""
    xs = list(np.arange(0.0, 1.6, 0.2)) + [1.1, 0.7, 0.35, 0.1]
    xs += [0.015, 0.0, 0.012, 0.005]
    poses = []
    for i, x in enumerate(xs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x
        T[1, 3] = 0.01 * np.sin(i)
        poses.append(T)
    return poses


def drift(i: int) -> np.ndarray:
    """The world-frame drift injected at frame ``i``."""
    ang = 0.003 * i
    ca, sa = np.cos(ang), np.sin(ang)
    T = np.eye(4, dtype=np.float32)
    T[0, 0], T[0, 2] = ca, sa
    T[2, 0], T[2, 2] = -sa, ca
    T[0, 3] = 0.009 * i
    T[1, 3] = 0.003 * i
    return T


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import (
        CameraConfig,
        MappingConfig,
        ORBConfig,
        SystemConfig,
        TrackingConfig,
    )
    from gsorb_slam_tpu_torch.frontend.matcher import hamming_matrix, search_by_bow
    from gsorb_slam_tpu_torch.frontend.vocab import default_vocabulary, score_l1
    from gsorb_slam_tpu_torch.raster import RasterConfig
    from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset
    from gsorb_slam_tpu_torch.slam.system import System

    device = "cpu" if args.cpu else "cuda"
    cam = Camera(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)
    cfg = SystemConfig(
        camera=CameraConfig(width=96, height=72, fx=90.0, fy=90.0, cx=48.0, cy=36.0, fps=10),
        orb=ORBConfig(n_features=300, n_levels=3),
        mapping=MappingConfig(num_iters=8, init_iters=10, max_gaussians=16384,
                              window_size=3, covis_window=2),
        tracking=TrackingConfig(num_iters=4, lost_num_iters=4),
    )
    traj = trajectory()
    ds = SyntheticDataset(cam, n_splats=3000, seed=5, trajectory=traj, device=device)
    rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128, dilate_px=8.0)
    sys_ = System(cfg, max_keyframes=32, raster=rcfg, frontend="orb",
                  vocabulary=default_vocabulary(), device=device)
    sys_.loop_closer.min_gap = 8
    sys_.loop_closer.min_inliers = 12
    sys_.max_frames_between_kf = 1

    # Instrument detect and verify.
    lc = sys_.loop_closer
    orig_detect = lc.detect

    def detect(kf, recent):
        cands = lc.db.query(kf.kf_id, recent, lc.min_score)
        print(f"  KF {kf.kf_id}: recent={sorted(recent)} "
              f"cands={[(c, round(s, 3)) for c, s in cands[:5]]} "
              f"consistency={lc.consistency}", flush=True)
        return orig_detect(kf, recent)

    lc.detect = detect
    orig_verify = lc.verify

    def verify(q, m, fe, cam=None):
        r = orig_verify(q, m, fe, cam=cam, debug=True)
        print(f"  VERIFY q={q.kf_id} m={m.kf_id} -> {'OK' if r is not None else 'FAIL'}",
              flush=True)
        return r

    lc.verify = verify

    for i, fr in enumerate(ds):
        t0 = time.time()
        T_inj = (fr.gt_T_cw @ np.linalg.inv(drift(i))).astype(np.float32)
        sys_.track_rgbd(fr.rgb, fr.depth, fr.timestamp, gt_pose=T_inj)
        print(f"frame {i} ({time.time() - t0:.1f}s) "
              f"kfs={len(sys_.fe.keyframes)} loops={sys_.loop_events}", flush=True)

    print("keyframes:", [(kf.kf_id, kf.frame_id) for kf in sys_.fe.keyframes])
    print("loop_events:", sys_.loop_events)

    # Post-run probe: how well keyframe pairs of the revisit match.
    kfs = {kf.kf_id: kf for kf in sys_.fe.keyframes}
    lcdb = lc.db
    for q, m in [(12, 0), (12, 1), (13, 0), (14, 0)]:
        if q not in kfs or m not in kfs:
            continue
        kq, km = kfs[q], kfs[m]
        bq, bm = lcdb.bows.get(q, {}), lcdb.bows.get(m, {})
        shared = set(bq) & set(bm)
        D = hamming_matrix(kq.feats.descriptors, km.feats.descriptors).cpu().numpy()
        vq = kq.feats.valid.cpu().numpy()
        vm = km.feats.valid.cpu().numpy()
        best = D[vq][:, vm].min(axis=1)
        _w1, _t1, n1 = lcdb.vocab.transform_with_nodes(kq.feats.descriptors, kq.feats.valid)
        _w2, _t2, n2 = lcdb.vocab.transform_with_nodes(km.feats.descriptors, km.feats.valid)
        sbb = search_by_bow(kq.feats, km.feats, n1, n2, max_dist=64)
        print(f"probe {q}vs{m}: nvalid=({int(vq.sum())},{int(vm.sum())}) "
              f"words=({len(bq)},{len(bm)}) shared={len(shared)} "
              f"score={score_l1(bq, bm):.3f} "
              f"bf_matches<=50={int((best <= 50).sum())} "
              f"bf<=64={int((best <= 64).sum())} "
              f"sbb={int(sbb.valid.sum())}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
