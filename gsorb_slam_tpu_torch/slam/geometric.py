"""The geometric SLAM frontend: map points, ORB tracking and local mapping
(counterpart of ``gsorb_slam_tpu/slam/geometric.py``).

The host-orchestrated graph layer of the reference (``Tracking`` +
``LocalMapping`` + ``MapPoint`` / ``Map``) around the tensor functions of
``frontend/``:

- map points live in fixed-capacity numpy arrays (positions, descriptors as
  ``np.uint32`` words, visibility statistics), keyframes in a list; this
  bookkeeping stays on the host, as in the JAX package;
- per frame: ORB extraction, projection matching against the local map and
  robust pose optimization run on the frontend's device; the surviving
  matches feed the Gaussian tracker's reprojection term
  (``slam/tracking.FeatureMatches``): TrackWithMotionModel ->
  TrackLocalMapWithGaussian (``src/Tracking.cc:293-487``);
- keyframes: new map points back-projected from the depth
  (``CreateNewKeyFrame`` ``src/Tracking.cc:1446-1510``), covisibility from
  shared observations, epipolar triangulation, fusion, periodic local BA
  and point / keyframe culling (``LocalMapping::Run``).

The JAX package pads every device call to a power-of-two bucket so that
jit compiles once; the port passes the real rows (padding changed no
number). The caps that do change results stay: ``match_capacity * 8`` rows
for the pose optimization and ``local_map_cap`` local-map points.
``timings`` accumulates wall seconds per phase (``fe.*`` per frame,
``kf.*`` per keyframe); ``fe.total`` covers the whole ``process_frame``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera, Distortion, undistort_points
from gsorb_slam_tpu_torch.core.config import ORBConfig
from gsorb_slam_tpu_torch.frontend import ba
from gsorb_slam_tpu_torch.frontend.initializer import triangulate
from gsorb_slam_tpu_torch.frontend.matcher import (
    fundamental_from_poses,
    match_descriptors,
    search_by_bow,
    search_by_projection,
    search_for_triangulation,
)
from gsorb_slam_tpu_torch.frontend.orb import (
    ORBFeatures,
    descriptors_from_numpy,
    descriptors_to_numpy,
    extract_orb,
    level_sigma2,
    quadtree_refine,
)
from gsorb_slam_tpu_torch.frontend.pnp import ransac_pnp
from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class KeyFrameFeatures:
    kf_id: int
    frame_id: int
    feats: ORBFeatures
    point_ids: np.ndarray  # [N] int32 map-point id per keypoint (-1 none)
    T_cw: np.ndarray
    # Spanning-tree parent (KeyFrame::mpParent): the most covisible keyframe
    # at insertion, reparented to the grandparent when the parent is culled.
    parent_id: int = -1


@dataclasses.dataclass
class FrontendResult:
    T_orb: Optional[np.ndarray]  # pose after ORB optimization (None if failed)
    matches: FeatureMatches  # padded matches for the GS tracker's chi^2 term
    n_inliers: int
    n_tracked_close: int
    n_nontracked_close: int
    feats: ORBFeatures


class GeometricFrontend:
    def __init__(
        self,
        cam: Camera,
        orb_cfg: ORBConfig = ORBConfig(),
        max_points: int = 200_000,
        th_depth: float = 3.5,  # meters close-point threshold (bf / fx * ThDepth)
        match_capacity: int = 512,
        local_ba_every: int = 3,
        dist: Optional[Distortion] = None,
        bf: float = 0.0,  # stereo baseline * fx (for stereo BA edges)
        local_map_cap: int = 4000,  # max local-map points per frame
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # Frame 0's ORB extraction runs before any kernel is built.
            _build.pin_full_f32()
        self.cam = cam
        self.dist = dist if dist is not None else Distortion()
        self.bf = bf
        self.orb_cfg = orb_cfg
        self.th_depth = th_depth
        self.match_capacity = match_capacity
        self.local_ba_every = local_ba_every
        self.local_map_cap = local_map_cap
        self.sigma2 = level_sigma2(orb_cfg)

        P = max_points
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 8), np.uint32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_visible = np.zeros(P, np.int32)
        self.pt_found = np.zeros(P, np.int32)
        self.pt_first_kf = np.zeros(P, np.int32)
        # MapPoint state (src/MapPoint.cc): the mean viewing direction (zero
        # = not set), the scale-invariance range (MapPoint::UpdateNormalAndDepth:
        # max = obs-dist * sf^octave, min = max / sf^(L-1); zero = not set)
        # and up to 8 observed descriptors per point.
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.scale_factors = (orb_cfg.scale_factor ** np.arange(orb_cfg.n_levels)).astype(
            np.float32)
        self.pt_obs_desc: dict[int, list] = {}
        # Point -> observing keyframes (MapPoint::mObservations), kept at
        # every point_ids assignment.
        self.pt_obs_kf: dict[int, set[int]] = {}
        self.n_points = 0

        self.keyframes: list[KeyFrameFeatures] = []
        self.kf_counter = 0
        # Map points matched as inliers in the last tracked frame: the vote
        # source of Tracking::UpdateLocalKeyFrames.
        self.last_matched_points: np.ndarray = np.zeros(0, np.int64)
        self.last_adjusted: list[int] = []
        self.timings: dict[str, float] = {}

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _tt(self, phase: str, t0: float) -> float:
        """Accumulate the wall time since ``t0`` into ``phase``; returns now."""
        now = time.perf_counter()
        self.timings[phase] = self.timings.get(phase, 0.0) + (now - t0)
        return now

    def _extract(self, gray) -> ORBFeatures:
        """ORB extraction on the device, keypoints undistorted
        (``Frame::UndistortKeyPoints``: descriptors stay sampled on the raw
        image, ``uv_raw`` keeps the raw coords for depth lookups), then the
        native quad-tree selection."""
        feats = extract_orb(torch.as_tensor(gray, dtype=torch.float32, device=self.device),
                            self.orb_cfg)
        if not self.dist.is_zero():
            feats = feats._replace(uv=undistort_points(self.cam, self.dist, feats.uv))
        return quadtree_refine(feats, self.orb_cfg)

    # ------------------------------------------------------------- tracking

    def _observe_kf(self, p: int, kf_id: int) -> None:
        self.pt_obs_kf.setdefault(int(p), set()).add(int(kf_id))

    def _set_scale_range(self, p: int, cam_center: np.ndarray, octave: int) -> None:
        """Scale-invariance distances from the observing octave."""
        dist = float(np.linalg.norm(self.pt_pos[p] - cam_center))
        octave = int(np.clip(octave, 0, len(self.scale_factors) - 1))
        self.pt_max_dist[p] = dist * self.scale_factors[octave]
        self.pt_min_dist[p] = self.pt_max_dist[p] / self.scale_factors[-1]

    def local_keyframes(self, max_kfs: int = 80) -> list[int]:
        """The covisibility local keyframe set (``Tracking::UpdateLocalKeyFrames``
        ``src/Tracking.cc:1572-1660``): every keyframe observing a point
        matched in the last frame votes; the voters and their 10 best
        covisible neighbours each form the window."""
        votes: dict[int, int] = {}
        for p in self.last_matched_points:
            for k in self.pt_obs_kf.get(int(p), ()):
                votes[k] = votes.get(k, 0) + 1
        alive = {kf.kf_id for kf in self.keyframes}
        voters = [k for k, _ in sorted(votes.items(), key=lambda x: -x[1]) if k in alive]
        local = list(voters[:max_kfs])
        chosen = set(local)
        by_id = {kf.kf_id: kf for kf in self.keyframes}
        for k in voters:
            if len(local) >= max_kfs:
                break
            for nid, _w in self.covisibility(by_id[k])[:10]:
                if nid not in chosen:
                    chosen.add(nid)
                    local.append(nid)
                    if len(local) >= max_kfs:
                        break
        return local

    def local_map_points(self, max_pts: Optional[int] = None) -> np.ndarray:
        """Candidate local map points: the valid points of the covisibility
        local keyframes (``Tracking::UpdateLocalPoints``) after a tracked
        frame, else the most recent points."""
        if max_pts is None:
            max_pts = self.local_map_cap
        lkfs = self.local_keyframes() if len(self.last_matched_points) else []
        if lkfs:
            by_id = {kf.kf_id: kf for kf in self.keyframes}
            sel: list[int] = []
            seen: set[int] = set()
            for k in lkfs:
                pids = by_id[k].point_ids
                for p in pids[pids >= 0].tolist():
                    if p not in seen and self.pt_valid[p]:
                        seen.add(p)
                        sel.append(p)
            if len(sel) >= 20:
                # Over the cap, the best-voted keyframes' points come first.
                return np.asarray(sel[:max_pts], np.int64)
        ids = np.nonzero(self.pt_valid)[0]
        if len(ids) > max_pts:
            ids = ids[-max_pts:]
        return ids

    def _local_map(self):
        """(ids, world, desc, valid, normals, dmin, dmax) of the local map,
        the arrays on the device."""
        ids = self.local_map_points()
        return (ids, self._t(self.pt_pos[ids]), descriptors_from_numpy(self.pt_desc[ids],
                                                                       self.device),
                self._t(self.pt_valid[ids], torch.bool), self._t(self.pt_normal[ids]),
                self._t(self.pt_min_dist[ids]), self._t(self.pt_max_dist[ids]))

    def process_frame(self, gray, T_pred: np.ndarray, feats: Optional[ORBFeatures] = None,
                      kp_ur: Optional[np.ndarray] = None) -> FrontendResult:
        """Track the local map in one frame; ``fe.total`` times the whole
        call so that the ``fe.*`` phases add up to it."""
        t_all = time.perf_counter()
        try:
            return self._process_frame(gray, T_pred, feats, kp_ur)
        finally:
            self._tt("fe.total", t_all)

    def _process_frame(self, gray, T_pred: np.ndarray, feats: Optional[ORBFeatures] = None,
                       kp_ur: Optional[np.ndarray] = None) -> FrontendResult:
        """``kp_ur`` (right-image u per keypoint) switches matched
        observations to 3-DoF stereo BA edges (``src/Optimizer.cc:300-380``)."""
        t0 = time.perf_counter()
        if feats is None:
            feats = self._extract(gray)
        t0 = self._tt("fe.extract", t0)
        empty = FeatureMatches.empty(self.match_capacity, device=self.device)
        if len(self.local_map_points()) < 20:
            return FrontendResult(None, empty, 0, 0, 0, feats)

        ids, world_p, desc_p, valid_p, norm_p, dmin_p, dmax_p = self._local_map()
        t0 = self._tt("fe.local_map", t0)
        # radius is the reference's `th` once scale information exists:
        # window = th * RadiusByViewingCos * sf[predicted level]
        # (src/ORBmatcher.cc:45-157; th = 3 covers the motion-model prior).
        m = search_by_projection(
            world_p, desc_p, valid_p, feats, self._t(T_pred), self.cam, radius=3.0,
            normals=norm_p, min_dists=dmin_p, max_dists=dmax_p,
            scale_factors=self._t(self.scale_factors),
        )
        mv = _np(m.valid)
        t0 = self._tt("fe.match", t0)
        self.pt_visible[ids[mv]] += 1
        kp_idx = _np(m.idx2)
        n = int(mv.sum())
        if n < 10:
            return FrontendResult(None, empty, 0, 0, 0, feats)

        cap = min(n, self.match_capacity * 8)
        world = self.pt_pos[ids[mv]][:cap]
        uv = _np(feats.uv)[kp_idx[mv]][:cap]
        inv_s2 = (1.0 / self.sigma2[_np(feats.octave)[kp_idx[mv]][:cap]]).astype(np.float32)
        ur = None
        if kp_ur is not None:
            ur = self._t(np.asarray(kp_ur, np.float32)[kp_idx[mv]][:cap])
        res = ba.pose_optimization(
            self._t(T_pred), self._t(world), self._t(uv), self._t(inv_s2),
            torch.ones(cap, dtype=torch.bool, device=self.device), self.cam,
            obs_ur=ur, bf=self.bf,
        )
        inl = _np(res.inliers)
        t0 = self._tt("fe.pose_opt", t0)
        matched_ids = ids[mv][:cap]
        self.pt_found[matched_ids[inl]] += 1
        n_inl = int(inl.sum())
        if n_inl >= 10:
            self.last_matched_points = matched_ids[inl].astype(np.int64)
        T_res = _np(res.T_cw)
        T_orb = T_res if (n_inl >= 10 and np.isfinite(T_res).all()) else None

        # Padded matches for the GS tracker's feature term (inliers only).
        mcap = self.match_capacity
        sel = np.nonzero(inl)[0][:mcap]
        obs = np.zeros((mcap, 2), np.float32)
        wld = np.zeros((mcap, 3), np.float32)
        isg = np.ones(mcap, np.float32)
        val = np.zeros(mcap, bool)
        obs[: len(sel)] = uv[sel]
        wld[: len(sel)] = world[sel]
        isg[: len(sel)] = inv_s2[sel]
        val[: len(sel)] = True
        matches = FeatureMatches(obs_uv=self._t(obs), world=self._t(wld),
                                 inv_sigma2=self._t(isg), valid=self._t(val, torch.bool))
        self._tt("fe.bookkeeping", t0)
        return FrontendResult(T_orb, matches, n_inl, n_inl, 0, feats)

    # ------------------------------------------------------------ keyframes

    def create_keyframe(
        self,
        feats: ORBFeatures,
        depth: np.ndarray,
        T_cw: np.ndarray,
        frame_id: int,
        max_new_points: int = 400,
        kp_depth: Optional[np.ndarray] = None,  # [N] per-keypoint depth
        run_local_mapping: bool = True,  # False: primitives only (tests)
    ) -> KeyFrameFeatures:
        """Back-project the depth at the keypoints into new map points, the
        closest first and capped (RGB-D ``CreateNewKeyFrame``), then run the
        local mapping of ``LocalMapping::Run`` (``src/LocalMapping.cc:48-648``):
        point culling, triangulation against the 2 most covisible keyframes,
        fusion, local BA every ``local_ba_every`` keyframes, keyframe culling
        every 10. ``kp_depth`` replaces the depth-image lookup (stereo)."""
        t0 = time.perf_counter()
        v = _np(feats.valid)
        uv = _np(feats.uv)  # undistorted: the ray
        uv_raw = _np(feats.uv_raw if feats.uv_raw is not None else feats.uv)
        desc = descriptors_to_numpy(feats.descriptors)
        N = len(uv)
        point_ids = np.full(N, -1, np.int32)
        if kp_depth is not None:
            z = np.asarray(kp_depth, np.float32)
        else:
            # The depth at the raw image location (the sensor grid), the ray
            # through the undistorted coords (Frame::UnprojectStereo).
            depth = np.asarray(depth)
            ui = np.clip(uv_raw[:, 0].astype(int), 0, depth.shape[1] - 1)
            vi = np.clip(uv_raw[:, 1].astype(int), 0, depth.shape[0] - 1)
            z = depth[vi, ui]
        ok = v & (z > 0)
        octv_np = _np(feats.octave)
        order = np.argsort(np.where(ok, z, np.inf))
        created = 0
        T_wc = np.linalg.inv(T_cw)
        cam_center = T_wc[:3, 3]
        for i in order:
            if not ok[i]:
                break
            if created >= max_new_points and z[i] > self.th_depth:
                break
            if self.n_points >= len(self.pt_pos):
                break
            xc = np.array([(uv[i, 0] - self.cam.cx) * z[i] / self.cam.fx,
                           (uv[i, 1] - self.cam.cy) * z[i] / self.cam.fy, z[i], 1.0], np.float32)
            p = self.n_points
            self.pt_pos[p] = (T_wc @ xc)[:3]
            self.pt_desc[p] = desc[i]
            self.pt_valid[p] = True
            self.pt_first_kf[p] = self.kf_counter
            self.pt_visible[p] = 1
            self.pt_found[p] = 1
            self.pt_normal[p] = 0.0
            self._observe_point(p, desc[i], cam_center)
            self._observe_kf(p, self.kf_counter)
            self._set_scale_range(p, cam_center, int(octv_np[i]))
            point_ids[i] = p
            self.n_points += 1
            created += 1

        kf = KeyFrameFeatures(kf_id=self.kf_counter, frame_id=frame_id, feats=feats,
                              point_ids=point_ids, T_cw=np.asarray(T_cw, np.float32))
        self.keyframes.append(kf)
        self.kf_counter += 1
        t0 = self._tt("kf.new_points", t0)

        # Spanning-tree parent: the most covisible keyframe, else the last.
        if len(self.keyframes) >= 2:
            covis0 = self.covisibility(kf, min_shared=5)
            kf.parent_id = covis0[0][0] if covis0 else self.keyframes[-2].kf_id
        t0 = self._tt("kf.covis", t0)

        self.last_adjusted = []
        if run_local_mapping and len(self.keyframes) >= 2:
            self.cull_points()
            t0 = self._tt("kf.cull_points", t0)
            by_id = {k.kf_id: k for k in self.keyframes}
            for cid, _w in self.covisibility(kf)[:2]:
                other = by_id.get(cid)
                if other is not None:
                    self.create_new_map_points(kf, other)
            t0 = self._tt("kf.triangulate", t0)
            self.fuse_duplicates(kf)
            t0 = self._tt("kf.fuse", t0)
        if run_local_mapping and self.kf_counter % self.local_ba_every == 0 \
                and len(self.keyframes) >= 3:
            self.last_adjusted = self.local_ba()
            t0 = self._tt("kf.lba", t0)
        if run_local_mapping and self.kf_counter % 10 == 0 and len(self.keyframes) > 4:
            self.cull_keyframes()
            t0 = self._tt("kf.cull_kfs", t0)
        return kf

    # -------------------------------------------------------- local mapping

    def _observe_point(self, p: int, desc: np.ndarray, cam_center: np.ndarray) -> None:
        """Register an observation: the running mean viewing direction
        (``MapPoint::UpdateNormalAndDepth``) and the descriptor for the
        distinctive-descriptor refresh."""
        view = self.pt_pos[p] - cam_center
        n = np.linalg.norm(view)
        if n > 1e-9:
            acc = self.pt_normal[p] + view / n
            an = np.linalg.norm(acc)
            self.pt_normal[p] = acc / an if an > 1e-9 else acc
        lst = self.pt_obs_desc.setdefault(p, [])
        if len(lst) < 8:
            lst.append(np.asarray(desc, np.uint32))

    def refresh_descriptors(self, ids) -> int:
        """``MapPoint::ComputeDistinctiveDescriptors``: among a point's
        observed descriptors, the one with the least median Hamming distance
        to the others."""
        refreshed = 0
        for p in ids:
            lst = self.pt_obs_desc.get(int(p))
            if not lst or len(lst) < 3:
                continue
            D = np.stack(lst)
            x = D[:, None, :] ^ D[None, :, :]
            dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            self.pt_desc[int(p)] = D[int(np.argmin(np.median(dist, axis=1)))]
            refreshed += 1
        return refreshed

    def cull_points(self, min_ratio: float = 0.25) -> int:
        """Found / visible ratio culling (``LocalMapping::MapPointCulling``)."""
        vis = np.maximum(self.pt_visible, 1)
        bad = self.pt_valid & (self.pt_visible >= 4) & (self.pt_found / vis < min_ratio)
        self.pt_valid[bad] = False
        return int(bad.sum())

    def covisibility(self, kf: KeyFrameFeatures, min_shared: int = 15):
        """Keyframes sharing at least ``min_shared`` valid map points
        (``KeyFrame::UpdateConnections``), by voting over the point ->
        keyframe index, most shared first."""
        votes: dict[int, int] = {}
        for p in kf.point_ids[kf.point_ids >= 0].tolist():
            if not self.pt_valid[p]:
                continue
            for k in self.pt_obs_kf.get(int(p), ()):
                if k != kf.kf_id:
                    votes[k] = votes.get(k, 0) + 1
        alive = {k.kf_id for k in self.keyframes}
        out = [(k, s) for k, s in votes.items() if s >= min_shared and k in alive]
        out.sort(key=lambda x: -x[1])
        return out

    def create_new_map_points(self, kf1: KeyFrameFeatures, kf2: KeyFrameFeatures,
                              max_new: int = 200) -> int:
        """Triangulate new points from epipolar matches between two keyframes
        (``LocalMapping::CreateNewMapPoints`` ``src/LocalMapping.cc:213``),
        gated on cheirality, parallax and a 5.991 chi^2 reprojection."""
        K = self.cam.K(self.device)
        F12 = fundamental_from_poses(self._t(kf1.T_cw), self._t(kf2.T_cw), K)
        m = search_for_triangulation(kf1.feats, kf2.feats, F12,
                                     self._t(kf1.point_ids < 0, torch.bool),
                                     self._t(kf2.point_ids < 0, torch.bool))
        mv = _np(m.valid)
        if not mv.any():
            return 0
        idx1 = np.nonzero(mv)[0]
        idx2 = _np(m.idx2)[mv]
        uv1 = _np(kf1.feats.uv)[idx1]
        uv2 = _np(kf2.feats.uv)[idx2]
        Kn = _np(K)
        P1 = Kn @ kf1.T_cw[:3]
        P2 = Kn @ kf2.T_cw[:3]
        X = _np(triangulate(self._t(P1), self._t(P2), self._t(uv1), self._t(uv2)))
        xc1 = X @ kf1.T_cw[:3, :3].T + kf1.T_cw[:3, 3]
        xc2 = X @ kf2.T_cw[:3, :3].T + kf2.T_cw[:3, 3]
        z1, z2 = xc1[:, 2], xc2[:, 2]
        finite = np.isfinite(X).all(1)
        with np.errstate(invalid="ignore", divide="ignore"):
            f, c = [self.cam.fx, self.cam.fy], [self.cam.cx, self.cam.cy]
            e1 = np.linalg.norm(xc1[:, :2] / np.maximum(z1[:, None], 1e-9) * f + c - uv1, axis=-1)
            e2 = np.linalg.norm(xc2[:, :2] / np.maximum(z2[:, None], 1e-9) * f + c - uv2, axis=-1)
            c1w = -kf1.T_cw[:3, :3].T @ kf1.T_cw[:3, 3]
            c2w = -kf2.T_cw[:3, :3].T @ kf2.T_cw[:3, 3]
            ray1, ray2 = X - c1w, X - c2w
            cosp = np.sum(ray1 * ray2, -1) / np.maximum(
                np.linalg.norm(ray1, axis=-1) * np.linalg.norm(ray2, axis=-1), 1e-12)
        good = (finite & (z1 > 0.05) & (z2 > 0.05) & (np.abs(X) < 1e3).all(1)
                & (e1 < 2.45) & (e2 < 2.45)  # sqrt(5.991) px at octave 0
                & (cosp < 0.9998))  # near-zero parallax
        created = 0
        desc1 = descriptors_to_numpy(kf1.feats.descriptors)
        oct1 = _np(kf1.feats.octave)
        for j in np.nonzero(good)[0][:max_new]:
            if self.n_points >= len(self.pt_pos):
                break
            p = self.n_points
            self.pt_pos[p] = X[j]
            self.pt_desc[p] = desc1[idx1[j]]
            self.pt_valid[p] = True
            self.pt_first_kf[p] = kf1.kf_id
            self.pt_visible[p] = 2
            self.pt_found[p] = 2
            kf1.point_ids[idx1[j]] = p
            kf2.point_ids[idx2[j]] = p
            self._observe_kf(p, kf1.kf_id)
            self._observe_kf(p, kf2.kf_id)
            self._set_scale_range(p, c1w.astype(np.float32), int(oct1[idx1[j]]))
            self.n_points += 1
            created += 1
        return created

    def fuse_duplicates(self, kf: KeyFrameFeatures, radius: float = 3.0) -> int:
        """Project the local map into a keyframe and merge duplicates
        (``ORBmatcher::Fuse`` ``src/ORBmatcher.cc:825``): a keypoint that
        already holds a point keeps the one with more observations (the
        projected one on a tie), and the other is retired
        (``MapPoint::Replace``)."""
        if len(self.local_map_points()) < 10:
            return 0
        ids, world_p, desc_p, valid_p, _norm_p, dmin_p, dmax_p = self._local_map()
        # Fuse semantics: window th * sf[pred], octaves [pred - 1, pred].
        m = search_by_projection(
            world_p, desc_p, valid_p, kf.feats, self._t(kf.T_cw), self.cam, radius=radius,
            max_dist=50, min_dists=dmin_p, max_dists=dmax_p,
            scale_factors=self._t(self.scale_factors), use_view_cos_radius=False,
        )
        mv = _np(m.valid)
        kp = _np(m.idx2)
        fused = 0
        kf_desc = descriptors_to_numpy(kf.feats.descriptors)
        cam_center = (-kf.T_cw[:3, :3].T @ kf.T_cw[:3, 3]).astype(np.float32)
        touched = []
        by_id = {k.kf_id: k for k in self.keyframes}
        obs_of = lambda q: max(len(self.pt_obs_desc.get(q, [])), 1)
        for i in np.nonzero(mv)[0]:
            p_new = int(ids[i])
            if not self.pt_valid[p_new]:  # merged away earlier in this pass
                continue
            existing = int(kf.point_ids[kp[i]])
            if existing < 0:
                kf.point_ids[kp[i]] = p_new
                self._observe_point(p_new, kf_desc[kp[i]], cam_center)
                self._observe_kf(p_new, kf.kf_id)
                touched.append(p_new)
                continue
            if existing == p_new or not self.pt_valid[existing]:
                continue
            keep, drop = ((existing, p_new) if obs_of(existing) > obs_of(p_new)
                          else (p_new, existing))
            self.pt_valid[drop] = False
            self.pt_found[keep] += self.pt_found[drop]
            self.pt_visible[keep] += self.pt_visible[drop]
            kf.point_ids[kp[i]] = keep
            for kid in self.pt_obs_kf.pop(drop, set()):
                other = by_id.get(kid)
                if other is not None:
                    other.point_ids[other.point_ids == drop] = keep
                self._observe_kf(keep, kid)
            self._observe_point(keep, kf_desc[kp[i]], cam_center)
            self._observe_kf(keep, kf.kf_id)
            touched.append(keep)
            fused += 1
        self.refresh_descriptors(touched)
        return fused

    def cull_keyframes(self, min_redundant: float = 0.9) -> list[int]:
        """Drop keyframes whose map points are at least 90% seen by 3 other
        keyframes (``LocalMapping::KeyFrameCulling``), never the first two or
        the last; children of a culled keyframe go to its nearest surviving
        ancestor (``KeyFrame::SetBadFlag``). Returns the culled ids."""
        culled = []
        for kf in self.keyframes[2:-1]:
            pts = [int(p) for p in kf.point_ids[kf.point_ids >= 0] if self.pt_valid[p]]
            if len(pts) < 10:
                continue
            redundant = sum(1 for p in pts if len(self.pt_obs_kf.get(p, ())) >= 4)
            if redundant / len(pts) >= min_redundant:
                culled.append(kf.kf_id)
        culled_set = set(culled)
        parent_of = {kf.kf_id: kf.parent_id for kf in self.keyframes}
        for kf in self.keyframes:
            if kf.kf_id in culled_set:
                for p in kf.point_ids[kf.point_ids >= 0].tolist():
                    self.pt_obs_kf.get(int(p), set()).discard(kf.kf_id)
        self.keyframes = [kf for kf in self.keyframes if kf.kf_id not in culled_set]
        alive = {kf.kf_id for kf in self.keyframes}
        for kf in self.keyframes:
            p = kf.parent_id
            seen_chain = set()
            while p >= 0 and p not in alive and p not in seen_chain:
                seen_chain.add(p)
                p = parent_of.get(p, -1)
            kf.parent_id = p if (p in alive and p != kf.kf_id) else -1
        return culled

    def relocalize(self, feats: ORBFeatures, n_candidates: int = 3, kfdb=None):
        """``Tracking::Relocalization`` (``src/Tracking.cc:1718``): candidate
        keyframes from the BoW database (``DetectRelocalizationCandidates``)
        or else the 20 most recent, matched by ``SearchByBoW`` (brute force
        without a vocabulary), then robust PnP against their map points.
        Returns T_cw or None."""
        if kfdb is not None and kfdb.bows:
            by_id = {kf.kf_id: kf for kf in self.keyframes}
            cands = [by_id[cid] for cid, _s in kfdb.query_descriptors(feats.descriptors,
                                                                       feats.valid)
                     if cid in by_id][: max(n_candidates * 2, 5)]
        else:
            cands = self.keyframes[-20:]
        use_bow = kfdb is not None and getattr(kfdb, "vocab", None) is not None
        if use_bow:
            _w, _t, nodes_f = kfdb.vocab.transform_with_nodes(feats.descriptors, feats.valid)
        scored = []
        for kf in cands:
            if use_bow:
                _w2, _t2, nodes_k = kfdb.vocab.transform_with_nodes(kf.feats.descriptors,
                                                                    kf.feats.valid)
                m = search_by_bow(feats, kf.feats, nodes_f, nodes_k, max_dist=64)
            else:
                m = match_descriptors(feats, kf.feats, max_dist=64)
            scored.append((int(m.valid.sum()), kf, m))
        scored.sort(key=lambda x: -x[0])
        f_uv = _np(feats.uv)
        for n_match, kf, m in scored[:n_candidates]:
            if n_match < 15:
                break
            idx2 = _np(m.idx2)
            world, uv = [], []
            for i in np.nonzero(_np(m.valid))[0]:
                p = kf.point_ids[idx2[i]]
                if p >= 0 and self.pt_valid[p]:
                    world.append(self.pt_pos[p])
                    uv.append(f_uv[i])
            if len(world) < 12:
                continue
            res = ransac_pnp(np.stack(world), np.stack(uv).astype(np.float32),
                             np.ones(len(world), bool), self.cam, device=self.device)
            if res is not None and res.n_inliers >= 15:
                return res.T_cw
        return None

    def global_ba(self, outer_iters: int = 10) -> list[int]:
        """Bundle adjustment over every keyframe and its points, the post-loop
        ``RunGlobalBundleAdjustment`` (``src/LoopClosing.cc:648``)."""
        return self.local_ba(n_kfs=len(self.keyframes), outer_iters=outer_iters)

    def local_ba(self, n_kfs: int = 6, outer_iters: int = 8) -> list[int]:
        """Local BA over the most recent keyframes and their points, the
        oldest held fixed. Returns the adjusted keyframe ids."""
        kfs = self.keyframes[-n_kfs:]
        obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
        pts_used: dict[int, int] = {}
        for k, kf in enumerate(kfs):
            uv = _np(kf.feats.uv)
            octv = _np(kf.feats.octave)
            for i, p in enumerate(kf.point_ids):
                if p < 0 or not self.pt_valid[p]:
                    continue
                if p not in pts_used:
                    pts_used[p] = len(pts_used)
                obs_kf.append(k)
                obs_pt.append(pts_used[p])
                obs_uv.append(uv[i])
                obs_is2.append(1.0 / self.sigma2[octv[i]])
        if len(pts_used) < 10 or len(obs_kf) < 30:
            return []
        pt_ids = np.array(sorted(pts_used, key=pts_used.get), np.int64)
        fixed = np.zeros(len(kfs), bool)
        fixed[0] = True
        res = ba.local_bundle_adjustment(
            self._t(np.stack([kf.T_cw for kf in kfs])), self._t(self.pt_pos[pt_ids]),
            self._t(obs_kf, torch.int64), self._t(obs_pt, torch.int64),
            self._t(np.array(obs_uv, np.float32)), self._t(np.array(obs_is2, np.float32)),
            torch.ones(len(obs_kf), dtype=torch.bool, device=self.device), self.cam,
            fixed_mask=self._t(fixed, torch.bool), outer_iters=outer_iters,
        )
        new_poses = _np(res.poses)
        self.pt_pos[pt_ids] = _np(res.points)
        adjusted = []
        for i, kf in enumerate(kfs):
            if not fixed[i]:
                kf.T_cw = new_poses[i]
                adjusted.append(kf.kf_id)
        return adjusted
