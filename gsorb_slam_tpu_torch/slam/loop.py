"""Loop detection and closure (counterpart of ``gsorb_slam_tpu/slam/loop.py``).

The reference's ``KeyFrameDatabase`` (an inverted BoW index with the
covisibility-consistent candidate grouping, ``src/KeyFrameDatabase.cc:76``)
and ``LoopClosing`` (``src/LoopClosing.cc``): candidate detection,
geometric verification (RANSAC Horn, ``SearchBySim3`` and the image-plane
``OptimizeSim3``), and pose-graph correction (``OptimizeEssentialGraph``).
The index, the BoW vectors and the Sim3 algebra of the correction are host
numpy; the matching and the optimizations run on the descriptors' device.

As in the reference, the Gaussian map is not warped by a loop closure: it
re-couples through the re-rendered keyframe poses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.frontend import sim3 as S3
from gsorb_slam_tpu_torch.frontend.ba import (
    pose_graph_optimization,
    sim3_pose_graph_optimization,
)
from gsorb_slam_tpu_torch.frontend.matcher import search_by_bow, search_by_sim3
from gsorb_slam_tpu_torch.frontend.orb import descriptors_from_numpy
from gsorb_slam_tpu_torch.frontend.vocab import Vocabulary, score_l1


class KeyFrameDatabase:
    """Inverted word -> keyframe index (``KeyFrameDatabase``)."""

    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.inverted: dict[int, set[int]] = {}
        self.bows: dict[int, dict[int, float]] = {}

    def add(self, kf_id: int, descriptors, valid) -> None:
        bow = self.vocab.bow_vector(descriptors, valid)
        self.bows[kf_id] = bow
        for w in bow:
            self.inverted.setdefault(w, set()).add(kf_id)

    def query_descriptors(self, descriptors, valid, exclude: set[int] = frozenset(),
                          rel_factor: float = 0.75) -> list[tuple[int, float]]:
        """Relocalization candidates for a frame
        (``DetectRelocalizationCandidates`` ``src/KeyFrameDatabase.cc:199``):
        keyframes sharing at least 0.8 of the most shared words, scored
        within ``rel_factor`` of the best, best first."""
        bow = self.vocab.bow_vector(descriptors, valid)
        if not bow:
            return []
        sharing: dict[int, int] = {}
        for w in bow:
            for other in self.inverted.get(w, ()):
                if other not in exclude:
                    sharing[other] = sharing.get(other, 0) + 1
        if not sharing:
            return []
        max_common = max(sharing.values())
        scored = [(other, score_l1(bow, self.bows[other]))
                  for other, common in sharing.items() if common >= 0.8 * max_common]
        if not scored:
            return []
        best = max(s for _, s in scored)
        out = [(o, s) for o, s in scored if s >= rel_factor * best]
        out.sort(key=lambda x: -x[1])
        return out

    def query(self, kf_id: int, exclude: set[int], min_score: float) -> list[tuple[int, float]]:
        """Loop candidates of a keyframe: those sharing at least 0.8 of the
        most shared words and scoring at least ``min_score``
        (``DetectLoopCandidates``; the caller tracks the consistency)."""
        bow = self.bows.get(kf_id)
        if not bow:
            return []
        sharing: dict[int, int] = {}
        for w in bow:
            for other in self.inverted.get(w, ()):
                if other != kf_id and other not in exclude:
                    sharing[other] = sharing.get(other, 0) + 1
        if not sharing:
            return []
        max_common = max(sharing.values())
        out = []
        for other, common in sharing.items():
            if common < 0.8 * max_common:
                continue
            s = score_l1(bow, self.bows[other])
            if s >= min_score:
                out.append((other, s))
        out.sort(key=lambda x: -x[1])
        return out


@dataclasses.dataclass
class LoopClosure:
    query_kf: int
    match_kf: int
    T_correction: np.ndarray  # corrective transform for the query pose


def _sim3_compose(a, b):
    """(s, R, t) triples: (a o b)(x) = a(b(x))."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta)


def _sim3_inv(a):
    s, R, t = a
    return (1.0 / s, R.T, -(R.T @ t) / s)


def _sim3_mat(a) -> np.ndarray:
    """(s, R, t) as a 4x4 with sR in the linear block (g2o Scw style)."""
    s, R, t = a
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = s * R
    M[:3, 3] = t
    return M


def _sim3_from_mat(M: np.ndarray):
    A = M[:3, :3]
    s = float(np.cbrt(max(np.linalg.det(A), 1e-18)))
    return (s, (A / s).astype(np.float32), M[:3, 3].astype(np.float32))


class LoopCloser:
    """Detection with temporal consistency, Sim3 / SE3 verification and
    pose-graph correction. ``min_consistency`` is mnCovisibilityConsistencyTh
    = 3; ``fix_scale`` is ``mbFixScale`` (True for RGB-D / stereo). The
    RANSAC draws use the fixed seed ``seed`` at every verification, as the
    JAX loop closer uses one fixed key (``PRNGKey(42)``)."""

    def __init__(self, vocab: Vocabulary, min_score: float = 0.015, min_inliers: int = 20,
                 min_consistency: int = 3, min_gap: int = 10, fix_scale: bool = True,
                 seed: int = 42):
        self.fix_scale = fix_scale
        self.db = KeyFrameDatabase(vocab)
        self.min_score = min_score
        self.min_inliers = min_inliers
        self.min_consistency = min_consistency
        self.min_gap = min_gap
        self.consistency: dict[int, int] = {}
        # The reference skips detection for 10 keyframes after a closure
        # (LoopClosing::DetectLoop, src/LoopClosing.cc:105).
        self.last_closed_kf: int = -1000
        self.seed = seed

    def add_keyframe(self, kf) -> None:
        self.db.add(kf.kf_id, kf.feats.descriptors, kf.feats.valid)

    def detect(self, kf, recent_ids: set[int]) -> Optional[int]:
        if kf.kf_id < self.last_closed_kf + 10:
            self.consistency = {}
            return None
        cands = self.db.query(kf.kf_id, recent_ids, self.min_score)
        new_consistency: dict[int, int] = {}
        detected = None
        for cid, _score in cands:
            streak = 1 + max((v for k, v in self.consistency.items() if abs(k - cid) <= 2),
                             default=0)
            new_consistency[cid] = streak
            if streak >= self.min_consistency and detected is None:
                detected = cid
        self.consistency = new_consistency
        return detected

    def verify(self, kf_query, kf_match, frontend, cam=None,
               debug: bool = False) -> Optional[np.ndarray]:
        """Geometric check: ``SearchByBoW`` between the keyframes, RANSAC
        Horn on the matched map points (``Sim3Solver``), three refits on a
        shrinking 3D threshold, then with ``cam`` ``SearchBySim3`` and the
        bidirectional image-plane refinement (``Optimizer::OptimizeSim3``).
        Returns the world-frame correction or None. ``debug`` prints the
        match, inlier and growth counts of each stage (the JAX method's
        lines)."""
        dev = frontend.device
        voc = self.db.vocab
        _w1, _t1, n1 = voc.transform_with_nodes(kf_query.feats.descriptors, kf_query.feats.valid)
        _w2, _t2, n2 = voc.transform_with_nodes(kf_match.feats.descriptors, kf_match.feats.valid)
        m = search_by_bow(kf_query.feats, kf_match.feats, n1, n2, max_dist=64)
        mv = m.valid.cpu().numpy()
        idx2 = m.idx2.cpu().numpy()
        p1_ids, p2_ids = kf_query.point_ids, kf_match.point_ids
        pairs, kp_pairs = [], []
        for i in np.nonzero(mv)[0]:
            p1, p2 = p1_ids[i], p2_ids[idx2[i]]
            if p1 >= 0 and p2 >= 0 and frontend.pt_valid[p1] and frontend.pt_valid[p2]:
                pairs.append((p1, p2))
                kp_pairs.append((i, idx2[i]))
        if debug:
            print(f"    verify[{kf_query.kf_id}->{kf_match.kf_id}]: "
                  f"bow_matches={int(mv.sum())} mp_pairs={len(pairs)} "
                  f"(min {self.min_inliers})", flush=True)
        if len(pairs) < self.min_inliers:
            return None
        pairs = np.array(pairs)
        kp_pairs = np.array(kp_pairs)
        x1 = frontend.pt_pos[pairs[:, 0]]
        x2 = frontend.pt_pos[pairs[:, 1]]
        # The hypotheses draw over a power-of-two row count (at least 64)
        # whose padding rows are zero points, as in the JAX package: the
        # padding changes which triples are drawn.
        n = len(pairs)
        cap = 64
        while cap < n:
            cap *= 2
        pad = np.zeros((cap - n, 3), np.float32)
        pvalid = np.zeros(cap, bool)
        pvalid[:n] = True
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        res = S3.ransac_sim3(t(np.concatenate([x1, pad])), t(np.concatenate([x2, pad])),
                             t(pvalid, torch.bool), self.seed, fix_scale=self.fix_scale)
        if debug:
            print(f"    verify: ransac_inliers={int(res.n_inliers)}", flush=True)
        if int(res.n_inliers) < self.min_inliers:
            return None
        # Iterative inlier refinement, the OptimizeSim3 analog: re-gate on
        # 3D residuals against a shrinking threshold, refit Horn on the host.
        R = res.R.cpu().numpy()
        tt = res.t.cpu().numpy()
        s = float(res.s)
        inl = res.inliers.cpu().numpy()[:n]
        for th in (0.10, 0.07, 0.05):
            d = np.linalg.norm(x2 - (s * (x1 @ R.T) + tt), axis=-1)
            inl = d < th
            if debug:
                print(f"    verify: refit th={th} inliers={int(inl.sum())}", flush=True)
            if inl.sum() < self.min_inliers:
                return None
            a, b = x1[inl], x2[inl]
            mu1, mu2 = a.mean(0), b.mean(0)
            ca, cb = a - mu1, b - mu2
            U, S_sv, Vt = np.linalg.svd(cb.T @ ca)
            sgn = np.sign(np.linalg.det(U @ Vt))
            R = (U @ np.diag([1.0, 1.0, sgn]) @ Vt).astype(np.float32)
            if not self.fix_scale:
                s = float((S_sv[0] + S_sv[1] + sgn * S_sv[2]) / max((ca * ca).sum(), 1e-12))
            tt = (mu2 - s * (R @ mu1)).astype(np.float32)
        # x2 = s R x1 + t maps query-side point coordinates onto the older,
        # drift-free match side: the world-frame correction.
        T_corr = _sim3_mat((s, R, tt))
        if cam is None:
            return T_corr

        T1, T2 = kf_query.T_cw, kf_match.T_cw
        # Sim3 embeddings compose as 4x4 algebra: S12 = T1 S_corr^-1 T2^-1.
        T12 = T1 @ np.linalg.inv(T_corr) @ np.linalg.inv(T2)
        s12, R12, t12 = _sim3_from_mat(T12)
        T12_se3 = np.eye(4, dtype=np.float32)
        T12_se3[:3, :3] = R12
        T12_se3[:3, 3] = t12

        def per_feature(kf):
            pids = np.asarray(kf.point_ids)
            safe = np.maximum(pids, 0)
            return (t(frontend.pt_pos[safe]), descriptors_from_numpy(frontend.pt_desc[safe], dev),
                    (pids >= 0) & frontend.pt_valid[safe],
                    t(frontend.pt_min_dist[safe]), t(frontend.pt_max_dist[safe]))

        w1, d1, h1, lo1, hi1 = per_feature(kf_query)
        w2, d2, h2, lo2, hi2 = per_feature(kf_match)
        h1[kp_pairs[:, 0]] = False  # already matched
        h2[kp_pairs[:, 1]] = False
        m12, _n_new = search_by_sim3(
            w1, d1, t(h1, torch.bool), lo1, hi1, kf_query.feats,
            w2, d2, t(h2, torch.bool), lo2, hi2, kf_match.feats,
            t(T1), t(T2), float(np.float32(s12)), t(R12), t(t12), cam,
            t(frontend.scale_factors))
        m12 = m12.cpu().numpy()
        grown = np.nonzero(m12 >= 0)[0]
        if debug:
            print(f"    verify: SearchBySim3 grew {len(grown)} matches", flush=True)
        if len(grown):
            gp = np.stack([grown, m12[grown]], axis=1)
            kp_pairs = np.concatenate([kp_pairs, gp])
            x1 = np.concatenate([x1, frontend.pt_pos[kf_query.point_ids[gp[:, 0]]]])
            x2 = np.concatenate([x2, frontend.pt_pos[kf_match.point_ids[gp[:, 1]]]])
            inl = np.concatenate([inl, np.ones(len(grown), bool)])
        xc1 = x1 @ T1[:3, :3].T + T1[:3, 3]  # query points, camera 1
        xc2 = x2 @ T2[:3, :3].T + T2[:3, 3]  # match points, camera 2
        uv1 = kf_query.feats.uv.cpu().numpy()[kp_pairs[:, 0]]
        uv2 = kf_match.feats.uv.cpu().numpy()[kp_pairs[:, 1]]
        is1 = (1.0 / frontend.sigma2[kf_query.feats.octave.cpu().numpy()[kp_pairs[:, 0]]])
        is2 = (1.0 / frontend.sigma2[kf_match.feats.octave.cpu().numpy()[kp_pairs[:, 1]]])
        T12_r, ls_r, _inl_r, n_r = S3.optimize_sim3_reprojection(
            t(T12_se3), t(xc2), t(uv1), t(xc1), t(uv2), t(is1), t(is2), t(inl, torch.bool),
            cam, fix_scale=self.fix_scale, log_s_init=float(np.log(max(s12, 1e-12))))
        T12_np = T12_r.cpu().numpy()
        if int(n_r) >= self.min_inliers and bool(np.isfinite(T12_np).all()):
            # T_corr = T2^-1 S12^-1 T1, exact for sR|t embeddings.
            S12 = _sim3_mat((float(np.exp(float(ls_r))), T12_np[:3, :3], T12_np[:3, 3]))
            T_corr = (np.linalg.inv(T2) @ np.linalg.inv(S12) @ T1).astype(np.float32)
        return T_corr

    def correct(self, keyframes: list, query_kf_id: int, match_kf_id: int, T_corr: np.ndarray,
                covis_edges: list[tuple[int, int, float]],
                device: torch.device | str = "cuda",
                ) -> tuple[dict[int, np.ndarray], Optional[dict[int, np.ndarray]]]:
        """Pose-graph correction, the ``OptimizeEssentialGraph`` analog:
        spanning-tree edges (odometry edges fill the gaps) and covisibility
        edges keep relative poses, the loop edge (weight 5) pins the query
        to the match through ``T_corr``. Returns ``({kf_id: corrected T_cw},
        point_corr)``; ``point_corr`` maps each keyframe's old world
        coordinates to corrected ones on the 7-DoF path (None on the
        fixed-scale path, where the global BA recovers the points)."""
        id_index = {kf.kf_id: i for i, kf in enumerate(keyframes)}
        K = len(keyframes)
        poses = np.stack([kf.T_cw for kf in keyframes]).astype(np.float32)
        edges_i, edges_j, rels, ws = [], [], [], []

        def edge(a, b, w, rel=None):
            edges_i.append(a)
            edges_j.append(b)
            rels.append(poses[a] @ np.linalg.inv(poses[b]) if rel is None else rel)
            ws.append(w)

        tree_pairs = set()
        for kf in keyframes:
            par = getattr(kf, "parent_id", -1)
            if par >= 0 and par in id_index:
                a, b = id_index[par], id_index[kf.kf_id]
                edge(a, b, 1.0)
                tree_pairs.add((min(a, b), max(a, b)))
        for a in range(K - 1):
            if (a, a + 1) not in tree_pairs:
                edge(a, a + 1, 1.0)
        for i_id, j_id, w in covis_edges:
            if i_id in id_index and j_id in id_index:
                edge(id_index[i_id], id_index[j_id], min(w / 100.0, 1.0))
        qa, mb = id_index[query_kf_id], id_index[match_kf_id]
        s_corr, R_corr, t_corr = _sim3_from_mat(T_corr)
        scale_active = (not self.fix_scale) and abs(np.log(s_corr)) > 1e-6
        fixed = np.zeros(K, bool)
        fixed[mb] = True
        fixed[0] = True
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        if not scale_active:
            # Points move x -> S_corr x, so camera-from-world absorbs the inverse.
            T_query_corrected = poses[qa] @ np.linalg.inv(T_corr)
            edge(qa, mb, 5.0, T_query_corrected @ np.linalg.inv(poses[mb]))
            new_poses = pose_graph_optimization(
                t(poses), t(edges_i, torch.int64), t(edges_j, torch.int64),
                t(np.stack(rels).astype(np.float32)), t(np.array(ws, np.float32)),
                t(fixed, torch.bool), iters=50).cpu().numpy()
            return {kf.kf_id: new_poses[i] for i, kf in enumerate(keyframes)}, None

        # 7-DoF path (monocular): odometry / covisibility edges carry relative
        # scale 1, the loop edge the verified drift scale.
        S_qc = _sim3_compose((1.0, poses[qa][:3, :3], poses[qa][:3, 3]),
                             _sim3_inv((s_corr, R_corr, t_corr)))
        s_rel, R_rel, t_rel = _sim3_compose(S_qc, _sim3_inv((1.0, poses[mb][:3, :3],
                                                             poses[mb][:3, 3])))
        rel_loop = np.eye(4, dtype=np.float32)
        rel_loop[:3, :3] = R_rel
        rel_loop[:3, 3] = t_rel
        edge(qa, mb, 5.0, rel_loop)
        rel_ls = np.zeros(len(rels), np.float32)
        rel_ls[-1] = np.log(s_rel)
        new_poses, new_ls = sim3_pose_graph_optimization(
            t(poses), torch.zeros(K, device=device), t(edges_i, torch.int64),
            t(edges_j, torch.int64), t(np.stack(rels).astype(np.float32)), t(rel_ls),
            t(np.array(ws, np.float32)), t(fixed, torch.bool), iters=50)
        new_poses = new_poses.cpu().numpy()
        new_s = np.exp(new_ls.cpu().numpy())
        out_poses, point_corr = {}, {}
        for i, kf in enumerate(keyframes):
            Ri, ti, si = new_poses[i][:3, :3], new_poses[i][:3, 3], float(new_s[i])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Ri
            T[:3, 3] = ti / si  # metric pose (g2o::Sim3 -> SE3)
            out_poses[kf.kf_id] = T
            S_old = (1.0, poses[i][:3, :3].copy(), poses[i][:3, 3].copy())
            point_corr[kf.kf_id] = _sim3_mat(_sim3_compose(_sim3_inv((si, Ri, ti)), S_old))
        return out_poses, point_corr
