"""Monocular bootstrap and two-view triangulation (counterpart of
``gsorb_slam_tpu/frontend/initializer.py``).

The reference ``Initializer`` (``src/Initializer.cc:46-935``): a homography
and a fundamental matrix are scored over batched RANSAC hypotheses at once,
the model is picked by the reference's ``RH = SH / (SH + SF) > 0.40`` rule,
decomposed into (R, t) candidates, and the candidate with the most
triangulated points in front of both cameras with enough parallax wins.
The hypothesis batch runs on the caller's device, one batched SVD per
model; the decompositions and the cheirality selection are host numpy, as
in the JAX package. The samples come from
``frontend.draws.draw_index_sets(seed, ...)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsorb_slam_tpu_torch.frontend import draws

CHI2_F = 3.841  # 1-DoF epipolar distance gate
CHI2_H = 5.991  # 2-DoF transfer error gate
TH_SCORE = 5.991


def _normalize(pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization by the mean absolute deviation: ``[N, 2]`` ->
    (normalized points, the ``[3, 3]`` transform)."""
    mu = pts.mean(0)
    d = (pts - mu).abs().mean(0)
    s = 1.0 / torch.clamp(d, min=1e-8)
    T = torch.zeros((3, 3), dtype=pts.dtype, device=pts.device)
    T[0, 0], T[0, 2] = s[0], -mu[0] * s[0]
    T[1, 1], T[1, 2] = s[1], -mu[1] * s[1]
    T[2, 2] = 1.0
    return (pts - mu) * s, T


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The last right singular vector of each ``[H, 8, 9]`` system (the full
    ``[9, 9]`` V, as the JAX SVD's ``full_matrices=True``) as ``[H, 3, 3]``;
    its sign is free."""
    return torch.linalg.svd(A, full_matrices=True).Vh[:, -1].reshape(-1, 3, 3)


def compute_f_batch(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point fundamental matrices of ``[H, 8, 2]`` sample pairs,
    projected to rank 2 -> ``[H, 3, 3]``."""
    a0, a1, b0, b1 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = torch.stack([b0 * a0, b0 * a1, b0, b1 * a0, b1 * a1, b1, a0, a1,
                     torch.ones_like(a0)], dim=-1)
    F = _null_vector(A)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    return U @ torch.diag_embed(S) @ Vt


def compute_h_batch(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT homographies of ``[H, 4, 2]`` sample pairs -> ``[H, 3, 3]``."""
    x, y, u, v = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    ru = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    rv = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    A = torch.stack([ru, rv], dim=2).reshape(p1.shape[0], 8, 9)  # rows u0, v0, u1, ...
    return _null_vector(A)


def score_f(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Symmetric epipolar chi^2 score (``CheckFundamental``) of ``[H, 3, 3]``
    hypotheses over ``[N, 2]`` pairs -> (``[H]`` scores, ``[H, N]`` inliers)."""
    x1, x2 = _homog(p1), _homog(p2)
    l2 = x1 @ F.transpose(1, 2)  # [H, N, 3]: lines in image 2
    l1 = x2 @ F  # lines in image 1
    d2 = (l2 * x2).sum(-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (l1 * x1).sum(-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return _score(d1, d2, CHI2_F)


def _score(d1: torch.Tensor, d2: torch.Tensor, chi2: float):
    zero = torch.zeros((), dtype=d1.dtype, device=d1.device)
    inl = (d1 < chi2) & (d2 < chi2)
    score = torch.where(d1 < chi2, TH_SCORE - d1, zero) + torch.where(d2 < chi2, TH_SCORE - d2,
                                                                        zero)
    return score.sum(-1), inl


def _dehomog(x: torch.Tensor) -> torch.Tensor:
    w = x[..., 2:]
    return x[..., :2] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def score_h(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Symmetric transfer chi^2 score (``CheckHomography``). A singular
    hypothesis gets a NaN inverse, as the JAX inverse gives it, so its
    reverse transfer passes no gate: it scores on its forward transfer
    alone and has no inlier. ``inv_ex`` neither raises nor synchronises."""
    x1, x2 = _homog(p1), _homog(p2)
    Hinv, info = torch.linalg.inv_ex(H)
    Hinv = torch.where((info == 0)[:, None, None], Hinv, torch.full_like(Hinv, float("nan")))
    d2 = ((_dehomog(x1 @ H.transpose(1, 2)) - p2) ** 2).sum(-1)
    d1 = ((_dehomog(x2 @ Hinv.transpose(1, 2)) - p1) ** 2).sum(-1)
    return _score(d1, d2, CHI2_H)


def triangulate(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor,
                p2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of ``[N]`` point pairs (``[N, 2]`` pixels each)
    under projection matrices ``[3, 4]`` -> ``[N, 3]``, one batched SVD."""
    A = torch.stack([
        p1[:, 0, None] * P1[2] - P1[0],
        p1[:, 1, None] * P1[2] - P1[1],
        p2[:, 0, None] * P2[2] - P2[0],
        p2[:, 1, None] * P2[2] - P2[1],
    ], dim=1)  # [N, 4, 4]
    X = torch.linalg.svd(A).Vh[:, -1]
    w = X[:, 3]
    return X[:, :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)[:, None]


def _drop_repeats(score: torch.Tensor, inl: torch.Tensor, draw: np.ndarray):
    """Scores -1 (below every real score, which is >= 0) and no inliers for
    the samples that repeat a point. The reference draws distinct points
    (``Initializer::Initialize``'s ``vAvailableIndices``); a repeat leaves a
    null space of two or more dimensions, where each SVD (LAPACK's on the
    host, cuSOLVER's on the card, the JAX package's) returns another vector
    of it, so such a hypothesis would score differently on every device."""
    d = np.sort(draw, axis=1)
    ok = torch.as_tensor((d[:, 1:] != d[:, :-1]).all(1), device=score.device)
    return torch.where(ok, score, torch.full_like(score, -1.0)), inl & ok[:, None]


class InitResult(NamedTuple):
    T_cw2: np.ndarray  # pose of frame 2 (frame 1 = identity)
    points: np.ndarray  # [N, 3] triangulated (inliers only meaningful)
    inliers: np.ndarray  # [N] bool
    model: str  # "H" or "F"


def initialize_monocular(
    uv1: np.ndarray,  # [N, 2] matched keypoints frame 1
    uv2: np.ndarray,  # [N, 2] matched keypoints frame 2
    K: np.ndarray,  # [3, 3] intrinsics
    seed: int = 0,
    n_hyp: int = 200,
    min_inliers: int = 50,
    min_parallax_deg: float = 1.0,
    device: torch.device | str = "cuda",
) -> Optional[InitResult]:
    """Full monocular bootstrap (``Initializer::Initialize``): the pose of
    frame 2 and the triangulated points at median depth 1, or None."""
    N = len(uv1)
    if N < 30:
        return None
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    p1, p2 = t(uv1), t(uv2)
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    draw_f, draw_h = draws.draw_index_sets(seed, [(n_hyp, 8), (n_hyp, 4)], N)
    idx_f, idx_h = (torch.as_tensor(np.array(i, np.int64), device=device) for i in (draw_f, draw_h))

    Fn = compute_f_batch(n1[idx_f], n2[idx_f])
    F = T2.T @ Fn @ T1  # denormalize: T2^T Fn T1
    sf, inl_f = _drop_repeats(*score_f(F, p1, p2), draw_f)
    Hn = compute_h_batch(n1[idx_h], n2[idx_h])
    H = torch.linalg.inv(T2) @ Hn @ T1
    sh, inl_h = _drop_repeats(*score_h(H, p1, p2), draw_h)

    bf = int(torch.argmax(sf))  # the first index wins a tie, as jnp.argmax
    bh = int(torch.argmax(sh))
    SF = float(sf[bf])
    SH = float(sh[bh])
    rh = SH / max(SH + SF, 1e-9)

    if rh > 0.40:
        model = "H"
        cand_RT = _decompose_h(H[bh].cpu().numpy(), K)
        inliers = inl_h[bh].cpu().numpy()
    else:
        model = "F"
        Kt = t(K)
        E = Kt.T @ F[bf] @ Kt
        cand_RT = _decompose_e(E.cpu().numpy())
        inliers = inl_f[bf].cpu().numpy()

    if inliers.sum() < min_inliers:
        return None

    # Cheirality: the (R, t) with the most triangulated points in front of
    # both cameras with enough parallax (``CheckRT``).
    Kn = np.asarray(K, np.float32)
    P1 = Kn @ np.hstack([np.eye(3), np.zeros((3, 1))])
    best = None
    for R, tv in cand_RT:
        P2 = Kn @ np.hstack([R, tv.reshape(3, 1)])
        X = triangulate(t(P1), t(P2), p1, p2).cpu().numpy()
        z1 = X[:, 2]
        Xc2 = X @ R.T + tv
        z2 = Xc2[:, 2]
        finite = np.isfinite(X).all(axis=1)
        good = inliers & finite & (z1 > 0) & (z2 > 0) & (np.abs(z1) < 1e4)
        c2 = -R.T @ tv
        r1 = X
        r2 = X - c2
        cosp = np.sum(r1 * r2, -1) / np.maximum(
            np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12)
        par = np.degrees(np.arccos(np.clip(cosp, -1, 1)))
        good_par = good & (par > 0.2)
        n_good = int(good_par.sum())
        med_par = float(np.median(par[good_par])) if n_good else 0.0
        if best is None or n_good > best[0]:
            best = (n_good, R, tv, X, good_par, med_par)

    n_good, R, tv, X, good, med_par = best
    if n_good < min_inliers or med_par < min_parallax_deg * 0.2:
        return None
    # Scale gauge: median scene depth 1.
    med_z = np.median(X[good, 2])
    if med_z <= 0:
        return None
    X = X / med_z
    tv = tv / med_z
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = tv
    return InitResult(T_cw2=T, points=X.astype(np.float32), inliers=good, model=model)


def _decompose_e(E: np.ndarray):
    """The four (R, t) of an essential matrix (``ReconstructF``)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / max(np.linalg.norm(t), 1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_h(H: np.ndarray, K: np.ndarray):
    """The JAX package's SVD homography decomposition: its candidate (R, t)
    set for the cheirality selection (the reference enumerates 8 Faugeras
    solutions, ``Initializer::ReconstructH``)."""
    A = np.linalg.inv(K) @ H @ K
    U, S, Vt = np.linalg.svd(A)
    A = A / S[1]
    out = []
    U, S, Vt = np.linalg.svd(A)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        # Near pure rotation: R = A orthonormalized, t = 0, left for the
        # cheirality test to reject.
        Uq, _, Vq = np.linalg.svd(A)
        out.append((Uq @ Vq, np.zeros(3)))
        return out
    s = np.linalg.det(U) * np.linalg.det(Vt)
    x1 = np.sqrt((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
    x3 = np.sqrt((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
    for e1 in (1, -1):
        for e3 in (1, -1):
            st = (e1 * e3 * np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                  / ((d1 + d3) * d2))
            ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
            Rp = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
            R = s * U @ Rp @ Vt
            tp = (d1 - d3) * np.array([e1 * x1, 0, -e3 * x3])
            t = U @ tp
            n = np.linalg.norm(t)
            if n > 1e-9:
                t = t / n
            out.append((R, t))
            out.append((R, -t))
    return out
