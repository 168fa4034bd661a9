"""ORB descriptor matching as batched bit math (counterpart of
``gsorb_slam_tpu/frontend/matcher.py``).

The reference's ``ORBmatcher`` (``src/ORBmatcher.cc``): Hamming distances
are XOR and a population count over ``[N1, N2]`` blocks of the eight
descriptor words, and the ratio test, the rotation-consistency histogram
and the projection windows are masked ``argmin`` reductions (the first
index wins a tie, as ``jnp.argmin``). Thresholds mirror the reference:
TH_LOW = 50, TH_HIGH = 100, HISTO_LENGTH = 30 (``src/ORBmatcher.cc:35-41``).

PyTorch has no population count: :func:`popcount32` is the SWAR count on
``int64`` words masked to 32 bits, exact on every device.
``compute_stereo_matches`` belongs to the stereo entry point and is not
ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.transforms import _matmul3, _matvec
from gsorb_slam_tpu_torch.frontend.orb import ORBFeatures

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 30
# Row tiles of the Hamming block stay under this many int64 elements (256 MB).
_BLOCK_ELEMS = 1 << 25


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word in ``x`` (any integer dtype; the low 32
    bits count), as ``int64``."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """``[N1, 8]`` x ``[N2, 8]`` descriptor words -> ``[N1, N2]`` int32 Hamming
    distances (``DescriptorDistance`` ``src/ORBmatcher.cc:1647``, batched),
    in row tiles whose ``[rows, N2, 8]`` XOR block stays under 256 MB."""
    n1, n2 = d1.shape[0], d2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    a = d1.to(torch.int64)
    b = d2.to(torch.int64)
    rows = max(1, _BLOCK_ELEMS // max(n2 * 8, 1))
    for r0 in range(0, n1, rows):
        x = a[r0:r0 + rows, None, :] ^ b[None, :, :]
        out[r0:r0 + rows] = popcount32(x).sum(-1).to(torch.int32)
    return out


class MatchResult(NamedTuple):
    idx2: torch.Tensor  # [N1] best match in set 2 (-1 = none)
    dist: torch.Tensor  # [N1] Hamming distance of the best match
    valid: torch.Tensor  # [N1] bool


def _big(ref: torch.Tensor) -> torch.Tensor:
    return torch.full((), BIG, dtype=torch.int32, device=ref.device)


def _best(D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise first argmin and its value."""
    best = torch.argmin(D, dim=1)
    return best, torch.gather(D, 1, best[:, None])[:, 0]


def _rotation_consistency(
    angle1: torch.Tensor, angle2_at_match: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 most common
    of 30 histogram bins (``ComputeThreeMaxima``), dropping bins under 10%
    of the largest (``src/ORBmatcher.cc:1640``)."""
    rot = (angle1 - angle2_at_match) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.clamp((rot * HISTO_LENGTH / 360.0).to(torch.int32), 0, HISTO_LENGTH - 1)
    onehot = bins[:, None] == torch.arange(HISTO_LENGTH, device=bins.device)
    hist = (onehot & valid[:, None]).to(torch.int32).sum(0)
    top3 = torch.topk(hist, 3).values
    keep_bin = (hist >= top3[2]) & (hist.to(torch.float32) > 0.1 * top3[0].to(torch.float32))
    return valid & keep_bin[bins.long()]


def _ratio_mutual(D: torch.Tensor, valid1: torch.Tensor, max_dist: int, ratio: float):
    """Best match, Lowe ratio against the second best, and the mutual-best
    check (the reference enforces a unique target index)."""
    best2, d_best = _best(D)
    rows = torch.arange(D.shape[0], device=D.device)
    D2 = D.clone()
    D2[rows, best2] = BIG
    d_second = D2.min(dim=1).values
    valid = (valid1 & (d_best <= max_dist)
             & (d_best.to(torch.float32) < ratio * d_second.to(torch.float32)))
    rev_best = torch.argmin(torch.where(valid[:, None], D, _big(D)), dim=0)
    valid = valid & (rev_best[best2] == rows)
    return best2, d_best, valid


def match_descriptors(
    f1: ORBFeatures,
    f2: ORBFeatures,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    check_rotation: bool = True,
) -> MatchResult:
    """Brute-force best match with the Lowe ratio, mutual-best and rotation
    consistency: the ``SearchForInitialization`` / ``SearchByBoW`` core."""
    D = hamming_matrix(f1.descriptors, f2.descriptors)
    D = torch.where(f2.valid[None, :] & f1.valid[:, None], D, _big(D))
    best2, d_best, valid = _ratio_mutual(D, f1.valid, max_dist, ratio)
    if check_rotation:
        valid = _rotation_consistency(f1.angle, f2.angle[best2], valid)
    return MatchResult(idx2=torch.where(valid, best2, -1), dist=d_best, valid=valid)


def search_by_bow(
    f1: ORBFeatures,
    f2: ORBFeatures,
    nodes1: torch.Tensor,  # [N1] direct-index node ids (-1 invalid)
    nodes2: torch.Tensor,  # [N2]
    max_dist: int = TH_LOW,
    ratio: float = 0.75,
    check_rotation: bool = True,
) -> MatchResult:
    """Direct-index-bucketed matching (``SearchByBoW``
    ``src/ORBmatcher.cc:159,522``): only pairs whose vocabulary descent
    lands in the same tree node are candidates (DBoW2's ``FeatureVector``
    walk as a masked distance matrix), with the same ratio and rotation
    gates."""
    D = hamming_matrix(f1.descriptors, f2.descriptors)
    same = (nodes1[:, None] == nodes2[None, :]) & (nodes1 >= 0)[:, None]
    D = torch.where(same & f1.valid[:, None] & f2.valid[None, :], D, _big(D))
    best2, d_best, valid = _ratio_mutual(D, f1.valid, max_dist, ratio)
    if check_rotation:
        valid = _rotation_consistency(f1.angle, f2.angle[best2], valid)
    return MatchResult(idx2=torch.where(valid, best2, -1), dist=d_best, valid=valid)


def fundamental_from_poses(T1_cw: torch.Tensor, T2_cw: torch.Tensor,
                           K: torch.Tensor) -> torch.Tensor:
    """F12 mapping image-1 points to epipolar lines in image 2
    (``ComputeF12`` ``src/LocalMapping.cc``)."""
    T21 = _matmul3(T2_cw, torch.linalg.inv(T1_cw))
    R, t = T21[:3, :3], T21[:3, 3]
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([z, -t[2], t[1]]), torch.stack([t[2], z, -t[0]]),
                      torch.stack([-t[1], t[0], z])])
    Kinv = torch.linalg.inv(K)
    return _matmul3(_matmul3(_matmul3(Kinv.T, tx), R), Kinv)


def _homog(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)


def search_for_triangulation(
    f1: ORBFeatures,
    f2: ORBFeatures,
    F12: torch.Tensor,
    unmatched1: torch.Tensor,  # [N1] bool: keypoints without a map point
    unmatched2: torch.Tensor,
    max_dist: int = TH_LOW,
    epi_th: float = 3.84,
) -> MatchResult:
    """Descriptor matching constrained to the epipolar line: candidates for
    new-point triangulation (``SearchForTriangulation``
    ``src/ORBmatcher.cc:657``)."""
    D = hamming_matrix(f1.descriptors, f2.descriptors)
    lines2 = _matvec(F12[None], _homog(f1.uv))  # [N1, 3] epipolar lines in image 2
    x2 = _homog(f2.uv)
    num = (lines2[:, None, :] * x2[None, :, :]).sum(-1) ** 2
    den = torch.clamp(lines2[:, None, 0] ** 2 + lines2[:, None, 1] ** 2, min=1e-12)
    mask = ((num / den < epi_th) & (f1.valid & unmatched1)[:, None]
            & (f2.valid & unmatched2)[None, :])
    D = torch.where(mask, D, _big(D))
    best, d_best = _best(D)
    valid = d_best <= max_dist
    return MatchResult(idx2=torch.where(valid, best, -1), dist=d_best, valid=valid)


def _predict_level(dist3d, max_d, scale_factors):
    """``MapPoint::PredictScale``: the octave a point at ``dist3d`` is
    expected at, from its scale-invariance max distance."""
    L = scale_factors.shape[0]
    log_sf = torch.log(scale_factors[min(1, L - 1)])
    ratio = torch.clamp(max_d, min=1e-6) / torch.clamp(dist3d, min=1e-6)
    return torch.clamp(torch.ceil(torch.log(ratio) / torch.clamp(log_sf, min=1e-6))
                       .to(torch.int32), 0, L - 1).long()


def _window_match(u, v, r_pt, oct_ok, ok, desc, frame: ORBFeatures, max_dist: int):
    """Best Hamming match among the frame's keypoints within ``r_pt`` px of
    each projection ``(u, v)``."""
    du = u[:, None] - frame.uv[None, :, 0]
    dv = v[:, None] - frame.uv[None, :, 1]
    within = (du * du + dv * dv) <= (r_pt * r_pt)[:, None]
    D = hamming_matrix(desc, frame.descriptors)
    D = torch.where(within & oct_ok & frame.valid[None, :] & ok[:, None], D, _big(D))
    best, d_best = _best(D)
    return best, d_best


def search_by_projection(
    world: torch.Tensor,  # [M, 3] map-point positions
    descriptors: torch.Tensor,  # [M, 8] representative descriptors
    pt_valid: torch.Tensor,  # [M] bool
    frame: ORBFeatures,
    T_cw: torch.Tensor,
    cam: Camera,
    radius: float = 15.0,
    max_dist: int = TH_HIGH,
    normals: Optional[torch.Tensor] = None,  # [M, 3] mean viewing directions
    min_dists: Optional[torch.Tensor] = None,  # [M] scale-invariance min dist
    max_dists: Optional[torch.Tensor] = None,  # [M] scale-invariance max dist
    scale_factors: Optional[torch.Tensor] = None,  # [L] per-octave 1.2^l
    octave_lo: int = 1,  # candidate octaves [pred - octave_lo, pred + octave_hi]
    octave_hi: int = 0,
    use_view_cos_radius: bool = True,  # False: Fuse semantics (r = th * sf)
) -> MatchResult:
    """Project map points into the frame and match within a pixel window
    (``SearchByProjection`` ``src/ORBmatcher.cc:45,1328``; the per-cell grid
    lookup becomes a masked distance matrix). With ``normals``, points seen
    more than 60 degrees off their mean viewing direction are excluded
    (``Frame::isInFrustum``'s viewCos < 0.5 gate). With the scale-invariance
    distances and ``scale_factors`` (``MapPoint::PredictScale``,
    ``GetMin/MaxDistanceInvariance``), points outside [0.8 minD, 1.2 maxD]
    are dropped, the window is ``radius * RadiusByViewingCos * sf[pred]``
    and candidates are restricted to octaves near the predicted one;
    entries with ``max_dists <= 0`` skip those gates."""
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    xc = _matvec(R[None], world) + t
    z = xc[:, 2]
    in_front = z > 0.05
    safe_z = torch.where(in_front, z, torch.ones_like(z))
    u = cam.fx * xc[:, 0] / safe_z + cam.cx
    v = cam.fy * xc[:, 1] / safe_z + cam.cy
    ok = pt_valid & in_front & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    cam_center = -_matvec(R.T, t)
    view = world - cam_center[None, :]
    dist3d = torch.linalg.norm(view, dim=-1)
    view_cos = None
    if normals is not None:
        vn = view / torch.clamp(dist3d[:, None], min=1e-9)
        view_cos = (vn * normals).sum(-1)
        has_normal = torch.linalg.norm(normals, dim=-1) > 0.5
        ok = ok & (~has_normal | (view_cos > 0.5))
        view_cos = torch.where(has_normal, view_cos, torch.ones_like(view_cos))

    if min_dists is not None and max_dists is not None and scale_factors is not None:
        has_range = max_dists > 0
        ok = ok & (~has_range | ((dist3d >= 0.8 * min_dists) & (dist3d <= 1.2 * max_dists)))
        pred = _predict_level(dist3d, max_dists, scale_factors)
        if not use_view_cos_radius:
            base_r = 1.0
        elif view_cos is None:
            base_r = 4.0
        else:
            base_r = torch.where(view_cos > 0.998, 2.5, 4.0)
        fallback_r = radius * (4.0 if use_view_cos_radius else 1.0)
        r_pt = torch.where(has_range, radius * base_r * scale_factors[pred],
                           torch.full_like(dist3d, fallback_r))
        kp_oct = frame.octave[None, :]
        oct_ok = ~has_range[:, None] | ((kp_oct >= pred[:, None] - octave_lo)
                                        & (kp_oct <= pred[:, None] + octave_hi))
    else:
        r_pt = torch.full((world.shape[0],), radius, dtype=torch.float32, device=world.device)
        oct_ok = torch.ones((1, 1), dtype=torch.bool, device=world.device)

    best, d_best = _window_match(u, v, r_pt, oct_ok, ok, descriptors, frame, max_dist)
    valid = ok & (d_best <= max_dist)
    return MatchResult(idx2=torch.where(valid, best, -1), dist=d_best, valid=valid)


def _sim3_directional(world, desc, pvalid, min_d, max_d, feats: ORBFeatures, A_R, A_t,
                      cam: Camera, scale_factors, th: float, max_dist: int) -> torch.Tensor:
    """One direction of ``SearchBySim3`` (``src/ORBmatcher.cc:1102-1226``):
    source map points through the scaled-rigid composite ``A`` into the
    target camera, gated on depth, image bounds and the scale-invariance
    range in the transformed frame, searched in a ``th * sf[pred]`` window
    over octaves [pred - 1, pred]; the best feature index per point (-1 =
    none)."""
    xc = _matvec(A_R[None], world) + A_t
    z = xc[:, 2]
    ok = pvalid & (z > 0.0)
    safe_z = torch.where(z > 0.0, z, torch.ones_like(z))
    u = cam.fx * xc[:, 0] / safe_z + cam.cx
    v = cam.fy * xc[:, 1] / safe_z + cam.cy
    ok = ok & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    dist3d = torch.linalg.norm(xc, dim=-1)
    has_range = max_d > 0
    ok = ok & (~has_range | ((dist3d >= 0.8 * min_d) & (dist3d <= 1.2 * max_d)))
    pred = _predict_level(dist3d, max_d, scale_factors)
    r_pt = torch.where(has_range, th * scale_factors[pred], torch.full_like(dist3d, th * 4.0))
    kp_oct = feats.octave[None, :]
    oct_ok = ~has_range[:, None] | ((kp_oct >= pred[:, None] - 1) & (kp_oct <= pred[:, None]))
    best, d_best = _window_match(u, v, r_pt, oct_ok, ok, desc, feats, max_dist)
    return torch.where(ok & (d_best <= max_dist), best, -1)


def search_by_sim3(
    world1, desc1, valid1, min_d1, max_d1, feats1: ORBFeatures,
    world2, desc2, valid2, min_d2, max_d2, feats2: ORBFeatures,
    T1_cw: torch.Tensor, T2_cw: torch.Tensor,
    s12: float, R12: torch.Tensor, t12: torch.Tensor,
    cam: Camera, scale_factors: torch.Tensor,
    th: float = 7.5, max_dist: int = TH_HIGH,
) -> tuple[torch.Tensor, int]:
    """``SearchBySim3`` (``src/ORBmatcher.cc:1102-1288``): grow the matches
    between two loop keyframes with a Sim3 estimate. KF1's per-feature map
    points go into KF2 through ``sR21``, KF2's into KF1 through ``sR12``,
    and only mutual agreements stay (``:1290-1308``). Returns ``(match12
    [N1] feature index in KF2 or -1, n_new)``."""
    R1w, t1w = T1_cw[:3, :3], T1_cw[:3, 3]
    R2w, t2w = T2_cw[:3, :3], T2_cw[:3, 3]
    sR12 = s12 * R12
    sR21 = (1.0 / s12) * R12.T
    t21 = -_matvec(sR21, t12)
    A2_R = _matmul3(sR21, R1w)  # world -> cam2' through cam1
    A2_t = _matvec(sR21, t1w) + t21
    A1_R = _matmul3(sR12, R2w)  # world -> cam1' through cam2
    A1_t = _matvec(sR12, t2w) + t12
    m12 = _sim3_directional(world1, desc1, valid1, min_d1, max_d1, feats2, A2_R, A2_t, cam,
                            scale_factors, th, max_dist)
    m21 = _sim3_directional(world2, desc2, valid2, min_d2, max_d2, feats1, A1_R, A1_t, cam,
                            scale_factors, th, max_dist)
    j = torch.clamp(m12, min=0)
    mutual = (m12 >= 0) & (m21[j] == torch.arange(m12.shape[0], device=m12.device))
    return torch.where(mutual, m12, -1), int(mutual.sum())
