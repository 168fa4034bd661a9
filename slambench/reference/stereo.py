"""The plain reference of ORB-SLAM2's stereo matching,
``Frame::ComputeStereoMatches`` (``src/Frame.cc``), written from the
source's loops in plain PyTorch (float32), importing nothing of the
program.

From the left and right keypoints (level-0 ``uv``, ``octave``, 256-bit
descriptors as eight 32-bit words, ``valid``), the two images' unblurred
pyramids and ``bf``, ``minZ`` and the per-level scale factors, it finds
each left keypoint's right coordinate and depth:

1. a row table: each right keypoint is listed on the rows ``floor(vR -
   r)`` to ``ceil(vR + r)``, ``r = 2 * scale[octave_R]``; a left keypoint
   at row ``vL`` tries the keypoints listed on row ``int(vL)`` whose
   octave is within one of its own and whose ``uR`` lies in ``[uL - maxD,
   uL - minD]`` (``minD = 0``, ``maxD = bf / minZ``), keeping the first
   with the least Hamming distance below ``TH_HIGH``, and goes on only if
   that distance is below ``thOrbDist = (TH_HIGH + TH_LOW) / 2``;
2. the SAD search on the pyramid level of the left keypoint's octave:
   coordinates times ``1 / scale``, rounded half away from zero; the
   column test ``scaleduR0 + L - w < 0 or scaleduR0 + L + w + 1 >= cols``
   drops it (w = L = 5); the 11 x 11 left patch less its centre against
   the right patch at ``scaleduR0 + incR``, incR = -5..5, less its centre,
   by the L1 norm; the first least distance wins; a best shift at +-L drops
   it; the parabola ``deltaR = (d1 - d3) / (2 (d1 + d3 - 2 d2))`` through
   the three distances around it, dropped beyond +-1; ``uR = scale
   (scaleduR0 + incR + deltaR)``, ``disparity = uL - uR`` kept in ``[minD,
   maxD)``, 0 set to 0.01 (``uR = uL - 0.01``), ``depth = bf / disparity``;
3. the median filter: over the kept keypoints sorted by distance, the
   median is the one at index ``n / 2``; every kept keypoint at or above
   ``1.5f * 1.4f`` times it is dropped.

A dropped keypoint reads ``u_right = -1`` and ``depth = 0`` (the source
writes -1 to the depth too; the program's no-match depth is 0).

Departures from ``Frame.cc``, all from the program's float pyramid: the
source's pyramid is 8-bit, so its L1 distances are whole numbers, and
``int bestDist`` and the ``int`` distances of its median filter hold them
exactly; here the levels are float32 and the distances are compared as
floats (summed in float64, as OpenCV's ``norm`` accumulates, then float32,
as the source stores them). A patch that would leave its level raises, as
the source's ``cv::Mat`` ranges do (ORB's 19-pixel keypoint border keeps
every patch inside).
"""

from __future__ import annotations

import math

import numpy as np
import torch

TH_HIGH = 100
TH_LOW = 50
W = 5  # half the SAD window
L = 5  # the SAD search's reach
F32 = torch.float32


def _f(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def c_round(x: float) -> int:
    """C's ``round``: halves away from zero."""
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def descriptor_distance(a: list[int], b: list[int]) -> int:
    """Bits that differ between two 256-bit descriptors (eight words)."""
    return sum(bin((x ^ y) & 0xFFFFFFFF).count("1") for x, y in zip(a, b))


def _host(feats) -> dict:
    return dict(uv=feats.uv.detach().cpu().to(F32), octave=feats.octave.cpu().tolist(),
                desc=feats.descriptors.cpu().to(torch.int64).tolist(),
                valid=feats.valid.cpu().tolist())


def compute_stereo_matches(fL, fR, levels_l: list, levels_r: list, bf: float, min_z: float,
                           scale_factors) -> dict:
    """``fL`` / ``fR``: any objects with ``uv [N, 2]``, ``octave [N]``,
    ``descriptors [N, 8]`` (int32 words) and ``valid [N]``; ``levels_*``:
    the pyramids (``[H_l, W_l]`` per level); ``scale_factors`` per level.
    Returns ``u_right``, ``depth`` (float32 ``[NL]``), ``valid`` (bool)
    and, per left keypoint, what each decision read: ``dist`` (the best L1
    distance), ``second`` (the next least one), ``shift`` (its incR),
    ``delta`` (deltaR), ``disparity`` (NaN where the keypoint stopped
    earlier), and the filter's threshold ``th_dist``."""
    kl, kr = _host(fL), _host(fR)
    lv_l = [lv.detach().cpu().to(F32) for lv in levels_l]
    lv_r = [lv.detach().cpu().to(F32) for lv in levels_r]
    sf = torch.as_tensor(scale_factors).detach().cpu().to(F32)
    inv_sf = _f(1.0) / sf
    n_l, n_r = len(kl["valid"]), len(kr["valid"])
    n_rows = lv_l[0].shape[0]
    min_d = _f(0.0)
    max_d = _f(np.float32(bf) / np.float32(min_z))
    th_orb = (TH_HIGH + TH_LOW) // 2

    u_right = torch.full((n_l,), -1.0, dtype=F32)
    depth = torch.zeros(n_l, dtype=F32)
    valid = torch.zeros(n_l, dtype=torch.bool)
    nan = float("nan")
    detail = {k: torch.full((n_l,), nan, dtype=torch.float64)
              for k in ("dist", "second", "shift", "delta", "disparity")}

    # The row table.
    rows: list[list[int]] = [[] for _ in range(n_rows)]
    for i_r in range(n_r):
        if not kr["valid"][i_r]:
            continue
        v = kr["uv"][i_r, 1]
        r = _f(2.0) * sf[kr["octave"][i_r]]
        for y in range(math.floor(float(v - r)), math.ceil(float(v + r)) + 1):
            if 0 <= y < n_rows:
                rows[y].append(i_r)

    dist_idx: list[tuple[float, int]] = []
    for i_l in range(n_l):
        if not kl["valid"][i_l]:
            continue
        level = kl["octave"][i_l]
        u_l, v_l = kl["uv"][i_l, 0], kl["uv"][i_l, 1]
        candidates = rows[int(v_l)]
        if not candidates:
            continue
        min_u = u_l - max_d
        max_u = u_l - min_d
        if max_u < 0:
            continue
        best_dist, best_r = TH_HIGH, 0
        for i_r in candidates:
            if kr["octave"][i_r] < level - 1 or kr["octave"][i_r] > level + 1:
                continue
            u_r = kr["uv"][i_r, 0]
            if min_u <= u_r <= max_u:
                d = descriptor_distance(kl["desc"][i_l], kr["desc"][i_r])
                if d < best_dist:
                    best_dist, best_r = d, i_r
        if best_dist >= th_orb:
            continue

        # Sub-pixel match by correlation, on the left keypoint's level.
        u_r0 = kr["uv"][best_r, 0]
        inv = inv_sf[level]
        su_l = c_round(float(u_l * inv))
        sv_l = c_round(float(v_l * inv))
        su_r0 = c_round(float(u_r0 * inv))
        img_l, img_r = lv_l[level], lv_r[level]
        patch_l = _patch(img_l, sv_l, su_l)
        patch_l = patch_l - patch_l[W, W]
        if su_r0 + L - W < 0 or su_r0 + L + W + 1 >= img_r.shape[1]:
            continue
        dists = []
        for inc in range(-L, L + 1):
            patch_r = _patch(img_r, sv_l, su_r0 + inc)
            patch_r = patch_r - patch_r[W, W]
            dists.append((patch_l - patch_r).abs().to(torch.float64).sum().to(F32))
        best_inc, best_sad = 0, None
        for inc in range(-L, L + 1):
            if best_sad is None or dists[L + inc] < best_sad:
                best_sad, best_inc = dists[L + inc], inc
        ranked = sorted(float(d) for d in dists)
        detail["dist"][i_l] = float(best_sad)
        detail["second"][i_l] = ranked[1]
        detail["shift"][i_l] = best_inc
        if best_inc in (-L, L):
            continue

        # Sub-pixel match (parabola fitting).
        d1, d2, d3 = dists[L + best_inc - 1], dists[L + best_inc], dists[L + best_inc + 1]
        delta = (d1 - d3) / (_f(2.0) * (d1 + d3 - _f(2.0) * d2))
        detail["delta"][i_l] = float(delta)
        if delta < -1 or delta > 1:
            continue
        best_u = sf[level] * ((_f(float(su_r0)) + _f(float(best_inc))) + delta)
        disparity = u_l - best_u
        detail["disparity"][i_l] = float(disparity)
        if min_d <= disparity < max_d:
            if disparity <= 0:
                disparity = _f(0.01)
                best_u = u_l - _f(0.01)
            depth[i_l] = _f(bf) / disparity
            u_right[i_l] = best_u
            valid[i_l] = True
            dist_idx.append((float(best_sad), i_l))

    # The median filter.
    th_dist = float("inf")
    if dist_idx:
        dist_idx.sort()
        median = _f(dist_idx[len(dist_idx) // 2][0])
        th_dist = float(_f(np.float32(1.5) * np.float32(1.4)) * median)
        for d, i_l in reversed(dist_idx):
            if d < th_dist:
                break
            u_right[i_l] = -1.0
            depth[i_l] = 0.0
            valid[i_l] = False
    return dict(u_right=u_right, depth=depth, valid=valid, th_dist=th_dist, **detail)


def _patch(img: torch.Tensor, row: int, col: int) -> torch.Tensor:
    """The 11 x 11 patch centred on (row, col)."""
    if row - W < 0 or col - W < 0 or row + W >= img.shape[0] or col + W >= img.shape[1]:
        raise IndexError(f"patch at ({row}, {col}) leaves the {tuple(img.shape)} level")
    return img[row - W:row + W + 1, col - W:col + W + 1]
