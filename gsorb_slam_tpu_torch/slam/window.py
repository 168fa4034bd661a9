"""Host-side keyframe bookkeeping and optimization-window selection
(the port's own numpy copy of ``gsorb_slam_tpu/slam/window.py``).

This is the graph/bookkeeping layer the reference spreads across
``Tracking::NeedNewKeyFrame``/``CreateNewKeyFrame`` (``src/Tracking.cc:
1260-1460``) and ``Render::AddGaussianForFrame``'s window assembly
(``src/Render.cc:221-397``). It is deliberately host NumPy: tiny data
(hundreds of keyframes x 1600 points) and inherently sequential set logic.

Keyframe reference points: 1600 random depth-valid pixels OUTSIDE the
center rectangle [w/4, 3w/4] x [h/4, 3h/4], stored as camera-frame
homogeneous points (``CreateNewKeyFrame`` ``src/Tracking.cc:1419-1445``).
Overlap ratio between keyframe A and camera pose B = fraction of A's points
that project inside B's image with a 20px margin
(``src/Tracking.cc:1331-1343``, ``src/Render.cc:262-290``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class KeyFrameMeta:
    """Host record for one keyframe. Image/depth/bins live in device pools
    (see ``system.py``); this holds the graph-side state."""

    kf_id: int  # index into the device keyframe pool
    frame_id: int  # source frame number
    T_cw: np.ndarray  # [4, 4]
    ref_points_cam: np.ndarray  # [n_ref, 4] camera-frame homogeneous
    rendered_num: int = 0  # local-BA touch counter (KeyFrame::mRenderedNum)
    bins_built_at: int = -(10**9)  # frame id when cached tile bins were last built
    is_bad: bool = False
    fe_kf_id: int = -1  # geometric-frontend keyframe id (monotonic; -1 none)

    @property
    def T_wc(self) -> np.ndarray:
        R = self.T_cw[:3, :3]
        t = self.T_cw[:3, 3]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        return T


def sample_reference_points(
    depth: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    n_points: int = 1600,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample border reference points (``src/Tracking.cc:1419-1445``)."""
    rng = rng or np.random.default_rng(0)
    h, w = depth.shape
    valid = depth > 0
    valid[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = False
    ys, xs = np.nonzero(valid)
    if len(xs) == 0:  # degenerate frame: fall back to any valid depth
        ys, xs = np.nonzero(depth > 0)
    if len(xs) == 0:
        return np.zeros((0, 4), np.float32)
    idx = rng.integers(0, len(xs), size=n_points)
    px, py = xs[idx], ys[idx]
    z = depth[py, px]
    x = (px - cx) * z / fx
    y = (py - cy) * z / fy
    return np.stack([x, y, z, np.ones_like(z)], axis=-1).astype(np.float32)


def overlap_ratio(
    ref_points_cam: np.ndarray,
    T_ref_wc: np.ndarray,
    T_cand_cw: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    edge: int = 20,
) -> float:
    """Fraction of the reference points visible from the candidate pose."""
    if len(ref_points_cam) == 0:
        return 0.0
    V = (T_cand_cw @ T_ref_wc).astype(np.float32)
    pc = ref_points_cam @ V.T  # [N, 4]
    z = pc[:, 2] + 1e-6
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    inside = (u > edge) & (u < width - edge) & (v > edge) & (v < height - edge)
    return float(np.mean(inside & (z > 0)))


def need_new_keyframe_visual(
    ref_kf: KeyFrameMeta,
    T_cur_cw: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    threshold: float = 0.87,
) -> bool:
    """The novel-view-overlap keyframe criterion (``isNewVisual``,
    ``src/Tracking.cc:1331-1373``): <87% of the reference KF's border points
    reproject inside the current frame.

    The full reference decision also mixes ORB inlier ratios (c1a/c1b/c1c &
    c2); those gates come in with the ORB front-end — callers combine them.
    """
    r = overlap_ratio(
        ref_kf.ref_points_cam, ref_kf.T_wc, T_cur_cw, fx, fy, cx, cy, width, height
    )
    return r < threshold


@dataclasses.dataclass
class WindowSelection:
    kf_ids: list  # pool ids of selected keyframes (current frame excluded)
    anchor_ids: list  # the 4 global anchors (subset of kf_ids)


def select_window(
    keyframes: list[KeyFrameMeta],
    ref_kf: KeyFrameMeta,
    current_frame_id: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    rng: np.random.Generator,
    covis_order: Optional[list[int]] = None,
    n_covis: int = 11,
    n_random_fill: int = 9,
    n_recent_ba: int = 5,
    n_anchor: int = 4,
) -> WindowSelection:
    """Assemble the mapping window (``src/Render.cc:221-397``):

    1. up to ``n_anchor`` global anchor KFs — the first keyframes in the map,
    2. up to ``n_covis`` covisible KFs chosen by overlap-ratio DIVERSITY
       (|ratio - last kept ratio| > 0.07 over the covisibility ordering;
       fallback sweep over all KFs with ratio > 0.3 and 0.05 diversity),
    3. up to ``n_recent_ba`` KFs most recently touched by local BA
       (``mRenderedNum`` desc, reset on use),
    4. random past KFs until covis+random reaches ``n_covis+n_random_fill``.

    ``covis_order``: keyframe indices ordered by covisibility weight (from
    the ORB covisibility graph when available). Without it we order by
    overlap ratio with the reference KF — the rendering-era analog.
    """
    selected: list[int] = []
    seen: set[int] = set()
    alive = [kf for kf in keyframes if not kf.is_bad]

    def take(kf: KeyFrameMeta) -> None:
        if kf.kf_id not in seen:
            selected.append(kf.kf_id)
            seen.add(kf.kf_id)

    # 1. global anchors: first KFs of the map (src/Render.cc:247-258).
    anchors = []
    for kf in alive[:n_anchor]:
        take(kf)
        anchors.append(kf.kf_id)

    # 2. covisible by overlap diversity (src/Render.cc:292-347).
    ratios = {
        kf.kf_id: overlap_ratio(
            ref_kf.ref_points_cam, ref_kf.T_wc, kf.T_cw, fx, fy, cx, cy, width, height
        )
        for kf in alive
    }
    if covis_order is not None:
        ordered = [kf for kf in alive if kf.kf_id in set(covis_order)]
        ordered.sort(key=lambda kf: covis_order.index(kf.kf_id))
    else:
        ordered = sorted(alive, key=lambda kf: -ratios[kf.kf_id])
    n_base = len(selected)
    last_ratio = 0.0
    for kf in ordered:
        if kf.kf_id in seen:
            continue
        r = ratios[kf.kf_id]
        if abs(r - last_ratio) > 0.07:
            take(kf)
            last_ratio = r
        if len(selected) - n_base >= n_covis:
            break
    if len(selected) - n_base < n_covis:
        last_ratio = 0.0
        for kf in alive:
            if kf.kf_id in seen:
                continue
            r = ratios[kf.kf_id]
            if r > 0.3 and abs(r - last_ratio) > 0.05:
                take(kf)
                last_ratio = r
            if len(selected) - n_base >= n_covis:
                break
    n_covis_taken = len(selected) - n_base

    # 3. recently BA-adjusted KFs (src/Render.cc:353-367).
    by_ba = sorted(alive, key=lambda kf: -kf.rendered_num)
    taken_ba = 0
    for kf in by_ba:
        if kf.rendered_num == 0 or taken_ba >= n_recent_ba:
            break
        if kf.kf_id not in seen:
            take(kf)
            taken_ba += 1
        kf.rendered_num = 0

    # 4. random fill (src/Render.cc:375-389).
    budget = len(alive)
    target = n_covis + n_random_fill
    past = [kf for kf in alive if kf.frame_id <= current_frame_id]
    while budget > 0 and past and (n_covis_taken + (len(selected) - n_base - n_covis_taken - taken_ba)) < target:
        kf = past[int(rng.integers(0, len(past)))]
        if kf.kf_id not in seen:
            take(kf)
        budget -= 1

    return WindowSelection(kf_ids=selected, anchor_ids=anchors)
