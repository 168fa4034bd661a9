"""Debug drawing: feature overlays and map views, as numpy images
(counterpart of ``gsorb_slam_tpu/utils/drawing.py``; numpy only, and the
same pixels).

Headless equivalents of ``FrameDrawer`` (2D keypoint/match overlay) and
``MapDrawer`` (3D points/keyframes/graph): the reference renders these into
its Pangolin/ImGui viewers (``src/FrameDrawer.cc``, ``src/MapDrawer.cc``);
here they produce plain ``uint8`` images that a file, a notebook or the web
viewer (``apps/viewer_web.py``) can display. Callers pass host arrays
(``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import numpy as np


def draw_keypoints(
    rgb: np.ndarray,  # [H, W, 3] float 0..1
    uv: np.ndarray,  # [N, 2]
    valid: np.ndarray | None = None,
    matched: np.ndarray | None = None,
    radius: int = 2,
) -> np.ndarray:
    """Overlay keypoints: green = matched (tracked map point), blue = not.
    (``FrameDrawer::DrawFrame`` color scheme.)"""
    img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8).copy()
    H, W = img.shape[:2]
    n = len(uv)
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    matched = np.zeros(n, bool) if matched is None else np.asarray(matched, bool)
    ys = np.clip(uv[:, 1].astype(int), radius, H - radius - 1)
    xs = np.clip(uv[:, 0].astype(int), radius, W - radius - 1)
    for y, x, v, m in zip(ys, xs, valid, matched):
        if not v:
            continue
        color = (40, 230, 70) if m else (70, 130, 240)
        img[y - radius : y + radius + 1, [x - radius, x + radius]] = color
        img[[y - radius, y + radius], x - radius : x + radius + 1] = color
    return img


def draw_map_topdown(
    means: np.ndarray,  # [N, 3] splat / map-point centers
    active: np.ndarray | None = None,
    kf_positions: np.ndarray | None = None,  # [K, 3] camera centers
    trajectory: np.ndarray | None = None,  # [T, 3]
    size: int = 512,
    axes: tuple[int, int] = (0, 2),  # x-z top-down
) -> np.ndarray:
    """Top-down scatter of the map: gray points, red keyframes, green
    trajectory (``MapDrawer::DrawMapPoints``/``DrawKeyFrames`` analog)."""
    img = np.full((size, size, 3), 15, np.uint8)
    if active is not None:
        means = means[np.asarray(active, bool)]
    if len(means) == 0:
        return img
    a, b = axes
    all_pts = [means[:, [a, b]]]
    if kf_positions is not None and len(kf_positions):
        all_pts.append(kf_positions[:, [a, b]])
    if trajectory is not None and len(trajectory):
        all_pts.append(trajectory[:, [a, b]])
    cat = np.concatenate(all_pts)
    lo = np.percentile(cat, 1, axis=0)
    hi = np.percentile(cat, 99, axis=0)
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        q = (p - lo) / span
        return np.clip((q * (size - 1)).astype(int), 0, size - 1)

    mp = to_px(means[:, [a, b]])
    img[mp[:, 1], mp[:, 0]] = (170, 170, 170)
    if trajectory is not None and len(trajectory):
        tp = to_px(trajectory[:, [a, b]])
        img[tp[:, 1], tp[:, 0]] = (60, 220, 60)
    if kf_positions is not None and len(kf_positions):
        kp = to_px(kf_positions[:, [a, b]])
        for y, x in zip(kp[:, 1], kp[:, 0]):
            img[max(y - 2, 0) : y + 3, max(x - 2, 0) : x + 3] = (60, 60, 230)
    return img


def camera_centers(T_cw_list) -> np.ndarray:
    """[T,4,4] or list of T_cw -> [T, 3] camera centers in world frame."""
    out = []
    for T in T_cw_list:
        R = T[:3, :3]
        t = T[:3, 3]
        out.append(-R.T @ t)
    return np.stack(out) if out else np.zeros((0, 3), np.float32)


def _draw_segment(img: np.ndarray, p0, p1, color) -> None:
    """Rasterize one line segment with a dense linspace (display-grade)."""
    H, W = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.clip(np.linspace(p0[0], p1[0], n).astype(int), 0, W - 1)
    ys = np.clip(np.linspace(p0[1], p1[1], n).astype(int), 0, H - 1)
    img[ys, xs] = color


def _frustum_world(T_cw: np.ndarray, scale: float) -> np.ndarray:
    """5 world-frame points of a wireframe camera: optical center + the 4
    image-plane corners at depth ``scale`` (``MapDrawer::DrawKeyFrames``
    ``src/MapDrawer.cc``: w=0.05, h=0.75w, z=0.6w GL frustum)."""
    w = scale
    h = 0.75 * scale
    z = 0.6 * scale * 2.0
    cam_pts = np.array(
        [[0, 0, 0], [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]],
        np.float64,
    )
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    return (cam_pts - t) @ R  # R^T (p - t) per row == world coords


def draw_map_3d(
    means: np.ndarray,  # [N, 3] map points / splat centers
    T_view: np.ndarray,  # [4, 4] viewing camera T_cw
    width: int,
    height: int,
    active: np.ndarray | None = None,
    kf_T_cw: list[np.ndarray] | None = None,
    graph_edges: list[tuple[int, int]] | None = None,  # indices into kf_T_cw
    cur_T_cw: np.ndarray | None = None,
    trajectory: np.ndarray | None = None,  # [T, 3] camera centers
    focal: float | None = None,
    frustum_scale: float = 0.05,
    max_points: int = 60_000,
) -> np.ndarray:
    """Free-view 3D map rendering: gray map points, blue keyframe frusta,
    covisibility/spanning-tree graph lines, green trajectory, red current
    camera — the live Pangolin map view (``MapDrawer::DrawMapPoints`` /
    ``DrawKeyFrames`` / ``DrawCurrentCamera``, ``src/MapDrawer.cc``) as a
    plain numpy image servable by the web viewer."""
    img = np.full((height, width, 3), 15, np.uint8)
    f = focal if focal is not None else 0.9 * max(width, height)
    cx, cy = width / 2.0, height / 2.0
    R = T_view[:3, :3]
    t = T_view[:3, 3]

    def project(pts):
        pc = pts @ R.T + t
        z = pc[:, 2]
        ok = z > 1e-3
        zs = np.where(ok, z, 1.0)
        u = f * pc[:, 0] / zs + cx
        v = f * pc[:, 1] / zs + cy
        ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
        return np.stack([u, v], -1), ok

    if active is not None:
        means = np.asarray(means)[np.asarray(active, bool)]
    means = np.asarray(means, np.float64)
    if len(means) > max_points:
        means = means[:: max(1, len(means) // max_points)]
    if len(means):
        uv, ok = project(means)
        pi = uv[ok].astype(int)
        img[pi[:, 1], pi[:, 0]] = (150, 150, 150)

    if trajectory is not None and len(trajectory) > 1:
        uv, ok = project(np.asarray(trajectory, np.float64))
        for i in range(len(uv) - 1):
            if ok[i] and ok[i + 1]:
                _draw_segment(img, uv[i], uv[i + 1], (60, 220, 60))

    kf_T_cw = kf_T_cw or []
    centers = []
    for T in kf_T_cw:
        fw = _frustum_world(np.asarray(T, np.float64), frustum_scale)
        centers.append(fw[0])
        uv, ok = project(fw)
        edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        for a, b in edges:
            if ok[a] and ok[b]:
                _draw_segment(img, uv[a], uv[b], (80, 80, 235))
    if graph_edges and centers:
        cuv, cok = project(np.stack(centers))
        for a, b in graph_edges:
            if 0 <= a < len(centers) and 0 <= b < len(centers):
                if cok[a] and cok[b]:
                    _draw_segment(img, cuv[a], cuv[b], (40, 160, 160))

    if cur_T_cw is not None:
        fw = _frustum_world(np.asarray(cur_T_cw, np.float64), frustum_scale * 1.5)
        uv, ok = project(fw)
        edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        for a, b in edges:
            if ok[a] and ok[b]:
                _draw_segment(img, uv[a], uv[b], (235, 60, 60))
    return img
