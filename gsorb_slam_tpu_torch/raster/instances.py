"""Instance-space rendering: the tracking path's per-frame pack and
per-iteration projection (counterpart of ``gsorb_slam_tpu/raster/instances.py``).

Tracking runs ~200 iterations against fixed bins, so:

1. :func:`pack_raw_instances` gathers the raw Gaussian parameters (means,
   rgb, world covariance, opacity logit, live flag) into the
   ``[T, 16, cap]`` tile-instance layout once per binning episode;
2. :func:`preprocess_instances` projects every instance under the current
   pose (K2's plain version; the kernel pair is in
   :mod:`gsorb_slam_tpu_torch.raster.preprocess_kernel`);
3. the fused tracking kernel consumes the result directly.

The pose gradient then flows through per-instance math only — no
per-iteration gather or scatter.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_and_untile,
    blend_forward_plain,
    render_output_from_tiles,
)
from gsorb_slam_tpu_torch.raster.preprocess import LOW_PASS, NEAR_CULL, rotation_entries
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput

N_RAW = 16  # mean3(3) rgb(3) cov_w(6) logit_op(1) live(1) pad(2)


def pack_raw_instances(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    bins: TileBins,
) -> torch.Tensor:
    """One row gather of raw params into ``[T, N_RAW, cap]``.

    The world covariance ``Rg diag(exp(2s)) Rg^T`` is pose-independent, so
    it is computed here once per binning episode on the C Gaussians."""
    T, cap = bins.indices.shape
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_entries(quats)
    v0 = torch.exp(2.0 * log_scales[:, 0])
    v1 = torch.exp(2.0 * log_scales[:, 1])
    v2 = torch.exp(2.0 * log_scales[:, 2])
    c00 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    c01 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    c02 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    c11 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    c12 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    c22 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2
    cols = torch.cat(
        [
            means,
            rgb,
            torch.stack([c00, c01, c02, c11, c12, c22], dim=1),
            logit_opacities[:, None],
            active.to(torch.float32)[:, None],
            means.new_zeros((means.shape[0], 2)),
        ],
        dim=1,
    )  # [C, N_RAW]
    idx = torch.clamp(bins.indices, min=0).reshape(-1).long()
    rows = cols[idx].reshape(T, cap, N_RAW)
    k = torch.arange(cap, device=rows.device)
    live = (k[None, :] < bins.counts[:, None]).to(torch.float32)
    rows = torch.cat([rows[..., :13], (rows[..., 13] * live)[..., None], rows[..., 14:]], -1)
    return rows.transpose(1, 2).contiguous()  # [T, N_RAW, cap]


def screen_rows(
    raw: torch.Tensor,  # [T, N_RAW, cap]
    rt: torch.Tensor,  # [12] R row-major, then t
    cam: Camera,
    scale_modifier: float = 1.0,
) -> torch.Tensor:
    """Per-instance EWA projection -> the packed screen layout
    ``[T, 16, cap]`` (``forward.cu:74-256`` on instance rows). Invalid
    instances (not live, behind the near plane, det <= 0) get zero conic,
    opacity and depth. Differentiable w.r.t. ``rt``."""
    g = lambda r: raw[:, r, :]  # [T, cap]
    x, y, z3 = g(0), g(1), g(2)
    c00, c01, c02 = g(6), g(7), g(8)
    c11, c12, c22 = g(9), g(10), g(11)
    R = [[rt[3 * i + j] for j in range(3)] for i in range(3)]
    t = [rt[9], rt[10], rt[11]]
    tx_ = R[0][0] * x + R[0][1] * y + R[0][2] * z3 + t[0]
    ty_ = R[1][0] * x + R[1][1] * y + R[1][2] * z3 + t[1]
    tz_ = R[2][0] * x + R[2][1] * y + R[2][2] * z3 + t[2]

    in_front = tz_ > NEAR_CULL
    safe_z = torch.where(in_front, tz_, torch.ones_like(tz_))
    lim_x = 1.3 * cam.tan_half_fov_x
    lim_y = 1.3 * cam.tan_half_fov_y
    txz = torch.clamp(tx_ / safe_z, -lim_x, lim_x)
    tyz = torch.clamp(ty_ / safe_z, -lim_y, lim_y)

    # cov_cam = (sm R) cov_w (sm R)^T: the world covariance is packed.
    Rs = [[R[i][j] * scale_modifier for j in range(3)] for i in range(3)]
    cw = [[c00, c01, c02], [c01, c11, c12], [c02, c12, c22]]
    M = [[Rs[i][0] * cw[0][j] + Rs[i][1] * cw[1][j] + Rs[i][2] * cw[2][j] for j in range(3)]
         for i in range(3)]

    def km(i, j):
        return M[i][0] * Rs[j][0] + M[i][1] * Rs[j][1] + M[i][2] * Rs[j][2]

    k00, k01, k02, k11, k12, k22 = km(0, 0), km(0, 1), km(0, 2), km(1, 1), km(1, 2), km(2, 2)

    fx_z = cam.fx / safe_z
    fy_z = cam.fy / safe_z
    j02 = -fx_z * txz
    j12 = -fy_z * tyz
    a = fx_z * (fx_z * k00 + j02 * k02) + j02 * (fx_z * k02 + j02 * k22) + LOW_PASS
    b = fx_z * (fy_z * k01 + j12 * k02) + j02 * (fy_z * k12 + j12 * k22)
    c = fy_z * (fy_z * k11 + j12 * k12) + j12 * (fy_z * k12 + j12 * k22) + LOW_PASS

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))

    # Center projected unclamped; the clamp is only for the EWA Jacobian.
    u = cam.fx * (tx_ / safe_z) + cam.cx
    v = cam.fy * (ty_ / safe_z) + cam.cy
    valid = (g(13) > 0.5) & in_front & det_ok
    vf = valid.to(torch.float32)
    zero = torch.zeros_like(vf)
    rows = [
        u,
        v,
        c * inv_det * vf,
        -b * inv_det * vf,
        a * inv_det * vf,
        torch.sigmoid(g(12)) * vf,
        g(3),
        g(4),
        g(5),
        torch.where(valid, tz_, zero),
        vf,
        zero, zero, zero, zero, zero,
    ]
    return torch.stack(rows, dim=1)  # [T, 16, cap]


def rt_from_matrix(T_cw: torch.Tensor) -> torch.Tensor:
    """``[4, 4]`` -> flat ``[12]`` (R row-major, then t); differentiable."""
    return torch.cat([T_cw[:3, :3].reshape(-1), T_cw[:3, 3]]).to(torch.float32)


def preprocess_instances(
    raw: torch.Tensor, T_cw: torch.Tensor, cam: Camera, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Per-instance EWA projection at pose ``T_cw`` (K2's plain version)."""
    return screen_rows(raw, rt_from_matrix(T_cw), cam, scale_modifier)


def blend_packed(
    packed: torch.Tensor,  # [T, 16, cap] screen rows
    counts: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
) -> RenderOutput:
    """Plain differentiable blend over the packed screen instances with
    ``cfg.exact_stop`` semantics; the counterpart of ``blend_packed_xla``."""
    out = blend_forward_plain(packed, counts, cam, cfg)[0]
    radii = torch.zeros((packed.shape[0],), device=packed.device)
    return render_output_from_tiles(out, cam, cfg, bg, radii)


def render_instances(
    raw: torch.Tensor,
    counts: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    cfg: RasterConfig,
    bg: float = 0.0,
    scale_modifier: float = 1.0,
) -> RenderOutput:
    """Render from raw tile-instances at a (differentiable) pose: the
    projection kernel pair (K2) and the blend (K3, backward K6) on CUDA,
    their plain versions on the CPU."""
    from gsorb_slam_tpu_torch.raster.preprocess_kernel import preprocess_instances_kernel

    screen = preprocess_instances_kernel(raw, rt_from_matrix(T_cw), cam, scale_modifier)
    return blend_and_untile(screen, counts, cam, cfg, bg)
