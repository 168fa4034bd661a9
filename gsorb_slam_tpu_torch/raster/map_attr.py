"""The mapping path's projection of the splats into the packed attribute
table, and its adjoint, as one kernel pair (the port's own; the JAX package
differentiates ``raster/preprocess.py`` and XLA fuses it).

- **K10f** :func:`map_attr_table_forward` (``csrc/map_attr.cu``): the five
  splat parameter groups, ``active`` and ``T_cw`` -> ``(cols [C + 1, 16],
  radius [C])``. Plain version: :func:`map_attr_table_plain`,
  ``attr_cols(preprocess(...))`` and preprocess's radius, which the kernel
  equals bit for bit on the card.
- **K10b** :func:`map_attr_table_backward`: ``d_cols`` (rows 0-9) -> the
  gradients of the five groups. Plain version:
  :func:`map_attr_table_backward_plain`, the kernel's formulas row by row in
  PyTorch, which the CPU tests hold to autograd through the plain forward.

:func:`map_attr_table` joins the two in a ``torch.autograd.Function`` for
CUDA tensors and runs the plain composite under autograd for CPU tensors.
A CUDA tensor reaches the kernels or raises; there is no fallback. The
pose gets no gradient here (tracking differentiates it through K2): a pose
that requires one raises.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.blend_kernels import CA, CB, CC, MU, MV, N_ATTR, OP, Z, attr_cols
from gsorb_slam_tpu_torch.raster.preprocess import NEAR_CULL, preprocess


def map_attr_table_plain(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K10f's plain version: ``(attr_cols(prep), prep.radius)`` of
    ``prep = preprocess(...)``; differentiable through ``cols``."""
    prep = preprocess(means, rgb, quats, logit_opacities, log_scales, active, T_cw, cam,
                      scale_modifier)
    return attr_cols(prep), prep.radius


def map_attr_table_backward_plain(
    d_cols: torch.Tensor,  # [C + 1, 16]
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, ...]:
    """K10b's plain version: ``(d_means, d_rgb, d_quats, d_logit_opacities,
    d_log_scales)`` from the cotangent rows 0-9 of ``d_cols``, by K10b's
    formulas, row by row. The forward is recomputed as ``preprocess`` does
    it, and its branches taken as autograd takes them: a clamp passes the
    gradient on min <= x <= max, a select the branch it took; the conic,
    opacity and depth rows carry gradient only where the row is valid, the
    mean and colour rows everywhere; the radius (a ceil) carries none."""
    with torch.no_grad():
        C = means.shape[0]
        g = d_cols[:C]
        prep = preprocess(means, rgb, quats, logit_opacities, log_scales, active, T_cw, cam,
                          scale_modifier)
        valid = prep.valid
        masked = lambda x: torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                                       torch.zeros_like(x))

        # The forward's intermediates, as preprocess computes them.
        P, t = T_cw[:3, :3], T_cw[:3, 3]
        x, y, z = means[:, 0], means[:, 1], means[:, 2]
        tx = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + t[0]
        ty = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + t[1]
        tz = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + t[2]
        in_front = tz > NEAR_CULL
        sz = torch.where(in_front, tz, torch.ones_like(tz))
        lim_x = 1.3 * cam.tan_half_fov_x
        lim_y = 1.3 * cam.tan_half_fov_y
        txr, tyr = tx / sz, ty / sz
        txz = torch.clamp(txr, -lim_x, lim_x)
        tyz = torch.clamp(tyr, -lim_y, lim_y)
        x_in = (txr >= -lim_x) & (txr <= lim_x)
        y_in = (tyr >= -lim_y) & (tyr <= lim_y)
        qw, qx, qy, qz = quats.unbind(-1)
        qs = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        qn = torch.clamp(qs, min=1e-12)
        qh = quats / qn[:, None]
        w_, xq, yq, zq = qh.unbind(-1)
        r = torch.stack([
            torch.stack([1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w_ * zq),
                         2 * (xq * zq + w_ * yq)], -1),
            torch.stack([2 * (xq * yq + w_ * zq), 1 - 2 * (xq * xq + zq * zq),
                         2 * (yq * zq - w_ * xq)], -1),
            torch.stack([2 * (xq * zq - w_ * yq), 2 * (yq * zq + w_ * xq),
                         1 - 2 * (xq * xq + yq * yq)], -1),
        ], -2)  # [C, 3, 3]
        v = (torch.exp(log_scales) * scale_modifier) ** 2  # [C, 3]
        cov_w = (r * v[:, None, :]) @ r.transpose(1, 2)
        K = P @ cov_w @ P.T
        fx_z, fy_z = cam.fx / sz, cam.fy / sz
        j02, j12 = -fx_z * txz, -fy_z * tyz
        k00, k01, k02 = K[:, 0, 0], K[:, 0, 1], K[:, 0, 2]
        k11, k12, k22 = K[:, 1, 1], K[:, 1, 2], K[:, 2, 2]
        a = fx_z * (fx_z * k00 + j02 * k02) + j02 * (fx_z * k02 + j02 * k22) + 0.3
        b = fx_z * (fy_z * k01 + j12 * k02) + j02 * (fy_z * k12 + j12 * k22)
        c = fy_z * (fy_z * k11 + j12 * k12) + j12 * (fy_z * k12 + j12 * k22) + 0.3
        det = a * c - b * b
        inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
        op = prep.opacity

        d_rgb = g[:, 6:9].clone()
        d_lo = masked(g[:, OP] * (1 - op) * op)

        # The conic (c, -b, a) / det.
        d_inv = g[:, CA] * c - g[:, CB] * b + g[:, CC] * a
        d_det = -d_inv * inv_det * inv_det
        da = g[:, CC] * inv_det + d_det * c
        db = -g[:, CB] * inv_det - 2 * d_det * b
        dc = g[:, CA] * inv_det + d_det * a
        # a, b, c over fx_z, fy_z, j02, j12 and cov_cam's six entries.
        d_fx = 2 * da * (fx_z * k00 + j02 * k02) + db * (fy_z * k01 + j12 * k02)
        d_fy = db * (fx_z * k01 + j02 * k12) + 2 * dc * (fy_z * k11 + j12 * k12)
        d_j02 = 2 * da * (fx_z * k02 + j02 * k22) + db * (fy_z * k12 + j12 * k22)
        d_j12 = db * (fx_z * k02 + j02 * k22) + 2 * dc * (fy_z * k12 + j12 * k22)
        # cov_cam's full-sum cotangent S (symmetric).
        s00, s11 = da * fx_z * fx_z, dc * fy_z * fy_z
        s22 = da * j02 * j02 + db * j02 * j12 + dc * j12 * j12
        s01 = 0.5 * db * fx_z * fy_z
        s02 = da * fx_z * j02 + 0.5 * db * fx_z * j12
        s12 = 0.5 * db * j02 * fy_z + dc * fy_z * j12
        S = torch.stack([torch.stack([s00, s01, s02], -1), torch.stack([s01, s11, s12], -1),
                         torch.stack([s02, s12, s22], -1)], -2)
        # j02 = -fx_z txz; fx_z = fx / sz; txz = clamp(txr).
        d_fx = d_fx - d_j02 * txz
        d_fy = d_fy - d_j12 * tyz
        d_txr_v = torch.where(x_in, -d_j02 * fx_z, torch.zeros_like(fx_z))
        d_tyr_v = torch.where(y_in, -d_j12 * fy_z, torch.zeros_like(fy_z))
        d_sz_v = -(d_fx * fx_z + d_fy * fy_z) / sz
        # cov_cam = P cov_w P^T; cov_w = r diag(v) r^T; v = (exp(s) sm)^2.
        G = P.T @ S @ P
        Gr = G @ r
        dv = (r * Gr).sum(-2)
        dr = 2 * Gr * v[:, None, :]
        dls = masked(2 * v * dv)
        # r of the normalized quaternion, then the norm (passes at >= 1e-12).
        d = lambda i, j: dr[:, i, j]
        dn = 2 * torch.stack([
            -zq * d(0, 1) + yq * d(0, 2) + zq * d(1, 0) - xq * d(1, 2) - yq * d(2, 0)
            + xq * d(2, 1),
            yq * d(0, 1) + zq * d(0, 2) + yq * d(1, 0) - 2 * xq * d(1, 1) - w_ * d(1, 2)
            + zq * d(2, 0) + w_ * d(2, 1) - 2 * xq * d(2, 2),
            -2 * yq * d(0, 0) + xq * d(0, 1) + w_ * d(0, 2) + xq * d(1, 0) + zq * d(1, 2)
            - w_ * d(2, 0) + zq * d(2, 1) - 2 * yq * d(2, 2),
            -2 * zq * d(0, 0) - w_ * d(0, 1) + xq * d(0, 2) + w_ * d(1, 0) - 2 * zq * d(1, 1)
            + yq * d(1, 2) + xq * d(2, 0) + yq * d(2, 1),
        ], -1)
        proj = torch.where(qs >= 1e-12, (dn * qh).sum(-1), torch.zeros_like(qs))
        d_quats = masked((dn - qh * proj[:, None]) / qn[:, None])

        # u = fx tx / sz + cx, v likewise (unmasked); sz = tz in front.
        d_txr = g[:, MU] * cam.fx + masked(d_txr_v)
        d_tyr = g[:, MV] * cam.fy + masked(d_tyr_v)
        d_sz = masked(d_sz_v) - (d_txr * txr + d_tyr * tyr) / sz
        d_tz = masked(g[:, Z]) + torch.where(in_front, d_sz, torch.zeros_like(d_sz))
        d_means = torch.stack([d_txr / sz, d_tyr / sz, d_tz], -1) @ P
    return d_means, d_rgb, d_quats, d_lo, dls


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _cam_args(cam: Camera, scale_modifier: float) -> tuple[float, ...]:
    return (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            1.3 * cam.tan_half_fov_x, 1.3 * cam.tan_half_fov_y, float(scale_modifier),
            float(cam.width), float(cam.height))


def _check_inputs(means, rgb, quats, logit_opacities, log_scales, active, T_cw) -> int:
    C = means.shape[0]
    dev = means.device
    f32 = torch.float32
    for x, name, shape in ((means, "means", (C, 3)), (rgb, "rgb", (C, 3)),
                           (quats, "quats", (C, 4)), (logit_opacities, "logit_opacities", (C,)),
                           (log_scales, "log_scales", (C, 3)), (T_cw, "T_cw", (4, 4))):
        _build.check_tensor(x, name, f32, shape, dev)
    _build.check_tensor(active, "active", torch.bool, (C,), dev)
    if quats.data_ptr() % 16:
        raise ValueError("quats: expected 16-byte aligned rows")
    return C


def map_attr_table_forward(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K10f -> ``(cols [C + 1, 16], radius [C])``; CUDA tensors only.
    Forward only: differentiate through :func:`map_attr_table`."""
    C = _check_inputs(means, rgb, quats, logit_opacities, log_scales, active, T_cw)
    dev = means.device
    cols = torch.empty((C + 1, N_ATTR), dtype=torch.float32, device=dev)
    radius = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count_launch("map_attr_fwd")
    err = lib.gsorb_map_attr_fwd(
        means.data_ptr(), rgb.data_ptr(), quats.data_ptr(), logit_opacities.data_ptr(),
        log_scales.data_ptr(), active.data_ptr(), T_cw.data_ptr(), cols.data_ptr(),
        radius.data_ptr(), C, *_cam_args(cam, scale_modifier), _build.stream_handle(dev),
    )
    _build.check(err, "map_attr_fwd")
    return cols, radius


def map_attr_table_backward(
    d_cols: torch.Tensor,  # [C + 1, 16]
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, ...]:
    """K10b -> ``(d_means, d_rgb, d_quats, d_logit_opacities, d_log_scales)``
    from ``d_cols``'s rows 0-9; CUDA tensors only. The kernel writes every
    element."""
    C = _check_inputs(means, rgb, quats, logit_opacities, log_scales, active, T_cw)
    dev = means.device
    _build.check_tensor(d_cols, "d_cols", torch.float32, (C + 1, N_ATTR), dev)
    if d_cols.data_ptr() % 16:
        raise ValueError("d_cols: expected 16-byte aligned rows")
    grads = tuple(torch.empty_like(p) for p in (means, rgb, quats, logit_opacities, log_scales))
    lib = _build.library()
    _build.count_launch("map_attr_bwd")
    err = lib.gsorb_map_attr_bwd(
        means.data_ptr(), quats.data_ptr(), logit_opacities.data_ptr(), log_scales.data_ptr(),
        active.data_ptr(), T_cw.data_ptr(), d_cols.data_ptr(), *(x.data_ptr() for x in grads),
        C, *_cam_args(cam, scale_modifier), _build.stream_handle(dev),
    )
    _build.check(err, "map_attr_bwd")
    return grads


class _MapAttrTable(torch.autograd.Function):
    """K10f forward, K10b backward."""

    @staticmethod
    def forward(ctx, means, rgb, quats, logit_opacities, log_scales, active, T_cw, cam, sm):
        cols, radius = map_attr_table_forward(means, rgb, quats, logit_opacities, log_scales,
                                              active, T_cw, cam, sm)
        ctx.save_for_backward(means, rgb, quats, logit_opacities, log_scales, active, T_cw)
        ctx.cam, ctx.sm = cam, sm
        ctx.mark_non_differentiable(radius)
        return cols, radius

    @staticmethod
    def backward(ctx, d_cols, _d_radius):
        grads = map_attr_table_backward(d_cols.contiguous(), *ctx.saved_tensors, ctx.cam,
                                        ctx.sm)
        return (*grads, None, None, None, None)


def map_attr_table(
    means: torch.Tensor,
    rgb: torch.Tensor,
    quats: torch.Tensor,
    logit_opacities: torch.Tensor,
    log_scales: torch.Tensor,
    active: torch.Tensor,
    T_cw: torch.Tensor,
    cam: Camera,
    scale_modifier: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed attribute table ``[C + 1, 16]`` of the splats seen from
    ``T_cw`` and their radii ``[C]``, differentiable w.r.t. the five
    parameter groups through the table: K10f / K10b for CUDA tensors, the
    plain composite under autograd for CPU tensors."""
    if T_cw.requires_grad:
        raise ValueError("map_attr_table gives the pose no gradient: pass a detached T_cw")
    if means.is_cuda:
        return _MapAttrTable.apply(means, rgb, quats, logit_opacities, log_scales, active,
                                   T_cw, cam, float(scale_modifier))
    return map_attr_table_plain(means, rgb, quats, logit_opacities, log_scales, active, T_cw,
                                cam, scale_modifier)
