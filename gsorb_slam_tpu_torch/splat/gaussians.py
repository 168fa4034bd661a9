"""Gaussian map state: fixed-capacity padded tensors + Adam state
(counterpart of ``gsorb_slam_tpu/splat/gaussians.py``).

The map lives in tensors of static capacity ``C`` with an ``active`` mask:
densify scatters new rows into dead slots (``add_points``), so the row
indices that tile bins hold stay valid. Adam moments live beside the
parameters; new rows start with zero moments and inherit the global step,
as after a concat in the reference (``src/Gaussian.cc:241-258``). Prune
clears mask bits; ``compact`` moves live rows to the front. Every function
returns a new map and leaves its input's tensors as they were.
"""

from __future__ import annotations

import dataclasses

import torch

from gsorb_slam_tpu_torch.core.config import MappingConfig, TrackingConfig

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # src/Gaussian.cc:153,171

PARAM_NAMES = ("means", "rgb", "quats", "logit_opacities", "log_scales")


@dataclasses.dataclass
class GaussianMap:
    """Padded splat parameters + Adam state. All tensors have leading dim C."""

    means: torch.Tensor  # [C, 3] world-frame centers
    rgb: torch.Tensor  # [C, 3] linear colors
    quats: torch.Tensor  # [C, 4] unnormalized wxyz
    logit_opacities: torch.Tensor  # [C]
    log_scales: torch.Tensor  # [C, 3]
    active: torch.Tensor  # [C] bool — live splats
    count: torch.Tensor  # [] int32 — high-water mark (slots ever allocated)
    adam_m: dict[str, torch.Tensor]  # first moments, same shapes as params
    adam_v: dict[str, torch.Tensor]  # second moments
    adam_t: torch.Tensor  # [] int32 — global Adam step
    scene_radius: torch.Tensor  # [] f32 — maxZ / raduisDepthRatio
    max_z: torch.Tensor  # [] f32 — running max observed depth

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def n_active(self) -> torch.Tensor:
        return self.active.sum(dtype=torch.int32)


def _zeros_like_params(capacity: int, device) -> dict[str, torch.Tensor]:
    f = dict(dtype=torch.float32, device=device)
    return {
        "means": torch.zeros((capacity, 3), **f),
        "rgb": torch.zeros((capacity, 3), **f),
        "quats": torch.zeros((capacity, 4), **f),
        "logit_opacities": torch.zeros((capacity,), **f),
        "log_scales": torch.zeros((capacity, 3), **f),
    }


def empty_map(capacity: int, device: torch.device | str = "cuda") -> GaussianMap:
    p = _zeros_like_params(capacity, device)
    p["quats"][:, 0] = 1.0
    return GaussianMap(
        **p,
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        adam_m=_zeros_like_params(capacity, device),
        adam_v=_zeros_like_params(capacity, device),
        adam_t=torch.zeros((), dtype=torch.int32, device=device),
        scene_radius=torch.ones((), dtype=torch.float32, device=device),
        max_z=torch.zeros((), dtype=torch.float32, device=device),
    )


def single_pixel_log_scale(z_cam: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """The default splat scale initializer (``initScalarMethod=2``): an
    isotropic scale of one pixel footprint at depth z,
    ``log(|z| / ((fx+fy)/2))`` (``src/Gaussian.cc:73-78``)."""
    return torch.log(torch.clamp(z_cam.abs() / ((fx + fy) * 0.5), min=1e-7))


def add_points(
    gm: GaussianMap,
    means: torch.Tensor,  # [M, 3] world points
    rgb: torch.Tensor,  # [M, 3]
    z_cam: torch.Tensor,  # [M] camera-frame depths (for scale init)
    valid: torch.Tensor,  # [M] bool — which candidates to insert
    fx: float,
    fy: float,
    init_scalar_method: int = 2,
) -> GaussianMap:
    """Densify: scatter valid candidate splats into dead slots.

    New rows get quat=identity, logit-opacity=1, the SinglePixel scale and
    zero Adam moments. Slot assignment recycles dead rows (holes below the
    high-water mark fill first, then the virgin tail); only candidates
    beyond the total dead-slot count are dropped. Returns a new map; the
    input map's tensors are not modified.
    """
    if init_scalar_method != 2:
        raise NotImplementedError(
            "only the SinglePixel scale init (init_scalar_method=2) is ported; "
            "the 3-NN initializers come with the ORB frontend"
        )
    valid = valid.to(torch.bool)
    log_scale_1d = single_pixel_log_scale(z_cam, fx, fy)

    # Slot for the i-th valid candidate = index of the (i+1)-th dead row.
    dead_cum = torch.cumsum((~gm.active).to(torch.int32), 0, dtype=torch.int32)
    n_dead = dead_cum[-1]
    ranks = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    applied = valid & (ranks < n_dead)
    slots = torch.searchsorted(dead_cum, ranks + 1, side="left")
    sel = torch.nonzero(applied, as_tuple=True)[0]
    dst = slots[sel]

    m = means.shape[0]
    quats = torch.zeros((m, 4), dtype=torch.float32, device=means.device)
    quats[:, 0] = 1.0
    src = {
        "means": means,
        "rgb": rgb,
        "quats": quats,
        "logit_opacities": torch.ones((m,), dtype=torch.float32, device=means.device),
        "log_scales": log_scale_1d[:, None].expand(m, 3),
    }

    def scat(dst_t: torch.Tensor, src_t: torch.Tensor) -> torch.Tensor:
        out = dst_t.clone()
        out[dst] = src_t[sel].to(out.dtype)
        return out

    def zero_rows(t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        out[dst] = 0.0
        return out

    new_params = {k: scat(getattr(gm, k), src[k]) for k in PARAM_NAMES}
    active = gm.active.clone()
    active[dst] = True
    # High-water mark: only tail allocations raise it.
    top = (dst.max() + 1) if dst.numel() else torch.zeros((), device=dst.device)
    new_count = torch.maximum(gm.count, top.to(torch.int32))
    return dataclasses.replace(
        gm,
        **new_params,
        active=active,
        count=new_count,
        adam_m={k: zero_rows(v) for k, v in gm.adam_m.items()},
        adam_v={k: zero_rows(v) for k, v in gm.adam_v.items()},
    )


def prefix_view(gm: GaussianMap, n: int) -> GaussianMap:
    """Prefix slice of every per-splat tensor (views, no copy). Rows
    ``[count, C)`` are permanently dead, so row indices into the view equal
    global indices."""
    n = min(int(n), gm.capacity)
    return dataclasses.replace(
        gm,
        **{k: getattr(gm, k)[:n] for k in PARAM_NAMES},
        active=gm.active[:n],
        adam_m={k: v[:n] for k, v in gm.adam_m.items()},
        adam_v={k: v[:n] for k, v in gm.adam_v.items()},
    )


def prefix_writeback(gm_full: GaussianMap, gm_part: GaussianMap) -> GaussianMap:
    """Write an updated prefix view back into a copy of the full map; the
    scalars (count, Adam step, scene radius, max z) come from the part."""
    n = gm_part.means.shape[0]

    def wb(full: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        out = full.clone()
        out[:n] = part
        return out

    return dataclasses.replace(
        gm_full,
        **{k: wb(getattr(gm_full, k), getattr(gm_part, k)) for k in PARAM_NAMES},
        active=wb(gm_full.active, gm_part.active),
        adam_m={k: wb(gm_full.adam_m[k], gm_part.adam_m[k]) for k in gm_full.adam_m},
        adam_v={k: wb(gm_full.adam_v[k], gm_part.adam_v[k]) for k in gm_full.adam_v},
        count=gm_part.count,
        adam_t=gm_part.adam_t,
        scene_radius=gm_part.scene_radius,
        max_z=gm_part.max_z,
    )


def prune_low_opacity(gm: GaussianMap, threshold: float = 0.005) -> GaussianMap:
    """Deactivate splats with sigmoid(opacity) < threshold
    (``RemoveLowOpcitiesGaussian``, ``src/Gaussian.cc:180-185``). Rows stay
    allocated until the next :func:`compact`."""
    low = torch.sigmoid(gm.logit_opacities) < threshold
    return dataclasses.replace(gm, active=gm.active & ~low)


def prune_to_budget(gm: GaussianMap, target_frac: float = 0.85) -> GaussianMap:
    """Capacity pressure valve: when the live count exceeds
    ``target_frac * capacity``, deactivate the lowest-opacity live splats
    down to the target (mask only; freed rows are recycled by
    :func:`add_points`). Ties at the threshold survive."""
    target = int(target_frac * gm.capacity)
    n_cut = torch.clamp(gm.n_active() - target, min=0)
    key = torch.where(gm.active, gm.logit_opacities, torch.full_like(gm.logit_opacities, float("inf")))
    order = torch.sort(key).values
    thresh = order[torch.clamp(n_cut, 0, gm.capacity - 1).long()]
    cut = gm.active & (gm.logit_opacities < thresh)
    return dataclasses.replace(gm, active=gm.active & ~cut)


def compact(gm: GaussianMap) -> GaussianMap:
    """Episodic defragmentation: stable-partition live rows to the front so
    the write cursor regains pruned slots (the reference's
    ``PruneOptimizer`` index-select, ``src/Gaussian.cc:223-239``)."""
    order = torch.sort((~gm.active).to(torch.int8), stable=True).indices
    return dataclasses.replace(
        gm,
        **{k: getattr(gm, k)[order] for k in PARAM_NAMES},
        active=gm.active[order],
        count=gm.n_active(),
        adam_m={k: v[order] for k, v in gm.adam_m.items()},
        adam_v={k: v[order] for k, v in gm.adam_v.items()},
    )


def map_learning_rates(cfg: MappingConfig) -> dict[str, float]:
    return {
        "means": cfg.lr_mean3d,
        "rgb": cfg.lr_rgb,
        "quats": cfg.lr_unnorm_rotation,
        "logit_opacities": cfg.lr_logit_opacities,
        "log_scales": cfg.lr_log_scales,
    }


def adam_step(
    gm: GaussianMap, grads: dict[str, torch.Tensor], lrs: dict[str, float]
) -> GaussianMap:
    """One masked Adam step over the five splat parameter groups
    (``StepUpdataForGaussian``, ``src/Gaussian.cc:136-141``, with the
    optimizer of ``CreateOptimizerForGaussian``, ``:158-182``, eps 1e-15).
    Inactive rows are frozen and keep zero moments. Returns a new map."""
    t = gm.adam_t + 1
    tf = t.to(torch.float32)
    c1 = 1.0 - ADAM_B1**tf
    c2 = 1.0 - ADAM_B2**tf
    new_p, new_m, new_v = {}, {}, {}
    for k in PARAM_NAMES:
        p = getattr(gm, k)
        mask = gm.active.to(p.dtype).reshape((-1,) + (1,) * (p.ndim - 1))
        g = grads[k] * mask
        m = ADAM_B1 * gm.adam_m[k] + (1 - ADAM_B1) * g
        v = ADAM_B2 * gm.adam_v[k] + (1 - ADAM_B2) * g * g
        update = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        new_p[k] = p - lrs[k] * update * mask
        new_m[k] = m * mask
        new_v[k] = v * mask
    return dataclasses.replace(gm, **new_p, adam_m=new_m, adam_v=new_v, adam_t=t)


# ---------------------------------------------------------------------------
# Camera pose optimization state (mCamUnnormQuat / mCamTrans,
# include/Gaussian.h:199-200, src/Gaussian.cc:98-176)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoseState:
    quat: torch.Tensor  # [4] unnormalized wxyz
    trans: torch.Tensor  # [3]
    m_quat: torch.Tensor
    v_quat: torch.Tensor
    m_trans: torch.Tensor
    v_trans: torch.Tensor
    t: torch.Tensor  # [] int32


def init_pose_state(quat: torch.Tensor, trans: torch.Tensor) -> PoseState:
    """Fresh pose + Adam state per tracked frame (``InitCameraPose``
    ``src/Gaussian.cc:98-128``)."""
    quat = quat.detach().to(torch.float32)
    trans = trans.detach().to(torch.float32)
    return PoseState(
        quat=quat,
        trans=trans,
        m_quat=torch.zeros_like(quat),
        v_quat=torch.zeros_like(quat),
        m_trans=torch.zeros_like(trans),
        v_trans=torch.zeros_like(trans),
        t=torch.zeros((), dtype=torch.int32, device=quat.device),
    )


def pose_adam_step(
    ps: PoseState,
    g_quat: torch.Tensor,
    g_trans: torch.Tensor,
    cfg: TrackingConfig,
) -> PoseState:
    """Adam on (quat, trans) with the configured per-group learning rates."""
    t = ps.t + 1
    tf = t.to(torch.float32)
    c1 = 1.0 - ADAM_B1**tf
    c2 = 1.0 - ADAM_B2**tf

    def upd(p, m, v, g, lr):
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS), m, v

    q, mq, vq = upd(ps.quat, ps.m_quat, ps.v_quat, g_quat, cfg.lr_cam_quat)
    tr, mt, vt = upd(ps.trans, ps.m_trans, ps.v_trans, g_trans, cfg.lr_cam_trans)
    return PoseState(quat=q, trans=tr, m_quat=mq, v_quat=vq, m_trans=mt, v_trans=vt, t=t)
