"""The mapping loss's SSIM and its adjoint as one kernel pair (the port's
own; the JAX package writes SSIM as depthwise convolutions and XLA fuses
them).

- **K11f** :func:`ssim_forward` (``csrc/ssim.cu``): ``pred``, ``target``
  ``[H, W, C]`` and an optional ``[H, W]`` mask -> the mean SSIM of
  :func:`~gsorb_slam_tpu_torch.ops.losses.ssim_plain`, its denominator and,
  where asked, the SSIM map's partials w.r.t. the blurred moments
  ``mu_p``, ``E[p^2]`` and ``E[pt]``. Plain version:
  :func:`ssim_partials_plain` (the partials) and ``ssim_plain`` (the value).
- **K11b** :func:`ssim_backward`: the scalar cotangent and those partials
  -> ``d pred``. Plain version: :func:`ssim_backward_plain`, the kernel's
  formulas in PyTorch on ``_depthwise_blur``, which the CPU tests hold to
  autograd through ``ssim_plain``.

:func:`ssim_kernel` joins the two in a ``torch.autograd.Function``;
``losses.ssim`` calls it for CUDA tensors (a CUDA tensor reaches the
kernels or raises; there is no fallback). ``target`` gets no gradient.
"""

from __future__ import annotations

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.ops.losses import (
    _channels_last,
    _crop_weights,
    _depthwise_blur,
    _window_tensor,
)

# K11's window (csrc/ssim.cu: R = 5) and the channels it takes.
WINDOW = 11
MAX_CHANNELS = 3


def ssim_partials_plain(
    pred: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> tuple[torch.Tensor, ...]:
    """K11f's per-pixel outputs on the valid crop ``[H - 10, W - 10, C]``:
    ``(S, dS/d mu_p, dS/d E[p^2], dS/d E[pt])`` with ``S = A B / (C D)``,
    ``A = 2 mu_p mu_t + c1``, ``B = 2 (E[pt] - mu_p mu_t) + c2``,
    ``C = mu_p^2 + mu_t^2 + c1``, ``D = var_p + var_t + c2``."""
    pred, target = _channels_last(pred, target)
    stack = torch.stack([pred, target, pred * pred, target * target, pred * target])
    mu_p, mu_t, e_pp, e_tt, e_pt = _depthwise_blur(stack, window_size, sigma).unbind(0)
    a = 2 * mu_p * mu_t + c1
    b = 2 * (e_pt - mu_p * mu_t) + c2
    c = mu_p * mu_p + mu_t * mu_t + c1
    d = (e_pp - mu_p * mu_p) + (e_tt - mu_t * mu_t) + c2
    cd = c * d
    s = a * b / cd
    return s, (2 * mu_t * (b - a) - 2 * mu_p * s * (d - c)) / cd, -s / d, 2 * a / cd


def ssim_backward_plain(
    g: torch.Tensor,
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """K11b's plain version: ``d pred`` of ``g * ssim_plain(pred, target,
    mask)``. The partials, each scaled by ``g / den`` and the mask, are
    blurred by the window's adjoint (a valid blur of the partials padded by
    ``window_size - 1`` zeros on each side: the window is symmetric), then
    combined as ``d_mu + 2 p d_pp + t d_pt``."""
    with torch.no_grad():
        shape = pred.shape
        pred, target = _channels_last(pred, target)
        s, d_mu, d_pp, d_pt = ssim_partials_plain(pred, target, window_size, sigma, c1, c2)
        m = _crop_weights(mask, s, window_size // 2)
        scale = g / torch.clamp(m.sum(), min=1.0) * m
        pad = window_size - 1
        parts = torch.nn.functional.pad(torch.stack([d_mu, d_pp, d_pt]) * scale,
                                        (0, 0, pad, pad, pad, pad))
        b_mu, b_pp, b_pt = _depthwise_blur(parts, window_size, sigma).unbind(0)
        return (b_mu + 2 * pred * b_pp + target * b_pt).reshape(shape)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

# Per device: K11f's ticket counter (int32, 0 between launches; the kernel's
# last block resets it).
_TICKETS: dict[torch.device, torch.Tensor] = {}


def _ticket(dev: torch.device) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None:
        t = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _check_inputs(pred, target, mask, window_size) -> tuple[int, int, int]:
    if window_size != WINDOW:
        raise ValueError(f"K11 takes an {WINDOW}-tap window, got {window_size}")
    if pred.ndim != 3:
        raise ValueError(f"pred: expected [H, W, C], got shape {tuple(pred.shape)}")
    H, W, C = pred.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"K11 takes 1 to {MAX_CHANNELS} channels, got {C}")
    if H < WINDOW or W < WINDOW:
        raise ValueError(f"K11 needs an image of at least {WINDOW}x{WINDOW}, got {H}x{W}")
    dev = pred.device
    _build.check_tensor(pred, "pred", torch.float32, (H, W, C), dev)
    _build.check_tensor(target, "target", torch.float32, (H, W, C), dev)
    if mask is not None:
        _build.check_tensor(mask, "mask", torch.float32, (H, W), dev)
    return H, W, C


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def ssim_forward(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    with_partials: bool = True,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """K11f -> ``(value, den, parts)``: the mean SSIM and its denominator
    (0-d) and the partials ``[3, H - 10, W - 10, C]`` (None without
    ``with_partials``). CUDA tensors only: ``pred``, ``target`` float32
    ``[H, W, C]`` and ``mask`` float32 ``[H, W]``, all contiguous. Forward
    only: differentiate through :func:`ssim_kernel`."""
    H, W, C = _check_inputs(pred, target, mask, window_size)
    dev = pred.device
    lib = _build.library()
    window = _window_tensor(window_size, sigma, torch.float32, dev)
    parts = (torch.empty((3, H - WINDOW + 1, W - WINDOW + 1, C), dtype=torch.float32,
                         device=dev) if with_partials else None)
    block_sums = torch.empty(2 * lib.gsorb_ssim_fwd_blocks(H, W), dtype=torch.float32,
                             device=dev)
    value, den = (torch.empty((), dtype=torch.float32, device=dev) for _ in range(2))
    _build.count_launch("ssim_fwd")
    err = lib.gsorb_ssim_fwd(
        pred.data_ptr(), target.data_ptr(), _ptr(mask), window.data_ptr(), _ptr(parts),
        block_sums.data_ptr(), _ticket(dev).data_ptr(), value.data_ptr(), den.data_ptr(),
        H, W, C, c1, c2, _build.stream_handle(dev),
    )
    _build.check(err, "ssim_fwd")
    return value, den, parts


def ssim_backward(
    g: torch.Tensor,
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None,
    parts: torch.Tensor,
    den: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """K11b -> ``d pred [H, W, C]`` from the scalar cotangent ``g`` and
    K11f's ``parts`` and ``den``; CUDA tensors only. The kernel writes every
    element."""
    H, W, C = _check_inputs(pred, target, mask, window_size)
    dev = pred.device
    _build.check_tensor(g, "g", torch.float32, (), dev)
    _build.check_tensor(parts, "parts", torch.float32,
                        (3, H - WINDOW + 1, W - WINDOW + 1, C), dev)
    _build.check_tensor(den, "den", torch.float32, (), dev)
    lib = _build.library()
    window = _window_tensor(window_size, sigma, torch.float32, dev)
    d_pred = torch.empty_like(pred)
    _build.count_launch("ssim_bwd")
    err = lib.gsorb_ssim_bwd(
        pred.data_ptr(), target.data_ptr(), _ptr(mask), window.data_ptr(), parts.data_ptr(),
        g.data_ptr(), den.data_ptr(), d_pred.data_ptr(), H, W, C,
        _build.stream_handle(dev),
    )
    _build.check(err, "ssim_bwd")
    return d_pred


class _SSIM(torch.autograd.Function):
    """K11f forward, K11b backward."""

    @staticmethod
    def forward(ctx, pred, target, mask, window_size, sigma, c1, c2):
        value, den, parts = ssim_forward(pred, target, mask, True, window_size, sigma, c1, c2)
        ctx.save_for_backward(pred, target, mask, parts, den)
        ctx.window = (window_size, sigma)
        return value

    @staticmethod
    def backward(ctx, g):
        pred, target, mask, parts, den = ctx.saved_tensors
        d_pred = ssim_backward(g.contiguous(), pred, target, mask, parts, den, *ctx.window)
        return d_pred, None, None, None, None, None, None


def ssim_kernel(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """The mean SSIM of CUDA images ``[H, W, C]`` or ``[H, W]``, K11f alone
    where no gradient is wanted, else K11f / K11b under autograd (w.r.t.
    ``pred`` only)."""
    pred, target = (x.contiguous() for x in _channels_last(pred, target))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if torch.is_grad_enabled() and pred.requires_grad:
        return _SSIM.apply(pred, target, mask, window_size, float(sigma), float(c1),
                           float(c2))
    return ssim_forward(pred, target, mask, False, window_size, sigma, c1, c2)[0]
