"""Adam as the source configures it (``src/Gaussian.cc:136-182``): betas
and eps from the configuration's ``optimizer`` block, bias-corrected, and
for the map masked to the live splats (a dead splat keeps its value and
zero moments)."""

from __future__ import annotations

import torch


def adam_moments(grads: list[torch.Tensor], b1: float, b2: float,
                 m: torch.Tensor | None = None, v: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """First and second moments after the gradients ``grads`` in order,
    from ``m`` and ``v`` (zero by default)."""
    m = torch.zeros_like(grads[0]) if m is None else m
    v = torch.zeros_like(grads[0]) if v is None else v
    for g in grads:
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
    return m, v


def adam_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor, t: int,
                lr: float, b1: float, b2: float, eps: float,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """The parameter after Adam step number ``t`` (1-based) with gradient
    ``g`` from moments ``m``, ``v``."""
    if mask is not None:
        mk = mask.to(p.dtype).reshape((-1,) + (1,) * (p.ndim - 1))
        g = g * mk
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    # The bias corrections in float32 on the parameter's device, as the
    # source's optimizer computes them.
    tf = torch.tensor(float(t), dtype=torch.float32, device=p.device)
    upd = (m / (1.0 - b1 ** tf)) / (torch.sqrt(v / (1.0 - b2 ** tf)) + eps)
    if mask is not None:
        upd = upd * mk
    return p - lr * upd
