"""The mapping loss's SSIM and its hand-derived adjoint on the CPU
(``ops/ssim_kernel.py``, K11b's formulas).

- ``ssim_backward_plain`` (the partials of the SSIM map w.r.t. the blurred
  moments, scaled, blurred by the window's adjoint and combined) against
  ``torch.autograd`` through the plain composite ``ssim_plain`` on seeded
  random images in float32 and float64: colour images of several sizes, a
  gray image, a mask with holes, and images that equal the target on part
  of their pixels. Each gradient within 1e-5 of its largest |g|.
- ``losses.ssim`` on CPU tensors is the plain composite under autograd and
  launches no kernel; a target that wants a gradient raises, as does an
  image smaller than the window.
"""

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.ops import losses
from gsorb_slam_tpu_torch.ops.ssim_kernel import ssim_backward_plain, ssim_partials_plain


def _images(shape, seed, dtype, equal_share=0.0, mask_holes=False):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=shape)
    target = np.clip(pred + rng.normal(0, 0.2, size=shape), 0, 1)
    if equal_share:  # a block of pixels where pred equals target
        h = int(shape[0] * equal_share)
        target[:h] = pred[:h]
    mask = None
    if mask_holes:
        mask = torch.as_tensor(rng.uniform(size=shape[:2]) > 0.3)
        mask[shape[0] // 3:shape[0] // 2, shape[1] // 4:shape[1] // 2] = False
    as_t = lambda a: torch.as_tensor(a, dtype=dtype)
    return as_t(pred), as_t(target), mask


CASES = {
    "11x11": dict(shape=(11, 11, 3)),
    "37x53": dict(shape=(37, 53, 3)),
    "48x64": dict(shape=(48, 64, 3)),
    "gray": dict(shape=(37, 53)),
    "mask_holes": dict(shape=(48, 64, 3), mask_holes=True),
    "equal_part": dict(shape=(48, 64, 3), equal_share=0.5),
    "equal_part_masked": dict(shape=(37, 53), equal_share=0.4, mask_holes=True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd(case, dtype):
    seed = sorted(CASES).index(case) + (10 if dtype == torch.float64 else 0)
    pred, target, mask = _images(seed=seed, dtype=dtype, **CASES[case])
    x = pred.clone().requires_grad_(True)
    g = torch.tensor(-0.7, dtype=dtype)
    (want,) = torch.autograd.grad(losses.ssim_plain(x, target, mask), x, g)
    got = ssim_backward_plain(g, pred, target, mask)
    assert got.shape == pred.shape and bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert scale > 0
    err = float((got - want).abs().max())
    assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("masked", [False, True])
def test_partials_give_the_composite_value(masked):
    """The partials' SSIM map is the composite's: its (masked) mean is
    ``ssim_plain``'s value."""
    pred, target, mask = _images((37, 53, 3), 3, torch.float64, mask_holes=masked)
    s = ssim_partials_plain(pred, target)[0]
    want = float(losses.ssim_plain(pred, target, mask))
    if mask is None:
        got = float(s.mean())
    else:
        m = mask[5:-5, 5:-5].to(s.dtype)[..., None].expand(s.shape)
        got = float((s * m).sum() / m.sum())
    assert got == pytest.approx(want, rel=1e-12)


def test_ssim_on_cpu_is_the_plain_composite():
    pred, target, mask = _images((24, 32, 3), 5, torch.float32, mask_holes=True)
    before = dict(_build.launches)
    for m in (None, mask):
        assert torch.equal(losses.ssim(pred, target, m), losses.ssim_plain(pred, target, m))
    x = pred.clone().requires_grad_(True)
    value = losses.ssim(x, target)
    assert "SSIM" not in type(value.grad_fn).__name__  # autograd's, not K11's Function
    (g1,) = torch.autograd.grad(value, x)
    (g2,) = torch.autograd.grad(losses.ssim_plain(x, target), x)
    assert torch.equal(g1, g2)
    assert dict(_build.launches) == before


def test_ssim_refuses_a_target_gradient_and_small_images():
    pred, target, _ = _images((24, 32, 3), 6, torch.float32)
    with pytest.raises(ValueError, match="target"):
        losses.ssim(pred, target.clone().requires_grad_(True))
    with torch.no_grad():  # no gradient is wanted: nothing to refuse
        losses.ssim(pred, target.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="at least 11x11"):
        losses.ssim(pred[:10], target[:10])
    with pytest.raises(ValueError, match="at least 11x11"):
        losses.ssim(pred[:, :10, 0], target[:, :10, 0])
