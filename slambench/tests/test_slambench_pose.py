"""The plain reference of the frontend's pose seed
(``slambench.reference.pose``): it recovers a known pose from noisy
matches with outliers, gates the outliers out, and agrees with the
program's motion-only bundle adjustment on the same inputs (CPU)."""

import math

import pytest
import torch

from slambench.reference import pose as P

FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3


def _scene(seed: int, n: int = 400, outliers: float = 0.1):
    g = torch.Generator().manual_seed(seed)
    world = torch.rand(n, 3, generator=g, dtype=torch.float64) * torch.tensor(
        [3.0, 2.0, 2.0], dtype=torch.float64) - torch.tensor([1.5, 1.0, -1.0],
                                                              dtype=torch.float64)
    xi = torch.tensor([0.05, -0.03, 0.02, 0.02, -0.04, 0.03], dtype=torch.float64)
    T_true = P.se3_exp(xi)
    r, _ = P.residuals(T_true, world, torch.zeros(n, 2, dtype=torch.float64), FX, FY, CX, CY)
    octave = torch.randint(0, 3, (n,), generator=g)
    inv_s2 = 1.0 / 1.44 ** octave.double()
    uv = r + torch.randn(n, 2, generator=g, dtype=torch.float64) / inv_s2.sqrt()[:, None]
    bad = torch.rand(n, generator=g) < outliers
    uv[bad] += (torch.rand(int(bad.sum()), 2, generator=g, dtype=torch.float64) - 0.5) * 80
    T_init = P.se3_exp(xi + torch.tensor([0.01, 0.01, -0.01, 0.005, 0.0, -0.005],
                                         dtype=torch.float64))
    return T_true, T_init, world, uv, inv_s2, bad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recovers_the_pose_and_gates_outliers(seed):
    T_true, T_init, world, uv, inv_s2, bad = _scene(seed)
    valid = torch.ones(world.shape[0], dtype=torch.bool)
    T, inl = P.pose_only(T_init, world, uv, inv_s2, valid, FX, FY, CX, CY)
    assert float((T - T_true)[:3].abs().max()) < 2e-3
    assert int((inl & bad).sum()) <= 0.2 * int(bad.sum())
    assert int(inl.sum()) > 0.8 * int((~bad).sum())


def test_se3_exp_is_a_rigid_motion():
    T = P.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.4, -0.5, 0.2], dtype=torch.float64))
    R = T[:3, :3]
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert math.isclose(float(torch.det(R)), 1.0, abs_tol=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
def test_agrees_with_the_program(seed):
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.frontend.ba import pose_optimization

    _, T_init, world, uv, inv_s2, _ = _scene(seed)
    valid = torch.ones(world.shape[0], dtype=torch.bool)
    cam = Camera(fx=FX, fy=FY, cx=CX, cy=CY, width=640, height=480)
    res = pose_optimization(T_init.float(), world.float(), uv.float(), inv_s2.float(), valid,
                            cam)
    T, inl = P.pose_only(T_init, world.float().double(), uv.float(), inv_s2.float(), valid,
                         FX, FY, CX, CY)
    assert float((res.T_cw.double() - T)[:3].abs().max()) < 1e-5
    assert bool((res.inliers == inl).all())
