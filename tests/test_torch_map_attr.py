"""The mapping path's attribute table and its hand-derived adjoint on the CPU
(``raster/map_attr.py``).

- ``map_attr_table_backward_plain`` (K10b's formulas, row by row) against
  ``torch.autograd`` through ``attr_cols(preprocess(...))`` on maps whose
  rows take every branch (``adjoint_edge_map``), in float32 and float64 and
  at several ``scale_modifier``: each parameter group within 1e-5 of its
  largest |g| over the rows of each kind.
- ``map_attr_table`` on CPU tensors is the plain composite, and raises for
  a pose that wants a gradient.
"""

import pytest
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.profiling.common import MAP_EDGE_KINDS, adjoint_edge_map
from gsorb_slam_tpu_torch.raster.map_attr import (
    map_attr_table,
    map_attr_table_backward_plain,
    map_attr_table_plain,
)
from gsorb_slam_tpu_torch.raster.preprocess import preprocess

CAM = Camera(fx=120.0, fy=110.0, cx=64.0, cy=48.0, width=128, height=96)
N = 2048
GROUPS = ("means", "rgb", "quats", "logit_opacities", "log_scales")
VALID_KINDS = ("plain", "jacobian_clamp", "qn_floor")


@pytest.mark.parametrize("dtype,scale_modifier,seed", [
    (torch.float32, 1.0, 0), (torch.float32, 0.7, 1), (torch.float64, 1.0, 2),
    (torch.float64, 1.4, 3),
])
def test_plain_adjoint_matches_autograd(dtype, scale_modifier, seed):
    m = adjoint_edge_map(N, seed, CAM, dtype)
    params = [p.clone().requires_grad_(True) for p in m[:5]]
    cols, _ = map_attr_table_plain(*params, *m[5:], CAM, scale_modifier)
    g = torch.randn(cols.shape, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    g[:, 10:] = 0.0
    want = torch.autograd.grad((cols * g).sum(), params)
    got = map_attr_table_backward_plain(g, *m, CAM, scale_modifier)

    # The rows take the branches they were built for.
    valid = preprocess(*m, CAM, scale_modifier).valid
    kind = torch.arange(N) % len(MAP_EDGE_KINDS)
    for k, name in enumerate(MAP_EDGE_KINDS):
        assert bool(valid[kind == k].any()) == (name in VALID_KINDS), name
    p_cam = m[0] @ m[6][:3, :3].T + m[6][:3, 3]
    txr = p_cam[:, 0] / p_cam[:, 2]
    clamp = kind == MAP_EDGE_KINDS.index("jacobian_clamp")
    assert bool((txr[clamp].abs() > 1.3 * CAM.tan_half_fov_x).all())
    assert bool(valid[clamp].all())

    for name, w, h in zip(GROUPS, want, got):
        assert w.shape == h.shape and bool(torch.isfinite(h).all()), name
        for k, kname in enumerate(MAP_EDGE_KINDS):
            rows = kind == k
            scale = float(w[rows].abs().max())
            err = float((h[rows] - w[rows]).abs().max())
            assert err <= 1e-5 * scale, (name, kname, err, scale)
            if kname not in VALID_KINDS and name in ("quats", "logit_opacities", "log_scales"):
                assert scale == 0.0, (name, kname)  # masked rows carry nothing


def test_map_attr_table_on_cpu_is_the_plain_composite():
    m = adjoint_edge_map(256, 5, CAM)
    cols, radius = map_attr_table(*m, CAM, 0.9)
    want_cols, want_radius = map_attr_table_plain(*m, CAM, 0.9)
    assert torch.equal(cols, want_cols) and torch.equal(radius, want_radius)
    assert cols.shape == (257, 16) and not bool(cols[-1].any())
    with pytest.raises(ValueError, match="pose"):
        map_attr_table(*m[:6], m[6].clone().requires_grad_(True), CAM)
