"""The port's core (camera, transforms, config) against the JAX package.

Same inputs, made with numpy from a seed, through both packages; float32
results agree to 1e-6 absolute plus 1e-6 relative (the same f32 formulas;
the two frameworks may sum a 3-term product in another order, which moves a
result of magnitude ~3 by a few ulps).
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core import camera as jcam
from gsorb_slam_tpu.core import config as jconfig
from gsorb_slam_tpu.core import transforms as jtf
from gsorb_slam_tpu_torch.core import camera as tcam
from gsorb_slam_tpu_torch.core import config as tconfig
from gsorb_slam_tpu_torch.core import transforms as ttf

torch.set_num_threads(1)

ATOL = 1e-6
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=ATOL)


def _cams():
    kw = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
    return jcam.Camera(**kw), tcam.Camera(**kw)


def test_camera_projection_matches_jax(rng):
    jc, tc = _cams()
    assert tc.tan_half_fov_x == jc.tan_half_fov_x
    assert tc.tan_half_fov_y == jc.tan_half_fov_y
    _close(tc.K("cpu"), jc.K)
    pts = np.stack(
        [rng.uniform(-2, 2, 500), rng.uniform(-1.5, 1.5, 500), rng.uniform(0.3, 5, 500)], -1
    ).astype(np.float32)
    uv_j, z_j = jcam.project_points(jc, jnp.asarray(pts))
    uv_t, z_t = tcam.project_points(tc, _t(pts))
    _close(uv_t, uv_j, atol=1e-4)  # pixel coords of magnitude ~1e3: 1e-6 relative
    _close(z_t, z_j)
    depth = rng.uniform(0.5, 4, 500).astype(np.float32)
    uv = rng.uniform(0, 640, (500, 2)).astype(np.float32)
    _close(tcam.backproject(tc, _t(uv), _t(depth)), jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)))
    _close(tcam.pixel_grid(tc, device="cpu"), jcam.pixel_grid(jc))
    assert tc.scaled(0.5) == tcam.Camera(**{
        f.name: getattr(jc.scaled(0.5), f.name) for f in dataclasses.fields(jc)
    })


def test_transforms_match_jax(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    _close(ttf.quat_to_rotmat(_t(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
    T_t = ttf.pose_to_matrix(_t(q), _t(t))
    T_j = jtf.pose_to_matrix(jnp.asarray(q), jnp.asarray(t))
    _close(T_t, T_j)
    q_t, tr_t = ttf.matrix_to_pose(T_t)
    q_j, tr_j = jtf.matrix_to_pose(T_j)
    _close(q_t, q_j)
    _close(tr_t, tr_j)
    _close(ttf.invert_se3(T_t), jtf.invert_se3(T_j))
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32)
    _close(ttf.transform_points(T_t, _t(pts)), jtf.transform_points(T_j, jnp.asarray(pts)))
    # rotmat_to_quat on every Shepperd branch: near-identity and 180-degree turns
    R = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]), np.diag([-1, -1, 1])])
    R = R.astype(np.float32)
    _close(ttf.rotmat_to_quat(_t(R)), jtf.rotmat_to_quat(jnp.asarray(R)))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_loading_matches_jax(path):
    assert dataclasses.asdict(tconfig.load_config(path)) == dataclasses.asdict(
        jconfig.load_config(path)
    )


def test_default_rebin_iters_matches_jax():
    for n in (1, 30, 60, 61, 100, 120, 121, 200, 500):
        assert tconfig.default_rebin_iters(n) == jconfig.default_rebin_iters(n)
