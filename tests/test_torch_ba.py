"""The port's bundle adjustment, PnP, Sim3 and triangulation against the
JAX package's on the CPU, on seeded problems with outliers.

Tolerances: poses within 1e-4 (rotation in rad, translation in m), points
within 1e-4 m, inlier masks equal. The RANSAC draws of ``ransac_pnp`` and
``ransac_sim3`` are the JAX package's, replayed through the port's
``frontend.draws.draw_indices``. The fixed-order segment sum
(``ba.Segments``) is held to ``index_add_`` at 1e-6 relative and to itself
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core import transforms as JTR
from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.frontend import ba as JB
from gsorb_slam_tpu.frontend import pnp as JP
from gsorb_slam_tpu.frontend import sim3 as JS3
from gsorb_slam_tpu.frontend.initializer import triangulate as jtriangulate
from gsorb_slam_tpu_torch.core import transforms as TTR
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.frontend import ba as TB
from gsorb_slam_tpu_torch.frontend import draws
from gsorb_slam_tpu_torch.frontend import pnp as TP
from gsorb_slam_tpu_torch.frontend import sim3 as TS3
from gsorb_slam_tpu_torch.frontend.initializer import triangulate

torch.set_num_threads(1)

CAM_KW = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
T = lambda a: torch.as_tensor(np.array(a))


def jax_draws(seed, shape, high):
    """The JAX package's draws: ``jax.random.randint(PRNGKey(seed), ...)``."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, high))


def _rot_err(A, B):
    """The angle of ``A^T B`` (atan2 form: arccos of the trace loses all
    precision below ~1e-4 rad)."""
    R = A[:3, :3].T @ B[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return float(np.arctan2(np.linalg.norm(w), (np.trace(R) - 1) / 2))


def _pose_close(A, B, tol=1e-4):
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    assert _rot_err(A, B) < tol
    assert np.abs(A[:3, 3] - B[:3, 3]).max() < tol


def _twist_pose(rng, rot, trans):
    xi = np.concatenate([rng.normal(0, trans, 3), rng.normal(0, rot, 3)]).astype(np.float32)
    return np.array(JTR.se3_exp(jnp.asarray(xi)))


def _project(T_cw, X):
    xc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    return np.stack([300 * xc[:, 0] / xc[:, 2] + 160, 300 * xc[:, 1] / xc[:, 2] + 120], -1)


def _scene(rng, n):
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                     rng.uniform(2, 5, n)], -1).astype(np.float32)


def test_transforms_match_jax(rng):
    xi = rng.normal(0, 0.5, (40, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-6  # the small-angle branches
    Tj = np.asarray(JTR.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(TTR.se3_exp(T(xi)).numpy(), Tj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TTR.se3_log(T(Tj)).numpy(), np.asarray(JTR.se3_log(jnp.asarray(Tj))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(TTR.so3_exp(T(xi[:, 3:])).numpy(),
                               np.asarray(JTR.so3_exp(jnp.asarray(xi[:, 3:]))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TTR.so3_log(T(Tj[:, :3, :3])).numpy(),
                               np.asarray(JTR.so3_log(jnp.asarray(Tj[:, :3, :3]))), rtol=0,
                               atol=1e-5)


def _pose_problem(rng, M=200):
    X = _scene(rng, M)
    T_true = _twist_pose(rng, 0.1, 0.1)
    uv = _project(T_true, X) + rng.normal(0, 0.5, (M, 2))
    out = rng.uniform(size=M) < 0.15
    uv[out] += rng.uniform(15, 40, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
    octv = rng.integers(0, 4, M)
    inv_s2 = (1.0 / 1.44 ** octv).astype(np.float32)
    valid = rng.uniform(size=M) < 0.95
    T_init = (_twist_pose(rng, 0.01, 0.02) @ T_true).astype(np.float32)
    return T_true, T_init, X, uv.astype(np.float32), inv_s2, valid


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimization_matches_jax(rng, stereo):
    T_true, T_init, X, uv, inv_s2, valid = _pose_problem(rng)
    kw_j, kw_t = {}, {}
    if stereo:
        xc = X @ T_true[:3, :3].T + T_true[:3, 3]
        ur = (uv[:, 0] - 40.0 / xc[:, 2]).astype(np.float32)
        ur[::3] = -1.0  # mono observations among them
        kw_j = dict(obs_ur=jnp.asarray(ur), bf=40.0)
        kw_t = dict(obs_ur=T(ur), bf=40.0)
    ref = JB.pose_optimization(jnp.asarray(T_init), jnp.asarray(X), jnp.asarray(uv),
                               jnp.asarray(inv_s2), jnp.asarray(valid), JCamera(**CAM_KW), **kw_j)
    out = TB.pose_optimization(T(T_init), T(X), T(uv), T(inv_s2), T(valid), Camera(**CAM_KW),
                               **kw_t)
    _pose_close(out.T_cw.numpy(), ref.T_cw)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers)
    _pose_close(out.T_cw.numpy(), T_true, 5e-3)  # converged


def _lba_problem(rng, K=5, P=120):
    X = _scene(rng, P)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(1, K):
        Tk = _twist_pose(rng, 0.03, 0.0)
        Tk[:3, 3] = [-0.15 * k, 0.02 * k, 0.0]
        poses.append(Tk)
    obs_kf, obs_pt, obs_uv = [], [], []
    for p in range(P):
        for k in rng.choice(K, rng.integers(2, K + 1), replace=False):
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(_project(poses[k], X[p:p + 1])[0])
    O = len(obs_kf)
    obs_uv = np.array(obs_uv) + rng.normal(0, 0.5, (O, 2))
    bad = rng.uniform(size=O) < 0.08
    obs_uv[bad] += 25.0
    poses0 = np.stack([poses[0]] + [(_twist_pose(rng, 0.005, 0.01) @ Pk).astype(np.float32)
                                    for Pk in poses[1:]])
    X0 = (X + rng.normal(0, 0.02, X.shape)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, O)).astype(np.float32)
    valid = rng.uniform(size=O) < 0.97
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (poses0, X0, np.array(obs_kf, np.int32), np.array(obs_pt, np.int32),
            obs_uv.astype(np.float32), inv_s2, valid, fixed)


def test_local_bundle_adjustment_matches_jax(rng):
    args = _lba_problem(rng)
    ref = JB.local_bundle_adjustment(*(jnp.asarray(a) for a in args[:7]), JCamera(**CAM_KW),
                                     fixed_mask=jnp.asarray(args[7]), outer_iters=8)
    out = TB.local_bundle_adjustment(*(T(a) for a in args[:7]), Camera(**CAM_KW),
                                     fixed_mask=T(args[7]), outer_iters=8)
    for a, b in zip(out.poses.numpy(), np.asarray(ref.poses)):
        _pose_close(a, b)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.inlier_obs.numpy(), np.asarray(ref.inlier_obs))
    # ... and the adjustment lowered the reprojection error (the monocular
    # gauge leaves the scale free, so the points need not approach the truth).

    def median_err(poses, pts):
        uv = np.stack([_project(poses[k], pts[p:p + 1])[0] for k, p in zip(args[2], args[3])])
        return np.median(np.linalg.norm(uv - args[4], axis=1))

    assert median_err(out.poses.numpy(), out.points.numpy()) < 0.5 * median_err(args[0], args[1])


def _graph(rng, K=8):
    """A drifting chain with a loop edge back to the first pose."""
    true = [np.eye(4, dtype=np.float32)]
    for k in range(1, K):
        true.append((_twist_pose(rng, 0.05, 0.2) @ true[-1]).astype(np.float32))
    true = np.stack(true)
    ei = list(range(K - 1)) + [0, 1]
    ej = list(range(1, K)) + [K - 1, 4]
    rel = np.stack([true[i] @ np.linalg.inv(true[j]) for i, j in zip(ei, ej)]).astype(np.float32)
    w = np.ones(len(ei), np.float32)
    w[-2] = 5.0
    init = np.stack([true[0]] + [(_twist_pose(rng, 0.01 * k, 0.02 * k) @ true[k]).astype(
        np.float32) for k in range(1, K)])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return init, np.array(ei, np.int32), np.array(ej, np.int32), rel, w, fixed, true


def test_pose_graph_optimization_matches_jax(rng):
    init, ei, ej, rel, w, fixed, true = _graph(rng)
    ref = JB.pose_graph_optimization(*(jnp.asarray(a) for a in (init, ei, ej, rel, w, fixed)),
                                     iters=50)
    out = TB.pose_graph_optimization(*(T(a) for a in (init, ei, ej, rel, w, fixed)), iters=50)
    for a, b in zip(out.numpy(), np.asarray(ref)):
        _pose_close(a, b)
    assert np.abs(out.numpy()[-1, :3, 3] - true[-1, :3, 3]).max() < np.abs(
        init[-1, :3, 3] - true[-1, :3, 3]).max()


def test_sim3_pose_graph_optimization_matches_jax(rng):
    init, ei, ej, rel, w, fixed, _true = _graph(rng)
    rel_ls = np.zeros(len(ei), np.float32)
    rel_ls[-2] = 0.05  # the loop edge carries a scale drift
    ls0 = np.zeros(len(init), np.float32)
    args = (init, ls0, ei, ej, rel, rel_ls, w, fixed)
    p_j, ls_j = JB.sim3_pose_graph_optimization(*(jnp.asarray(a) for a in args), iters=20)
    p_t, ls_t = TB.sim3_pose_graph_optimization(*(T(a) for a in args), iters=20)
    for a, b in zip(p_t.numpy(), np.asarray(p_j)):
        _pose_close(a, b)
    np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j), rtol=0, atol=1e-4)
    assert np.abs(ls_t.numpy()).max() > 1e-3  # the scale moved


def test_segments_is_a_fixed_order_sum(rng):
    idx = rng.integers(0, 13, 500)
    vals = rng.normal(0, 1, (500, 3, 2)).astype(np.float32)
    seg = TB.Segments(T(idx), 15)
    a = seg.sum(T(vals))
    ref = torch.zeros((15, 3, 2)).index_add_(0, T(idx), T(vals))
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6, atol=1e-5)
    assert torch.equal(a, seg.sum(T(vals)))
    assert not a[13:].any()  # targets without terms


def test_triangulate_matches_jax(rng):
    X = _scene(rng, 50)
    P1 = np.array([[300, 0, 160, 0], [0, 300, 120, 0], [0, 0, 1, 0]], np.float32)
    T2 = _twist_pose(rng, 0.05, 0.0)
    T2[:3, 3] = [-0.2, 0.01, 0.0]
    P2 = (P1[:, :3] @ T2[:3]).astype(np.float32)
    uv1 = (_project(np.eye(4), X) + rng.normal(0, 0.3, (50, 2))).astype(np.float32)
    uv2 = (_project(T2, X) + rng.normal(0, 0.3, (50, 2))).astype(np.float32)
    ref = np.asarray(jtriangulate(*(jnp.asarray(a) for a in (P1, P2, uv1, uv2))))
    out = triangulate(*(T(a) for a in (P1, P2, uv1, uv2))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_ransac_pnp_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(draws, "draw_indices", jax_draws)
    T_true, _T_init, X, uv, _s2, valid = _pose_problem(rng, 120)
    ref = JP.ransac_pnp(X, uv, valid, JCamera(**CAM_KW), seed=3)
    out = TP.ransac_pnp(X, uv, valid, Camera(**CAM_KW), seed=3, device="cpu")
    assert ref is not None and out is not None
    np.testing.assert_array_equal(out.inliers, ref.inliers)
    assert out.n_inliers == ref.n_inliers
    _pose_close(out.T_cw, ref.T_cw)
    _pose_close(out.T_cw, T_true, 5e-3)
    assert TP.ransac_pnp(X[:5], uv[:5], valid[:5], Camera(**CAM_KW), device="cpu") is None


def _sim3_problem(rng, n=150):
    p1 = _scene(rng, n)
    Tc = _twist_pose(rng, 0.05, 0.1)
    p2 = (p1 @ Tc[:3, :3].T + Tc[:3, 3] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    out = rng.uniform(size=n) < 0.2
    p2[out] += rng.uniform(0.5, 1.0, (int(out.sum()), 3)).astype(np.float32)
    return p1, p2, Tc


def test_ransac_sim3_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(draws, "draw_indices", jax_draws)
    p1, p2, Tc = _sim3_problem(rng)
    cap = 256  # the loop closer's padding: zero rows the draws may hit
    pad = lambda a: np.concatenate([a, np.zeros((cap - len(a), 3), np.float32)])
    valid = np.zeros(cap, bool)
    valid[: len(p1)] = True
    for fix_scale in (True, False):
        ref = JS3.ransac_sim3(jnp.asarray(pad(p1)), jnp.asarray(pad(p2)), jnp.asarray(valid),
                              jax.random.PRNGKey(42), fix_scale=fix_scale)
        out = TS3.ransac_sim3(T(pad(p1)), T(pad(p2)), T(valid), 42, fix_scale=fix_scale)
        np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-4)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(out.s), float(ref.s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.R.numpy(), Tc[:3, :3], atol=2e-2)


def test_optimize_sim3_reprojection_matches_jax(rng):
    n = 80
    X1 = _scene(rng, n)  # camera-1 frame
    T12 = _twist_pose(rng, 0.05, 0.1)  # x1 = T12 x2
    X2 = (X1 - T12[:3, 3]) @ T12[:3, :3]
    uv1 = (_project(np.eye(4), X1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (_project(np.eye(4), X2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2[:8] += 30.0  # outliers
    xc1 = (X1 + rng.normal(0, 0.01, X1.shape)).astype(np.float32)
    xc2 = (X2 + rng.normal(0, 0.01, X2.shape)).astype(np.float32)
    T0 = (_twist_pose(rng, 0.01, 0.02) @ T12).astype(np.float32)
    is1 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    is2 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    args = (T0, xc2, uv1, xc1, uv2, is1, is2, valid)
    for fix_scale in (True, False):
        Tj, lsj, inj, nj = JS3.optimize_sim3_reprojection(
            *(jnp.asarray(a) for a in args), JCamera(**CAM_KW), fix_scale=fix_scale,
            log_s_init=0.01)
        Tt, lst, int_, nt = TS3.optimize_sim3_reprojection(
            *(T(a) for a in args), Camera(**CAM_KW), fix_scale=fix_scale, log_s_init=0.01)
        _pose_close(Tt.numpy(), Tj)
        assert abs(float(lst) - float(lsj)) < 1e-4
        np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
        assert int(nt) == int(nj) > n // 2
