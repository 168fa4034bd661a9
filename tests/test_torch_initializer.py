"""The port's monocular initializer against the JAX package's on the CPU
(mirrors ``tests/test_mono_reloc.py``'s initializer tests).

Tolerances: F and H hypotheses within 1e-4 of the largest entry (their
sign is free, so each is compared after aligning the sign); scores within
1e-4 relative of the float64 scores of the same hypotheses and 2e-4 of
JAX's (whose f32 rounding of the transfer errors is up to 1.1e-4 from
float64 here), the same best hypothesis, inlier masks equal where no
distance lies within 1e-3 of its chi^2 gate; the decompositions equal to
1e-6; ``initialize_monocular``: the same model, equal inlier masks,
``T_cw2`` within 1e-4 and the points within 1e-4 (the median depth is 1),
with the JAX package's draws replayed through
``frontend.draws.draw_index_sets``. A sample that repeats a point scores -1
with no inliers (the port's departure: each device's SVD picks another
vector of its null space), and never changes the bootstrap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.frontend import initializer as JI
from gsorb_slam_tpu_torch.frontend import draws
from gsorb_slam_tpu_torch.frontend import initializer as TI

torch.set_num_threads(1)

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def jax_index_sets(seed, shapes, high):
    """The JAX initializer's draws: ``PRNGKey(seed)`` split once per shape,
    ``randint`` on each key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    return [np.asarray(jax.random.randint(k, s, 0, high)) for k, s in zip(keys, shapes)]


def _project(T, X):
    xc = X @ T[:3, :3].T + T[:3, 3]
    uvw = xc @ K.T
    return uvw[:, :2] / uvw[:, 2:3]


def _pose(ang, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                          [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    T[:3, 3] = t
    return T


def _general(rng, n=200):
    """test_mono_reloc's scene: a 3D point cloud and a translating camera."""
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(2, 6, n)],
                 -1).astype(np.float32)
    return X, _pose(0.05, [0.3, 0.05, 0.02])


def _planar(rng, n=200):
    """A tilted plane seen under a rotation and a translation (the H path)."""
    u, v = rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n)
    X = np.stack([u, v, 3.0 + 0.4 * u + 0.2 * v], -1).astype(np.float32)
    return X, _pose(0.08, [0.25, -0.04, 0.05])


def _views(rng, X, T2, noise=0.3):
    uv1 = _project(np.eye(4, dtype=np.float32), X) + rng.normal(0, noise, (len(X), 2))
    uv2 = _project(T2, X) + rng.normal(0, noise, (len(X), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32)


def _sign_aligned(a, b):
    """``a`` with each ``[3, 3]`` matrix's sign chosen to agree with ``b``."""
    s = np.sign((a * b).sum((1, 2)))
    return a * s[:, None, None]


def _samples(rng, n, n_hyp, k):
    """Draws without repeats inside a sample (a repeat leaves the system's
    null space two-dimensional, where the two SVDs may pick any vector)."""
    return np.stack([rng.choice(n, k, replace=False) for _ in range(n_hyp)])


def _gate_margin_ok(d, chi2):
    return np.abs(d - chi2) > 1e-3


def _distances(M, uv1, uv2, homography: bool):
    """The two squared distances each score gates (float64): transfer errors
    for a homography, epipolar distances for a fundamental matrix."""
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1))], 1).astype(np.float64)
    x2 = np.concatenate([uv2, np.ones((len(uv2), 1))], 1).astype(np.float64)
    M = M.astype(np.float64)
    if homography:
        dehomog = lambda x: x[..., :2] / x[..., 2:]
        d2 = ((dehomog(x1 @ M.transpose(0, 2, 1)) - uv2) ** 2).sum(-1)
        d1 = ((dehomog(x2 @ np.linalg.inv(M).transpose(0, 2, 1)) - uv1) ** 2).sum(-1)
        return d1, d2
    l2 = x1 @ M.transpose(0, 2, 1)
    l1 = x2 @ M
    d2 = (l2 * x2).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2)
    d1 = (l1 * x1).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2)
    return d1, d2


def test_f_and_h_batches_and_scores_match_jax(rng):
    X, T2 = _general(rng, 120)
    uv1, uv2 = _views(rng, X, T2)
    outl = rng.uniform(size=120) < 0.2
    uv2[outl] += rng.uniform(-20, 20, (int(outl.sum()), 2)).astype(np.float32)
    n1j, T1j = JI._normalize(jnp.asarray(uv1))
    n2j, T2j = JI._normalize(jnp.asarray(uv2))
    n1t, T1t = TI._normalize(torch.as_tensor(uv1))
    n2t, T2t = TI._normalize(torch.as_tensor(uv2))
    np.testing.assert_allclose(n1t.numpy(), np.asarray(n1j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T2t.numpy(), np.asarray(T2j), rtol=1e-6)
    idx_f, idx_h = _samples(rng, 120, 64, 8), _samples(rng, 120, 64, 4)

    Fj = np.asarray(JI.compute_f_batch(n1j[idx_f], n2j[idx_f]))
    Ft = TI.compute_f_batch(n1t[idx_f], n2t[idx_f]).numpy()
    np.testing.assert_allclose(_sign_aligned(Ft, Fj), Fj, atol=1e-4)
    Hj = np.asarray(JI.compute_h_batch(n1j[idx_h], n2j[idx_h]))
    Ht = TI.compute_h_batch(n1t[idx_h], n2t[idx_h]).numpy()
    np.testing.assert_allclose(_sign_aligned(Ht, Hj), Hj, atol=1e-4)

    # The scores of the same (denormalized) hypotheses on both sides.
    F = np.asarray(jnp.einsum("ji,hjk,kl->hil", T2j, jnp.asarray(Fj), T1j))
    H = np.asarray(jnp.einsum("ij,hjk,kl->hil", jnp.linalg.inv(T2j), jnp.asarray(Hj), T1j))
    for fn_j, fn_t, M, chi2 in ((JI.score_f, TI.score_f, F, JI.CHI2_F),
                                (JI.score_h, TI.score_h, H, JI.CHI2_H)):
        sj, inl_j = (np.asarray(a) for a in fn_j(jnp.asarray(M), jnp.asarray(uv1),
                                                 jnp.asarray(uv2)))
        st, inl_t = (a.numpy() for a in fn_t(*(torch.as_tensor(np.array(a))
                                                 for a in (M, uv1, uv2))))
        # Against the float64 scores of the same hypotheses, then JAX's (its
        # own f32 rounding lies up to 1.1e-4 from float64 on these H).
        d1, d2 = _distances(M, uv1, uv2, fn_j is JI.score_h)
        s64 = (np.where(d1 < chi2, JI.TH_SCORE - d1, 0.0)
               + np.where(d2 < chi2, JI.TH_SCORE - d2, 0.0)).sum(-1)
        np.testing.assert_allclose(st, s64, rtol=1e-4)
        np.testing.assert_allclose(st, sj, rtol=2e-4)
        # Masks equal wherever both distances lie clear of the gate.
        far = _gate_margin_ok(d1, chi2) & _gate_margin_ok(d2, chi2)
        assert far.mean() > 0.99
        np.testing.assert_array_equal(inl_t[far], inl_j[far])
        assert int(np.argmax(st)) == int(np.argmax(sj))


def test_score_h_singular_hypothesis_scores_as_jax(rng):
    """A batch with singular homographies (zero, rank 1, rank 2): no error,
    the JAX scores and masks, no inlier for a singular one, and a regular
    hypothesis wins the argmax."""
    X, T2 = _planar(rng, 80)
    uv1, uv2 = _views(rng, X, T2, noise=0.2)
    Hgood = np.asarray(K @ np.linalg.inv(K), np.float32)  # identity: a poor but regular H
    rank2 = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]], np.float32)
    rank1 = np.outer([1.0, 2.0, 1.0], [0.5, 0.1, 3.0]).astype(np.float32)
    # The plane's homography, n^T X = d in the first view: H = K (R + t n^T / d) K^-1.
    n = np.array([-0.4, -0.2, 1.0]) / np.linalg.norm([-0.4, -0.2, 1.0])
    d = 3.0 * n[2]
    Htrue = (K @ (T2[:3, :3] + np.outer(T2[:3, 3], n) / d) @ np.linalg.inv(K)).astype(np.float32)
    H = np.stack([np.zeros((3, 3), np.float32), rank2, Htrue, rank1, Hgood])
    sj, inl_j = (np.asarray(a) for a in JI.score_h(jnp.asarray(H), jnp.asarray(uv1),
                                                   jnp.asarray(uv2)))
    st, inl_t = (a.numpy() for a in TI.score_h(*(torch.as_tensor(a) for a in (H, uv1, uv2))))
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(inl_t, inl_j)
    assert not inl_t[[0, 1, 3]].any()
    assert int(np.argmax(st)) == int(np.argmax(sj)) == 2
    assert inl_t[2].sum() > 60


def test_decompositions_match_jax(rng):
    X, T2 = _general(rng, 50)
    R, t = T2[:3, :3], T2[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    E = (tx @ R).astype(np.float32)
    for (Rj, tj), (Rt, tt) in zip(JI._decompose_e(E), TI._decompose_e(E), strict=True):
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        np.testing.assert_allclose(tt, tj, atol=1e-6)
    n = np.array([0.1, -0.2, 1.0])
    Hn = (R - np.outer(t, n) / 3.0).astype(np.float32)
    H = (K @ Hn @ np.linalg.inv(K)).astype(np.float32)
    cand_j, cand_t = JI._decompose_h(H, K), TI._decompose_h(H, K)
    assert len(cand_t) == len(cand_j) == 8
    for (Rj, tj), (Rt, tt) in zip(cand_j, cand_t, strict=True):
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        np.testing.assert_allclose(tt, tj, atol=1e-6)
    # The true rotation is among the candidates.
    assert min(np.abs(Rt - R).max() for Rt, _ in cand_t) < 1e-4


@pytest.mark.parametrize("scene,model", [(_general, "F"), (_planar, "H")])
def test_initialize_monocular_matches_jax(rng, monkeypatch, scene, model):
    X, T2 = scene(rng)
    uv1, uv2 = _views(rng, X, T2)
    monkeypatch.setattr(draws, "draw_index_sets", jax_index_sets)
    ref = JI.initialize_monocular(uv1, uv2, K, seed=1)
    out = TI.initialize_monocular(uv1, uv2, K, seed=1, device="cpu")
    assert ref is not None and out is not None
    assert out.model == ref.model == model
    np.testing.assert_array_equal(out.inliers, ref.inliers)
    np.testing.assert_allclose(out.T_cw2, ref.T_cw2, atol=1e-4)
    good = out.inliers
    assert good.sum() > 100
    np.testing.assert_allclose(out.points[good], ref.points[good], atol=1e-4)
    # And against the ground truth (monocular: the translation's direction).
    t_est, t_gt = out.T_cw2[:3, 3], T2[:3, 3]
    assert np.dot(t_est, t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt)) > 0.95
    np.testing.assert_allclose(out.T_cw2[:3, :3], T2[:3, :3], atol=0.05)


def test_initialize_monocular_default_draws_and_degenerate(rng):
    """The port's own draws: a pure function of the seed, each set in range;
    the bootstrap still recovers the motion. Too few matches -> None."""
    a = draws.draw_index_sets(3, [(200, 8), (200, 4)], 150)
    b = draws.draw_index_sets(3, [(200, 8), (200, 4)], 150)
    assert [x.shape for x in a] == [(200, 8), (200, 4)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.min() >= 0 and x.max() < 150 for x in a)
    X, T2 = _general(rng)
    uv1, uv2 = _views(rng, X, T2)
    out = TI.initialize_monocular(uv1, uv2, K, seed=1, device="cpu")
    assert out is not None and out.model == "F" and out.inliers.sum() > 100
    np.testing.assert_allclose(out.T_cw2[:3, :3], T2[:3, :3], atol=0.05)
    uv = rng.uniform(0, 100, (10, 2)).astype(np.float32)
    assert TI.initialize_monocular(uv, uv, np.eye(3, dtype=np.float32), device="cpu") is None


def test_samples_that_repeat_a_point_never_win(rng, monkeypatch):
    """A sample that repeats a point has a null space of two or more
    dimensions, where each device's SVD returns another vector: the port
    scores it -1 with no inliers (the reference draws distinct points), so
    the bootstrap is the same on every device. With every other sample
    repeating a point, the bootstrap equals the one from the distinct
    samples alone (the repeats replaced by copies of the first)."""
    X, T2 = _general(rng, 120)
    uv1, uv2 = _views(rng, X, T2)
    f, h = _samples(rng, 120, 200, 8), _samples(rng, 120, 200, 4)
    f[1::2, 1], h[1::2, 1] = f[1::2, 0], h[1::2, 0]
    score = torch.arange(200, dtype=torch.float32)
    sf, inl = TI._drop_repeats(score, torch.ones((200, 5), dtype=torch.bool), f)
    np.testing.assert_array_equal(sf.numpy()[1::2], -1.0)
    np.testing.assert_array_equal(sf.numpy()[::2], score.numpy()[::2])
    assert not inl[1::2].any() and inl[::2].all()

    monkeypatch.setattr(draws, "draw_index_sets", lambda seed, shapes, high: [f, h])
    out = TI.initialize_monocular(uv1, uv2, K, device="cpu")
    f2, h2 = f.copy(), h.copy()
    f2[1::2], h2[1::2] = f[0], h[0]
    monkeypatch.setattr(draws, "draw_index_sets", lambda seed, shapes, high: [f2, h2])
    ref = TI.initialize_monocular(uv1, uv2, K, device="cpu")
    assert out is not None and ref is not None and out.model == ref.model == "F"
    np.testing.assert_array_equal(out.inliers, ref.inliers)
    np.testing.assert_array_equal(out.T_cw2, ref.T_cw2)
