"""The port's descriptor matching against the JAX package's on the CPU.

``hamming_matrix`` must be exactly equal across all 32 bits of every word
(words with the top bit set included); each search function must give the
same ``idx2``, ``dist`` and ``valid`` on inputs with planted ties (second
sets holding several exact copies of a descriptor, so that a first-index
``argmin`` decides). Features are made from a seed with numpy and carried
to both sides (``interop.orb_features_from_numpy``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.frontend import matcher as JM
from gsorb_slam_tpu.frontend.orb import ORBFeatures as JFeatures
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.frontend import matcher as TM
from gsorb_slam_tpu_torch.frontend.orb import descriptors_from_numpy
from gsorb_slam_tpu_torch.interop import orb_features_from_numpy

torch.set_num_threads(1)

CAM_KW = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
SF = (1.2 ** np.arange(3)).astype(np.float32)


def _flip(desc, rng, n_bits):
    out = desc.copy()
    for row in out:
        for b in rng.choice(256, n_bits, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _feats(rng, n, desc, uv=None):
    d = dict(
        uv=(rng.uniform([0, 0], [160, 120], (n, 2)) if uv is None else uv).astype(np.float32),
        response=rng.uniform(0, 1, n).astype(np.float32),
        angle=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        octave=rng.integers(0, 3, n).astype(np.int32),
        descriptors=desc.astype(np.uint32),
        valid=rng.uniform(size=n) < 0.9,
    )
    d["uv_raw"] = d["uv"]
    return d


def _pair(d):
    return JFeatures(**{k: jnp.asarray(v) for k, v in d.items()}), orb_features_from_numpy(
        d, device="cpu")


def _check(res_t, res_j):
    valid = np.asarray(res_j.valid)
    np.testing.assert_array_equal(res_t.valid.numpy(), valid)
    np.testing.assert_array_equal(res_t.idx2.numpy(), np.asarray(res_j.idx2))
    np.testing.assert_array_equal(res_t.dist.numpy(), np.asarray(res_j.dist))


@pytest.fixture
def sets(rng):
    """Set 1 and a set 2 holding noisy copies of its descriptors, each
    planted 1-3 times (exact duplicates tie), and unrelated rows."""
    d1 = rng.integers(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    d1[0] = 0xFFFFFFFF
    d1[1] = 0x80000000
    noisy = _flip(d1, rng, 6)
    copies = [noisy[i:i + 1].repeat(1 + i % 3, 0) for i in range(40)]
    d2 = np.concatenate(copies + [rng.integers(0, 2**32, (20, 8), dtype=np.uint64)
                                  .astype(np.uint32)])
    f1, f2 = _feats(rng, len(d1), d1), _feats(rng, len(d2), d2)
    # The copies of a row share its angle (rotation-consistent) and sit
    # near it in the image (epipolar and window tests pass).
    src = np.concatenate([np.full(1 + i % 3, i) for i in range(40)])
    f2["angle"][: len(src)] = f1["angle"][src] + rng.normal(0, 0.02, len(src)).astype(np.float32)
    f2["uv"][: len(src)] = f1["uv"][src] + rng.normal(0, 1.0, (len(src), 2)).astype(np.float32)
    f2["uv_raw"] = f2["uv"]
    f2["valid"][: len(src)] = True
    return f1, f2


def test_hamming_matrix_exact_all_bits(rng):
    d1 = rng.integers(0, 2**32, (70, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2**32, (90, 8), dtype=np.uint64).astype(np.uint32)
    d1[:4] = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0], np.uint32)[:, None]
    d2[:3] = np.array([0xFFFFFFFF, 0x80000001, 0], np.uint32)[:, None]
    ref = np.asarray(JM.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    out = TM.hamming_matrix(descriptors_from_numpy(d1, "cpu"), descriptors_from_numpy(d2, "cpu"))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref[0, 0] == 0 and ref[0, 2] == 256 and ref[1, 1] == 8
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x12345678], np.uint32)
    np.testing.assert_array_equal(
        TM.popcount32(torch.as_tensor(words.view(np.int32))).numpy(),
        [bin(int(w)).count("1") for w in words])


def test_hamming_matrix_row_tiles(rng, monkeypatch):
    """The row tiling (a smaller block limit forces several tiles)."""
    d1 = rng.integers(0, 2**32, (33, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2**32, (17, 8), dtype=np.uint64).astype(np.uint32)
    whole = TM.hamming_matrix(descriptors_from_numpy(d1, "cpu"), descriptors_from_numpy(d2, "cpu"))
    monkeypatch.setattr(TM, "_BLOCK_ELEMS", 17 * 8 * 5)
    tiled = TM.hamming_matrix(descriptors_from_numpy(d1, "cpu"), descriptors_from_numpy(d2, "cpu"))
    assert torch.equal(whole, tiled)


def test_argmin_ties_take_the_first_index():
    D = torch.tensor([[5, 3, 3, 7], [2, 2, 2, 2], [9, 8, 1, 1]], dtype=torch.int32)
    assert torch.argmin(D, dim=1).tolist() == [1, 0, 2]
    assert torch.argmin(D, dim=0).tolist() == [1, 1, 2, 2]


@pytest.mark.parametrize("check_rotation", [True, False])
def test_match_descriptors_matches_jax(sets, check_rotation):
    f1, f2 = sets
    (j1, t1), (j2, t2) = _pair(f1), _pair(f2)
    res_j = JM.match_descriptors(j1, j2, max_dist=64, check_rotation=check_rotation)
    res_t = TM.match_descriptors(t1, t2, max_dist=64, check_rotation=check_rotation)
    _check(res_t, res_j)
    assert int(res_t.valid.sum()) > 5


def test_rotation_consistency_matches_jax(rng):
    a1 = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    a2 = (a1 + rng.choice([0.1, 0.5, 2.0, 3.0], 200) + rng.normal(0, 0.05, 200)).astype(
        np.float32)
    valid = rng.uniform(size=200) < 0.8
    ref = JM._rotation_consistency(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(valid))
    out = TM._rotation_consistency(torch.as_tensor(a1), torch.as_tensor(a2),
                                   torch.as_tensor(valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_search_by_bow_matches_jax(sets, rng):
    f1, f2 = sets
    (j1, t1), (j2, t2) = _pair(f1), _pair(f2)
    n1 = rng.integers(-1, 4, len(f1["uv"])).astype(np.int32)
    n2 = rng.integers(0, 4, len(f2["uv"])).astype(np.int32)
    src = np.concatenate([np.full(1 + i % 3, i) for i in range(40)])
    n2[: len(src)] = np.maximum(n1[src], 0)
    res_j = JM.search_by_bow(j1, j2, jnp.asarray(n1), jnp.asarray(n2), max_dist=64)
    res_t = TM.search_by_bow(t1, t2, torch.as_tensor(n1), torch.as_tensor(n2), max_dist=64)
    _check(res_t, res_j)


def test_search_for_triangulation_matches_jax(sets, rng):
    f1, f2 = sets
    (j1, t1), (j2, t2) = _pair(f1), _pair(f2)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.1, 0.0, 0.02]
    K = np.array([[120.0, 0, 80.0], [0, 120.0, 60.0], [0, 0, 1]], np.float32)
    F_j = JM.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K))
    F_t = TM.fundamental_from_poses(torch.as_tensor(T1), torch.as_tensor(T2), torch.as_tensor(K))
    np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j), rtol=1e-5, atol=1e-7)
    un1 = rng.uniform(size=len(f1["uv"])) < 0.8
    un2 = rng.uniform(size=len(f2["uv"])) < 0.9
    # A wide epipolar gate keeps the planted ties among the candidates.
    res_j = JM.search_for_triangulation(j1, j2, F_j, jnp.asarray(un1), jnp.asarray(un2),
                                        epi_th=400.0)
    res_t = TM.search_for_triangulation(t1, t2, torch.as_tensor(np.array(F_j)),
                                        torch.as_tensor(un1), torch.as_tensor(un2), epi_th=400.0)
    _check(res_t, res_j)
    assert int(res_t.valid.sum()) > 5


def _projection_problem(rng):
    M = 60
    world = np.stack([rng.uniform(-1, 1, M), rng.uniform(-0.7, 0.7, M),
                      rng.uniform(1.5, 4, M)], -1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.02, -0.01, 0.05]
    xc = world + T[:3, 3]
    uv = np.stack([120 * xc[:, 0] / xc[:, 2] + 80, 120 * xc[:, 1] / xc[:, 2] + 60], -1)
    desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    # The frame: each point seen 1-3 times (exact copies of a noisy
    # descriptor: ties) near its projection, plus clutter.
    reps = 1 + np.arange(M) % 3
    src = np.repeat(np.arange(M), reps)
    f_uv = uv[src] + rng.normal(0, 1.5, (len(src), 2))
    f_desc = _flip(desc, rng, 10)[src]
    n_clutter = 30
    f = _feats(rng, len(src) + n_clutter,
               np.concatenate([f_desc, rng.integers(0, 2**32, (n_clutter, 8), dtype=np.uint64)
                               .astype(np.uint32)]),
               uv=np.concatenate([f_uv, rng.uniform([0, 0], [160, 120], (n_clutter, 2))]))
    normals = rng.normal(0, 1, (M, 3)).astype(np.float32)
    normals[:, 2] = -np.abs(normals[:, 2]) - 1.0  # facing the camera
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[::7] = 0.0  # not yet set
    dist = np.linalg.norm(world - (-T[:3, 3]), axis=1)
    dmax = (dist * rng.uniform(0.9, 1.8, M)).astype(np.float32)
    dmax[::5] = 0.0  # no scale range yet
    dmin = (dmax / SF[-1]).astype(np.float32)
    pvalid = rng.uniform(size=M) < 0.9
    return world, desc, pvalid, f, T, normals, dmin, dmax


@pytest.mark.parametrize("mode", ["plain", "track", "fuse"])
def test_search_by_projection_matches_jax(rng, mode):
    world, desc, pvalid, f, T, normals, dmin, dmax = _projection_problem(rng)
    jf, tf = _pair(f)
    kw_j, kw_t = {}, {}
    if mode == "track":
        kw = dict(radius=3.0)
        extra = dict(normals=normals, min_dists=dmin, max_dists=dmax, scale_factors=SF)
    elif mode == "fuse":
        kw = dict(radius=3.0, max_dist=50, use_view_cos_radius=False)
        extra = dict(min_dists=dmin, max_dists=dmax, scale_factors=SF)
    else:
        kw, extra = dict(radius=8.0), {}
    kw_j = {**kw, **{k: jnp.asarray(v) for k, v in extra.items()}}
    kw_t = {**kw, **{k: torch.as_tensor(v) for k, v in extra.items()}}
    res_j = JM.search_by_projection(jnp.asarray(world), jnp.asarray(desc), jnp.asarray(pvalid),
                                    jf, jnp.asarray(T), JCamera(**CAM_KW), **kw_j)
    res_t = TM.search_by_projection(torch.as_tensor(world), descriptors_from_numpy(desc, "cpu"),
                                    torch.as_tensor(pvalid), tf, torch.as_tensor(T),
                                    Camera(**CAM_KW), **kw_t)
    _check(res_t, res_j)
    assert int(res_t.valid.sum()) > 5


def test_search_by_sim3_matches_jax(rng):
    world, desc, pvalid, f2, T2, _n, dmin, dmax = _projection_problem(rng)
    M = len(world)
    # KF1: the same points from a second pose; KF2's per-feature rows are
    # the points of the features' sources, the rest none.
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, 3] = [-0.03, 0.0, 0.04]
    xc1 = world + T1[:3, 3]
    uv1 = np.stack([120 * xc1[:, 0] / xc1[:, 2] + 80, 120 * xc1[:, 1] / xc1[:, 2] + 60], -1)
    f1 = _feats(rng, M, _flip(desc, rng, 8), uv=uv1 + rng.normal(0, 1.0, (M, 2)))
    n2 = len(f2["uv"])
    src = np.repeat(np.arange(M), 1 + np.arange(M) % 3)
    w2 = np.zeros((n2, 3), np.float32)
    w2[: len(src)] = world[src]
    d2 = np.zeros((n2, 8), np.uint32)
    d2[: len(src)] = desc[src]
    h2 = np.zeros(n2, bool)
    h2[: len(src)] = rng.uniform(size=len(src)) < 0.7
    lo2, hi2 = np.zeros(n2, np.float32), np.zeros(n2, np.float32)
    lo2[: len(src)], hi2[: len(src)] = dmin[src], dmax[src]
    h1 = pvalid & (rng.uniform(size=M) < 0.8)
    R12 = np.eye(3, dtype=np.float32)
    t12 = (T1[:3, 3] - T2[:3, 3]).astype(np.float32)
    s12 = np.float32(1.0)
    (jf1, tf1), (jf2, tf2) = _pair(f1), _pair(f2)
    m_j, n_j = JM.search_by_sim3(
        jnp.asarray(world), jnp.asarray(desc), jnp.asarray(h1), jnp.asarray(dmin),
        jnp.asarray(dmax), jf1, jnp.asarray(w2), jnp.asarray(d2), jnp.asarray(h2),
        jnp.asarray(lo2), jnp.asarray(hi2), jf2, jnp.asarray(T1), jnp.asarray(T2),
        jnp.asarray(s12), jnp.asarray(R12), jnp.asarray(t12), JCamera(**CAM_KW), jnp.asarray(SF))
    t = torch.as_tensor
    m_t, n_t = TM.search_by_sim3(
        t(world), descriptors_from_numpy(desc, "cpu"), t(h1), t(dmin), t(dmax), tf1, t(w2),
        descriptors_from_numpy(d2, "cpu"), t(h2), t(lo2), t(hi2), tf2, t(T1), t(T2),
        float(s12), t(R12), t(t12), Camera(**CAM_KW), t(SF))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert n_t == int(n_j) > 3
