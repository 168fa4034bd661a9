"""The port's 3-NN module and native binding against the JAX package's:
``morton_codes`` bit for bit, the Morton-window ``knn3_mean_sq_dist`` to
1e-6 relative, the exact ``knn3_mean_sq_dist_exact`` bit for bit (the same
native source, built by each package) and against brute force,
``add_points`` with the 3-NN scale inits (methods 0 and 1: equal slots,
log-scales to 1e-6), the exact search's raise on a flat point set, and the
native ``exact_knn3`` binding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.frontend import native as jnative
from gsorb_slam_tpu.ops import knn as jknn
from gsorb_slam_tpu.splat import gaussians as jg
from gsorb_slam_tpu_torch.frontend import native
from gsorb_slam_tpu_torch.interop import gaussian_map_to_numpy
from gsorb_slam_tpu_torch.ops import knn
from gsorb_slam_tpu_torch.splat import gaussians as tg

torch.set_num_threads(1)

REL = 1e-6


def _cloud(rng, n, p_valid=0.9):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([1.0, 0.6, 2.0])
    return pts, rng.uniform(size=n) < p_valid


def _grid_with_duplicates():
    """A lattice with every point twice (duplicate Morton codes) and a flat
    axis (a degenerate span)."""
    g = np.stack(np.meshgrid(np.arange(12), np.arange(9), [0.0], indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(np.float32) * 0.1
    pts = np.concatenate([g, g + np.float32([0.001, 0.0, 0.0])])
    return pts, np.ones(len(pts), bool)


def _brute_force(pts, valid):
    out = np.zeros(len(pts), np.float32)
    ids = np.flatnonzero(valid)
    for a in ids:
        d2 = np.sort(((pts[ids] - pts[a]) ** 2).sum(-1).astype(np.float64))[1:4]
        out[a] = d2.mean() if len(d2) else 0.0
    return out


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("case", ["random", "grid", "degenerate"])
def test_morton_codes_bit_for_bit(rng, case):
    if case == "grid":
        pts, valid = _grid_with_duplicates()
    else:
        pts, valid = _cloud(rng, 500, p_valid=0.7)
        if case == "degenerate":
            pts[:, 1] = 0.25  # zero span on one axis
    want = np.asarray(jknn.morton_codes(jnp.asarray(pts), jnp.asarray(valid))).astype(np.int64)
    got = knn.morton_codes(_t(pts), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["2000", "grid", "small", "few_valid"])
def test_knn3_window_matches_jax(rng, case):
    if case == "2000":
        pts, valid = _cloud(rng, 2000)
    elif case == "grid":
        pts, valid = _grid_with_duplicates()
    elif case == "small":  # N < 2 x window
        pts, valid = _cloud(rng, 40)
    else:  # fewer than 4 valid rows
        pts, valid = _cloud(rng, 100)
        valid[:] = False
        valid[[3, 50, 97]] = True
    want = np.asarray(jknn.knn3_mean_sq_dist(jnp.asarray(pts), jnp.asarray(valid)))
    got = knn.knn3_mean_sq_dist(_t(pts), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert (got[~valid] == 0).all() and (got[valid] > 0).all()


@pytest.mark.parametrize("case", ["2000", "duplicates", "few_valid"])
def test_knn3_exact_matches_jax_and_brute_force(rng, case):
    # No point set flat along an axis here: the port raises on those
    # (test_knn3_exact_raises_on_a_flat_point_set), and the native search
    # the JAX package calls would not end.
    if case == "2000":
        pts, valid = _cloud(rng, 2000)
    elif case == "duplicates":
        pts, valid = _cloud(rng, 300)
        pts = np.concatenate([pts, pts[:100]])
        valid = np.concatenate([valid, valid[:100]])
    else:
        pts, valid = _cloud(rng, 50)
        valid[:] = False
        valid[[1, 7, 30]] = True
    want = np.asarray(jknn.knn3_mean_sq_dist_exact(jnp.asarray(pts), jnp.asarray(valid)))
    got = knn.knn3_mean_sq_dist_exact(_t(pts), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _brute_force(pts, valid), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("method", [0, 1])
def test_add_points_3nn_scale_init_matches_jax(rng, method):
    cap, m = 128, 300
    means, valid = _cloud(rng, m, p_valid=0.6)
    means[:5] = means[5:10]  # coincident points: the 1e-7 floor
    means[-1] = means[0] + np.float32([50.0, 0.0, 0.0])  # an outlier: method 1's clamp
    rgb = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    z = np.abs(means[:, 2]) + 0.5
    jm = jg.add_points(jg.empty_map(cap), jnp.asarray(means), jnp.asarray(rgb), jnp.asarray(z),
                       jnp.asarray(valid), 60.0, 58.0, init_scalar_method=method)
    tm = tg.add_points(tg.empty_map(cap, device="cpu"), _t(means), _t(rgb), _t(z), _t(valid),
                       60.0, 58.0, init_scalar_method=method)
    a = gaussian_map_to_numpy(tm)
    np.testing.assert_array_equal(a["active"], np.asarray(jm.active))
    np.testing.assert_array_equal(a["count"], np.asarray(jm.count))
    np.testing.assert_array_equal(a["means"], np.asarray(jm.means))
    np.testing.assert_allclose(a["log_scales"], np.asarray(jm.log_scales), rtol=REL, atol=REL)
    assert int(tm.count) == cap  # more valid candidates than slots: clamped
    s = a["log_scales"][a["active"]]
    assert np.isfinite(s).all() and (s[:, 0] == s[:, 2]).all()


def test_native_bindings_match_jax(rng):
    # Exact 3-NN.
    pts, valid = _cloud(rng, 1000)
    np.testing.assert_array_equal(native.exact_knn3_native(pts, valid),
                                  jnative.exact_knn3_native(pts, valid))
    with pytest.raises(ValueError):
        native.exact_knn3_native(pts[:, :2], valid)


def _slab(rng, n, thickness):
    """Points over a 3 m x 3 m square, ``thickness`` m deep (0: a plane)."""
    xy = rng.uniform(-1.5, 1.5, (n, 2))
    return np.c_[xy, 2.0 + thickness * rng.uniform(0, 1, n)].astype(np.float32)


@pytest.mark.parametrize("thickness", [0.0, 1e-4])
def test_knn3_exact_raises_on_a_flat_point_set(rng, thickness):
    """A wall at the identity pose, or one a tenth of a millimetre deep: the
    native ring search would not end, so the port raises by name, also
    through the scale initializers."""
    pts = _slab(rng, 2000, thickness)
    valid = np.ones(len(pts), bool)
    with pytest.raises(ValueError, match="flat along an axis"):
        knn.knn3_mean_sq_dist_exact(_t(pts), _t(valid))
    z = _t(np.full(len(pts), 2.0, np.float32))
    rgb = _t(np.full((len(pts), 3), 0.5, np.float32))
    with pytest.raises(ValueError, match="flat along an axis"):
        tg.add_points(tg.empty_map(4096, device="cpu"), _t(pts), rgb, z, _t(valid),
                      60.0, 58.0, init_scalar_method=0)
    # Four valid points are brute-forced natively, flat or not.
    few = np.zeros(len(pts), bool)
    few[:4] = True
    got = knn.knn3_mean_sq_dist_exact(_t(pts), _t(few)).numpy()
    np.testing.assert_allclose(got, _brute_force(pts, few), rtol=1e-5, atol=1e-12)


def test_knn3_exact_runs_on_a_thin_slab(rng):
    """A slab 5 cm deep is thin against the grid's cells but ends quickly:
    the guard lets it through, and the result is the brute force's."""
    pts = _slab(rng, 400, 0.05)
    valid = np.ones(len(pts), bool)
    got = knn.knn3_mean_sq_dist_exact(_t(pts), _t(valid)).numpy()
    want = np.asarray(jknn.knn3_mean_sq_dist_exact(jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _brute_force(pts, valid), rtol=1e-5, atol=1e-12)


def test_native_builds_its_own_library():
    """Under build/native/, named by a hash of the source: never the JAX
    package's native/libgsorb_native.so."""
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == native.BUILD_DIR == native.SOURCE.parents[1] / "build" / "native"
    assert path.name.startswith("libgsorb_native_") and path.suffix == ".so"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
