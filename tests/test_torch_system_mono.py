"""The port's monocular System against the JAX package's on the CPU.

``tests/test_sensors.py``'s scene (160x120, sharp mid-scale splats, seed 7,
``motion_scale`` 0.35, 8 frames, 400 ORB features on 3 levels, the JAX
app's bootstrap gates 40 / 30) through ``System(frontend="orb")
.track_monocular`` on both sides, loop closing on with the packaged
vocabulary. Both take the same ORB features (the JAX extraction, carried
across), and the initializer's and PnP's draws are the JAX package's
(replayed through ``frontend.draws``). Tolerances: the bootstrap at the
same frame with the same model and point count; every later frame's pose
within 1 mm and 1 mrad (in the run's own scale, median bootstrap depth 1)
with the same state and inlier count; the splat map after ``add_points``
equal to JAX's within 1e-4 (means, through ``interop``) and 1e-4 relative
(log-scales), the rest equal; map points within 1e-3.

Then the port alone, on the same run: two blank frames -> LOST, a jump back
to an early frame -> relocalized (``tests/test_sensors.py:81-122``); and a
short run lost with a young map resets itself and bootstraps again
(``tests/test_sensors.py:125-150``).
"""

import jax
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.frontend import initializer as JI
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.frontend import draws
from gsorb_slam_tpu_torch.interop import (
    gaussian_map_to_numpy,
    orb_features_from_numpy,
    system_config_from_dict,
)
from gsorb_slam_tpu_torch.raster import RasterConfig
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

N_PARITY, N_FRAMES = 8, 10
CAM_KW = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)
CONFIG = {
    "Camera": {**CAM_KW, "fps": 10.0, "bf": 13.0},
    "ORBextractor": {"nFeatures": 400, "nLevels": 3},
    "Mapping": {"numIters": 15, "maxGaussians": 16384},
    "Tracking": {"numIters": 20},
    "Debug": {"useLoop": True},
}
RASTER = dict(tile=16, tile_capacity=2048, max_dup=16, chunk=128, dilate_px=8.0)
MONO_KW = dict(mono_min_matches=40, mono_min_inliers=30)


def jax_index_sets(seed, shapes, high):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    return [np.asarray(jax.random.randint(k, s, 0, high)) for k, s in zip(keys, shapes)]


def jax_draws(seed, shape, high):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, high))


def _rot_err(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return float(np.arctan2(np.linalg.norm(w), (np.trace(R) - 1) / 2))


def _port_system(**kw):
    return S.System(system_config_from_dict(CONFIG), max_keyframes=16, device="cpu",
                    frontend="orb", raster=RasterConfig(**RASTER), **MONO_KW, **kw)


def _recording(module, name, out):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        out.append(res)
        return res

    return wrapped


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setattr(draws, "draw_index_sets", jax_index_sets)
    mp.setattr(draws, "draw_indices", jax_draws)
    ds = JD.SyntheticDataset(JCamera(**CAM_KW), n_frames=N_FRAMES, n_splats=6000, seed=7,
                             motion_scale=0.35, scale_range=(0.02, 0.05))
    jsys = JS.System(jload_config(CONFIG), max_keyframes=16, frontend="orb",
                     raster=JRasterConfig(**RASTER), **MONO_KW)
    tsys = _port_system()
    init_j, init_t = [], []
    mp.setattr(JI, "initialize_monocular", _recording(JI, "initialize_monocular", init_j))
    mp.setattr(S, "initialize_monocular", _recording(S, "initialize_monocular", init_t))
    feats = []
    extract_j, extract_t = jsys.fe._extract, tsys.fe._extract

    def record(gray):
        f = extract_j(gray)
        feats.append(orb_features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()},
                                             device="cpu"))
        return f

    jsys.fe._extract = record
    tsys.fe._extract = lambda gray: feats.pop(0)
    rows = []
    for i in range(N_PARITY):
        fr = ds[i]
        T_j = jsys.track_monocular(fr.rgb, fr.timestamp)
        T_t = tsys.track_monocular(fr.rgb, fr.timestamp)
        rows.append((T_j, T_t, jsys._mono_state, tsys._mono_state))
    del tsys.fe._extract
    assert tsys.fe._extract.__func__ is extract_t.__func__
    gm_j = {k: np.asarray(getattr(jsys.gm, k)) for k in
            ("means", "rgb", "quats", "logit_opacities", "log_scales", "active", "count")}
    out = dict(ds=ds, jsys=jsys, tsys=tsys, rows=rows, init_j=init_j, init_t=init_t,
               gm_j=gm_j, gm_t=gaussian_map_to_numpy(tsys.gm))
    mp.undo()
    return out


def test_monocular_bootstrap_matches_jax(runs):
    rows, jsys, tsys = runs["rows"], runs["jsys"], runs["tsys"]
    first = [T is not None for T, _, _, _ in rows].index(True)
    assert [T is not None for _, T, _, _ in rows] == [T is not None for T, _, _, _ in rows]
    assert all(T is not None for _, T, _, _ in rows[first:])
    (res_j,) = [r for r in runs["init_j"] if r is not None]
    (res_t,) = [r for r in runs["init_t"] if r is not None]
    assert len(runs["init_t"]) == len(runs["init_j"])
    assert res_t.model == res_j.model
    np.testing.assert_array_equal(res_t.inliers, res_j.inliers)
    np.testing.assert_allclose(res_t.T_cw2, res_j.T_cw2, atol=1e-4)
    assert tsys.trajectory[0].frame_id == jsys.trajectory[0].frame_id == first
    assert tsys.trajectory[0].is_keyframe and len(tsys.fe.keyframes) >= 2
    # The loop closer solves the scale on the monocular path.
    assert tsys.loop_closer is not None and tsys.loop_closer.fix_scale is False
    # The splat map seeded from the bootstrap points.
    gj, gt = runs["gm_j"], runs["gm_t"]
    assert int(gt["count"]) == int(gj["count"]) == int(res_j.inliers.sum())
    n = int(gj["count"])
    np.testing.assert_array_equal(gt["active"], gj["active"])
    np.testing.assert_allclose(gt["means"][:n], gj["means"][:n], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gt["rgb"][:n], gj["rgb"][:n])
    np.testing.assert_array_equal(gt["quats"][:n], gj["quats"][:n])
    np.testing.assert_array_equal(gt["logit_opacities"][:n], gj["logit_opacities"][:n])
    np.testing.assert_allclose(gt["log_scales"][:n], gj["log_scales"][:n], rtol=1e-4)
    assert tsys.fe.n_points > 25 and n > 25


def test_monocular_tracking_matches_jax(runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    for T_j, T_t, s_j, s_t in runs["rows"]:
        assert s_t == s_j
        if T_j is None:
            continue
        assert np.isfinite(T_t).all()
        assert float(np.abs(T_t[:3, 3] - T_j[:3, 3]).max()) < 1e-3
        assert _rot_err(T_t, T_j) < 1e-3
    assert len(tsys.trajectory) == len(jsys.trajectory) >= 4
    assert [r.track_iters for r in tsys.trajectory] == [r.track_iters for r in jsys.trajectory]
    assert [r.is_keyframe for r in tsys.trajectory] == [r.is_keyframe for r in jsys.trajectory]
    assert max(r.track_iters for r in tsys.trajectory[1:]) >= 10  # ORB inliers
    jfe, tfe = jsys.fe, tsys.fe
    assert tfe.n_points == jfe.n_points and len(tfe.keyframes) == len(jfe.keyframes)
    np.testing.assert_array_equal(tfe.pt_valid, jfe.pt_valid)
    np.testing.assert_allclose(tfe.pt_pos[:tfe.n_points], jfe.pt_pos[:jfe.n_points], rtol=0,
                               atol=1e-3)
    assert tfe.pt_desc.dtype == np.uint32
    np.testing.assert_array_equal(tfe.pt_desc[:tfe.n_points], jfe.pt_desc[:jfe.n_points])
    # No render-path work: the monocular path neither maps nor tracks by render.
    assert not tsys.keyframes and tsys.timings["n_track"] == tsys.timings["n_map"] == 0
    summary = tsys.shutdown_summary()
    assert summary["n_keyframes"] == 0 and summary["total_gaussians"] == int(tsys.gm.n_active())


def test_monocular_lost_then_relocalizes(runs):
    """Two blank frames -> LOST; a jump back to an early viewpoint (the
    motion model is useless there) -> relocalized near the run's own first
    estimate of that frame."""
    ds, tsys = runs["ds"], runs["tsys"]
    results = [T for _, T, _, _ in runs["rows"]]
    for i in range(N_PARITY, N_FRAMES):
        results.append(tsys.track_monocular(ds[i].rgb, float(i)))
    assert tsys._mono_state == "OK"
    blank = np.zeros_like(ds[0].rgb)
    for j in range(2):
        tsys.track_monocular(blank, float(N_FRAMES + j))
    assert tsys._mono_state == "LOST"
    recovered = False
    for k in range(2, 5):
        T = tsys.track_monocular(ds[k].rgb, float(N_FRAMES + 2 + k))
        if tsys._mono_state == "OK" and T is not None and results[k] is not None:
            ref = results[k]
            err = np.linalg.norm(T[:3, 3] - ref[:3, 3])
            assert err < 0.5 * max(np.linalg.norm(ref[:3, 3]), 0.2), err
            recovered = True
            break
    assert recovered, "never relocalized after the blackout"


def test_monocular_early_lost_auto_resets(runs):
    """Lost with a young map (<= 5 keyframes) for 3 frames: the System
    resets itself (a new frontend, an empty splat map, a new loop closer
    with ``fix_scale`` True, as the JAX package's) and bootstraps again."""
    ds = runs["ds"]
    tsys = _port_system()
    for i in range(4):
        tsys.track_monocular(ds[i].rgb, float(i))
    assert tsys._mono_initialized and tsys.loop_closer.fix_scale is False
    fe0 = tsys.fe
    blank = np.zeros_like(ds[0].rgb)
    for j in range(4):
        tsys.track_monocular(blank, float(4 + j))
    assert not tsys._mono_initialized and tsys._mono_state == "NOT_INITIALIZED"
    assert tsys.fe is not fe0 and tsys.fe.n_points == 0 and int(tsys.gm.n_active()) == 0
    assert tsys.loop_closer.fix_scale is True  # the reference's hazard, mirrored
    for i in range(4):
        tsys.track_monocular(ds[i].rgb, float(10 + i))
    assert tsys._mono_initialized and tsys.fe.n_points > 25
