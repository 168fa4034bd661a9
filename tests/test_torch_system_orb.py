"""The port's ORB System against the JAX package's on the CPU.

4 frames of a distorted TUM-like sequence (128x96, TUM1's coefficients)
through ``System(frontend="orb")`` on both sides, loop closing on with the
packaged vocabulary. Both take the same ORB features (the JAX extraction,
carried across as ``stereo_aux["feats"]``), the port's mapping draws are
the JAX System's (replayed as in ``tests/test_torch_system_parity.py``),
and each frame starts from the same splat map (the JAX map carried across):
the mapping step drifts apart by rounding (Adam's eps of 1e-15 turns a
rounding-level gradient into a full step; ROADMAP queue 3), and this test
holds the ORB path of each frame, not that drift. Tolerances: each frame's
pose within 1 mm and 1 mrad; equal keyframe flags, frontend inlier counts
and map-point counts; map points within 1 mm (they are back-projected from
poses that agree to 1 mm).

Then: a JAX checkpoint with ORB state loads into the port; the port's ORB
checkpoint round-trips; ``reset()`` empties the frontend and the loop
database; the stereo and monocular entry points run, and the System raises
where it should.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import geometric as JG
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.interop import (
    gaussian_map_from_numpy,
    orb_features_from_numpy,
    system_config_from_dict,
)
from gsorb_slam_tpu_torch.slam import geometric as TG
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

W, H, N_FRAMES, SEED = 128, 96, 4, 0
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
# The JAX System's side: its default raster config blends in bf16.
JRASTER = dict(RASTER, blend_bf16=False, elem_bf16=False)
GM_FIELDS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active", "count",
             "adam_t", "scene_radius", "max_z")


def _config(ds):
    c = ds.cam
    return {
        "Camera": {"width": W, "height": H, "fx": c.fx, "fy": c.fy, "cx": c.cx, "cy": c.cy,
                   "fps": 30.0, "k1": 0.262383, "k2": -0.953104, "p1": -0.005358,
                   "p2": 0.002628, "k3": 1.163314},
        "Mapping": {"numIters": 3, "maxGaussians": 65536},
        "Tracking": {"numIters": 5},
        "ORBextractor": {"nFeatures": 500},
        "Debug": {"useLoop": True},
    }


def _with_init_iters(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=5))


def _rot_err(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    return float(np.arctan2(np.linalg.norm(w), (np.trace(R) - 1) / 2))


def _gm_numpy(gm):
    return {**{k: np.asarray(getattr(gm, k)) for k in GM_FIELDS},
            "adam_m": {k: np.asarray(v) for k, v in gm.adam_m.items()},
            "adam_v": {k: np.asarray(v) for k, v in gm.adam_v.items()}}


def _record_inliers(monkeypatch, module, out):
    fn = module.GeometricFrontend.process_frame

    def record(self, *a, **kw):
        res = fn(self, *a, **kw)
        out.append(res.n_inliers)
        return res

    monkeypatch.setattr(module.GeometricFrontend, "process_frame", record)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    ds = JD.TUMLikeDataset(n_frames=N_FRAMES, seed=0, width=W, height=H, apply_distortion=True,
                           splat_spacing=0.05)
    cfg = _config(ds)
    jsys = JS.System(_with_init_iters(jload_config(cfg)), seed=SEED, frontend="orb",
                     raster=dataclasses.replace(JS.System.default_raster_config(W),
                                                backend="pallas", **JRASTER))
    tsys = S.System(_with_init_iters(system_config_from_dict(cfg)), seed=SEED, frontend="orb",
                    device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    key = [jax.random.PRNGKey(SEED)]

    def jax_draws(n_iters, n_frames):
        key[0], sub = jax.random.split(key[0])
        keys = jax.random.split(sub, n_iters)
        return [int(jax.random.randint(k, (), 0, max(int(n_frames), 1))) for k in keys]

    mp.setattr(tsys, "_mapping_draws", jax_draws)
    inl_j, inl_t = [], []
    _record_inliers(mp, JG, inl_j)
    _record_inliers(mp, TG, inl_t)
    poses = []
    for i, fr in enumerate(ds):
        gray = (0.299 * fr.rgb[..., 0] + 0.587 * fr.rgb[..., 1]
                + 0.114 * fr.rgb[..., 2]).astype(np.float32)
        fj = jsys.fe._extract(jnp.asarray(gray))
        ft = orb_features_from_numpy({k: np.asarray(v) for k, v in fj._asdict().items()},
                                     device="cpu")
        if i > 0:
            tsys.gm = gaussian_map_from_numpy(_gm_numpy(jsys.gm), device="cpu")
        T_j = jsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp, stereo_aux={"feats": fj})
        T_t = tsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp, stereo_aux={"feats": ft})
        poses.append((T_j, T_t))
    mp.undo()
    return dict(ds=ds, cfg=cfg, jsys=jsys, tsys=tsys, poses=poses, inl_j=inl_j, inl_t=inl_t)


def test_orb_system_matches_jax(runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    assert tsys.loop_closer is not None and not tsys.fe.dist.is_zero()
    for T_j, T_t in runs["poses"]:
        assert np.isfinite(T_t).all()
        assert float(np.abs(T_t[:3, 3] - T_j[:3, 3]).max()) < 1e-3
        assert _rot_err(T_t, T_j) < 1e-3
    assert [r.is_keyframe for r in tsys.trajectory] == [r.is_keyframe for r in jsys.trajectory]
    assert runs["inl_t"] == runs["inl_j"] and len(runs["inl_t"]) == N_FRAMES - 1
    assert max(runs["inl_t"]) >= 10  # the ORB pose seeded the tracking
    jfe, tfe = jsys.fe, tsys.fe
    assert tfe.n_points == jfe.n_points and int(tfe.pt_valid.sum()) == int(jfe.pt_valid.sum())
    np.testing.assert_array_equal(tfe.pt_valid, jfe.pt_valid)
    np.testing.assert_allclose(tfe.pt_pos[:tfe.n_points], jfe.pt_pos[:jfe.n_points], rtol=0,
                               atol=1e-3)
    assert [k.kf_id for k in tfe.keyframes] == [k.kf_id for k in jfe.keyframes]
    assert [m.fe_kf_id for m in tsys.keyframes] == [m.fe_kf_id for m in jsys.keyframes]
    assert tfe.timings["fe.total"] >= tfe.timings["fe.pose_opt"] > 0
    assert tsys.timings["frontend"] > 0 and tsys.timings["kf"] > 0


def _check_frontend_equal(fe_a, fe_b, lc_a, lc_b):
    n = fe_b.n_points
    assert fe_a.n_points == n and fe_a.kf_counter == fe_b.kf_counter
    for name in ("pt_pos", "pt_desc", "pt_valid", "pt_visible", "pt_found", "pt_first_kf"):
        np.testing.assert_array_equal(getattr(fe_a, name)[:n], getattr(fe_b, name)[:n])
    for a, b in zip(fe_a.keyframes, fe_b.keyframes, strict=True):
        assert (a.kf_id, a.frame_id) == (b.kf_id, b.frame_id)
        np.testing.assert_array_equal(a.point_ids, b.point_ids)
        np.testing.assert_array_equal(a.T_cw, np.asarray(b.T_cw))
        for f in ("uv", "octave", "valid", "angle"):
            np.testing.assert_array_equal(getattr(a.feats, f).numpy(), np.asarray(getattr(b.feats,
                                                                                          f)))
        desc_b = np.asarray(b.feats.descriptors)
        if desc_b.dtype != np.uint32:
            desc_b = b.feats.descriptors.numpy().view(np.uint32)
        np.testing.assert_array_equal(a.feats.descriptors.numpy().view(np.uint32), desc_b)
    assert lc_a.db.inverted == lc_b.db.inverted
    assert lc_a.db.bows == lc_b.db.bows and lc_a.consistency == lc_b.consistency


def test_jax_orb_checkpoint_loads_into_port(runs, tmp_path):
    jsys = runs["jsys"]
    jsys.save_checkpoint(str(tmp_path))
    tsys = S.System(_with_init_iters(system_config_from_dict(runs["cfg"])), seed=SEED,
                    frontend="orb", device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    tsys.load_checkpoint(str(tmp_path))
    assert tsys.frame_id == jsys.frame_id == N_FRAMES
    _check_frontend_equal(tsys.fe, jsys.fe, tsys.loop_closer, jsys.loop_closer)


def test_orb_checkpoint_round_trip_and_reset(runs, tmp_path):
    src = runs["tsys"]
    src.save_checkpoint(str(tmp_path))
    tsys = S.System(_with_init_iters(system_config_from_dict(runs["cfg"])), seed=SEED,
                    frontend="orb", device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    tsys.load_checkpoint(str(tmp_path))
    _check_frontend_equal(tsys.fe, src.fe, tsys.loop_closer, src.loop_closer)
    # The port's state loads into the JAX System too.
    jsys = JS.System(_with_init_iters(jload_config(runs["cfg"])), seed=SEED, frontend="orb",
                     raster=dataclasses.replace(JS.System.default_raster_config(W),
                                                backend="pallas", **JRASTER))
    jsys.load_checkpoint(str(tmp_path))
    _check_frontend_equal(src.fe, jsys.fe, src.loop_closer, jsys.loop_closer)

    vocab = tsys.loop_closer.db.vocab
    tsys.reset()
    assert tsys.frame_id == 0 and not tsys.trajectory and not tsys.keyframes
    assert tsys.fe.n_points == 0 and not tsys.fe.keyframes and not tsys.fe.pt_valid.any()
    assert not tsys.loop_closer.db.bows and tsys.loop_closer.db.vocab is vocab
    ds = runs["ds"]
    for fr in (ds[0], ds[1]):
        T = tsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        assert np.isfinite(T).all()
    assert tsys.fe.n_points > 0 and len(tsys.fe.keyframes) >= 1


def test_orb_system_raises_where_it_should(runs):
    """The stereo and monocular entry points run (they raised by name until
    they were ported): a first monocular frame becomes the reference, a
    stereo pair 16 px apart seeds the map; ``track_monocular`` without the
    ORB frontend, an unknown frontend and, without a card, the default
    device raise."""
    fr0, fr1 = runs["ds"][0], runs["ds"][1]
    cfg = _with_init_iters(system_config_from_dict(runs["cfg"]))
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, bf=40.0))
    raster = dataclasses.replace(S.System.default_raster_config(W), **RASTER)
    mono = S.System(cfg, seed=SEED, frontend="orb", device="cpu", raster=raster)
    assert mono.track_monocular(fr0.rgb, fr0.timestamp) is None
    assert mono._mono_ref is not None and mono.loop_closer.fix_scale is False
    mono.track_monocular(fr1.rgb, fr1.timestamp)
    assert mono.frame_id == 2 and mono._mono_state in ("NOT_INITIALIZED", "OK")
    stereo = S.System(cfg, seed=SEED, frontend="orb", device="cpu", raster=raster)
    T = stereo.track_stereo(fr0.rgb, np.roll(fr0.rgb, -16, axis=1), fr0.timestamp)
    np.testing.assert_array_equal(T, np.eye(4, dtype=np.float32))
    assert stereo.fe.n_points > 0 and int(stereo.gm.n_active()) > 0
    with pytest.raises(RuntimeError, match="frontend='orb'"):
        S.System(cfg, frontend="render", device="cpu", raster=raster).track_monocular(fr0.rgb)
    with pytest.raises(ValueError, match="frontend"):
        S.System(system_config_from_dict(runs["cfg"]), frontend="stereo", device="cpu")
    if not torch.cuda.is_available():
        # Without a card the ORB System runs only where the caller asks for the CPU.
        with pytest.raises((RuntimeError, AssertionError)):
            S.System(system_config_from_dict(runs["cfg"]), frontend="orb")
