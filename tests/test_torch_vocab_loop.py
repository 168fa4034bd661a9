"""The port's vocabulary, keyframe database and loop closer against the JAX
package's on the CPU, and the port's own loop closure end to end.

- ``Vocabulary.transform_with_nodes`` equal (words, nodes); tf-idf weights,
  ``bow_vector`` and ``score_l1`` within 1e-6; the text format round trip.
- On ``tests/test_loop_e2e.py``'s revisiting scene (96x72, 16 frames,
  poses injected under accumulating drift), both frontends take the same
  ORB features (the JAX extraction, carried across): keyframe creation
  (map points within 1e-5 m), ``KeyFrameDatabase.add`` / ``query``,
  ``LoopCloser.detect`` at every keyframe, then ``verify`` (the RANSAC
  draws replayed; correction within 1e-4) and ``correct`` (poses within
  1e-4), from one state that ``interop.frontend_state_from_numpy`` carries
  across from the dict of the JAX System's ``_frontend_state``.
- The port's System closes the loop on that scene: the loop fires and the
  late keyframes end closer to the ground truth than 0.7x the injected
  drift (the JAX package's test of the same outcome is marked slow).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import ORBConfig as JORBConfig
from gsorb_slam_tpu.frontend import vocab as JV
from gsorb_slam_tpu.slam import geometric as JG
from gsorb_slam_tpu.slam import loop as JL
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import (
    CameraConfig,
    MappingConfig,
    ORBConfig,
    SystemConfig,
    TrackingConfig,
)
from gsorb_slam_tpu_torch.frontend import draws
from gsorb_slam_tpu_torch.frontend import vocab as TV
from gsorb_slam_tpu_torch.frontend.orb import descriptors_from_numpy
from gsorb_slam_tpu_torch.interop import (
    frontend_state_from_numpy,
    orb_features_from_numpy,
    vocabulary_from_numpy,
)
from gsorb_slam_tpu_torch.raster import RasterConfig
from gsorb_slam_tpu_torch.slam import geometric as TG
from gsorb_slam_tpu_torch.slam import loop as TL
from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset
from gsorb_slam_tpu_torch.slam.system import System

torch.set_num_threads(1)

CAM_KW = dict(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)


def _trajectory():
    """tests/test_loop_e2e.py's: out along +x, back, then a dwell."""
    xs = list(np.arange(0.0, 1.6, 0.2)) + [1.1, 0.7, 0.35, 0.1] + [0.015, 0.0, 0.012, 0.005]
    poses = []
    for i, x in enumerate(xs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -x
        T[1, 3] = 0.01 * np.sin(i)
        poses.append(T)
    return poses


def _drift(i: int) -> np.ndarray:
    """~0.14 m / ~2.6 degrees of world-frame drift by the last frame."""
    ang = 0.003 * i
    T = np.eye(4, dtype=np.float32)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang)
    T[0, 3], T[1, 3] = 0.009 * i, 0.003 * i
    return T


def jax_draws(seed, shape, high):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, high))


def _feats_np(f):
    return {k: np.asarray(v) for k, v in f._asdict().items()}


@pytest.fixture(scope="module")
def vocabs():
    jv = JV.default_vocabulary()
    return jv, TV.default_vocabulary()


def test_vocabulary_files_load_alike(vocabs, tmp_path):
    jv, tv = vocabs
    for f in ("children", "node_desc", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))
    assert (tv.k, tv.L, tv.n_words) == (jv.k, jv.L, jv.n_words)
    carried = vocabulary_from_numpy(dataclasses.asdict(jv))
    np.testing.assert_array_equal(carried.node_desc, tv.node_desc)
    path = str(tmp_path / "voc.txt")
    TV.save_orbvoc_text(tv, path)
    back = TV.load_orbvoc_text(path)
    rng = np.random.default_rng(0)
    d = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    v = torch.ones(64, dtype=torch.bool)
    assert torch.equal(back.transform(descriptors_from_numpy(d, "cpu"), v)[0],
                       tv.transform(descriptors_from_numpy(d, "cpu"), v)[0])


def test_transform_and_bow_match_jax(vocabs, rng):
    jv, tv = vocabs
    d = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    # Rows near the tree's own node descriptors descend deep and share words.
    d[:100] = jv.node_desc[rng.integers(1, len(jv.node_desc), 100)]
    valid = rng.uniform(size=300) < 0.9
    for levels_up in (1, 2):
        wj, tj, nj = jv.transform_with_nodes(jnp.asarray(d), jnp.asarray(valid), levels_up)
        wt, tt, nt = tv.transform_with_nodes(descriptors_from_numpy(d, "cpu"),
                                             torch.as_tensor(valid), levels_up)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)
    bj = jv.bow_vector(jnp.asarray(d), jnp.asarray(valid))
    bt = tv.bow_vector(descriptors_from_numpy(d, "cpu"), torch.as_tensor(valid))
    assert bt.keys() == bj.keys()
    assert max(abs(bt[k] - bj[k]) for k in bj) < 1e-6
    d2 = d.copy()
    d2[150:] = rng.integers(0, 2**32, (150, 8), dtype=np.uint64).astype(np.uint32)
    bj2 = jv.bow_vector(jnp.asarray(d2), jnp.asarray(valid))
    bt2 = tv.bow_vector(descriptors_from_numpy(d2, "cpu"), torch.as_tensor(valid))
    assert abs(TV.score_l1(bt, bt2) - JV.score_l1(bj, bj2)) < 1e-6
    assert 0.0 < TV.score_l1(bt, bt2) < 1.0


@pytest.fixture(scope="module")
def loop_run(vocabs):
    """Both frontends and loop closers over the revisiting scene, keyframe
    per frame (no local mapping), the JAX features given to both."""
    jv, tv = vocabs
    traj = _trajectory()
    ds = SyntheticDataset(Camera(**CAM_KW), n_splats=3000, seed=5, trajectory=traj, device="cpu")
    ocfg = dict(n_features=300, n_levels=3)
    jfe = JG.GeometricFrontend(JCamera(**CAM_KW), JORBConfig(**ocfg))
    tfe = TG.GeometricFrontend(Camera(**CAM_KW), ORBConfig(**ocfg), device="cpu")
    jlc, tlc = JL.LoopCloser(jv, min_inliers=12, min_gap=8), TL.LoopCloser(tv, min_inliers=12,
                                                                         min_gap=8)
    out = dict(jfe=jfe, tfe=tfe, jlc=jlc, tlc=tlc, traj=traj, det_j=[], det_t=[], injected=[])
    for i, fr in enumerate(ds):
        gray = (0.299 * fr.rgb[..., 0] + 0.587 * fr.rgb[..., 1]
                + 0.114 * fr.rgb[..., 2]).astype(np.float32)
        fj = jfe._extract(jnp.asarray(gray))
        ft = orb_features_from_numpy(_feats_np(fj), device="cpu")
        T_inj = (fr.gt_T_cw @ np.linalg.inv(_drift(i))).astype(np.float32)
        out["injected"].append(T_inj)
        kj = jfe.create_keyframe(fj, fr.depth, T_inj, i, run_local_mapping=False)
        kt = tfe.create_keyframe(ft, fr.depth, T_inj, i, run_local_mapping=False)
        for fe, lc, k, key in ((jfe, jlc, kj, "det_j"), (tfe, tlc, kt, "det_t")):
            lc.add_keyframe(k)
            recent = {kf.kf_id for kf in fe.keyframes if k.kf_id - kf.kf_id < lc.min_gap}
            out[key].append(lc.detect(k, recent))
    return out


def test_keyframes_and_database_match_jax(loop_run):
    jfe, tfe, jlc, tlc = (loop_run[k] for k in ("jfe", "tfe", "jlc", "tlc"))
    assert tfe.n_points == jfe.n_points > 500
    n = tfe.n_points
    np.testing.assert_allclose(tfe.pt_pos[:n], jfe.pt_pos[:n], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tfe.pt_desc[:n], jfe.pt_desc[:n])
    for a, b in zip(tfe.keyframes, jfe.keyframes):
        np.testing.assert_array_equal(a.point_ids, b.point_ids)
        assert a.parent_id == b.parent_id
    assert tlc.db.inverted == jlc.db.inverted
    for k, bow in jlc.db.bows.items():
        assert tlc.db.bows[k].keys() == bow.keys()
        assert max(abs(tlc.db.bows[k][w] - v) for w, v in bow.items()) < 1e-6
    last = tfe.keyframes[-1].kf_id
    qj = jlc.db.query(last, set(), 0.01)
    qt = tlc.db.query(last, set(), 0.01)
    assert [c for c, _ in qt] == [c for c, _ in qj] and qj
    assert max(abs(a[1] - b[1]) for a, b in zip(qt, qj)) < 1e-6
    fj = tfe.keyframes[5].feats
    rj = jlc.db.query_descriptors(jnp.asarray(descriptors_np(fj)), jnp.asarray(fj.valid.numpy()))
    rt = tlc.db.query_descriptors(fj.descriptors, fj.valid)
    assert [c for c, _ in rt] == [c for c, _ in rj]


def descriptors_np(f):
    return f.descriptors.numpy().view(np.uint32)


def _carried(loop_run):
    """The first detected loop's (query, match) ids, and the port's frontend
    and loop closer carried across from the JAX System's checkpoint dict,
    plus the state that dict does not hold (scale ranges, normals,
    observers, parents)."""
    hits = [(i, c) for i, c in enumerate(loop_run["det_j"]) if c is not None]
    assert hits, "no loop detected"
    jfe, jlc, tlc = loop_run["jfe"], loop_run["jlc"], loop_run["tlc"]
    tfe = TG.GeometricFrontend(Camera(**CAM_KW), ORBConfig(n_features=300, n_levels=3),
                               device="cpu")
    tlc2 = TL.LoopCloser(tlc.db.vocab, min_inliers=12, min_gap=8)
    state = JS.System._frontend_state(types.SimpleNamespace(fe=jfe, loop_closer=jlc))
    frontend_state_from_numpy(state, tfe, tlc2)
    assert tlc2.db.inverted == jlc.db.inverted and tlc2.consistency == jlc.consistency
    for name in ("pt_min_dist", "pt_max_dist", "pt_normal"):
        getattr(tfe, name)[:] = getattr(jfe, name)
    tfe.pt_obs_kf = {p: set(s) for p, s in jfe.pt_obs_kf.items()}
    for a, b in zip(tfe.keyframes, jfe.keyframes):
        a.parent_id = b.parent_id
    by_t = {kf.kf_id: kf for kf in tfe.keyframes}
    by_j = {kf.kf_id: kf for kf in jfe.keyframes}
    return hits[0], tfe, tlc2, by_t, by_j


def test_detect_verify_correct_match_jax(loop_run, monkeypatch):
    monkeypatch.setattr(draws, "draw_indices", jax_draws)
    assert loop_run["det_t"] == loop_run["det_j"]
    (q, m), tfe, tlc2, by_t, by_j = _carried(loop_run)
    jfe, jlc = loop_run["jfe"], loop_run["jlc"]
    cam_j, cam_t = JCamera(**CAM_KW), Camera(**CAM_KW)
    Tj = jlc.verify(by_j[q], by_j[m], jfe, cam=cam_j)
    Tt = tlc2.verify(by_t[q], by_t[m], tfe, cam=cam_t)
    assert Tj is not None and Tt is not None
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-4)
    # Without the camera: the 3D refits only.
    np.testing.assert_allclose(tlc2.verify(by_t[q], by_t[m], tfe), jlc.verify(by_j[q], by_j[m],
                                                                              jfe),
                               rtol=0, atol=1e-4)
    covis = [(q, k, 50.0) for k in (q - 1, q - 2) if k >= 0]
    cj, pj = jlc.correct(jfe.keyframes, q, m, Tj, covis)
    ct, pt = tlc2.correct(tfe.keyframes, q, m, Tj, covis, device="cpu")
    assert pj is None and pt is None
    for k in cj:
        np.testing.assert_allclose(ct[k], cj[k], rtol=0, atol=1e-4)
    # The 7-DoF path (monocular): a correction with a scale.
    S = Tj.copy()
    S[:3, :3] *= 1.05
    jlc.fix_scale = tlc2.fix_scale = False
    cj, pj = jlc.correct(jfe.keyframes, q, m, S, covis)
    ct, pt = tlc2.correct(tfe.keyframes, q, m, S, covis, device="cpu")
    for k in cj:
        np.testing.assert_allclose(ct[k], cj[k], rtol=0, atol=1e-4)
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=1e-4)


def test_verify_debug_lines_match_jax(loop_run, monkeypatch, capsys):
    """``verify(debug=True)`` prints the JAX method's lines with the same
    numbers (matches, RANSAC inliers, each refit, the SearchBySim3 growth),
    and nothing without ``debug``."""
    monkeypatch.setattr(draws, "draw_indices", jax_draws)
    (q, m), tfe, tlc2, by_t, by_j = _carried(loop_run)
    jfe, jlc = loop_run["jfe"], loop_run["jlc"]
    capsys.readouterr()
    Tj = jlc.verify(by_j[q], by_j[m], jfe, cam=JCamera(**CAM_KW), debug=True)
    theirs = capsys.readouterr().out.splitlines()
    Tt = tlc2.verify(by_t[q], by_t[m], tfe, cam=Camera(**CAM_KW), debug=True)
    mine = capsys.readouterr().out.splitlines()
    assert Tj is not None and Tt is not None
    assert mine == theirs and len(mine) == 6
    assert mine[0].startswith(f"    verify[{q}->{m}]: bow_matches=")
    assert mine[-1].startswith("    verify: SearchBySim3 grew ")
    tlc2.verify(by_t[q], by_t[m], tfe, cam=Camera(**CAM_KW))
    assert capsys.readouterr().out == ""


def test_system_closes_the_loop():
    """The port's System on the revisiting scene with drifted poses
    injected (``gt_pose``): the loop fires and the late keyframes' camera
    centres end closer to the truth than 0.7x the injected drift."""
    traj = _trajectory()
    cfg = SystemConfig(
        camera=CameraConfig(**CAM_KW, fps=10), orb=ORBConfig(n_features=300, n_levels=3),
        # The poses are injected, so the splat map does not reach the loop
        # path: one mapping iteration per frame keeps the test short (the
        # card runs tests/test_loop_e2e.py's 8 in chip_smoke.py phase 23).
        mapping=MappingConfig(num_iters=1, init_iters=1, max_gaussians=16384, window_size=3,
                              covis_window=2),
        tracking=TrackingConfig(num_iters=4, lost_num_iters=4))
    ds = SyntheticDataset(Camera(**CAM_KW), n_splats=3000, seed=5, trajectory=traj, device="cpu")
    sys_ = System(cfg, max_keyframes=32, frontend="orb", vocabulary=TV.default_vocabulary(),
                  raster=RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128,
                                      dilate_px=8.0), device="cpu")
    assert sys_.loop_closer is not None
    sys_.loop_closer.min_gap = 8
    sys_.loop_closer.min_inliers = 12
    sys_.max_frames_between_kf = 1
    injected = {}
    for i, fr in enumerate(ds):
        injected[i] = (fr.gt_T_cw @ np.linalg.inv(_drift(i))).astype(np.float32)
        sys_.track_rgbd(fr.rgb, fr.depth, fr.timestamp, gt_pose=injected[i])
    assert len(sys_.fe.keyframes) >= 10
    assert sys_.loop_events, "loop closing never fired"
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]
    err_inj, err_corr = [], []
    for kf in sys_.fe.keyframes:
        assert np.isfinite(kf.T_cw).all()
        if kf.frame_id >= len(traj) // 2:
            c_gt = centre(traj[kf.frame_id])
            err_inj.append(np.linalg.norm(centre(injected[kf.frame_id]) - c_gt))
            err_corr.append(np.linalg.norm(centre(np.asarray(kf.T_cw)) - c_gt))
    assert err_corr
    assert np.mean(err_corr) < 0.7 * np.mean(err_inj), (np.mean(err_corr), np.mean(err_inj))
    # Every keyframe's bins are stale after the closure; the rendering
    # keyframes follow the frontend's corrected poses.
    by_fe = {kf.kf_id: kf for kf in sys_.fe.keyframes}
    for meta in sys_.keyframes:
        if meta.fe_kf_id in by_fe:
            np.testing.assert_array_equal(meta.T_cw, np.asarray(by_fe[meta.fe_kf_id].T_cw,
                                                                np.float32))
