"""The port's stereo and monocular inputs against the JAX package's on the CPU.

- ``compute_stereo_matches`` (mirrors ``tests/test_stereo_orb.py:39-72``):
  the JAX package stops at the descriptor match, the port goes on as
  ORB-SLAM2 does (SAD sub-pixel refinement, median filter). So the port's
  descriptor stage (``stereo_candidates``) is held to JAX's matches, with
  planted Hamming ties (right sets holding exact copies of a descriptor,
  so the first index decides) and wrong-row rejection, and the refined
  output to the plain reference (``slambench.reference.stereo``) on a
  textured pyramid; the descriptor stage's depths within 1e-2 m.
- ``StereoSyntheticDataset``: rgb within 2e-3, poses equal (the render's
  tolerance of ``tests/test_torch_eval.py``), the right view the left pose
  shifted by the baseline.
- ``KittiStereoDataset`` (stereo and ``mono=True``) and ``MonoTumDataset``
  read layouts written here: frames equal to the JAX loaders'.
- ``track_stereo``'s host stage: ``track_rgbd`` replaced on one instance of
  each System to capture its arguments, the JAX features carried across
  (with the port's pyramid of the same gray); SGBM depth and rgb equal,
  the descriptor stage on those features equal to JAX's ``kp_ur``, and the
  port's ``kp_ur`` and ``kp_depth`` equal to the reference's.
- A 2-frame port-only stereo System (``frontend="orb"``) at 128x96.
"""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.frontend import matcher as JM
from gsorb_slam_tpu.frontend.orb import ORBFeatures as JFeatures
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import ORBConfig
from gsorb_slam_tpu_torch.frontend import matcher as TM
from gsorb_slam_tpu_torch.frontend import orb as TO
from gsorb_slam_tpu_torch.interop import orb_features_from_numpy, system_config_from_dict
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import system as S
from slambench.reference import stereo as RS

torch.set_num_threads(1)

BF = 200.0 * 0.08
SF = np.asarray([1.0, 1.2, 1.44], np.float32)
W, H = 128, 96
CAM_KW = dict(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=W, height=H)
CONFIG = {
    "Camera": {**CAM_KW, "fps": 10.0, "bf": 10.0},
    "ORBextractor": {"nFeatures": 400, "nLevels": 3},
    "Mapping": {"numIters": 3, "maxGaussians": 16384},
    "Tracking": {"numIters": 5},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
# The JAX System's side: its default raster config blends in bf16.
JRASTER = dict(RASTER, blend_bf16=False, elem_bf16=False)


def _feats(uv, desc, octave=None, n_pad=8):
    n = len(uv)
    N = n + n_pad
    d = dict(uv=np.zeros((N, 2), np.float32), response=np.ones(N, np.float32),
             angle=np.zeros(N, np.float32), octave=np.zeros(N, np.int32),
             descriptors=np.zeros((N, 8), np.uint32), valid=np.zeros(N, bool))
    d["uv"][:n], d["descriptors"][:n], d["valid"][:n] = uv, desc, True
    if octave is not None:
        d["octave"][:n] = octave
    d["uv_raw"] = d["uv"]
    return JFeatures(**{k: jnp.asarray(v) for k, v in d.items()}), orb_features_from_numpy(
        d, device="cpu")


def _stereo_both(fL, fR):
    """The port's descriptor stage against JAX's matches (``min_z`` 0.3 on
    both sides, as JAX's System passes)."""
    ref = JM.compute_stereo_matches(fL[0], fR[0], BF, min_z=0.3, scale_factors=jnp.asarray(SF))
    cand = TM.stereo_candidates(fL[1], fR[1], BF, min_z=0.3, scale_factors=torch.as_tensor(SF))
    u_r = torch.where(cand.valid, fR[1].uv[:, 0][torch.clamp(cand.idx2, min=0)], -1.0)
    np.testing.assert_array_equal(cand.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(u_r.numpy(), np.asarray(ref.u_right))
    np.testing.assert_array_equal(np.where(cand.valid.numpy(), BF / np.maximum(
        fL[1].uv[:, 0].numpy() - u_r.numpy(), 0.01), 0.0).astype(np.float32),
        np.asarray(ref.depth))
    return cand


def _pyramid(shift: np.ndarray, h: int, w: int, seed: int):
    """Left and right pyramids of a smooth random texture, the right level
    shifted left by ``shift`` level-0 pixels (one value a row, so each row
    has its own disparity)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 3 + 4, w // 3 + 12)).astype(np.float32)
    big = cv2.resize(base, (3 * base.shape[1], 3 * base.shape[0]), interpolation=cv2.INTER_CUBIC)
    xs = np.arange(w, dtype=np.float32)
    left = np.stack([np.interp(xs + 12, np.arange(big.shape[1]), big[y]) for y in range(h)])
    right = np.stack([np.interp(xs + 12 + shift[y], np.arange(big.shape[1]), big[y])
                      for y in range(h)])
    right = right + 0.01 * rng.standard_normal(right.shape)
    lv_l, lv_r = [], []
    for lv in range(len(SF)):
        hl, wl = int(round(h / SF[lv])), int(round(w / SF[lv]))
        lv_l.append(TO.resize_linear(torch.as_tensor(left, dtype=torch.float32), hl, wl))
        lv_r.append(TO.resize_linear(torch.as_tensor(right, dtype=torch.float32), hl, wl))
    return lv_l, lv_r


def _refined_matches_reference(fL, fR, lv_l, lv_r, bf, min_z):
    got = TM.compute_stereo_matches(fL, fR, bf, min_z=min_z, scale_factors=torch.as_tensor(SF),
                                    levels_l=lv_l, levels_r=lv_r)
    ref = RS.compute_stereo_matches(fL, fR, lv_l, lv_r, bf, min_z, torch.as_tensor(SF))
    for f in ("u_right", "depth", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f].numpy(), err_msg=f)
    return got


def test_compute_stereo_matches_matches_jax():
    rng = np.random.default_rng(3)
    n = 60
    z = rng.uniform(0.8, 4.0, n).astype(np.float32)
    uL = rng.uniform(30, 150, n).astype(np.float32)
    vL = rng.uniform(5, 115, n).astype(np.float32)
    uR = uL - BF / z
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    octave = rng.integers(0, 3, n).astype(np.int32)
    fL = _feats(np.stack([uL, vL], -1), desc, octave)
    # Right set: every left descriptor, then exact copies of the first 20 at
    # other columns of the same rows (ties the first index must win), and
    # the next 10 with 3 bits flipped.
    flipped = desc[20:30].copy()
    flipped[:, 0] ^= np.uint32(0b10101)
    uv_r = np.concatenate([np.stack([uR, vL], -1),
                           np.stack([uR[:20] - 2.0, vL[:20]], -1),
                           np.stack([uR[20:30] + 1.0, vL[20:30]], -1)]).astype(np.float32)
    fR = _feats(uv_r, np.concatenate([desc, desc[:20], flipped]),
                np.concatenate([octave, octave[:20], octave[20:30]]))
    cand = _stereo_both(fL, fR)
    valid = cand.valid.numpy()[:n]
    assert valid.mean() > 0.9
    u_r = fR[1].uv[:, 0].numpy()[cand.idx2.numpy()[:n]]
    assert np.abs(BF / (uL - u_r)[valid] - z[valid]).max() < 1e-2
    # The copies lie further left: a larger disparity, only chosen if first.
    np.testing.assert_array_equal(u_r[:20][valid[:20]], uR[:20][valid[:20]])
    assert not cand.valid.numpy()[n:].any()

    # The refined output against the reference: the same keypoints moved 30 px
    # into a pyramid whose right view shows each keypoint's row at its
    # disparity (the copies' rows too), so the SAD search finds the true match.
    off = np.float32(30.0)
    shift = np.zeros(180, np.float32)
    rows = (vL + off).astype(int)
    for dv in range(-3, 4):
        shift[rows + dv] = BF / z
    lv_l, lv_r = _pyramid(shift, 180, 220, seed=3)
    move = lambda f: f._replace(uv=f.uv + torch.tensor([off, off]))
    got = _refined_matches_reference(move(fL[1]), move(fR[1]), lv_l, lv_r, BF, 0.3)
    ok = got.valid.numpy()[:n]
    assert ok.mean() > 0.5


def test_stereo_matches_reject_wrong_row():
    rng = np.random.default_rng(4)
    n = 30
    uL = rng.uniform(40, 140, n).astype(np.float32)
    vL = rng.uniform(10, 50, n).astype(np.float32)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    fL = _feats(np.stack([uL, vL], -1), desc)
    fR = _feats(np.stack([uL - 5.0, vL + 40.0], -1), desc)
    cand = _stereo_both(fL, fR)
    assert cand.valid.numpy().sum() == 0
    lv_l, lv_r = _pyramid(np.full(120, 5.0, np.float32), 120, 180, seed=4)
    out = _refined_matches_reference(fL[1], fR[1], lv_l, lv_r, BF, 0.3)
    assert out.valid.numpy().sum() == 0
    assert (out.u_right.numpy() == -1.0).all() and (out.depth.numpy() == 0.0).all()


@pytest.fixture(scope="module")
def stereo_pairs():
    kw = dict(n_frames=2, n_splats=3000, seed=2, motion_scale=0.05)
    ref = JD.StereoSyntheticDataset(JCamera(**CAM_KW), 0.1, **kw)
    port = D.StereoSyntheticDataset(Camera(**CAM_KW), 0.1, **kw, device="cpu")
    return ref, port


def test_stereo_synthetic_dataset_matches_jax(stereo_pairs):
    ref, port = stereo_pairs
    assert len(port) == len(ref) == 2
    for i in range(2):
        a, b = port[i], ref[i]
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.gt_T_cw, b.gt_T_cw)
        np.testing.assert_allclose(a.left, b.left, atol=2e-3)
        np.testing.assert_allclose(a.right, b.right, atol=2e-3)
        T_r = port._right.poses[i]
        np.testing.assert_allclose(T_r[:3, 3] - a.gt_T_cw[:3, 3], [-0.1, 0.0, 0.0], atol=1e-6)
        assert not np.array_equal(a.left, a.right)


def _write_kitti(root, pairs, n):
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    gray = lambda rgb: cv2.cvtColor((rgb * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    for i in range(n):
        fr = pairs[i]
        cv2.imwrite(os.path.join(root, "image_0", f"{i:06d}.png"), gray(fr.left))
        cv2.imwrite(os.path.join(root, "image_1", f"{i:06d}.png"), gray(fr.right))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{0.1 * i:.6e}\n" for i in range(n + 1)))  # one time too many


def test_kitti_and_mono_tum_loaders_match_jax(stereo_pairs, tmp_path):
    ref, port = stereo_pairs
    root = str(tmp_path / "kitti")
    _write_kitti(root, port, 2)
    for mono in (False, True):
        a, b = D.KittiStereoDataset(root, mono=mono), JD.KittiStereoDataset(root, mono=mono)
        assert len(a) == len(b) == 2
        for i in range(2):
            fa, fb = a[i], b[i]
            assert type(fa).__name__ == type(fb).__name__ == ("MonoFrame" if mono
                                                              else "StereoFrame")
            assert fa.timestamp == fb.timestamp
            for f in (("rgb",) if mono else ("left", "right")):
                np.testing.assert_array_equal(getattr(fa, f), getattr(fb, f))
                assert getattr(fa, f).shape == (H, W, 3)

    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    lines = ["# color images", "# timestamp filename"]
    for i in range(2):
        name = f"rgb/{1305031102.0 + i / 30:.6f}.png"
        cv2.imwrite(str(tum / name), cv2.cvtColor((port[i].left * 255).astype(np.uint8),
                                                  cv2.COLOR_RGB2BGR))
        lines.append(f"{1305031102.0 + i / 30:.6f} {name}")
    (tum / "rgb.txt").write_text("\n".join(lines) + "\n")
    a, b = D.MonoTumDataset(str(tum)), JD.MonoTumDataset(str(tum))
    assert len(a) == len(b) == 2 and a.gt is None
    for i in range(2):
        assert a[i].timestamp == b[i].timestamp and a[i].gt_T_cw is None
        np.testing.assert_array_equal(a[i].rgb, b[i].rgb)
    gt = ["# ground truth", f"{1305031102.0:.4f} 0.1 0.2 0.3 0 0 0 1"]
    (tum / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    a, b = D.MonoTumDataset(str(tum)), JD.MonoTumDataset(str(tum))
    np.testing.assert_array_equal(a[0].gt_T_cw, b[0].gt_T_cw)
    np.testing.assert_allclose(a[0].gt_T_cw[:3, 3], [-0.1, -0.2, -0.3], atol=1e-6)


def _capture_track_rgbd(system, out):
    def capture(rgb, depth, timestamp=0.0, stereo_aux=None, **kw):
        out.append(dict(rgb=np.asarray(rgb), depth=np.asarray(depth), aux=stereo_aux))
        return np.eye(4, dtype=np.float32)

    system.track_rgbd = capture


def test_track_stereo_host_stage_matches_jax(stereo_pairs):
    """SGBM, the quantized gray and the row-wise ORB matches: both Systems'
    ``track_rgbd`` receive the same rgb and depth (the port takes JAX's
    features, with its own pyramid of the same gray); the port's
    descriptor stage on them gives JAX's matches, and its refined
    ``kp_ur`` / ``kp_depth`` are the reference's."""
    ref, _ = stereo_pairs
    raster_j = dataclasses.replace(JS.System.default_raster_config(W), backend="pallas",
                                   **JRASTER)
    jsys = JS.System(jload_config(CONFIG), frontend="orb", raster=raster_j)
    tsys = S.System(system_config_from_dict(CONFIG), frontend="orb", device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    feats, used = [], []
    extract_j = jsys.fe._extract
    orb_cfg = ORBConfig(n_features=400, n_levels=3)

    def record(gray):
        f = extract_j(gray)
        feats.append(orb_features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()},
                                             device="cpu"))
        return f

    def carried(gray, levels=None, read=torch.Tensor.cpu):
        TO.extract_orb(torch.as_tensor(gray, dtype=torch.float32), orb_cfg, levels=levels)
        used.append((feats.pop(0), levels))
        return used[-1][0]

    jsys.fe._extract = record
    tsys.fe._extract = carried
    got_j, got_t = [], []
    _capture_track_rgbd(jsys, got_j)
    _capture_track_rgbd(tsys, got_t)
    fr = ref[1]
    jsys.track_stereo(fr.left, fr.right, fr.timestamp)
    tsys.track_stereo(fr.left, fr.right, fr.timestamp)
    (a,), (b,) = got_t, got_j
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    np.testing.assert_array_equal(a["depth"], b["depth"])
    assert 0.2 < float((b["depth"] > 0).mean()) < 1.0
    (fl, lv_l), (fr_, lv_r) = used
    sf = torch.as_tensor(np.sqrt(TO.level_sigma2(orb_cfg)))
    bf = CONFIG["Camera"]["bf"]
    # The descriptor stage, as JAX's System runs it (min_z 0.3).
    cand = TM.stereo_candidates(fl, fr_, bf, 0.3, sf)
    valid_j = b["aux"]["kp_ur"] >= 0
    # A best distance of exactly thOrbDist (75): JAX keeps it (<=), Frame.cc
    # and the port drop it (<); nothing else differs on these features.
    at_th = cand.dist.numpy() == (TM.TH_HIGH + TM.TH_LOW) // 2
    np.testing.assert_array_equal(cand.valid.numpy(), valid_j & ~at_th)
    assert valid_j.sum() > 20
    keep = cand.valid.numpy()
    np.testing.assert_array_equal(fr_.uv[:, 0].numpy()[cand.idx2.numpy()[keep]],
                                  b["aux"]["kp_ur"][keep])
    # The refined matches, with minZ the baseline bf / fx.
    want = RS.compute_stereo_matches(fl, fr_, lv_l, lv_r, bf,
                                     float(np.float32(bf) / np.float32(CAM_KW["fx"])), sf)
    valid_t = a["aux"]["kp_ur"] >= 0
    np.testing.assert_array_equal(valid_t, want["valid"].numpy())
    assert valid_t.sum() > 10
    np.testing.assert_array_equal(a["aux"]["kp_ur"], want["u_right"].numpy())
    np.testing.assert_array_equal(a["aux"]["kp_depth"], want["depth"].numpy())
    assert a["aux"]["kp_ur"].dtype == a["aux"]["kp_depth"].dtype == np.float32
    np.testing.assert_array_equal(a["aux"]["feats"].uv.numpy(), np.asarray(b["aux"]["feats"].uv))


def test_stereo_system_runs_on_the_cpu(stereo_pairs):
    _, port = stereo_pairs
    cfg = system_config_from_dict(CONFIG)
    tsys = S.System(cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=5)),
                    frontend="orb", device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))
    seen = []
    track = tsys.track_rgbd

    def spy(rgb, depth, timestamp=0.0, stereo_aux=None, **kw):
        seen.append(stereo_aux)
        return track(rgb, depth, timestamp, stereo_aux=stereo_aux, **kw)

    tsys.track_rgbd = spy
    for i in range(2):
        fr = port[i]
        T = tsys.track_stereo(fr.left, fr.right, fr.timestamp)
        assert T.shape == (4, 4) and np.isfinite(T).all()
        assert float(np.abs(T[:3, 3] - fr.gt_T_cw[:3, 3]).max()) < 0.05
    assert all(int((aux["kp_ur"] >= 0).sum()) > 0 for aux in seen)
    assert tsys.fe.n_points > 0 and int(tsys.gm.n_active()) > 100
    assert [r.timestamp for r in tsys.trajectory] == [port[0].timestamp, port[1].timestamp]
