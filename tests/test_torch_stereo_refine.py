"""The port's ``compute_stereo_matches`` (ORB-SLAM2's
``Frame::ComputeStereoMatches``: the row-band descriptor match, the SAD
sub-pixel refinement on the pyramid and the median filter) against the
benchmark's plain reference, ``slambench.reference.stereo``, on the CPU.

Each case builds a small rectified scene: eight pyramid levels of a
sum-of-sines texture (quantised to 1/256, so float sums are exact), the
right levels the left ones shifted by a known sub-pixel disparity with
noise, and keypoints planted at chosen levels with copied descriptors.
The port must give the reference's ``u_right``, ``depth`` and ``valid``
bit for bit, and each case checks that its decision was taken: every
octave refined, the +-L border and the column test, the parabola's
bound, the median filter, the strict ``thOrbDist``, a zero disparity,
``minZ`` at the baseline, a coordinate rounded half away from zero.

Then the System: an RGB-D frame leaves the stereo spans and counters at 0,
a stereo frame fills them, and ``track_stereo`` passes the baseline as
``minZ``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.frontend import matcher as TM
from gsorb_slam_tpu_torch.frontend.orb import ORBFeatures
from gsorb_slam_tpu_torch.interop import system_config_from_dict
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import system as S
from slambench.reference import stereo as RS

torch.set_num_threads(1)

N_LEVELS = 8
SF = torch.tensor([1.2**i for i in range(N_LEVELS)], dtype=torch.float32)
H0, W0 = 240, 320
FX = 100.0
BF = 40.0


def _texture(x: np.ndarray, y: np.ndarray, seed: int, mirror_x: float | None = None,
             freq=(0.08, 0.3)):
    rng = np.random.default_rng(seed)
    if mirror_x is not None:
        x = np.abs(x - mirror_x)
    out = np.full(x.shape, 0.5)
    for _ in range(6):
        fx, fy = rng.uniform(*freq, 2) * rng.choice([-1, 1], 2)
        out += rng.uniform(0.04, 0.09) * np.sin(2 * np.pi * (fx * x + fy * y)
                                                + rng.uniform(0, 2 * np.pi))
    return out


def _q(img: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.clip(np.round(img * 256.0) / 256.0, 0.0, 1.0), dtype=torch.float32)


def _shape(level: int) -> tuple[int, int]:
    s = 1.2**level
    return int(round(H0 / s)), int(round(W0 / s))


def _levels(disp: float, seed: int, noise: float = 0.01, bands=(), freq=(0.08, 0.3)):
    """Left and right pyramids; the right level ``l`` shows the left one
    shifted by ``disp / 1.2^l`` level pixels, the texture's frequencies in
    cycles a pixel drawn from ``freq``. ``bands`` (level 0 only):
    ``(row0, row1, col0, col1, kind)`` regions where the right image is
    ``"same"`` (no shift, no noise, a texture mirrored about the region's
    centre column) or ``"noisy"`` (heavy noise)."""
    rng = np.random.default_rng(seed + 100)
    out_l, out_r = [], []
    for lv in range(N_LEVELS):
        h, w = _shape(lv)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        d = disp / 1.2**lv
        left = _texture(xx, yy, seed + lv, freq=freq)
        right = _texture(xx + d, yy, seed + lv, freq=freq) + noise * rng.standard_normal((h, w))
        if lv == 0:
            for r0, r1, c0, c1, kind in bands:
                if kind == "same":
                    sym = _texture(xx, yy, seed + 50, mirror_x=(c0 + c1) / 2.0)
                    left[r0:r1, c0:c1] = sym[r0:r1, c0:c1]
                    right[r0:r1, c0:c1] = sym[r0:r1, c0:c1]
                else:
                    right[r0:r1, c0:c1] += 0.3 * rng.standard_normal((r1 - r0, c1 - c0))
        out_l.append(_q(left))
        out_r.append(_q(right))
    return out_l, out_r


def _features(points, seed: int):
    """Left and right ``ORBFeatures`` from ``points``: (octave, level x,
    level y, right level x, bit flips); two invalid pad rows each."""
    rng = np.random.default_rng(seed + 7)
    n = len(points)
    desc = rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64)
    uv_l, uv_r, octv, desc_r = [], [], [], desc.copy()
    for i, (lv, x, y, xr, flips) in enumerate(points):
        s = torch.tensor(1.2**lv, dtype=torch.float64)
        uv_l.append([float(torch.tensor(x, dtype=torch.float32) * s.float()),
                     float(torch.tensor(y, dtype=torch.float32) * s.float())])
        uv_r.append([float(torch.tensor(xr, dtype=torch.float32) * s.float()), uv_l[-1][1]])
        octv.append(lv)
        for b in range(flips):  # flip bits b of the 256, one per word in turn
            desc_r[i, b % 8] ^= 1 << (b // 8)

    def feats(uv, d):
        pad = 2
        uv = torch.tensor(uv + [[0.0, 0.0]] * pad, dtype=torch.float32)
        d = np.concatenate([d, np.zeros((pad, 8), np.int64)])
        d = ((d + 2**31) % 2**32 - 2**31).astype(np.int32)
        valid = torch.tensor([True] * n + [False] * pad)
        octave = torch.tensor(octv + [0] * pad, dtype=torch.int32)
        return ORBFeatures(uv=uv, response=torch.ones(n + pad), angle=torch.zeros(n + pad),
                           octave=octave, descriptors=torch.as_tensor(d), valid=valid,
                           uv_raw=uv)

    return feats(uv_l, desc), feats(uv_r, desc_r)


def _grid(lv: int, disp: float, n: int, seed: int, offset: int = 0, flips: int = 0,
          margin: int = 12):
    """``n`` keypoints at level ``lv`` away from the borders; the right
    keypoint at the rounded true match plus ``offset`` level pixels."""
    rng = np.random.default_rng(seed)
    h, w = _shape(lv)
    d = disp / 1.2**lv
    pts = []
    for _ in range(n):
        x = int(rng.integers(margin + int(np.ceil(d)) + 6, w - margin))
        y = int(rng.integers(margin, h - margin))
        pts.append((lv, x, y, int(round(x - d)) + offset, flips))
    return pts


def _run(levels_l, levels_r, points, seed=0, bf=BF):
    fL, fR = _features(points, seed)
    got = TM.compute_stereo_matches(fL, fR, bf, min_z=bf / FX, scale_factors=SF,
                                    levels_l=levels_l, levels_r=levels_r)
    ref = RS.compute_stereo_matches(fL, fR, levels_l, levels_r, bf, bf / FX, SF)
    np.testing.assert_array_equal(got.valid.numpy(), ref["valid"].numpy())
    np.testing.assert_array_equal(got.u_right.numpy(), ref["u_right"].numpy())
    np.testing.assert_array_equal(got.depth.numpy(), ref["depth"].numpy())
    assert not got.valid[len(points):].any()
    return got, ref, fL


def _case_octave(lv):
    disp = 7.3
    pts = _grid(lv, disp, 10, seed=lv) + _grid(0, disp, 12, seed=40 + lv)
    ll, lr = _levels(disp, seed=lv)
    got, ref, fL = _run(ll, lr, pts)
    at = (fL.octave == lv) & got.valid
    assert int(at.sum()) >= 3
    # The parabola moves each match off the level's pixel grid, to within a
    # fraction of a level pixel of the true disparity on average.
    s = float(SF[lv])
    gap = (fL.uv[:, 0] - got.u_right - disp).abs()[at]
    assert float(gap.mean()) < 0.3 * s
    off_grid = (got.u_right[at] / s - torch.round(got.u_right[at] / s)).abs() > 1e-3
    assert float(off_grid.float().mean()) > 0.8


def _case_border():
    # Right keypoints 7 level pixels right of the true match (on a texture
    # of long periods the best shift is -5, the border) and 7 left (+5),
    # beside sound ones.
    disp = 9.4
    sound = _grid(0, disp, 12, seed=1)
    minus = _grid(0, disp, 6, seed=2, offset=7)
    plus = _grid(0, disp, 6, seed=3, offset=-7, margin=20)
    ll, lr = _levels(disp, seed=1, freq=(0.015, 0.03))
    got, ref, _ = _run(ll, lr, sound + minus + plus)
    n = len(sound)
    shift = ref["shift"].numpy()
    border = np.abs(shift[n:n + 12]) == RS.L
    assert border.sum() >= 8
    assert not got.valid[n:n + 12][torch.as_tensor(border)].any()
    assert int(got.valid[:n].sum()) >= 8


def _case_column_bounds():
    # At the right edge: scaleduR0 + L + w + 1 >= cols drops the keypoint;
    # one pixel further left it is kept.
    disp = 2.2
    w = _shape(0)[1]
    pts = _grid(0, disp, 10, seed=4)
    pts += [(0, w - 7, 60, w - 9, 0), (0, w - 7, 90, w - 10, 0),
            (0, w - 8, 120, w - 12, 0), (0, w - 9, 150, w - 13, 0)]
    ll, lr = _levels(disp, seed=4)
    got, ref, _ = _run(ll, lr, pts)
    edge = got.valid[10:14].tolist()
    assert edge[:2] == [False, False]
    assert np.isnan(ref["dist"][10:12].numpy()).all()  # stopped before the SAD search
    assert not np.isnan(ref["dist"][12:14].numpy()).any()


def _case_delta_bound():
    # deltaR = (d1 - d3) / (2 (d1 + d3 - 2 d2)) with d2 the first least of
    # the three: |deltaR| <= 1/2, so the source's |deltaR| > 1 drop cannot
    # fire; every refined keypoint of a frame stays inside it.
    disp = 5.5
    pts = sum((_grid(lv, disp, 6, seed=10 + lv) for lv in range(4)), [])
    ll, lr = _levels(disp, seed=5, noise=0.03)
    got, ref, _ = _run(ll, lr, pts)
    delta = ref["delta"].numpy()
    delta = delta[np.isfinite(delta)]
    assert len(delta) >= 15 and np.abs(delta).max() <= 0.5


def _case_median():
    # Keypoints in a heavily noised region of the right image: their SAD
    # lies far above the median's 2.1 times and the filter drops them.
    disp = 6.1
    sound = [p for p in _grid(0, disp, 40, seed=6) if not 160 <= p[1] < 262]
    noisy = [(0, x, y, int(round(x - disp)), 0) for x, y in
             ((190, 40), (200, 80), (210, 120), (220, 160), (195, 200), (215, 60))]
    ll, lr = _levels(disp, seed=6, bands=[(0, 240, 170, 250, "noisy")])
    got, ref, _ = _run(ll, lr, sound + noisy)
    kept = np.isfinite(ref["disparity"].numpy()) & (ref["disparity"].numpy() >= 0)
    dropped = kept & ~got.valid.numpy()[:len(kept)] & (
        ref["dist"].numpy() >= ref["th_dist"])
    assert dropped[len(sound):].sum() >= 4
    assert int(got.valid[:len(sound)].sum()) >= 0.8 * len(sound)


def _case_th_orb_dist():
    # thOrbDist = 75 is strict: 75 flipped bits drop the match, 74 keep it.
    disp = 4.6
    pts = (_grid(0, disp, 10, seed=7) + _grid(0, disp, 5, seed=8, flips=75)
           + _grid(0, disp, 5, seed=9, flips=74))
    ll, lr = _levels(disp, seed=7)
    fL, fR = _features(pts, 0)
    cand = TM.stereo_candidates(fL, fR, BF, BF / FX, SF)
    assert cand.dist[10:20].tolist() == [75] * 5 + [74] * 5
    assert cand.valid[10:20].tolist() == [False] * 5 + [True] * 5
    got, _, _ = _run(ll, lr, pts)
    assert not got.valid[10:15].any() and int(got.valid[15:20].sum()) >= 4


def _case_zero_disparity():
    # A mirrored texture with no shift: d1 == d3 exactly, deltaR = 0, uR =
    # uL, and the zero disparity becomes 0.01 (depth bf / 0.01).
    disp = 8.0
    pts = _grid(0, disp, 14, seed=11)
    pts = [p for p in pts if not (100 <= p[2] < 140 and 40 <= p[1] < 100)]
    pts += [(0, 70, 120, 70, 0)]
    ll, lr = _levels(disp, seed=11, bands=[(100, 140, 40, 100, "same")])
    got, ref, fL = _run(ll, lr, pts)
    k = len(pts) - 1
    assert float(ref["delta"][k]) == 0.0 and float(ref["disparity"][k]) == 0.0
    assert bool(got.valid[k])
    assert float(got.u_right[k]) == float(fL.uv[k, 0] - torch.tensor(0.01))
    assert float(got.depth[k]) == float(torch.tensor(BF) / torch.tensor(0.01))


def _case_min_z_baseline():
    # minZ = bf / fx (the baseline), so maxD = fx = 100 px: with bf = 12 a
    # 60 px disparity is matched, which the port's former minZ of 0.3 m
    # (maxD = 40 px) missed; a descriptor match beyond 100 px is none.
    bf, disp = 12.0, 60.4
    pts = _grid(0, disp, 12, seed=12)
    ll, lr = _levels(disp, seed=12)
    got, _, fL = _run(ll, lr, pts, bf=bf)
    assert int(got.valid.sum()) >= 8
    fR = _features(pts, 0)[1]
    assert not TM.stereo_candidates(fL, fR, bf, 0.3, SF).valid.any()
    far = fL._replace(uv=fL.uv + torch.tensor([45.0, 0.0]))
    assert not TM.stereo_candidates(far, fR, bf, bf / FX, SF).valid.any()


def _case_round_half():
    # uL = 120.5, uR0 = 113.5, vL = 80.5 at octave 0: C's round takes
    # them to 121, 114 and 81 (torch.round: 120, 112, 80).
    disp = 7.0
    pts = _grid(0, disp, 12, seed=13)
    fL, fR = _features(pts + [(0, 120, 80, 113, 0)], 0)
    half = torch.tensor([0.5, 0.5])
    fL = fL._replace(uv=torch.cat([fL.uv[:12], fL.uv[12:13] + half, fL.uv[13:]]))
    fR = fR._replace(uv=torch.cat([fR.uv[:12], fR.uv[12:13] + half, fR.uv[13:]]))
    ll, lr = _levels(disp, seed=13)
    got = TM.compute_stereo_matches(fL, fR, BF, min_z=BF / FX, scale_factors=SF,
                                    levels_l=ll, levels_r=lr)
    ref = RS.compute_stereo_matches(fL, fR, ll, lr, BF, BF / FX, SF)
    for k in ("u_right", "depth", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k].numpy())
    assert np.isfinite(float(ref["dist"][12]))
    x = torch.tensor([-2.5, -0.5, 0.5, 1.5, 2.5, 120.5, 0.49999997, -1.49999988])
    assert TM.round_half_away(x).tolist() == [RS.c_round(float(v)) for v in x]
    assert TM.round_half_away(x).tolist() == [-3, -1, 1, 2, 3, 121, 0, -1]


CASES = {
    **{f"octave{lv}": (lambda lv=lv: _case_octave(lv)) for lv in range(N_LEVELS)},
    "border": _case_border,
    "column_bounds": _case_column_bounds,
    "delta_bound": _case_delta_bound,
    "median_filter": _case_median,
    "th_orb_dist": _case_th_orb_dist,
    "zero_disparity": _case_zero_disparity,
    "min_z_baseline": _case_min_z_baseline,
    "round_half_away": _case_round_half,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case):
    CASES[case]()


# ------------------------------------------------------------- the System

W, H = 128, 96
CAM_KW = dict(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=W, height=H)
CONFIG = {
    "Camera": {**CAM_KW, "fps": 10.0, "bf": 10.0},
    "ORBextractor": {"nFeatures": 400, "nLevels": 3},
    "Mapping": {"numIters": 3, "maxGaussians": 16384},
    "Tracking": {"numIters": 5},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
STEREO_SPANS = ("fe.stereo_depth", "fe.stereo_orb", "fe.stereo_match")
STEREO_COUNTERS = ("stereo_keypoints", "stereo_matches")


def _system():
    cfg = system_config_from_dict(CONFIG)
    return S.System(cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=5)),
                    frontend="orb", device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(W), **RASTER))


@pytest.fixture(scope="module")
def pairs():
    return D.StereoSyntheticDataset(Camera(**CAM_KW), 0.1, n_frames=2, n_splats=3000, seed=2,
                                    motion_scale=0.05, device="cpu")


def test_stereo_spans_and_counters(pairs, monkeypatch):
    names = [*STEREO_SPANS, *("n_" + s for s in STEREO_SPANS), *STEREO_COUNTERS]
    rgbd = _system()
    assert all(rgbd.timings[k] == 0 for k in names)
    for i in range(2):
        fr = pairs[i]
        z = np.full((H, W), 2.0, np.float32)
        rgbd.track_rgbd(fr.left, z, fr.timestamp)
    assert rgbd.timings["n_frame"] == 2 and all(rgbd.timings[k] == 0 for k in names)

    seen = []
    orig = S.compute_stereo_matches

    def spy(fL, fR, bf, min_z, **kw):
        seen.append(min_z)
        return orig(fL, fR, bf, min_z=min_z, **kw)

    monkeypatch.setattr(S, "compute_stereo_matches", spy)
    st = _system()
    for i in range(2):
        fr = pairs[i]
        st.track_stereo(fr.left, fr.right, fr.timestamp)
    t = st.timings
    assert seen == [float(np.float32(10.0) / np.float32(100.0))] * 2  # minZ = bf / fx
    assert all(t[s] > 0 and t["n_" + s] == 2 for s in STEREO_SPANS)
    assert 0 < t["stereo_matches"] <= t["stereo_keypoints"] <= 2 * 400
    # The stage is a frontend span of its own, its parts inside it, and its
    # host reads (the quad-tree's and the matches') are frontend waits.
    assert t["n_frontend"] == 4
    assert sum(t[s] for s in STEREO_SPANS) + t["fe.total"] <= t["frontend"]
    assert t["n_frontend.wait"] >= 2 * (1 + 2 * 4)

