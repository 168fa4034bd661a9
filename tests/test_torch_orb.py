"""The port's ORB extraction and lens distortion against the JAX package's
on the CPU.

- The pyramid resize against ``jax.image.resize(..., "linear")``: within
  1e-6 per pixel.
- ``extract_orb`` at 160x120, 3 levels, 300 features, on a textured
  synthetic frame and on one tiled from a single patch (many equal FAST
  scores): ``uv``, ``octave`` and ``valid`` equal (level 0 in the same
  order: its ties are exact and both keep the lower index; on the
  resampled levels the planted ties become near-ties that the two resizes
  round apart, and rows whose responses agree within 1e-5 may trade
  places); ``response`` within
  1e-5; ``angle`` within 1e-4 rad on the valid rows; descriptors bit for bit
  on at least 99% of the valid rows (a steered BRIEF offset on a .5 rounding
  boundary flips a bit when the angle moves by one ulp; such rows are
  printed).
- ``quadtree_refine``: the same keep mask.
- ``undistort_points`` / ``distort_points`` at TUM1's coefficients within
  1e-4 px, and the ``TUMLikeDataset`` warp maps built from them.
- The BRIEF pattern and the vocabulary are byte-for-byte copies of the JAX
  package's files.
- Constructing the frontend needs no ``nvcc``; ``pin_full_f32`` sets the
  three flags.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core import camera as JC
from gsorb_slam_tpu.core.config import ORBConfig as JORBConfig
from gsorb_slam_tpu.frontend import orb as JO
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core import camera as TC
from gsorb_slam_tpu_torch.core.config import ORBConfig
from gsorb_slam_tpu_torch.frontend import orb as TO
from gsorb_slam_tpu_torch.frontend import vocab as TV
from gsorb_slam_tpu_torch.slam import dataset as TD
from gsorb_slam_tpu_torch.slam.geometric import GeometricFrontend

torch.set_num_threads(1)

H, W = 120, 160
ORB_KW = dict(n_features=300, n_levels=3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUM1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)


def _textured(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 1, (H // 4, W // 4)), np.ones((4, 4)))
    return ((img + 0.1 * rng.uniform(0, 1, (H, W))) / 1.1).astype(np.float32)


def _tiled(seed: int) -> np.ndarray:
    """One 20x20 patch repeated: equal FAST scores at every repeat."""
    rng = np.random.default_rng(seed)
    patch = np.kron(rng.uniform(0, 1, (5, 5)), np.ones((4, 4)))
    return np.tile(patch, (H // 20, W // 20)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_extract():
    return jax.jit(JO.extract_orb, static_argnums=1)


@pytest.mark.parametrize("shape", [(100, 133), (83, 111), (58, 77)])
def test_resize_matches_jax(shape):
    img = _textured(0)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
    out = TO.resize_linear(torch.as_tensor(img), *shape).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _half_offsets(angle: float) -> list[int]:
    """Pattern pairs whose steered offsets sit within 1e-4 of a .5 boundary."""
    pat = TO._pattern().astype(np.float64)
    c, s = np.cos(angle), np.sin(angle)
    xs = [pat[:, 0] * c - pat[:, 1] * s, pat[:, 0] * s + pat[:, 1] * c,
          pat[:, 2] * c - pat[:, 3] * s, pat[:, 2] * s + pat[:, 3] * c]
    near = np.zeros(len(pat), bool)
    for x in xs:
        near |= np.abs(np.abs(x - np.floor(x)) - 0.5) < 1e-4
    return np.nonzero(near)[0].tolist()


def _match_near_ties(out, ref) -> np.ndarray:
    """The permutation of the port's rows onto the JAX rows. Level 0 must
    keep its order exactly: its equal FAST scores are exact ties, and both
    keep the lower index. On the resampled levels the planted ties are
    near-ties (the two resizes round differently below 1e-6), so rows may
    only trade places with rows of the same level whose JAX responses are
    within 1e-5."""
    uv_o, uv_r = out.uv.numpy(), np.asarray(ref.uv)
    oct_r, resp_r = np.asarray(ref.octave), np.asarray(ref.response)
    order = np.arange(len(uv_r))
    for i in np.nonzero((uv_o != uv_r).any(1))[0]:
        assert oct_r[i] > 0, f"level-0 row {i} out of order"
        (j,) = np.nonzero((uv_o == uv_r[i]).all(1) & (out.octave.numpy() == oct_r[i]))[0]
        assert abs(resp_r[i] - resp_r[j]) < 1e-5, (i, j, resp_r[i], resp_r[j])
        order[i] = j
    assert sorted(order) == list(range(len(order)))
    return torch.as_tensor(order)


@pytest.mark.parametrize("make", [_textured, _tiled], ids=["textured", "planted_ties"])
def test_extract_orb_matches_jax(make, jax_extract):
    img = make(1)
    ref = jax_extract(jnp.asarray(img), JORBConfig(**ORB_KW))
    out = TO.extract_orb(torch.as_tensor(img), ORBConfig(**ORB_KW))
    order = _match_near_ties(out, ref)
    out = out._replace(**{k: getattr(out, k)[order] for k in out._fields
                          if getattr(out, k) is not None})
    np.testing.assert_array_equal(out.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(out.octave.numpy(), np.asarray(ref.octave))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    valid = np.asarray(ref.valid)
    assert valid.sum() > 50
    np.testing.assert_allclose(out.response.numpy(), np.asarray(ref.response), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.angle.numpy()[valid], np.asarray(ref.angle)[valid], rtol=0,
                               atol=1e-4)
    d_out = TO.descriptors_to_numpy(out.descriptors)
    d_ref = np.asarray(ref.descriptors)
    rows = (d_out == d_ref).all(1)
    for i in np.nonzero(~rows & valid)[0]:
        a = float(np.asarray(ref.angle)[i])
        print(f"row {i}: angle {a:.7f} (port {float(out.angle[i]):.7f}); pairs on a .5 "
              f"boundary {_half_offsets(a)}")
    assert rows[valid].mean() >= 0.99


def test_planted_ties_are_ties():
    """The tiled frame really plants equal scores among the candidates."""
    img = torch.as_tensor(_tiled(1))
    r = TO._fast_response(img, 20 / 255.0)
    vals = r[r > 0]
    assert len(vals) > len(torch.unique(vals)) + 20


def test_quadtree_refine_matches_jax(jax_extract):
    """300 candidates distributed down to a 120-feature budget per level."""
    img = _textured(2)
    cfg = dict(n_features=120, n_levels=3)
    ref = JO.quadtree_refine(jax_extract(jnp.asarray(img), JORBConfig(**ORB_KW)),
                             JORBConfig(**cfg))
    feats = TO.extract_orb(torch.as_tensor(img), ORBConfig(**ORB_KW))
    out = TO.quadtree_refine(feats, ORBConfig(**cfg))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(out.valid.sum()) < int(feats.valid.sum())


def test_distortion_matches_jax():
    jcam = JC.Camera(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, width=640,
                     height=480)
    tcam = TC.Camera(fx=jcam.fx, fy=jcam.fy, cx=jcam.cx, cy=jcam.cy, width=640, height=480)
    jd, td = JC.Distortion(*TUM1_DIST), TC.Distortion(*TUM1_DIST)
    uu, vv = np.meshgrid(np.linspace(0, 640, 33), np.linspace(0, 480, 25))
    uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    for j_fn, t_fn in ((JC.undistort_points, TC.undistort_points),
                       (JC.distort_points, TC.distort_points)):
        ref = np.asarray(j_fn(jcam, jd, jnp.asarray(uv)))
        out = t_fn(tcam, td, torch.as_tensor(uv)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert TC.undistorted_image_bounds(tcam, td) == pytest.approx(
        JC.undistorted_image_bounds(jcam, jd), abs=1e-4)
    assert TC.undistorted_image_bounds(tcam, TC.Distortion()) == (0.0, 640.0, 0.0, 480.0)


def test_tumlike_undistort_maps_match_jax():
    """The warp maps of ``TUMLikeDataset(apply_distortion=True)`` (the
    frames themselves are held to the JAX package's in
    ``tests/test_torch_eval.py``)."""
    jds = JD.TUMLikeDataset.__new__(JD.TUMLikeDataset)
    tds = TD.TUMLikeDataset.__new__(TD.TUMLikeDataset)
    jds.cam = JC.Camera(fx=100.0, fy=100.0, cx=40.0, cy=30.0, width=80, height=60)
    tds.cam = TC.Camera(fx=100.0, fy=100.0, cx=40.0, cy=30.0, width=80, height=60)
    for a, b in zip(tds._undistort_maps(), jds._undistort_maps()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_assets_are_byte_copies():
    pairs = [("gsorb_slam_tpu/frontend/brief_pattern.npy",
              "gsorb_slam_tpu_torch/frontend/brief_pattern.npy"),
             ("gsorb_slam_tpu/assets/ORBvoc_synth.txt",
              "gsorb_slam_tpu_torch/assets/ORBvoc_synth.txt")]
    for a, b in pairs:
        assert filecmp.cmp(os.path.join(ROOT, a), os.path.join(ROOT, b), shallow=False), b
    assert os.path.samefile(TV.DEFAULT_VOCABULARY_PATH, os.path.join(ROOT, pairs[1][1]))


def test_frontend_needs_no_nvcc(monkeypatch):
    """Constructing the frontend (and extracting on the CPU) builds nothing."""

    def no_build(*a, **kw):
        raise AssertionError("the kernel library was built")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    cam = TC.Camera(fx=100.0, fy=100.0, cx=80.0, cy=60.0, width=W, height=H)
    fe = GeometricFrontend(cam, ORBConfig(**ORB_KW), dist=TC.Distortion(*TUM1_DIST),
                           device="cpu")
    feats = fe._extract(torch.as_tensor(_textured(3)))
    assert feats.count() > 0 and feats.uv_raw is not None
    assert not torch.equal(feats.uv, feats.uv_raw)  # the keypoints are undistorted


def test_pin_full_f32_sets_the_flags(monkeypatch):
    for mod, name in ((torch.backends.cuda.matmul, "allow_tf32"),
                      (torch.backends.cudnn, "allow_tf32"), (torch.backends.cudnn,
                                                             "deterministic")):
        monkeypatch.setattr(mod, name, name == "allow_tf32")
    _build.pin_full_f32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
