"""The port's disk datasets against the JAX package's: the image readers and
writers through ``cv2`` and through Pillow (PNG bit for bit, the loaders'
frames under Pillow against ``cv2``'s), ``associate_timestamps``, the TUM /
Replica / ScanNet loaders on the JAX exporters' files (frames equal to the
JAX loaders'), the port's exporters read by the JAX loaders (within
``tests/test_dataset_disk.py``'s and ``tests/test_tum_disk.py``'s bounds),
``open_dataset``'s depth factors, a missing ground truth, a non-finite
ScanNet pose, images without a codec, and the ``TUMLikeDataset`` cache."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.slam import dataset as D

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    """The JAX disk tests' sequence (their bounds were set on it)."""
    cam = Camera(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)
    ds = D.SyntheticDataset(cam, n_frames=5, n_splats=2000, motion_scale=0.15, device="cpu")
    return [ds[i] for i in range(len(ds))]


# -------------------------------------------------------------- image codecs


def _without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert D.image_codec_name() == "pillow"


@pytest.mark.parametrize("codec", ["cv2", "pillow"])
@pytest.mark.parametrize("kind", ["rgb", "depth16"])
def test_png_round_trip_through_either_codec(rng, tmp_path, monkeypatch, codec, kind):
    """PNG is lossless whichever codec writes and reads it, and cv2 reads
    the file back to the source's values."""
    if kind == "rgb":
        img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
        img[:, :20] = 200  # a flat region, where the encoders pick other row filters
    else:
        img = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    if codec == "pillow":
        _without_cv2(monkeypatch)
    path = str(tmp_path / "img.png")
    D._imwrite(path, img)
    if kind == "rgb":
        np.testing.assert_array_equal(D._imread_color(path), img.astype(np.float32) / 255.0)
    else:
        np.testing.assert_array_equal(D._imread_depth(path, 5000.0),
                                      img.astype(np.float32) / 5000.0)
    monkeypatch.undo()
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if kind == "rgb" else back, img)


@pytest.mark.parametrize("layout", ["tum", "replica", "scannet"])
def test_loaders_through_pillow_match_cv2(frames, tmp_path, monkeypatch, layout):
    """The JAX exporter's files (written by cv2) read by the port's loaders
    through Pillow: the PNG values equal cv2's, the JPEG colors within a
    decoder's rounding."""
    root = str(tmp_path / layout)
    getattr(JD, f"export_{layout}_format")(frames, root)
    want = [D.open_dataset(layout, root, 5000.0)[i] for i in (0, len(frames) - 1)]
    _without_cv2(monkeypatch)
    got = [D.open_dataset(layout, root, 5000.0)[i] for i in (0, len(frames) - 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.depth, w.depth)
        if layout == "tum":
            np.testing.assert_array_equal(g.rgb, w.rgb)
        else:
            assert np.abs(g.rgb - w.rgb).max() <= 2.0 / 255.0 + 1e-7
        np.testing.assert_array_equal(g.gt_T_cw, w.gt_T_cw)


# ------------------------------------------------------------------- loaders


def test_associate_timestamps_matches_jax(rng):
    a = np.sort(1305031102.0 + np.arange(60) / 30.0 + rng.uniform(-4e-3, 4e-3, 60))
    b = np.sort(1305031102.0 + np.arange(60) / 30.0 + rng.uniform(-4e-3, 4e-3, 60))
    b[10] = b[11] = a[11]  # a collision: two a's want the same b
    b = np.delete(b, 30)  # an a with no partner inside max_dt
    got = D.associate_timestamps(a, b)
    assert got == JD.associate_timestamps(a, b)
    assert len(got) < len(a)


def _assert_frames_equal(port, jax):
    assert len(port) == len(jax)
    for i in range(len(jax)):
        p, j = port[i], jax[i]
        assert p.timestamp == j.timestamp
        np.testing.assert_array_equal(p.rgb, j.rgb)
        np.testing.assert_array_equal(p.depth, j.depth)
        if j.gt_T_cw is None:
            assert p.gt_T_cw is None
        else:
            np.testing.assert_array_equal(p.gt_T_cw, j.gt_T_cw)


@pytest.mark.parametrize("layout", ["tum", "replica", "scannet"])
def test_port_loaders_read_jax_exports(frames, tmp_path, layout):
    root = str(tmp_path / layout)
    getattr(JD, f"export_{layout}_format")(frames, root)
    _assert_frames_equal(D.open_dataset(layout, root, 5000.0),
                         JD.open_dataset(layout, root, 5000.0))


@pytest.mark.parametrize("layout", ["tum", "replica", "scannet"])
def test_jax_loaders_read_port_exports(frames, tmp_path, layout):
    root = str(tmp_path / layout)
    getattr(D, f"export_{layout}_format")(frames, root)
    loaded = JD.open_dataset(layout, root, 5000.0)
    assert len(loaded) == len(frames), "frames lost"
    for i in (0, len(frames) - 1):
        fr, src = loaded[i], frames[i]
        m = src.depth > 0
        if layout == "tum":  # 8-bit PNG, depth x 5000
            assert np.abs(fr.rgb - src.rgb).max() < 2.5 / 255.0
            assert np.abs(fr.depth - src.depth)[m].max() < 1.5 / 5000.0
            np.testing.assert_allclose(fr.gt_T_cw, src.gt_T_cw, atol=1e-4)
        else:  # JPEG q98; depth x 6553.5 / millimeters
            assert np.abs(fr.rgb - src.rgb).mean() < 6.0 / 255.0
            tol = 1.5 / 6553.5 if layout == "replica" else 1.5e-3
            assert np.abs(fr.depth - src.depth)[m].max() < tol
            np.testing.assert_allclose(fr.gt_T_cw, src.gt_T_cw, atol=1e-5)
    # The same files: the port's exports decode to the JAX exports' frames.
    jroot = str(tmp_path / f"jax_{layout}")
    getattr(JD, f"export_{layout}_format")(frames, jroot)
    a, b = D.open_dataset(layout, root, 5000.0), D.open_dataset(layout, jroot, 5000.0)
    for i in range(len(frames)):
        np.testing.assert_array_equal(a[i].depth, b[i].depth)
        np.testing.assert_array_equal(a[i].rgb, b[i].rgb)
    # The images go through the same cv2 calls: the same bytes.
    sub = {"tum": "rgb", "replica": "results", "scannet": "color"}[layout]
    names = sorted(os.listdir(os.path.join(root, sub)))
    assert names == sorted(os.listdir(os.path.join(jroot, sub)))
    for name in names:
        with open(os.path.join(root, sub, name), "rb") as f, \
                open(os.path.join(jroot, sub, name), "rb") as g:
            assert f.read() == g.read(), name


def test_open_dataset_factors_and_unknown_type(frames, tmp_path):
    for layout in ("tum", "replica", "scannet"):
        D_root = str(tmp_path / layout)
        getattr(D, f"export_{layout}_format")(frames[:1], D_root)
        for factor in (5000.0, 1234.0):
            assert (D.open_dataset(layout, D_root, factor).depth_factor
                    == JD.open_dataset(layout, D_root, factor).depth_factor)
    assert D.open_dataset("Replica", str(tmp_path / "replica"), 5000.0).depth_factor == 6553.5
    assert D.open_dataset("scannet", str(tmp_path / "scannet"), 5000.0).depth_factor == 1000.0
    with pytest.raises(ValueError, match="unknown dataset type"):
        D.open_dataset("kitti", str(tmp_path), 5000.0)


def test_missing_groundtruth_and_nonfinite_scannet_pose(frames, tmp_path):
    tum = str(tmp_path / "tum")
    D.export_tum_format(frames, tum)
    os.remove(os.path.join(tum, "groundtruth.txt"))
    ds = D.TUMDataset(tum)
    assert ds.gt is None and ds[0].gt_T_cw is None and len(ds) == len(frames)

    scn = str(tmp_path / "scannet")
    D.export_scannet_format(frames, scn)
    bad = np.full((4, 4), np.inf)
    np.savetxt(os.path.join(scn, "pose", "1.txt"), bad)
    os.remove(os.path.join(scn, "pose", "2.txt"))
    ds, jds = D.ScanNetDataset(scn), JD.ScanNetDataset(scn)
    assert ds[1].gt_T_cw is None and jds[1].gt_T_cw is None
    assert ds[2].gt_T_cw is None and ds[0].gt_T_cw is not None


def test_images_without_a_codec_raise(frames, tmp_path, monkeypatch):
    rep = str(tmp_path / "replica")
    D.export_replica_format(frames[:1], rep)
    tum = str(tmp_path / "tum")
    D.export_tum_format(frames[:1], tum)
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    assert D.image_codec_name() is None
    for read in (D.ReplicaDataset(rep), D.TUMDataset(tum)):
        with pytest.raises(RuntimeError, match="cv2 or Pillow"):
            read[0]
    for export in (D.export_scannet_format, D.export_tum_format):
        with pytest.raises(RuntimeError, match="cv2 or Pillow"):
            export(frames[:1], str(tmp_path / "again"))


def test_tumlike_cache_reloads_bit_for_bit(tmp_path):
    kw = dict(n_frames=2, seed=3, width=64, height=48, apply_distortion=False,
              splat_spacing=0.1, device="cpu")
    a = D.TUMLikeDataset(cache_dir=str(tmp_path), **kw)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("tumlike_torch_") and name.endswith(".npz")
    b = D.TUMLikeDataset(cache_dir=str(tmp_path), **kw)
    assert os.listdir(tmp_path) == [name]
    assert b.cam == a.cam
    for i in range(2):
        np.testing.assert_array_equal(b[i].rgb, a[i].rgb)
        np.testing.assert_array_equal(b[i].depth, a[i].depth)
        np.testing.assert_array_equal(b[i].gt_T_cw, a[i].gt_T_cw)
        assert b[i].timestamp == a[i].timestamp
