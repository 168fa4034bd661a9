"""The port's tools against the JAX package's, on the CPU.

- ``frontend.vocab.build_vocabulary`` element for element equal to the JAX
  function (``children``, ``node_desc``, ``word_id``, ``weights``,
  ``n_words``) for three (k, L, seed, iters) settings, one of them
  ``train_vocab``'s (9, 3, 0, 6), from ``uint32`` words, ``int32`` words and
  an ``int32`` tensor alike; ``_pack_bits(_unpack_bits(x)) == x``.
- ``scripts.train_vocab``'s training images equal to
  ``scripts/train_vocab.py``'s (the script loaded by path); the tool over 2
  of them on the CPU writes the vocabulary trained on their descriptors
  (the extraction itself is held to the JAX package's in
  ``tests/test_torch_orb.py``).
- ``core.transforms.quat_multiply`` and ``raster.preprocess.covariance_3d``
  within 1e-6 of the JAX functions; ``frontend.native``'s
  ``associate_timestamps_native`` equal to the JAX binding's pairs.
- ``scripts.pose2traj``'s ``groundtruth.txt`` byte for byte the JAX
  script's; ``scripts.make_tum_disk``'s three layouts: the same files, the
  same text (poses within 1e-6), images within 2 levels of their 8-bit
  colour or 16-bit depth (the two packages' renders differ by rounding).
- The shell drivers, run with a stub ``python`` on ``PATH`` that records its
  arguments: the JAX drivers' calls with the module name swapped.
- ``scripts.debug_loop``: the JAX script's trajectory and drift exactly
  (its ``main``, 16 ORB System frames, runs on the card in
  ``chip_smoke.py`` phase 34; ``verify(debug=True)``'s lines are held to
  the JAX method's in ``tests/test_torch_vocab_loop.py``).
"""

import importlib.util
import os
import shutil
import subprocess

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.transforms import quat_multiply as jquat_multiply
from gsorb_slam_tpu.frontend import vocab as JV
from gsorb_slam_tpu.frontend.native import associate_timestamps_native as jassociate
from gsorb_slam_tpu.frontend.native import have_native
from gsorb_slam_tpu.raster.preprocess import covariance_3d as jcovariance_3d
from gsorb_slam_tpu_torch.core.transforms import quat_multiply
from gsorb_slam_tpu_torch.frontend import vocab as TV
from gsorb_slam_tpu_torch.frontend.native import associate_timestamps_native
from gsorb_slam_tpu_torch.raster.preprocess import covariance_3d
from gsorb_slam_tpu_torch.scripts import debug_loop, make_tum_disk, pose2traj, train_vocab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(REPO, "gsorb_slam_tpu_torch", "scripts")


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _descriptors(rng, n):
    """Random words around 12 centres (flipped bits), so the tree has
    structure to find."""
    centres = rng.integers(0, 2**32, (12, 8), dtype=np.uint64).astype(np.uint32)
    d = centres[rng.integers(0, 12, n)]
    flips = (rng.uniform(size=(n, 8, 32)) < 0.1).astype(np.uint64)
    mask = (flips << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return d ^ mask


def _assert_vocab_equal(a, b):
    for f in ("children", "node_desc", "word_id", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)


@pytest.mark.parametrize("k,L,seed,iters,n", [(9, 3, 0, 6, 3000), (6, 3, 1, 4, 2000),
                                              (4, 2, 5, 3, 600)])
def test_build_vocabulary_matches_jax(k, L, seed, iters, n):
    d = _descriptors(np.random.default_rng(seed + 100), n)
    ref = JV.build_vocabulary(d, k=k, L=L, seed=seed, iters=iters)
    assert ref.n_words > k
    for given in (d, d.view(np.int32), torch.as_tensor(d.view(np.int32))):
        _assert_vocab_equal(TV.build_vocabulary(given, k=k, L=L, seed=seed, iters=iters), ref)


def test_pack_unpack_bits_round_trip(rng):
    d = rng.integers(0, 2**32, (50, 8), dtype=np.uint64).astype(np.uint32)
    bits = TV._unpack_bits(d)
    np.testing.assert_array_equal(bits, JV._unpack_bits(d))
    np.testing.assert_array_equal(TV._pack_bits(bits), d)
    assert TV._pack_bits(bits).dtype == np.uint32


def test_train_vocab_images_match_the_script():
    script = _load_script("train_vocab")
    rng = np.random.default_rng(7)
    theirs = [script.textured(rng) if i % 2 == 0 else script.speckle(rng) for i in range(6)]
    for a, b in zip(train_vocab.training_images(6), theirs):
        np.testing.assert_array_equal(a, b)
    assert len(train_vocab.training_images()) == 40


def test_train_vocab_tool_on_the_cpu(tmp_path, monkeypatch):
    out = str(tmp_path / "voc.txt")
    monkeypatch.setattr(train_vocab, "N_IMAGES", 2)
    assert train_vocab.main(["--cpu", "--out", out]) == 0
    D, voc = train_vocab.train(train_vocab.training_images(2), "cpu", verbose=False)
    assert D.dtype == np.uint32 and D.shape == (1000, 8) and voc.n_words > 9
    direct = str(tmp_path / "direct.txt")
    TV.save_orbvoc_text(voc, direct)
    _assert_vocab_equal(TV.load_orbvoc_text(out), TV.load_orbvoc_text(direct))
    assert open(out).read() == open(direct).read()


def test_quat_multiply_matches_jax(rng):
    a = rng.normal(size=(3, 1, 4)).astype(np.float32)
    b = rng.normal(size=(1, 5, 4)).astype(np.float32)
    got = quat_multiply(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jquat_multiply(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    e = np.array([1.0, 0, 0, 0], np.float32)
    np.testing.assert_array_equal(quat_multiply(torch.as_tensor(e), torch.as_tensor(a[0, 0])),
                                  a[0, 0])


def test_covariance_3d_matches_jax(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    ls = rng.uniform(-4, -1, (50, 3)).astype(np.float32)
    got = covariance_3d(torch.as_tensor(q), torch.as_tensor(ls), 1.3).numpy()
    np.testing.assert_allclose(got, np.asarray(jcovariance_3d(jnp.asarray(q), jnp.asarray(ls),
                                                              1.3)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, got.transpose(0, 2, 1))


def test_associate_timestamps_native_matches_jax(rng):
    assert have_native()  # else the JAX binding falls back to Python
    a = np.sort(rng.uniform(0, 50, 200))
    b = np.sort(rng.uniform(0, 50, 190))
    for max_dt in (0.02, 0.05):
        pairs = associate_timestamps_native(a, b, max_dt)
        assert pairs == jassociate(a, b, max_dt) and len(pairs) > 10
        assert all(abs(a[i] - b[j]) < max_dt for i, j in pairs)


def test_pose2traj_matches_the_script(rng, tmp_path):
    script = _load_script("pose2traj")
    scene = tmp_path / "scene"
    (scene / "pose").mkdir(parents=True)
    for i in (0, 1, 2, 10, 11):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if i == 2:
            T[:] = -np.inf  # ScanNet's mark of an untracked frame
        np.savetxt(scene / "pose" / f"{i}.txt", T)
    jscene = tmp_path / "jscene"
    shutil.copytree(scene, jscene)
    assert pose2traj.convert_scene(str(scene)) == script.convert_scene(str(jscene)) == 4
    assert ((scene / "groundtruth.txt").read_bytes()
            == (jscene / "groundtruth.txt").read_bytes())
    assert pose2traj.main([]) == script.main([]) == 2
    with pytest.raises(FileNotFoundError):
        pose2traj.convert_scene(str(tmp_path))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("layout", ["tum", "replica", "scannet"])
def test_make_tum_disk_matches_the_script(tmp_path, layout):
    script = _load_script("make_tum_disk")
    args = ["--kind", "synthetic", "--frames", "2", "--width", "64", "--height", "48",
            "--format", layout]
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert make_tum_disk.main(args + ["--out", mine, "--cpu"]) == 0
    assert script.main(args + ["--out", theirs]) == 0
    names = _files(mine)
    assert names == _files(theirs) and len(names) >= 5
    for name in names:
        a, b = os.path.join(mine, name), os.path.join(theirs, name)
        if name.endswith(".txt"):
            la, lb = open(a).read().splitlines(), open(b).read().splitlines()
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                if x.startswith("#"):
                    assert x == y
                    continue
                xa, ya = x.split(), y.split()
                assert [v for v in xa if not _num(v)] == [v for v in ya if not _num(v)]
                np.testing.assert_allclose([float(v) for v in xa if _num(v)],
                                           [float(v) for v in ya if _num(v)], rtol=0, atol=1e-6)
        else:
            ia, ib = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert ia.shape == ib.shape and ia.dtype == ib.dtype
            # 8-bit colour levels, or quanta of the layout's 16-bit depth
            assert np.abs(ia.astype(np.int64) - ib.astype(np.int64)).max() <= 2, name


def _num(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return True


def _run_driver(tmp_path, script: str, tag: str) -> list[str]:
    """Run ``script`` with a stub ``python`` that logs its arguments; the
    calls it made, one line each."""
    stub = tmp_path / f"bin_{tag}"
    stub.mkdir()
    log = tmp_path / f"{tag}.log"
    (stub / "python").write_text('#!/bin/sh\n'
                                 'for a in "$@"; do printf "%s|" "$a"; done >> "$STUB_LOG"\n'
                                 'echo >> "$STUB_LOG"\n')
    (stub / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{stub}:{os.environ['PATH']}", STUB_LOG=str(log), ROUNDS="2",
               DATA_ROOT="/data/root")
    res = subprocess.run(["bash", script, "--max-frames", "3"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return log.read_text().splitlines()


@pytest.mark.parametrize("name", ["run.sh", "run_tum.sh", "run_replica.sh", "run_scannet.sh"])
def test_shell_drivers_call_the_port(tmp_path, name):
    theirs = _run_driver(tmp_path, os.path.join("scripts", name), "jax")
    mine = _run_driver(tmp_path, os.path.join(PORT_SCRIPTS, name), "port")
    assert mine == [c.replace("gsorb_slam_tpu.apps.", "gsorb_slam_tpu_torch.apps.")
                    for c in theirs]
    assert all("-m|gsorb_slam_tpu_torch.apps.run_rgbd|" in c for c in mine)
    assert len(mine) == {"run.sh": 34, "run_tum.sh": 6, "run_replica.sh": 16,
                         "run_scannet.sh": 12}[name]
    assert all(c.endswith("--max-frames|3|") for c in mine)


def test_debug_loop_scene_matches_the_script():
    script = _load_script("debug_loop")
    for a, b in zip(debug_loop.trajectory(), script.trajectory(), strict=True):
        np.testing.assert_array_equal(a, b)
    for i in (0, 7, 15):
        np.testing.assert_array_equal(debug_loop.drift(i), script.drift(i))
