"""The port's disk-sequence tools against the JAX package's, on the CPU at
64x48 over 3 frames: ``run_rgbd --type tum|replica|scannet`` against JAX
``run_rgbd`` with the mapping draws replayed (poses and both trajectory
files at ``tests/test_torch_system_parity.py``'s tolerances), ``eval_ate`` (to
1e-9), ``replay`` (PSNR within 0.05 dB), ``run_benchmark --frontend render
--no-distortion`` and ``run_benchmark`` with its defaults (ORB frontend,
TUM1's distortion) and ``--loop`` (their ``result.txt`` keys against the
JAX source's literal key set), ``run_rgbd --frontend orb`` and ``--vocab``,
and the raises of the TPU kernel layout flags."""

import ast
import dataclasses
import inspect
import json
import types

import jax
import numpy as np
import pytest
import torch

import gsorb_slam_tpu.core.config as JC
from gsorb_slam_tpu.apps import eval_ate as j_eval_ate
from gsorb_slam_tpu.apps import replay as j_replay
from gsorb_slam_tpu.apps import run_benchmark as j_run_benchmark
from gsorb_slam_tpu.apps import run_rgbd as j_run_rgbd
from gsorb_slam_tpu.eval import ate as JA
from gsorb_slam_tpu.eval import trajectory as JT
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu_torch.apps import eval_ate, replay, run_benchmark, run_rgbd
from gsorb_slam_tpu_torch.core import config as C
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.eval import ate as TA
from gsorb_slam_tpu_torch.eval import trajectory as TT
from gsorb_slam_tpu_torch.frontend import vocab as TV
from gsorb_slam_tpu_torch.slam import dataset as D
from gsorb_slam_tpu_torch.slam import system as S

torch.set_num_threads(1)

CAM = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CONFIG = {
    "Dataset": {"name": "disk", "type": "tum", "path": "unused"},
    "Camera": {**CAM, "fps": 10.0},
    "DepthMapFactor": 5000.0,
    "Mapping": {"numIters": 5, "maxGaussians": 16384},
    "Tracking": {"numIters": 10},
    "Evalution": {"enable": True, "savePly": True, "saveRootPath": "experiments"},
}
# tests/test_torch_system_parity.py's raster view.
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
# The JAX System's side: its default raster config blends in bf16.
JRASTER = dict(RASTER, blend_bf16=False, elem_bf16=False)
SEED = 0


def _with_init_iters(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=10))


@pytest.fixture
def small_systems(monkeypatch):
    """Both packages' Systems at the parity test's raster view and 10
    warm-up iterations (no config key holds them)."""
    jraster = dataclasses.replace(JS.System.default_raster_config(64), **JRASTER)
    traster = dataclasses.replace(S.System.default_raster_config(64), **RASTER)
    monkeypatch.setattr(JS.System, "default_raster_config", staticmethod(lambda w=320: jraster))
    monkeypatch.setattr(S.System, "default_raster_config", staticmethod(lambda w=320: traster))
    jload, tload = JC.load_config, C.load_config
    monkeypatch.setattr(JC, "load_config", lambda p: _with_init_iters(jload(p)))
    monkeypatch.setattr(C, "load_config", lambda p: _with_init_iters(tload(p)))


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The parity test's 3-frame sequence in the three layouts, and the
    config as a .json file."""
    root = tmp_path_factory.mktemp("disk")
    ds = D.SyntheticDataset(Camera(**CAM), n_frames=3, n_splats=400, motion_scale=0.2,
                            device="cpu")
    for layout in ("tum", "replica", "scannet"):
        getattr(D, f"export_{layout}_format")(ds, str(root / layout))
    (root / "cfg.json").write_text(json.dumps(CONFIG))
    return root


def _run(main, disk, layout, out, *extra):
    return main(["--config", str(disk / "cfg.json"), "--type", layout, "--dataset",
                 str(disk / layout), "--out", str(out), "--eval-stride", "1", "--cpu", *extra])


def _jax_draws(seed):
    """The JAX System's mapping draws: one key split per mapping call, one
    randint per iteration (slam/system.py:805,987)."""
    key = [jax.random.PRNGKey(seed)]

    def draws(self, n_iters, n_frames):
        key[0], sub = jax.random.split(key[0])
        keys = jax.random.split(sub, n_iters)
        return [int(jax.random.randint(k, (), 0, max(int(n_frames), 1))) for k in keys]

    return draws


def _rot_err(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def _assert_poses_close(mine, theirs):
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert float(np.abs(a[:3, 3] - b[:3, 3]).max()) < 1e-3
        assert _rot_err(a, b) < 1e-3


def _camera_trajectory(path, layout):
    """``CameraTrajectory.txt`` in the dataset's own format, as T_wc."""
    if layout == "tum":
        return [T for _, T in TT.load_tum(str(path))]
    return list(np.loadtxt(path).reshape(-1, 4, 4))


@pytest.mark.parametrize("layout", ["tum", "replica", "scannet"])
def test_run_rgbd_matches_jax(disk, tmp_path, small_systems, monkeypatch, layout):
    """Both packages' run_rgbd on each layout, the mapping draws replayed:
    the poses, both trajectory files and the result at the parity test's
    tolerances."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(S.System, "_mapping_draws", _jax_draws(SEED))
    assert _run(run_rgbd.main, disk, layout, tout) == 0
    assert _run(j_run_rgbd.main, disk, layout, jout) == 0
    for name in ("CameraTrajectory.txt", "CameraTrajectory_TUM.txt", "GaussianModel.ply",
                 "result.txt"):
        assert (tout / name).stat().st_size > 0, name
    tt = TT.load_tum(str(tout / "CameraTrajectory_TUM.txt"))
    jt = JT.load_tum(str(jout / "CameraTrajectory_TUM.txt"))
    assert [t for t, _ in tt] == [t for t, _ in jt]
    _assert_poses_close([T for _, T in tt], [T for _, T in jt])
    # The dataset's own trajectory file: the JAX file's layout and poses.
    mine = (tout / "CameraTrajectory.txt").read_text().splitlines()
    theirs = (jout / "CameraTrajectory.txt").read_text().splitlines()
    width = 8 if layout == "tum" else 16
    assert [len(x.split()) for x in mine] == [len(x.split()) for x in theirs] == [width] * 3
    if layout == "tum":
        assert [x.split()[0] for x in mine] == [x.split()[0] for x in theirs]
    _assert_poses_close(_camera_trajectory(tout / "CameraTrajectory.txt", layout),
                        _camera_trajectory(jout / "CameraTrajectory.txt", layout))
    tres = json.loads((tout / "result.txt").read_text().splitlines()[-1])
    jres = json.loads((jout / "result.txt").read_text().splitlines()[-1])
    assert tres["n_frames"] == jres["n_frames"] == 3
    assert tres["n_eval_frames"] == jres["n_eval_frames"] == 3
    assert tres["n_keyframes"] == jres["n_keyframes"]
    assert abs(tres["ate_rmse"] - jres["ate_rmse"]) < 1e-3 and tres["ate_rmse"] < 0.02
    assert tres["psnr"] > 15.0


def test_eval_ate_and_replay_match_jax(disk, tmp_path, small_systems, capsys):
    """eval_ate and replay of the port's TUM run, by both packages."""
    tout = tmp_path / "port"
    assert _run(run_rgbd.main, disk, "tum", tout) == 0
    tres = json.loads((tout / "result.txt").read_text().splitlines()[-1])
    tt = TT.load_tum(str(tout / "CameraTrajectory_TUM.txt"))

    # eval_ate on the exported ground truth and the port's trajectory.
    gt, est = str(disk / "tum" / "groundtruth.txt"), str(tout / "CameraTrajectory_TUM.txt")
    capsys.readouterr()
    assert eval_ate.main([gt, est]) == 0
    mine = capsys.readouterr().out
    assert j_eval_ate.main([gt, est]) == 0
    assert mine == capsys.readouterr().out
    rmse = float(mine.split("rmse ")[1].split()[0])
    g = TT.load_tum(gt)
    pairs = D.associate_timestamps(np.array([t for t, _ in tt]), np.array([t for t, _ in g]))
    e_t = TA.ate_rmse([tt[i][1] for i, _ in pairs], [g[j][1] for _, j in pairs])
    assert abs(rmse - e_t) <= 5e-7
    assert abs(e_t - float(JA.ate_rmse([tt[i][1] for i, _ in pairs],
                                       [g[j][1] for _, j in pairs]))) < 1e-9
    assert abs(rmse - tres["ate_rmse"]) < 1e-5

    # replay of the port's PLY along its trajectory, by both packages.
    argv = ["--ply", str(tout / "GaussianModel.ply"), "--traj", est, "--config",
            str(disk / "cfg.json"), "--dataset", str(disk / "tum"), "--type", "tum",
            "--stride", "1"]
    capsys.readouterr()
    assert replay.main(argv + ["--cpu", "--lpips"]) == 0
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j_replay.main(argv + ["--lpips"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine["frames"] == theirs["frames"] == 3
    assert abs(mine["psnr"] - theirs["psnr"]) < 0.05 and mine["psnr"] > 15.0
    assert abs(mine["ssim"] - theirs["ssim"]) < 1e-3
    assert abs(mine["depth_l1"] - theirs["depth_l1"]) < 1e-3
    assert mine["lpips"] is None and mine["lpips_note"] == theirs["lpips_note"]


def _jax_result_keys() -> set:
    """The keys the JAX run_benchmark writes: its literal ``result`` keys and
    its System's ``bin_*`` truncation keys (no ``phase_*`` keys without the
    ORB frontend)."""
    tree = ast.parse(inspect.getsource(j_run_benchmark))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "result" and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and isinstance(node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "result" \
                and isinstance(node.targets[0].slice, ast.Constant):
            keys.add(node.targets[0].slice.value)
    keys.discard("trunc_weight_dropped_frac")  # set twice (the error branch too)
    keys.add("trunc_weight_dropped_frac")
    bins = JS.System._bin_truncation_stats(types.SimpleNamespace(_bin_stats=[]))
    return keys | set(bins)


def test_run_benchmark_render_no_distortion(tmp_path, small_systems):
    out = tmp_path / "bench"
    argv = ["--frames", "3", "--width", "64", "--height", "48", "--track-iters", "10",
            "--map-iters", "5", "--max-gaussians", "16384", "--cache", str(tmp_path / "cache"),
            "--out", str(out), "--cpu"]
    res = run_benchmark.main(argv + ["--frontend", "render", "--no-distortion"])
    line = json.loads((out / "result.txt").read_text().splitlines()[-1])
    assert set(line) == _jax_result_keys() == set(res)
    assert line["backend"] == "cpu" and line["frontend"] == "render"
    assert line["distortion"] is False and line["frames"] == 3
    assert np.isfinite(line["ate_rmse_m"]) and np.isfinite(line["psnr_db"])
    assert line["trunc_oracle_dropped"] == 0
    assert len((out / "frames.jsonl").read_text().splitlines()) == 3
    assert len(TT.load_tum(str(out / "CameraTrajectory.txt"))) == 3



def _record_systems(monkeypatch) -> list:
    """Every System the apps make from here on is appended to the list."""
    made = []
    base = S.System

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(S, "System", Recorded)
    return made


def test_run_benchmark_defaults_orb_distortion_loop(tmp_path, small_systems, monkeypatch):
    """``run_benchmark`` with the JAX package's defaults (the ORB frontend,
    TUM1's distortion warped into the sequence) and ``--loop``."""
    out = tmp_path / "bench"
    made = _record_systems(monkeypatch)
    argv = ["--frames", "3", "--width", "64", "--height", "48", "--track-iters", "10",
            "--map-iters", "5", "--max-gaussians", "16384", "--cache", str(tmp_path / "cache"),
            "--out", str(out), "--cpu", "--loop"]
    res = run_benchmark.main(argv)
    line = json.loads((out / "result.txt").read_text().splitlines()[-1])
    phases = {k for k in line if k.startswith("phase_")}
    assert phases and "phase_fe.total" in phases
    assert set(line) == _jax_result_keys() | phases == set(res)
    assert line["frontend"] == "orb" and line["distortion"] is True and line["frames"] == 3
    assert np.isfinite(line["ate_rmse_m"]) and np.isfinite(line["psnr_db"])
    assert line["loop_events"] == 0
    (sys_,) = made
    assert sys_.fe is not None and sys_.loop_closer is not None
    assert not sys_.fe.dist.is_zero() and sys_.cfg.camera.k1 == D.TUMLikeDataset.DIST[0]


def test_run_rgbd_orb_and_vocab_raise(disk, tmp_path, small_systems, monkeypatch):
    """``run_rgbd --frontend orb`` on the tiny TUM layout, with the packaged
    vocabulary and with ``--vocab`` (a copy of it read from its file): both
    run to the end and write the trajectory and the result."""
    made = _record_systems(monkeypatch)

    for i, extra in enumerate((["--frontend", "orb"],
                               ["--frontend", "orb", "--vocab", TV.DEFAULT_VOCABULARY_PATH])):
        out = tmp_path / f"out{i}"
        assert _run(run_rgbd.main, disk, "tum", out, *extra) == 0
        assert len(TT.load_tum(str(out / "CameraTrajectory_TUM.txt"))) == 3
        res = json.loads((out / "result.txt").read_text().splitlines()[-1])
        assert res["n_frames"] == 3 and np.isfinite(res["ate_rmse"])
        assert any(k.startswith("phase_") for k in res)
        sys_ = made[-1]
        assert sys_.frontend_mode == "orb" and sys_.loop_closer is not None
        assert sys_.timings["frontend"] > 0
    voc_default, voc_file = (m.loop_closer.db.vocab for m in made)
    assert voc_file is not voc_default
    np.testing.assert_array_equal(voc_file.node_desc, voc_default.node_desc)


@pytest.mark.parametrize("flag", ["--blend-bf16", "--elem-bf16", "--no-elem-bf16",
                                  "--no-preprocess-pallas"])
def test_run_benchmark_tpu_layout_flags_raise(tmp_path, flag):
    """The JAX flags that pick a TPU kernel layout raise rather than run the
    port's float32 kernels under their label."""
    with pytest.raises(NotImplementedError, match=flag):
        run_benchmark.main(["--frontend", "render", "--no-distortion", "--cpu", "--out",
                            str(tmp_path / "bench"), flag])
    assert not (tmp_path / "bench").exists()
