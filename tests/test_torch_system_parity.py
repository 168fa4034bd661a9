"""The port's System against the JAX package's over the same 3-frame
sequence on the CPU (JAX on its Pallas path, interpret mode): frame 0's
seeded and warmed-up map, then two tracked and mapped frames.

The mapping iterations' frame draws of the port's System are replaced by
the JAX System's (its key splits, replayed here), so both pick the same
window frames; the numpy draws (reference points, window fill) come from
the same seed on both sides. Tolerances: each frame's pose within 1 mm and
1 mrad, equal keyframe flags and mapping windows, densify add counts within
1% (Adam's eps of 1e-15 turns a gradient at rounding level into a full step,
so the maps drift apart by rounding, not by design).
"""

import dataclasses

import jax
import numpy as np
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import load_config as jload_config
from gsorb_slam_tpu.slam import dataset as JD
from gsorb_slam_tpu.slam import system as JS
from gsorb_slam_tpu.slam import window as JW
from gsorb_slam_tpu_torch.interop import system_config_from_dict
from gsorb_slam_tpu_torch.slam import system as S
from gsorb_slam_tpu_torch.slam import window as W

torch.set_num_threads(1)

CONFIG = {
    "Camera": {"width": 64, "height": 48, "fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0,
               "fps": 10.0},
    "Mapping": {"numIters": 5, "maxGaussians": 16384},
    "Tracking": {"numIters": 10},
}
RASTER = dict(chunk=64, tile_capacity=256, track_tile_capacity=128)
# The JAX System's side: its default raster config blends in bf16.
JRASTER = dict(RASTER, blend_bf16=False, elem_bf16=False)
SEED = 0


def _config(cfg):
    return cfg.replace(mapping=dataclasses.replace(cfg.mapping, init_iters=10))


def _rot_err(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def _record_windows(monkeypatch, module, out):
    select = module.select_window

    def record(*a, **kw):
        sel = select(*a, **kw)
        out.append(list(sel.kf_ids))
        return sel

    monkeypatch.setattr(module, "select_window", record)


def test_system_matches_jax(monkeypatch):
    ds = JD.SyntheticDataset(JCamera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48),
                             n_frames=3, n_splats=400, motion_scale=0.2)
    jwin, twin = [], []
    _record_windows(monkeypatch, JW, jwin)
    _record_windows(monkeypatch, W, twin)

    jsys = JS.System(_config(jload_config(CONFIG)), seed=SEED, raster=dataclasses.replace(
        JS.System.default_raster_config(64), backend="pallas", **JRASTER))
    tsys = S.System(_config(system_config_from_dict(CONFIG)), seed=SEED, device="cpu",
                    raster=dataclasses.replace(S.System.default_raster_config(64), **RASTER))
    key = [jax.random.PRNGKey(SEED)]

    def jax_draws(n_iters, n_frames):
        """The JAX System's draws: one key split per mapping call, one
        randint per iteration (slam/system.py:805,987, mapping.py:285,337)."""
        key[0], sub = jax.random.split(key[0])
        keys = jax.random.split(sub, n_iters)
        return [int(jax.random.randint(k, (), 0, max(int(n_frames), 1))) for k in keys]

    monkeypatch.setattr(tsys, "_mapping_draws", jax_draws)

    for fr in ds:
        T_j = jsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        T_t = tsys.track_rgbd(fr.rgb, fr.depth, fr.timestamp)
        assert np.isfinite(T_t).all()
        assert float(np.abs(T_t[:3, 3] - T_j[:3, 3]).max()) < 1e-3
        assert _rot_err(T_t, T_j) < 1e-3
    assert [r.is_keyframe for r in tsys.trajectory] == [r.is_keyframe for r in jsys.trajectory]
    assert [r.track_iters for r in tsys.trajectory] == [r.track_iters for r in jsys.trajectory]
    assert twin == jwin and len(twin) == 2
    assert [(k.kf_id, k.frame_id) for k in tsys.keyframes] == [
        (k.kf_id, k.frame_id) for k in jsys.keyframes]
    np.testing.assert_allclose(tsys.densify_added, jsys.densify_added, rtol=1e-2, atol=1)
    # The trajectory tracks the sequence's motion.
    for rec, fr in zip(tsys.trajectory, ds):
        assert float(np.abs(rec.T_cw[:3, 3] - fr.gt_T_cw[:3, 3]).max()) < 0.02
    s = tsys.shutdown_summary()
    assert s["n_frames"] == 3 and s["n_keyframes"] == len(jsys.keyframes)
    assert s["compile_s"] == 0.0  # nothing is built on the CPU
