"""The slice end to end: the port's ``track_frame`` (plain versions on the
CPU) against the JAX package's ``track_frame`` on its Pallas path
(``backend="pallas"``, ``exact_stop=False``; interpret mode on the CPU), on
the same map, gt and initial pose, over 10 iterations with one rebin.
Tolerances: pose 1e-4 abs, loss 2e-3 rel.

Also: the masked-sum L1 tracking loss against the JAX one (1e-6 rel), and
the port imports neither ``jax`` nor ``gsorb_slam_tpu``."""

import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gsorb_slam_tpu_torch
from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import TrackingConfig as JTrackingConfig
from gsorb_slam_tpu.core.transforms import pose_to_matrix as jpose_to_matrix
from gsorb_slam_tpu.ops.losses import l1_tracking as jl1_tracking
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import render
from gsorb_slam_tpu.slam.tracking import FeatureMatches as JFeatureMatches
from gsorb_slam_tpu.slam.tracking import track_frame as jtrack_frame
from gsorb_slam_tpu.splat.gaussians import empty_map as jempty_map
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy
from gsorb_slam_tpu_torch.ops.losses import l1_tracking
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches, track_frame

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=4.0,
              exact_stop=False)
ITERS, REBIN = 10, (5,)


def test_track_frame_matches_jax(rng):
    scene = random_cloud_scene(rng, n=500, capacity=512, spread=1.6)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 6.0)
    jgm = jempty_map(512)
    jgm = jgm.__class__(**{**jgm.__dict__, **scene, "count": jnp.asarray(500, jnp.int32)})
    jc = JCamera(**CAM_KW)
    keys = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
    out = render(*(scene[k] for k in keys), jnp.eye(4), jc, JRasterConfig(**CFG_KW))
    gt_color = out.color
    gt_depth = jnp.where(out.alpha > 0.5, out.median_depth, 0.0)
    T_init = jpose_to_matrix(jnp.array([1.0, 0.004, -0.003, 0.005]),
                             jnp.array([0.015, -0.01, 0.012]))

    jcfg = JRasterConfig(**CFG_KW, backend="pallas")
    jres = jax.jit(lambda: jtrack_frame(
        jgm, T_init, gt_color, gt_depth, JFeatureMatches.empty(), jc,
        JTrackingConfig(num_iters=ITERS, early_stop_delta=0.0), jcfg,
        rebin_iters=REBIN,
    ))()

    d = {f: np.asarray(getattr(jgm, f)) for f in (*keys, "count", "max_z", "scene_radius")}
    tgm = gaussian_map_from_numpy(d, device="cpu")
    tres = track_frame(
        tgm, torch.as_tensor(np.array(T_init)), torch.as_tensor(np.array(gt_color)),
        torch.as_tensor(np.array(gt_depth)), FeatureMatches.empty(device="cpu"),
        Camera(**CAM_KW), TrackingConfig(num_iters=ITERS, early_stop_delta=0.0),
        RasterConfig(**CFG_KW), rebin_iters=REBIN,
    )
    assert int(tres.n_iters) == int(jres.n_iters) == ITERS
    T_j = np.asarray(jres.T_cw)
    np.testing.assert_allclose(tres.T_cw.numpy(), T_j, atol=1e-4)
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=2e-3)
    # ... and the run made progress from the initial pose.
    err0 = np.abs(np.asarray(T_init) - np.eye(4)).max()
    assert np.abs(T_j - np.eye(4)).max() < err0


def test_l1_tracking_matches_jax(rng):
    pred = rng.uniform(size=(12, 16, 3)).astype(np.float32)
    target = rng.uniform(size=(12, 16, 3)).astype(np.float32)
    mask = rng.uniform(size=(12, 16)) < 0.6
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.as_tensor(m)
        np.testing.assert_allclose(
            float(l1_tracking(torch.as_tensor(pred), torch.as_tensor(target), tm)),
            float(jl1_tracking(jnp.asarray(pred), jnp.asarray(target), jm)), rtol=1e-6)


def test_port_imports_no_jax():
    """Every module of the port (``parallel/`` included), and chip_smoke.py,
    imports without jax or
    the JAX package, and without PyYAML or OpenCV (the machine with the card
    has neither)."""
    names = [m.name for m in pkgutil.walk_packages(
        gsorb_slam_tpu_torch.__path__, "gsorb_slam_tpu_torch.")]
    assert "gsorb_slam_tpu_torch.slam.tracking" in names
    assert {"gsorb_slam_tpu_torch.parallel.mesh", "gsorb_slam_tpu_torch.parallel.tracking"} <= set(
        names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gsorb_slam_tpu' or m.startswith('gsorb_slam_tpu.')"
        " or m in ('yaml', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
