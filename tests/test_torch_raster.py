"""The port's rasterizer reference path against the JAX package:
``preprocess`` (1e-5), ``bin_gaussians`` (exactly equal indices, counts and
n_dropped), ``render_tiled`` (2e-5), ``pack_raw_instances`` /
``preprocess_instances`` (1e-5), ``blend_packed`` / ``render_instances``
(2e-5), and the dense oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.transforms import pose_to_matrix as jpose_to_matrix
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render_tiled as jrender_tiled
from gsorb_slam_tpu.raster.instances import pack_raw_instances as jpack_raw
from gsorb_slam_tpu.raster.instances import blend_packed_xla as jblend_packed
from gsorb_slam_tpu.raster.instances import preprocess_instances as jpp_inst
from gsorb_slam_tpu.raster.instances import render_instances as jrender_instances
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render_naive
from gsorb_slam_tpu_torch.raster import render_tiled
from gsorb_slam_tpu_torch.raster.binning import TileBins
from gsorb_slam_tpu_torch.raster.instances import (
    blend_packed,
    pack_raw_instances,
    preprocess_instances,
    render_instances,
)

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=2.0)
POSE = (np.array([1.0, 0.01, -0.02, 0.015], np.float32), np.array([0.03, -0.02, 0.05], np.float32))


def _scene(rng, n=300, capacity=320):
    scene = random_cloud_scene(rng, n=n, capacity=capacity)
    return {k: np.array(v) for k, v in scene.items()}


def _pose():
    return np.array(jpose_to_matrix(jnp.asarray(POSE[0]), jnp.asarray(POSE[1])))


def _both_prep(scene, T):
    jc, tc = JCamera(**CAM_KW), Camera(**CAM_KW)
    keys = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
    jp = jpreprocess(*(jnp.asarray(scene[k]) for k in keys), jnp.asarray(T), jc)
    tp = preprocess(*(torch.as_tensor(scene[k]) for k in keys), torch.as_tensor(T), tc)
    return jp, tp


@pytest.mark.parametrize("posed", [False, True])
def test_preprocess_matches_jax(rng, posed):
    scene = _scene(rng)
    T = _pose() if posed else np.eye(4, dtype=np.float32)
    jp, tp = _both_prep(scene, T)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    v = np.asarray(jp.valid)
    for k in ("mean2d", "conic", "opacity", "color"):
        np.testing.assert_allclose(getattr(tp, k).numpy()[v], np.asarray(getattr(jp, k))[v],
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))


@pytest.mark.parametrize("capacity", [256, 32])
def test_bin_gaussians_exactly_equal(rng, capacity):
    """Same tile lists index for index; capacity 32 overflows tiles."""
    scene = _scene(rng)
    jp, tp = _both_prep(scene, _pose())
    kw = dict(CFG_KW, tile_capacity=capacity)
    jb = jbin(jp, JCamera(**CAM_KW), JRasterConfig(**kw))
    tb = bin_gaussians(tp, Camera(**CAM_KW), RasterConfig(**kw))
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert int(tb.n_dropped) == int(jb.n_dropped)
    assert (int(tb.n_dropped) > 0) == (capacity == 32)


def test_render_tiled_matches_jax(rng):
    scene = _scene(rng)
    jp, tp = _both_prep(scene, np.eye(4, dtype=np.float32))
    jcfg, tcfg = JRasterConfig(**CFG_KW), RasterConfig(**CFG_KW)
    jb = jbin(jp, JCamera(**CAM_KW), jcfg)
    tb = bin_gaussians(tp, Camera(**CAM_KW), tcfg)
    jo = jrender_tiled(jp, jb, JCamera(**CAM_KW), jcfg, bg=0.25)
    to = render_tiled(tp, tb, Camera(**CAM_KW), tcfg, bg=0.25)
    for k in ("color", "depth", "alpha", "final_t", "median_depth"):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                   atol=2e-5, err_msg=k)
    # ... and both agree with the port's dense oracle.
    no = render_naive(tp, Camera(**CAM_KW), bg=0.25, cfg=tcfg)
    for k in ("color", "alpha", "final_t"):
        np.testing.assert_allclose(getattr(to, k).numpy(), getattr(no, k).numpy(),
                                   atol=5e-5, err_msg=k)


def test_instances_match_jax(rng):
    scene = _scene(rng)
    jp, tp = _both_prep(scene, np.eye(4, dtype=np.float32))
    jb = jbin(jp, JCamera(**CAM_KW), JRasterConfig(**CFG_KW))
    keys = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
    jraw = jpack_raw(*(jnp.asarray(scene[k]) for k in keys), jb)
    tb = TileBins(indices=torch.as_tensor(np.array(jb.indices)),
                  counts=torch.as_tensor(np.array(jb.counts)),
                  n_dropped=torch.as_tensor(np.array(jb.n_dropped)))
    traw = pack_raw_instances(*(torch.as_tensor(scene[k]) for k in keys), tb)
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), atol=1e-5, rtol=1e-5)
    T = _pose()
    js = jpp_inst(jraw, jnp.asarray(T), JCamera(**CAM_KW), 1.1)
    ts = preprocess_instances(traw, torch.as_tensor(T), Camera(**CAM_KW), 1.1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)


def test_render_instances_matches_jax(rng):
    """The instance-space render at a pose (K2 then K3 on the card; their
    plain versions here) and the plain packed blend, against the JAX
    package's XLA path (CUDA-exact stop, which ``blend_packed_xla`` always
    uses)."""
    scene = _scene(rng)
    jp, _ = _both_prep(scene, np.eye(4, dtype=np.float32))
    jcfg = JRasterConfig(**CFG_KW, backend="xla")
    tcfg = RasterConfig(**CFG_KW)
    jc, tc = JCamera(**CAM_KW), Camera(**CAM_KW)
    jb = jbin(jp, jc, jcfg)
    keys = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
    jraw = jpack_raw(*(jnp.asarray(scene[k]) for k in keys), jb)
    T = _pose()
    jo = jrender_instances(jraw, jb.counts, jnp.asarray(T), jc, jcfg, bg=0.25,
                           scale_modifier=1.1)
    traw, tcounts = torch.as_tensor(np.array(jraw)), torch.as_tensor(np.array(jb.counts))
    to = render_instances(traw, tcounts, torch.as_tensor(T), tc, tcfg, bg=0.25,
                          scale_modifier=1.1)
    screen = preprocess_instances(traw, torch.as_tensor(T), tc, 1.1)
    po = blend_packed(screen, tcounts, tc, tcfg, bg=0.25)
    jpo = jblend_packed(jpp_inst(jraw, jnp.asarray(T), jc, 1.1), jb.counts, jc, jcfg, bg=0.25)
    assert float(jo.alpha.max()) > 0.5  # the view is not empty
    for k in ("color", "depth", "alpha", "final_t", "median_depth"):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(getattr(po, k).numpy(), np.asarray(getattr(jpo, k)),
                                   atol=2e-5, err_msg=k)
