"""The per-tile blend's backward (K6's plain version, the differentiated
render, the deterministic per-tile pack backward) against the JAX package,
on the CPU. The JAX side runs its Pallas kernels in interpret mode
(``_blend_vjp_bwd`` through ``jax.vjp`` of ``blend_and_untile``, and
``render`` with ``backend="pallas"``).

Scene: ``tests/scenes.py``'s tiny camera (64x48), capacity 256, chunk 128,
a non-zero background. Inputs are made from a seed with numpy and fed to
both packages. Tolerances: per-instance gradient rows within
``2e-5 max(scale, 1)`` abs + 1e-3 rel (``tests/test_pallas.py``'s), with the
pixels where an alpha sits at the 1/255 gate or the 0.99 clamp within
rounding left out; parameter and pose gradients within 1e-3 of their
largest entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render as jrender
from gsorb_slam_tpu.raster.instances import pack_raw_instances as jpack_raw
from gsorb_slam_tpu.raster.instances import render_instances as jrender_instances
from gsorb_slam_tpu.raster.pallas_raster import _pack_instances as jpack_instances
from gsorb_slam_tpu.raster.pallas_raster import blend_and_untile as jblend_and_untile
from gsorb_slam_tpu.raster.types import RenderOutput as JRenderOutput
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess, render
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    attr_cols,
    blend,
    blend_backward,
    blend_backward_plain,
    pack_instances,
    render_output_from_tiles,
    tile_cotangent_without_gate_edges,
    untile,
)
from gsorb_slam_tpu_torch.raster.instances import render_instances
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene, tiny_camera

torch.set_num_threads(1)

CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=128)
BG = 0.3
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
PARAMS = KEYS[:5]


def _cam():
    jc = tiny_camera()
    return jc, Camera(fx=jc.fx, fy=jc.fy, cx=jc.cx, cy=jc.cy, width=jc.width, height=jc.height)


def _scene(seed=0, n=200, opacity=None):
    scene = random_cloud_scene(np.random.default_rng(seed), n=n, capacity=256)
    if opacity is not None:
        scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], opacity)
    return scene


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _cotangents(seed, h, w):
    rng = np.random.default_rng(seed)
    return dict(color=rng.normal(size=(h, w, 3)), depth=rng.normal(size=(h, w)),
                alpha=rng.normal(size=(h, w)), final_t=rng.normal(size=(h, w)))


def _close(a, b, atol_scale=2e-5, rtol=1e-3):
    scale = max(float(np.abs(b).max()), 1e-8)
    np.testing.assert_allclose(a, b, atol=atol_scale * max(scale, 1.0), rtol=rtol)


@pytest.mark.parametrize("exact", [False, True])
def test_blend_backward_plain_matches_jax_vjp(exact):
    """K6's plain version against the TPU kernel's VJP (``_blend_vjp_bwd``)
    under a random cotangent of color, depth, alpha and the final T."""
    jc, cam = _cam()
    jcfg = JRasterConfig(**CFG_KW, exact_stop=exact)
    cfg = RasterConfig(**CFG_KW, exact_stop=exact)
    scene = _scene(opacity=5.0 if exact else None)
    jprep = jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc)
    jbins = jbin(jprep, jc, jcfg)
    jpacked = jpack_instances(jprep, jbins)
    packed = _t(jpacked)
    counts = _t(jbins.counts, torch.int32)

    # Image cotangents, zero at the gate-edge pixels; the port's tile-layout
    # cotangent follows from them through its own untiling (the final-T row
    # gathers bg times the color cotangent).
    n_tiles, px = packed.shape[0], cfg.tile * cfg.tile
    keep, n_edge = tile_cotangent_without_gate_edges(packed, torch.ones(n_tiles, 8, px), cam, cfg)
    keep_img = untile(keep[:, 0], cam, cfg).numpy()
    cot = {k: (v * (keep_img[..., None] if v.ndim == 3 else keep_img)).astype(np.float32)
           for k, v in _cotangents(1, cam.height, cam.width).items()}
    out_t = torch.zeros((n_tiles, 8, px), requires_grad=True)
    ro = render_output_from_tiles(out_t, cam, cfg, BG, torch.zeros(n_tiles))
    (g_out,) = torch.autograd.grad(sum((getattr(ro, k) * _t(v)).sum() for k, v in cot.items()),
                                   out_t)
    grads = blend_backward_plain(packed, counts, g_out, cam, cfg)
    # On CPU tensors the wrapper takes the plain version.
    assert torch.equal(blend_backward(packed, counts, None, None, None, g_out, cam, cfg),
                       grads)

    out, vjp = jax.vjp(lambda p: jblend_and_untile(p, jbins.counts, jc, jcfg, BG, True), jpacked)
    (d_j,) = vjp(JRenderOutput(
        color=jnp.asarray(cot["color"]), depth=jnp.asarray(cot["depth"]),
        alpha=jnp.asarray(cot["alpha"]), median_depth=jnp.zeros_like(out.median_depth),
        final_t=jnp.asarray(cot["final_t"]), radii=jnp.zeros_like(out.radii)))
    d_j = np.asarray(d_j)
    assert n_edge < n_tiles * px // 10
    assert np.abs(d_j).max() > 0 and not grads[:, 10:].any()
    _close(grads.numpy(), d_j)


def test_render_gradients_match_jax_pallas():
    """The port's differentiated ``render`` against JAX ``render`` on its
    Pallas path, on ``tests/test_pallas.py``'s loss (with a background)."""
    jc, cam = _cam()
    scene = _scene(seed=2)
    rng = np.random.default_rng(3)
    target = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    tdep = rng.uniform(1, 3, size=(48, 64)).astype(np.float32)

    def loss(out, mean, absf):
        return (mean(absf(out.color - target)) + 0.3 * mean(absf(out.depth - tdep))
                + 0.1 * mean(out.alpha) + 0.05 * mean(out.final_t ** 2))

    jcfg = JRasterConfig(**CFG_KW, backend="pallas")
    jgrads = jax.grad(lambda p: loss(
        jrender(*(p[k] for k in PARAMS), scene["active"], jnp.eye(4), jc, jcfg, bg=BG),
        jnp.mean, jnp.abs))({k: scene[k] for k in PARAMS})

    ps = {k: _t(scene[k]).requires_grad_(True) for k in PARAMS}
    out = render(*(ps[k] for k in PARAMS), _t(scene["active"]), torch.eye(4), cam,
                 RasterConfig(**CFG_KW), bg=BG)
    tgt, td = torch.as_tensor(target), torch.as_tensor(tdep)
    l_t = ((out.color - tgt).abs().mean() + 0.3 * (out.depth - td).abs().mean()
           + 0.1 * out.alpha.mean() + 0.05 * (out.final_t ** 2).mean())
    grads = torch.autograd.grad(l_t, [ps[k] for k in PARAMS])
    for k, g in zip(PARAMS, grads):
        ref = np.asarray(jgrads[k])
        assert np.abs(ref).max() > 0, k
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-3, (k, err)


def test_render_instances_pose_gradient_matches_jax():
    """``render_instances``' gradient w.r.t. the pose matrix against the JAX
    package's (its Pallas blend in interpret mode)."""
    jc, cam = _cam()
    scene = _scene(seed=4, n=250)
    jcfg = JRasterConfig(**CFG_KW, backend="pallas")
    jbins = jbin(jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc), jc, jcfg)
    jraw = jpack_raw(*(scene[k] for k in KEYS), jbins)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = (0.01, -0.008, 0.005)
    rng = np.random.default_rng(5)
    w_c = rng.normal(size=(48, 64, 3)).astype(np.float32)
    w_d = rng.normal(size=(48, 64)).astype(np.float32)

    def jloss(T):
        o = jrender_instances(jraw, jbins.counts, T, jc, jcfg, BG, True)
        return jnp.sum(o.color * w_c) + jnp.sum(o.depth * w_d)

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(T0)))
    T = torch.as_tensor(T0).requires_grad_(True)
    o = render_instances(_t(jraw), _t(jbins.counts, torch.int32), T, cam, RasterConfig(**CFG_KW),
                         BG)
    (g_t,) = torch.autograd.grad((o.color * torch.as_tensor(w_c)).sum()
                                 + (o.depth * torch.as_tensor(w_d)).sum(), T)
    assert np.abs(g_j[:3]).max() > 0
    err = np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max()
    assert err < 1e-3, err


def test_median_carries_no_gradient():
    """A cotangent on the median row alone moves nothing, through K6's plain
    version and through the differentiable blend."""
    _, cam = _cam()
    cfg = RasterConfig(**CFG_KW)
    scene = {k: _t(v) for k, v in _scene(seed=6).items()}
    prep = preprocess(*(scene[k] for k in KEYS), torch.eye(4), cam)
    bins = bin_gaussians(prep, cam, cfg)
    packed = pack_instances(prep, bins)
    g = torch.zeros((packed.shape[0], 8, cfg.tile * cfg.tile))
    g[:, 5] = torch.randn(g[:, 5].shape, generator=torch.Generator().manual_seed(0))
    assert not blend_backward_plain(packed, bins.counts, g, cam, cfg).any()
    x = packed.clone().requires_grad_(True)
    (d,) = torch.autograd.grad(blend(x, bins.counts, cam, cfg)[:, 5].sum() + 0.0 * x.sum(), x)
    assert not d.any()


def test_empty_map_gives_zero_gradients():
    """No active splat: the render is the background and every gradient is
    zero (JAX's render gives the same zeros)."""
    jc, cam = _cam()
    scene = _scene(seed=7)
    scene["active"] = jnp.zeros_like(scene["active"])
    ps = {k: _t(scene[k]).requires_grad_(True) for k in PARAMS}
    out = render(*(ps[k] for k in PARAMS), _t(scene["active"]), torch.eye(4), cam,
                 RasterConfig(**CFG_KW), bg=BG)
    torch.testing.assert_close(out.color, torch.full_like(out.color, BG))
    grads = torch.autograd.grad(out.color.sum() + out.depth.sum() + out.alpha.sum(),
                                [ps[k] for k in PARAMS], allow_unused=True)
    assert all(g is None or not g.any() for g in grads)
    jgrads = jax.grad(lambda p: (lambda o: jnp.sum(o.color) + jnp.sum(o.depth))(
        jrender(*(p[k] for k in PARAMS), scene["active"], jnp.eye(4), jc,
                JRasterConfig(**CFG_KW, backend="pallas"), bg=BG)))({k: scene[k] for k in PARAMS})
    assert all(not np.asarray(jgrads[k]).any() for k in PARAMS)


def test_tile_pack_backward_sums_like_scatter():
    """The per-tile pack's fixed-order backward gives autograd's scatter-add
    sums (slots past each tile's count and padding send nothing)."""
    _, cam = _cam()
    cfg = RasterConfig(**CFG_KW)
    scene = {k: _t(v) for k, v in _scene(seed=8, n=240).items()}
    prep = preprocess(*(scene[k] for k in KEYS), torch.eye(4), cam)
    bins = bin_gaussians(prep, cam, cfg)
    bins = dataclasses.replace(bins, counts=torch.clamp(bins.counts - 3, min=0))
    g = torch.randn((bins.counts.shape[0], 16, 256), generator=torch.Generator().manual_seed(1))
    fields = ("mean2d", "conic", "opacity", "color", "depth")
    leaves = {f: getattr(prep, f).detach().requires_grad_(True) for f in fields}
    p2 = dataclasses.replace(prep, **leaves)
    with torch.no_grad():
        plain = pack_instances(p2, bins)  # no grad: the index gather
    sorted_ = torch.autograd.grad((pack_instances(p2, bins) * g).sum(), list(leaves.values()))
    k = torch.arange(256)
    dead = (bins.indices < 0) | (k[None, :] >= bins.counts[:, None])
    idx = torch.where(dead, torch.full_like(bins.indices, prep.depth.shape[0]), bins.indices)
    cols = attr_cols(p2)
    ref_pack = cols[idx.reshape(-1).long()].reshape(*idx.shape, 16).transpose(1, 2)
    assert torch.equal(plain, ref_pack)
    scatter = torch.autograd.grad((ref_pack * g).sum(), list(leaves.values()))
    for f, a, b in zip(fields, sorted_, scatter):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=f)
