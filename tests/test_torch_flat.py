"""The port's flat-chunk mapping render against the JAX package on the CPU
(Pallas in interpret mode).

- ``chunk_layout``: equal index for index, at the live chunk count and above
  it; the port raises below it (the JAX version drops tail tiles).
- K4 / K5 plain versions against ``render_pallas_flat`` and its ``jax.vjp``
  to the screen attributes, through the sorted pack backward, both stop
  rules, with and without background. The Pallas fast path leaves the blend
  at chunk granularity and has no per-element gates; the port stops per
  pixel. Tolerances are the flat tolerances of ``tests/test_pallas.py``:
  fast stop outputs 3e-4 (depth and median 6e-4), gradients atol 8e-4 /
  rtol 2e-3; exact stop outputs 5e-5 (depth and median 1e-4), gradients
  2e-4 / 2e-3.
- The wrappers take the plain versions for CPU tensors.
- The sorted pack backward equals autograd's scatter to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster.binning import chunk_layout as jchunk_layout
from gsorb_slam_tpu.raster.pallas_raster import flat_pack_grad_aux as jflat_pack_grad_aux
from gsorb_slam_tpu.raster.pallas_raster import render_pallas_flat
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, chunk_layout
from gsorb_slam_tpu_torch.raster.blend_kernels import flat_pack_grad_aux, sorted_segment_sum
from gsorb_slam_tpu_torch.raster.flat_kernels import (
    blend_flat,
    blend_flat_backward,
    blend_flat_backward_plain,
    blend_flat_forward,
    blend_flat_forward_plain,
    cotangent_without_gate_edges,
    pack_instances_flat,
    render_flat,
)
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, chunk_budget=64)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
N_TILES = 12
PREP_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_scene(rng, exact, n=300):
    scene = random_cloud_scene(rng, n=n, capacity=384)
    jcfg = JRasterConfig(**CFG_KW, exact_stop=exact)
    jc = JCamera(**CAM_KW)
    prep = jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc)
    bins = jbin(prep, jc, jcfg)
    return jcfg, jc, prep, bins


def _port_bins(bins):
    return TileBins(indices=_t(bins.indices), counts=_t(bins.counts), n_dropped=_t(bins.n_dropped))


def _port_prep(prep, requires_grad=()):
    d = {f.name: _t(getattr(prep, f.name)) for f in dataclasses.fields(Preprocessed)}
    for k in requires_grad:
        d[k] = d[k].requires_grad_(True)
    return Preprocessed(**d)


def test_chunk_layout_matches_jax(rng):
    _, _, _, bins = _jax_scene(rng, exact=False)
    tb = _port_bins(bins)
    live = int(jnp.sum((bins.counts + 63) // 64))
    for budget in (live, live + 37):
        jcb = jchunk_layout(bins, N_TILES, 64, budget)
        cb = chunk_layout(tb, N_TILES, 64, budget)
        for f in ("indices", "chunk_tile", "chunk_pos", "n_chunks"):
            np.testing.assert_array_equal(getattr(cb, f).numpy(), np.asarray(getattr(jcb, f)),
                                          err_msg=f)
        # tile_start: the first flat chunk of each tile, the live count last.
        ct = cb.chunk_tile.numpy()
        starts = [int(np.searchsorted(ct, t)) for t in range(N_TILES)] + [live]
        np.testing.assert_array_equal(cb.tile_start.numpy(), starts)
    with pytest.raises(ValueError, match="chunk budget"):
        chunk_layout(tb, N_TILES, 64, live - 1)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("bg", [0.0, 0.3])
def test_flat_plain_matches_pallas(rng, exact, bg):
    """K4 / K5 plain versions (with the sorted pack backward) against
    render_pallas_flat and its vjp to the screen attributes."""
    jcfg, jc, prep, bins = _jax_scene(rng, exact)
    jcb = jchunk_layout(bins, N_TILES, 64, 64)
    jaux = jflat_pack_grad_aux(jcb.indices, prep.depth.shape[0])

    def jrender(*vals):
        p = dataclasses.replace(prep, **dict(zip(PREP_FIELDS, vals)))
        o = render_pallas_flat(p, jcb, jc, jcfg, bg=bg, interpret=True, pack_aux=jaux)
        return o.color, o.depth, o.alpha, o.final_t, o.median_depth

    jo, vjp = jax.vjp(jrender, *(getattr(prep, f) for f in PREP_FIELDS))
    cot = [rng.normal(size=x.shape).astype(np.float32) for x in jo[:4]]
    j_grads = vjp((*map(jnp.asarray, cot), jnp.zeros_like(jo[4])))

    cfg = RasterConfig(**CFG_KW, exact_stop=exact)
    cam = Camera(**CAM_KW)
    cb = chunk_layout(_port_bins(bins), N_TILES, 64, 64)
    tprep = _port_prep(prep, PREP_FIELDS)
    aux = flat_pack_grad_aux(cb.indices, tprep.depth.shape[0])
    to = render_flat(tprep, cb, cam, cfg, bg=bg, pack_aux=aux)
    tol = 5e-5 if exact else 3e-4
    outs = (to.color, to.depth, to.alpha, to.final_t, to.median_depth)
    for name, t_x, j_x, k in zip(("color", "depth", "alpha", "final_t", "median"),
                                 outs, jo, (1, 2, 1, 1, 2)):
        np.testing.assert_allclose(t_x.detach().numpy(), np.asarray(j_x), atol=k * tol,
                                   err_msg=name)
    assert not to.median_depth.requires_grad
    t_grads = torch.autograd.grad(outs[:4], [getattr(tprep, f) for f in PREP_FIELDS],
                                  [torch.as_tensor(c) for c in cot])
    for f, t_g, j_g in zip(PREP_FIELDS, t_grads, j_grads):
        np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), err_msg=f,
                                   atol=2e-4 if exact else 8e-4, rtol=2e-3)


def test_flat_wrappers_take_plain_on_cpu(rng):
    """On CPU tensors K4's and K5's wrappers are their plain versions; the
    plain forward's residuals are the kernel's (incoming T per chunk, the
    last applied slot) and its backward needs none of them."""
    jcfg, jc, prep, bins = _jax_scene(rng, exact=False)
    cfg, cam = RasterConfig(**CFG_KW, exact_stop=False), Camera(**CAM_KW)
    cb = chunk_layout(_port_bins(bins), N_TILES, 64, 64)
    packed = pack_instances_flat(_port_prep(prep), cb)
    out, chunk_t, last, visit = blend_flat_forward(packed, cb, cam, cfg)
    pairs = {}
    out_p, chunk_t_p, last_p, visit_p = blend_flat_forward_plain(packed, cb, cam, cfg,
                                                                 pairs=pairs)
    assert torch.equal(out, out_p) and torch.equal(chunk_t, chunk_t_p)
    assert torch.equal(last, last_p) and last.dtype == torch.int32
    assert torch.equal(visit, visit_p) and visit.dtype == torch.int32
    assert visit.shape == (64, 8, 2) and not visit[int(cb.n_chunks):].any()
    n_live = int(cb.n_chunks)
    assert chunk_t.shape == (64, 256) and not chunk_t[n_live:].any()
    first = cb.tile_start[:-1][cb.tile_start[1:] > cb.tile_start[:-1]].long()
    assert bool((chunk_t[first] == 1.0).all())  # every tile starts unblended
    assert int(last.max()) < 4 * 64 and int(last.min()) == -1
    assert 0 < pairs["applied"] < pairs["evaluated"]
    g = torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))
    d = blend_flat_backward(packed, cb, out, chunk_t, last, visit, g, cam, cfg)
    torch.testing.assert_close(blend_flat_backward_plain(packed, cb, g, cam, cfg, tile_batch=5),
                               d, atol=1e-6, rtol=1e-6)
    assert d.shape == (64, 16, 64) and not d[:, 10:].any() and not d[n_live:].any()
    # blend_flat differentiates the plain forward on the CPU.
    x = packed.clone().requires_grad_(True)
    (d_auto,) = torch.autograd.grad(blend_flat(x, cb, cam, cfg), x, g)
    torch.testing.assert_close(d_auto, d, atol=1e-6, rtol=1e-6)


def _visit_words_per_pixel(packed, cb, exact):
    """K4's visit words by a per-pixel loop over each tile's flat chunks in
    order: bit b of word j of warp w of chunk c is set iff one of the warp's
    32 pixels applied slot 32 j + b of chunk c."""
    MC, _, K = packed.shape
    words = np.zeros((MC, 256 // 32, K // 32), np.int64)
    starts = cb.tile_start.numpy()
    for t in range(N_TILES):
        for p in range(256):
            pu, pv = (t % 4) * 16 + p % 16, (t // 4) * 16 + p // 16
            T, done = 1.0, False
            for c in range(starts[t], starts[t + 1]):
                for k in range(K):
                    if done:
                        break
                    mu, mv, ca, cb_, cc, op = (float(x) for x in packed[c, :6, k])
                    d0, d1 = np.float32(mu - pu), np.float32(mv - pv)
                    power = -0.5 * (ca * d0 * d0 + cc * d1 * d1) - cb_ * d0 * d1
                    alpha = min(0.99, op * np.exp(power))
                    if power > 0 or alpha < 1.0 / 255.0:
                        continue
                    Tn = T * (1.0 - alpha)
                    if exact and Tn < 1e-4:
                        done = True
                        break
                    words[c, p // 32, k // 32] |= 1 << (k % 32)
                    T = Tn
                    done = not exact and T < 1e-4
    return np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32)


@pytest.mark.parametrize("exact", [False, True])
def test_flat_visit_words_match_per_pixel_loop(rng, exact):
    """The visit words of K4's plain version (K5's residual) equal a
    brute-force per-pixel loop's, under both stop rules; their set bits
    are the (warp, slot) pairs K5 walks."""
    _, _, prep, bins = _jax_scene(rng, exact)
    cfg, cam = RasterConfig(**CFG_KW, exact_stop=exact), Camera(**CAM_KW)
    cb = chunk_layout(_port_bins(bins), N_TILES, 64, 64)
    packed = pack_instances_flat(_port_prep(prep), cb)
    pairs = {}
    visit = blend_flat_forward_plain(packed, cb, cam, cfg, pairs=pairs)[3]
    ref = _visit_words_per_pixel(packed.numpy(), cb, exact)
    np.testing.assert_array_equal(visit.numpy(), ref)
    bits = sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in ref.reshape(-1))
    assert 0 < bits and pairs["warp_visits"] == 32 * bits


def test_sorted_pack_backward_matches_scatter(rng):
    _, _, prep, bins = _jax_scene(rng, exact=False)
    C = prep.depth.shape[0]
    jcb = jchunk_layout(bins, N_TILES, 64, 64)
    cb = chunk_layout(_port_bins(bins), N_TILES, 64, 64)
    aux = flat_pack_grad_aux(cb.indices, C)
    j_flat, j_perm, _ = jflat_pack_grad_aux(jcb.indices, C)
    np.testing.assert_array_equal(aux.flat_idx.numpy(), np.asarray(j_flat))
    # Each Gaussian's slots in the table, in the order of JAX's sorted slots.
    table = aux.table.numpy()
    order = np.concatenate([row[row < aux.flat_idx.numel()] for row in table])
    np.testing.assert_array_equal(order, np.asarray(j_perm)[: order.size])
    g = torch.as_tensor(rng.normal(size=(aux.flat_idx.numel(), 16)).astype(np.float32))
    ref = torch.zeros((C + 1, 16)).index_add_(0, aux.flat_idx, g)
    d = sorted_segment_sum(g, aux)
    torch.testing.assert_close(d[:C, :10], ref[:C, :10], atol=1e-6, rtol=1e-6)
    assert not d[C].any() and not d[:, 10:].any()
    # Through the pack: the sorted backward against autograd's scatter.
    w = torch.as_tensor(rng.normal(size=(64, 16, 64)).astype(np.float32))
    grads = []
    for a in (aux, None):
        tprep = _port_prep(prep, PREP_FIELDS)
        packed = pack_instances_flat(tprep, cb, a)
        grads.append(torch.autograd.grad((packed * w).sum(),
                                         [getattr(tprep, f) for f in PREP_FIELDS]))
    for f, a, b in zip(PREP_FIELDS, *grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6, msg=f)


def test_cotangent_without_gate_edges():
    """Pixels where an instance's alpha sits within eps of the 0.99 clamp or
    the 1/255 gate lose their cotangent; all others keep it."""
    cam, cfg = Camera(**CAM_KW), RasterConfig(**CFG_KW, exact_stop=False)
    counts = torch.zeros(N_TILES, dtype=torch.int32)
    counts[0] = 2
    idx = torch.full((N_TILES, 256), -1, dtype=torch.int32)
    idx[0, :2] = torch.tensor([0, 1])
    cb = chunk_layout(TileBins(idx, counts, torch.zeros((), dtype=torch.int32)), N_TILES, 64, 64)
    packed = torch.zeros((64, 16, 64))
    # Instance 0: alpha exactly 0.99 at its centre pixel (3, 0). Instance 1:
    # an isotropic splat at (10, 10) whose alpha is 1/255 at distance 3.
    packed[0, :6, 0] = torch.tensor([3.0, 0.0, 1.0, 0.0, 1.0, 0.99])
    packed[0, :6, 1] = torch.tensor([10.0, 10.0, 1.0, 0.0, 1.0, float(np.exp(4.5) / 255.0)])
    g = torch.ones((N_TILES, 8, 256))
    g_e, n = cotangent_without_gate_edges(packed, cb, g, cam, cfg, eps=1e-5)
    edges = [3] + [y * 16 + x for x, y in ((13, 10), (7, 10), (10, 13), (10, 7))]
    assert n == 5 and not g_e[0][:, edges].any()
    assert int((g_e[0, 0] == 0).sum()) == 5 and torch.equal(g_e[1:], g[1:])
