"""K3's visit words, the residual K6 walks, on the CPU.

The per-tile packs come from the JAX package's ``preprocess`` and
``bin_gaussians`` at a small size (64x48, tile 16, capacity 256, chunk 64:
12 tiles of 4 chunks), gathered by the port's ``pack_instances``.

- ``blend_forward_plain``'s visit words equal those of a per-pixel numpy
  loop (float32, as the kernel evaluates a pair), exactly, under both stop
  rules. The pack's tiles end inside a chunk, and their slots past the count
  hold opaque splats: the count bounds the blend, whatever lies past it.
- They equal ``blend_flat_forward_plain``'s words, exactly, when the same
  instances are laid flat by ``chunk_layout`` (K3 and K4 share one
  contract), and are zero in the chunks past each tile's count.
- The wrapper takes the plain version on CPU tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import TileBins, chunk_layout
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_forward,
    blend_forward_plain,
    pack_instances,
)
from gsorb_slam_tpu_torch.raster.flat_kernels import blend_flat_forward_plain, pack_instances_flat
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")
N_TILES, K, CAP, PX = 12, 64, 256, 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _port_scene(rng, exact):
    """The port's ``(Preprocessed, TileBins)`` of a JAX-binned random scene."""
    jc = JCamera(**CAM_KW)
    scene = random_cloud_scene(rng, n=350, capacity=384)
    scene["logit_opacities"] = jnp.full_like(scene["logit_opacities"], 3.0)
    prep = jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc)
    bins = jbin(prep, jc, JRasterConfig(**CFG_KW, exact_stop=exact))
    pp = Preprocessed(**{f.name: _t(getattr(prep, f.name))
                         for f in dataclasses.fields(Preprocessed)})
    tb = TileBins(indices=_t(bins.indices), counts=_t(bins.counts), n_dropped=_t(bins.n_dropped))
    return pp, tb


def _visit_words_per_pixel(packed, counts, exact):
    """K3's visit words by a per-pixel loop over each tile's live slots in
    order (float32, the pixels of a tile side by side): bit b of word j of
    warp w in chunk c is set iff one of the warp's 32 pixels applied slot
    c K + 32 j + b."""
    words = np.zeros((N_TILES, CAP // K, PX // 32, K // 32), np.int64)
    loc = np.arange(PX)
    for t in range(N_TILES):
        pu = ((t % 4) * 16 + loc % 16).astype(np.float32)
        pv = ((t // 4) * 16 + loc // 16).astype(np.float32)
        T = np.ones(PX, np.float32)
        live = np.ones(PX, bool)
        for k in range(int(counts[t])):
            mu, mv, ca, cb, cc, op = packed[t, :6, k]
            d0, d1 = mu - pu, mv - pv
            power = np.float32(-0.5) * (ca * d0 * d0 + cc * d1 * d1) - cb * d0 * d1
            alpha = np.minimum(np.float32(0.99), op * np.exp(power))
            hit = live & (power <= 0) & (alpha >= np.float32(1.0 / 255.0))
            Tn = T * (np.float32(1.0) - alpha)
            if exact:
                live &= ~(hit & (Tn < 1e-4))
                hit &= live
            for w in np.flatnonzero(hit.reshape(-1, 32).any(axis=1)):
                words[t, k // K, w, (k % K) // 32] |= 1 << (k % 32)
            T = np.where(hit, Tn, T)
            if not exact:
                live &= T >= 1e-4
    return np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32)


def _n_bits(words):
    return sum(bin(int(w) & 0xFFFFFFFF).count("1") for w in words.reshape(-1))


@pytest.mark.parametrize("exact", [False, True])
def test_tile_visit_words_match_per_pixel_loop(rng, exact):
    """The plain K3's visit words (K6's residual) equal the per-pixel loop's,
    with opaque splats past every tile's count; their set bits are the
    (warp, slot) pairs K6 walks."""
    pp, tb = _port_scene(rng, exact)
    cfg, cam = RasterConfig(**CFG_KW, exact_stop=exact), Camera(**CAM_KW)
    packed = pack_instances(pp, tb)
    counts = tb.counts
    ends_inside = (counts % K != 0) & (counts < CAP) & (counts > 0)
    assert bool(ends_inside.any())
    # Past each tile's count: the tile's own live instances again, opaque.
    clean = packed.clone()
    for t in range(N_TILES):
        n = int(counts[t])
        if 0 < n < CAP:
            idx = torch.arange(n, CAP) % n
            packed[t, :, n:] = packed[t][:, idx]
            packed[t, 5, n:] = 0.9
    pairs = {}
    out, chunk_t, last, visit = blend_forward_plain(packed, counts, cam, cfg, pairs=pairs)
    assert visit.dtype == torch.int32 and visit.shape == (N_TILES, CAP // K, PX // 32, K // 32)
    ref = _visit_words_per_pixel(packed.numpy(), counts.numpy(), exact)
    np.testing.assert_array_equal(visit.numpy(), ref)
    bits = _n_bits(ref)
    assert bits > 0 and pairs["warp_visits"] == 32 * bits
    # A word of the last live chunk of a tile that ends inside it is set,
    # and nothing past the count is applied.
    t = int(torch.nonzero(ends_inside & (counts > 32)).reshape(-1)[0])
    assert bool(visit[t, (int(counts[t]) - 1) // K].any())
    assert bool((last < counts[:, None]).all())
    # The slots past the count change nothing.
    clean_res = blend_forward_plain(clean, counts, cam, cfg)
    for a, b in zip(clean_res, (out, chunk_t, last, visit)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("exact", [False, True])
def test_tile_visit_words_match_flat_layout(rng, exact):
    """K3's words on the per-tile pack equal K4's on the same instances laid
    flat by ``chunk_layout``, chunk for chunk, and are zero in the chunks
    past each tile's count; the wrapper takes the plain version on CPU
    tensors."""
    pp, tb = _port_scene(rng, exact)
    cfg, cam = RasterConfig(**CFG_KW, exact_stop=exact), Camera(**CAM_KW)
    packed = pack_instances(pp, tb)
    visit = blend_forward_plain(packed, tb.counts, cam, cfg)[3]
    cb = chunk_layout(tb, N_TILES, K, N_TILES * CAP // K)
    visit_flat = blend_flat_forward_plain(pack_instances_flat(pp, cb), cb, cam, cfg)[3]
    n_live = int(cb.n_chunks)
    tile, pos = cb.chunk_tile[:n_live].long(), cb.chunk_pos[:n_live].long()
    assert torch.equal(visit[tile, pos], visit_flat[:n_live])
    assert not visit_flat[n_live:].any()
    live = torch.zeros(visit.shape[:2], dtype=torch.bool)
    live[tile, pos] = True
    assert torch.equal(live, torch.arange(CAP // K)[None, :] * K < tb.counts[:, None])
    assert not visit[~live].any() and bool(visit[live].any())
    res = blend_forward(packed, tb.counts, cam, cfg)
    assert len(res) == 4 and torch.equal(res[3], visit)
