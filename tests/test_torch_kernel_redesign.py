"""The math of K2b's reverse-mode pose adjoint and of K4's footprint cull
(``csrc/preprocess_instances.cu``, ``csrc/blend_flat.cu``) against the JAX
package on the CPU.

- K2b: :func:`_k2b_sweep`, a step-by-step PyTorch mirror of the kernel's
  ``ewa_rows`` + ``ewa_adjoint`` (the package keeps one plain version, the
  autograd of ``screen_rows``), against the JAX VJP of
  ``preprocess_instances_pallas`` in interpret mode, at 1e-4 relative, on
  ``adjoint_edge_pack`` packs: each kind of slot on its own (near plane,
  clips, ``det <= 0``, dead, zero cotangents), all of them together at a
  capacity that is not a multiple of 256, and one tile. At ``T = 0`` the
  Pallas kernel's block cannot slice an empty pack, so the reference there
  is the VJP of the JAX package's XLA ``preprocess_instances`` (zeros).
- K4 and K3: ``footprint_keep_plain`` keeps every slot a warp applies (the
  visit words of ``blend_flat_forward_plain``) on a small mapping pack under
  both stop rules, ``footprint_keep`` those of ``blend_forward_plain`` on
  the same scene's per-tile pack, and on a ``hypothesis`` search of conics
  and opacities placed so that one pixel's alpha lies within a few ulps of
  the 1/255 gate; the plain blend's count of kept (lane, slot) pairs lies
  between its visited and evaluated ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster.instances import preprocess_instances as jpreprocess_instances
from gsorb_slam_tpu.raster.preprocess_pallas import preprocess_instances_pallas
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.raster.binning import ChunkBins, TileBins, chunk_layout
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    blend_forward_plain,
    footprint_extents,
    footprint_keep,
    pack_instances,
    tile_pixels,
)
from gsorb_slam_tpu_torch.raster.flat_kernels import (
    blend_flat_forward_plain,
    footprint_keep_plain,
    pack_instances_flat,
)
from gsorb_slam_tpu_torch.raster.naive import MIN_ALPHA
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed
from gsorb_slam_tpu_torch.raster.preprocess_kernel import (
    EDGE_KINDS,
    adjoint_edge_pack,
    preprocess_bwd_plain,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene

torch.set_num_threads(1)

CAM_KW = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
SM = 1.1
POSE_ROWS = [0, 1, 2, 3, 4, 9]


def _k2b_sweep(raw, rt, d_screen, cam, sm):
    """K2b's arithmetic, step by step as ``ewa_rows`` and ``ewa_adjoint``
    compute it, on every slot at once (float32) -> ``d_rt [12]``."""
    f = lambda r: raw[:, r, :]
    x, y, z3 = f(0), f(1), f(2)
    cw = [[f(6), f(7), f(8)], [f(7), f(9), f(10)], [f(8), f(10), f(11)]]
    R = [[rt[3 * i + j] for j in range(3)] for i in range(3)]
    tx = R[0][0] * x + R[0][1] * y + R[0][2] * z3 + rt[9]
    ty = R[1][0] * x + R[1][1] * y + R[1][2] * z3 + rt[10]
    tz = R[2][0] * x + R[2][1] * y + R[2][2] * z3 + rt[11]
    in_front = tz > 0.2
    safe_z = torch.where(in_front, tz, torch.ones_like(tz))
    txr, tyr = tx / safe_z, ty / safe_z
    lim_x, lim_y = 1.3 * cam.tan_half_fov_x, 1.3 * cam.tan_half_fov_y
    x_in = ~(txr < -lim_x) & ~(txr > lim_x)
    y_in = ~(tyr < -lim_y) & ~(tyr > lim_y)
    txz = torch.clamp(txr, -lim_x, lim_x)
    tyz = torch.clamp(tyr, -lim_y, lim_y)
    Rs = [[R[i][j] * sm for j in range(3)] for i in range(3)]
    M = [[Rs[i][0] * cw[0][j] + Rs[i][1] * cw[1][j] + Rs[i][2] * cw[2][j] for j in range(3)]
         for i in range(3)]

    def km(i, j):
        return M[i][0] * Rs[j][0] + M[i][1] * Rs[j][1] + M[i][2] * Rs[j][2]

    k00, k01, k02, k11, k12, k22 = km(0, 0), km(0, 1), km(0, 2), km(1, 1), km(1, 2), km(2, 2)
    fx_z, fy_z = cam.fx / safe_z, cam.fy / safe_z
    j02, j12 = -(fx_z * txz), -(fy_z * tyz)
    a = fx_z * (fx_z * k00 + j02 * k02) + j02 * (fx_z * k02 + j02 * k22) + 0.3
    b = fx_z * (fy_z * k01 + j12 * k02) + j02 * (fy_z * k12 + j12 * k22)
    c = fy_z * (fy_z * k11 + j12 * k12) + j12 * (fy_z * k12 + j12 * k22) + 0.3
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    valid = (f(13) > 0.5) & in_front & (det > 0)
    vm = valid.float()

    g = [d_screen[:, r, :] for r in POSE_ROWS]
    inv_sz = 1.0 / safe_z
    d_tx = g[0] * fx_z
    d_ty = g[1] * fy_z
    d_sz = -(g[0] * fx_z * txr + g[1] * fy_z * tyr)
    # The conic rows and z: valid slots only (the kernel's if (e.valid)).
    d_inv = g[2] * c - g[3] * b + g[4] * a
    d_det = -d_inv * inv_det * inv_det
    da = (g[4] * inv_det + d_det * c) * vm
    db = (-g[3] * inv_det - 2.0 * d_det * b) * vm
    dc = (g[2] * inv_det + d_det * a) * vm
    d_tz = g[5] * vm
    d_fx = 2.0 * da * (fx_z * k00 + j02 * k02) + db * (fy_z * k01 + j12 * k02)
    d_fy = db * (fx_z * k01 + j02 * k12) + 2.0 * dc * (fy_z * k11 + j12 * k12)
    d_j02 = 2.0 * da * (fx_z * k02 + j02 * k22) + db * (fy_z * k12 + j12 * k22)
    d_j12 = db * (fx_z * k02 + j02 * k22) + 2.0 * dc * (fy_z * k12 + j12 * k22)
    w00 = 2.0 * da * fx_z * fx_z
    w11 = 2.0 * dc * fy_z * fy_z
    w22 = 2.0 * (da * j02 * j02 + db * j02 * j12 + dc * j12 * j12)
    w01 = db * fx_z * fy_z
    w02 = 2.0 * da * fx_z * j02 + db * fx_z * j12
    w12 = db * j02 * fy_z + 2.0 * dc * fy_z * j12
    d_fx = d_fx - d_j02 * txz
    d_fy = d_fy - d_j12 * tyz
    d_txz, d_tyz = -d_j02 * fx_z, -d_j12 * fy_z
    d_sz = d_sz - (d_fx * fx_z + d_fy * fy_z) * inv_sz
    zero = torch.zeros_like(d_tx)
    d_tx = d_tx + torch.where(x_in, d_txz * inv_sz, zero)
    d_sz = d_sz - torch.where(x_in, d_txz * txr * inv_sz, zero)
    d_ty = d_ty + torch.where(y_in, d_tyz * inv_sz, zero)
    d_sz = d_sz - torch.where(y_in, d_tyz * tyr * inv_sz, zero)
    W = [[w00, w01, w02], [w01, w11, w12], [w02, w12, w22]]
    d_tz = d_tz + torch.where(in_front, d_sz, zero)
    m = [x, y, z3]
    d_t = [d_tx, d_ty, d_tz]
    dR = [[sm * (W[i][0] * M[0][l] + W[i][1] * M[1][l] + W[i][2] * M[2][l]) + d_t[i] * m[l]
           for l in range(3)] for i in range(3)]
    # Slots whose six cotangents are all zero are skipped.
    nz = torch.stack(g).ne(0).any(0)
    terms = [dR[i][l] for i in range(3) for l in range(3)] + d_t
    return torch.stack([torch.where(nz, v, zero).sum() for v in terms])


def _edge_case(kind, n_tiles, cap, seed=0):
    """The edge pack, with the cotangent kept only on the slots of ``kind``
    (every slot for None)."""
    cam = Camera(**CAM_KW)
    raw, rt, d, kinds = adjoint_edge_pack(seed, n_tiles, cap, cam)
    if kind is not None:
        keep = kinds == EDGE_KINDS.index(kind)
        assert keep.any()
        d = d * keep[:, None, :]
    return cam, raw, rt, d.astype(np.float32)


def _jax_drt(raw, rt, d, n_tiles):
    jc = JCamera(**CAM_KW)
    if n_tiles == 0:
        T_cw = jnp.eye(4).at[:3, :3].set(jnp.asarray(rt[:9]).reshape(3, 3)).at[:3, 3].set(
            jnp.asarray(rt[9:]))
        _, vjp = jax.vjp(lambda T: jpreprocess_instances(jnp.asarray(raw), T, jc, SM), T_cw)
        (dT,) = vjp(jnp.asarray(d))
        return np.concatenate([np.asarray(dT[:3, :3]).reshape(-1), np.asarray(dT[:3, 3])])
    _, vjp = jax.vjp(lambda r: preprocess_instances_pallas(jnp.asarray(raw), r, jc, SM, 8, True),
                     jnp.asarray(rt))
    return np.asarray(vjp(jnp.asarray(d))[0])


@pytest.mark.parametrize("kind,n_tiles,cap", [
    *((k, 3, 300) for k in EDGE_KINDS),  # each kind alone, cap not a multiple of 256
    (None, 3, 300),  # every kind together
    (None, 1, 256),  # one tile of one block
    (None, 0, 300),  # no tiles
])
def test_k2b_sweep_matches_jax_vjp(kind, n_tiles, cap):
    cam, raw, rt, d = _edge_case(kind, n_tiles, cap)
    ref = _jax_drt(raw, rt, d, n_tiles)
    got = _k2b_sweep(torch.as_tensor(raw), torch.as_tensor(rt), torch.as_tensor(d), cam, SM)
    plain = preprocess_bwd_plain(torch.as_tensor(raw), torch.as_tensor(rt), torch.as_tensor(d),
                                 cam, SM)
    if kind == "zero_cotangent" or n_tiles == 0:
        assert not np.any(ref) and not got.any() and not plain.any()
        return
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)


def test_edge_pack_takes_every_branch():
    """The edge pack reaches each branch of the adjoint: instances on both
    sides of the near plane, x / z and y / z clipped on both sides, det <= 0
    among live instances in front, dead slots with a cotangent, zero
    cotangents."""
    cam = Camera(**CAM_KW)
    raw, rt, d = (torch.as_tensor(a) for a in adjoint_edge_pack(0, 3, 300, cam)[:3])
    f = lambda r: raw[:, r, :]
    tx, ty, tz = (rt[3 * i] * f(0) + rt[3 * i + 1] * f(1) + rt[3 * i + 2] * f(2) + rt[9 + i]
                  for i in range(3))
    near = (tz - 0.2).abs() < 0.1
    assert int((near & (tz > 0.2)).sum()) > 10 and int((near & (tz <= 0.2)).sum()) > 10
    safe_z = torch.where(tz > 0.2, tz, torch.ones_like(tz))
    for t_, lim in ((tx, cam.tan_half_fov_x), (ty, cam.tan_half_fov_y)):
        r = t_ / safe_z
        assert int((r > 1.3 * lim).sum()) > 10 and int((r < -1.3 * lim).sum()) > 10
    from gsorb_slam_tpu_torch.raster.instances import screen_rows

    s = screen_rows(raw, rt, cam, SM)
    live_front = (f(13) > 0.5) & (tz > 0.2)
    assert int((live_front & (s[:, 10] == 0)).sum()) > 10  # det <= 0
    assert int(((f(13) == 0) & d[:, POSE_ROWS].ne(0).any(1)).sum()) > 10
    assert int(d.eq(0).all(1).sum()) > 10


# ---------------------------------------------------------------------------
# K4's footprint cull
# ---------------------------------------------------------------------------

FLAT_CFG = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, chunk_budget=64)
N_TILES = 12
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits(words):
    """int32 visit words [..., n] -> bool [..., 32 n] (bit b of word j is
    slot 32 j + b)."""
    w = words.long() & 0xFFFFFFFF
    bits = (w[..., None] >> torch.arange(32)) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


@pytest.mark.parametrize("exact,layout", [
    pytest.param(False, "flat", id="False"), pytest.param(True, "flat", id="True"),
    pytest.param(False, "tile", id="tile-False"), pytest.param(True, "tile", id="tile-True"),
])
def test_footprint_keeps_every_applied_slot(rng, exact, layout):
    """On a small mapping pack (K4's flat layout) and on the same scene's
    per-tile pack (K3's, whose tiles' counts end inside a chunk) the cull
    keeps every slot a warp applies, and drops most of the rest."""
    scene = random_cloud_scene(rng, n=300, capacity=384)
    jc = JCamera(**CAM_KW)
    prep = jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc)
    bins = jbin(prep, jc, JRasterConfig(**FLAT_CFG, exact_stop=exact))
    tb = TileBins(indices=_t(bins.indices), counts=_t(bins.counts), n_dropped=_t(bins.n_dropped))
    pp = Preprocessed(**{f.name: _t(getattr(prep, f.name))
                         for f in dataclasses.fields(Preprocessed)})
    if layout == "tile":
        _check_tile_cull_keeps_applied(pp, tb, exact)
        return
    cb = chunk_layout(tb, N_TILES, 64, 64)
    packed = pack_instances_flat(pp, cb)
    cfg, cam = RasterConfig(**FLAT_CFG, exact_stop=exact), Camera(**CAM_KW)
    visit = blend_flat_forward_plain(packed, cb, cam, cfg)[3]
    keep = footprint_keep_plain(packed, cb, cam, cfg)
    applied = _bits(visit)
    assert keep.shape == applied.shape
    assert int(applied.sum()) > 0
    assert not bool((applied & ~keep).any())
    live = (cb.indices >= 0)[:, None, :].expand_as(keep)
    assert int(keep.sum()) < 0.5 * int(live.sum())  # the cull drops most pairs
    # The warps' kept pairs lie between the visited and the evaluated ones.
    pairs = {}
    blend_flat_forward_plain(packed, cb, cam, cfg, pairs=pairs)
    assert pairs["warp_visits"] <= pairs["warp_kept"] < pairs["evaluated"]


def _check_tile_cull_keeps_applied(pp, tb, exact):
    """K3's side of test_footprint_keeps_every_applied_slot: the per-tile
    pack (capacity 256, chunk 64), the cull of each warp over every slot
    against the visit words of ``blend_forward_plain``."""
    cfg, cam = RasterConfig(**FLAT_CFG, exact_stop=exact), Camera(**CAM_KW)
    packed = pack_instances(pp, tb)
    counts = tb.counts
    visit = blend_forward_plain(packed, counts, cam, cfg)[3]  # [T, n_chunks, W, kw]
    pu, pv = tile_pixels(torch.arange(N_TILES), 4, 16, 16)
    keep = footprint_keep(packed, pu, pv)  # [T, W, cap]
    applied = _bits(visit).transpose(1, 2).reshape(keep.shape)
    assert int(applied.sum()) > 0
    assert not bool((applied & ~keep).any())
    # A tile whose count ends inside a chunk applies a slot of that chunk.
    slot = torch.arange(keep.shape[2])
    last_chunk = (slot[None, :] // 64 == (counts[:, None] - 1) // 64) & (counts[:, None] % 64 > 0)
    assert bool((applied & last_chunk[:, None, :]).any())
    live = (slot[None, :] < counts[:, None])[:, None, :].expand_as(keep)
    assert not bool((applied & ~live).any())
    assert int((keep & live).sum()) < 0.5 * int(live.sum())  # the cull drops most pairs
    pairs = {}
    blend_forward_plain(packed, counts, cam, cfg, pairs=pairs)
    assert pairs["warp_visits"] <= pairs["warp_kept"] < pairs["evaluated"]


def _one_slot_pack(mu, mv, ca, cb, cc, op):
    """A one-tile flat pack (tile 0, 16 x 16 pixels, chunk 32) holding one
    instance in slot 0."""
    packed = torch.zeros((1, 16, 32))
    for r, v in enumerate((mu, mv, ca, cb, cc, op, 0.5, 0.5, 0.5, 1.0)):
        packed[0, r, 0] = v
    cb_ = ChunkBins(indices=torch.tensor([[0] + [-1] * 31], dtype=torch.int32),
                    chunk_tile=torch.zeros(1, dtype=torch.int32),
                    chunk_pos=torch.zeros(1, dtype=torch.int32),
                    n_chunks=torch.tensor(1, dtype=torch.int32),
                    tile_start=torch.tensor([0, 1], dtype=torch.int32))
    return packed, cb_


GATE_CAM = Camera(fx=16.0, fy=16.0, cx=8.0, cy=8.0, width=16, height=16)
GATE_CFG = RasterConfig(tile=16, tile_capacity=32, max_dup=16, chunk=32, chunk_budget=1)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(
    log_var=st.floats(-2.0, 6.0), aniso=st.floats(0.0, 4.0), angle=st.floats(0.0, np.pi),
    op=st.floats(MIN_ALPHA * 0.999, 1.0), theta=st.floats(0.0, 2 * np.pi),
    extreme=st.sampled_from([None, 0, 1]), sign=st.sampled_from([-1.0, 1.0]),
    pixel=st.integers(0, 255), ulps=st.integers(-2, 2),
)
def test_footprint_keeps_pairs_at_the_gate(log_var, aniso, angle, op, theta, extreme, sign, pixel,
                                           ulps):
    """An instance placed so that one pixel's alpha lies within a few ulps of
    the 1/255 gate (conic from a random variance, anisotropy and angle; the
    pixel in a random direction, or at the ellipse's extreme point along x
    or y, where the box is tight): if the plain blend applies it, the cull
    keeps it for that pixel's warp, and the pixel lies inside the slot's
    box."""
    s1 = np.exp(log_var)
    s2 = s1 * np.exp(-aniso)
    co, si = np.cos(angle), np.sin(angle)
    cov = np.array([[co * co * s1 + si * si * s2, co * si * (s1 - s2)],
                    [co * si * (s1 - s2), si * si * s1 + co * co * s2]])
    C = np.linalg.inv(cov)
    ca, cb, cc = np.float32(C[0, 0]), np.float32(C[0, 1]), np.float32(C[1, 1])
    op = np.float32(op)
    tau = 2.0 * np.log(255.0 * float(op))
    if tau <= 0:
        return
    Cf = np.array([[ca, cb], [cb, cc]], np.float64)
    if extreme is None:
        u = np.array([np.cos(theta), np.sin(theta)])
    else:  # the ellipse's extreme point along axis `extreme`: d ~ C^-1 e
        u = sign * np.linalg.inv(Cf)[:, extreme]
        u /= np.linalg.norm(u)
    q = u @ Cf @ u
    dist = np.sqrt(tau / q)
    # Step the offset by whole ulps of the mean around the gate crossing.
    pu, pv = float(pixel % 16), float(pixel // 16)
    mu = np.float32(pu + dist * u[0])
    mv = np.float32(pv + dist * u[1])
    for _ in range(abs(ulps)):
        mu = np.nextafter(mu, np.float32(np.sign(ulps) * np.inf), dtype=np.float32)
    packed, cb_ = _one_slot_pack(float(mu), float(mv), float(ca), float(cb), float(cc),
                                 float(op))
    visit = blend_flat_forward_plain(packed, cb_, GATE_CAM, GATE_CFG)[3]
    keep = footprint_keep_plain(packed, cb_, GATE_CAM, GATE_CFG)
    applied = _bits(visit)[0, :, 0]
    assert not bool((applied & ~keep[0, :, 0]).any())
    if applied[pixel // 32]:
        ex, ey = footprint_extents(*(packed[0, r, :1] for r in (2, 3, 4, 5)))
        pix = torch.zeros(256, dtype=torch.bool)
        pix[pixel] = True
        out = blend_flat_forward_plain(packed, cb_, GATE_CAM, GATE_CFG)[0]
        if float(out[0, 4, pixel]) > 0:  # this pixel applied it
            assert abs(float(mu) - pu) <= float(ex[0]) and abs(float(mv) - pv) <= float(ey[0])
    # The pixel's own alpha is at the gate within rounding.
    d0, d1 = np.float32(mu - pu), np.float32(mv - pv)
    power = np.float32(-0.5) * (ca * d0 * d0 + cc * d1 * d1) - cb * d0 * d1
    assert abs(float(op) * np.exp(float(power)) - MIN_ALPHA) < 1e-3 * MIN_ALPHA


def test_footprint_extents_edge_values():
    """Opacity below the gate: never evaluated (-1); a conic that is not
    positive definite, or NaN: never culled (inf, NaN); otherwise a box that
    holds the ellipse d^T C d <= 2 ln(255 op)."""
    t = lambda *v: torch.tensor(v, dtype=torch.float32)
    ca, cb, cc = t(0.5, 1.0, -1.0, 1.0, float("nan")), t(0.1, 2.0, 0.0, 0.0, 0.0), t(
        0.25, 1.0, 1.0, 1.0, 1.0)
    op = t(0.9, 0.9, 0.9, MIN_ALPHA * 0.99, 0.9)
    ex, ey = footprint_extents(ca, cb, cc, op)
    det = 0.5 * 0.25 - 0.01
    tau = 2 * np.log(255 * 0.9)
    assert float(ex[0]) >= np.sqrt(tau * 0.25 / det) and float(ey[0]) >= np.sqrt(tau * 0.5 / det)
    assert float(ex[0]) < np.sqrt(tau * 0.25 / det) * 1.001 + 2e-3
    assert ex[1] == float("inf") and ex[2] == float("inf")  # det < 0, ca < 0
    assert ex[3] == -1 and ey[3] == -1
    assert not bool(ex[4] < 0)  # NaN: kept
