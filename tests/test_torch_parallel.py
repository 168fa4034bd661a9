"""The port's multi-device path (``gsorb_slam_tpu_torch.parallel`` and
``System(use_mesh=True)``) against the JAX package, on the CPU.

The port's ranks are processes spawned with ``torch.multiprocessing``
(``tests/torch_parallel_workers.py``, which never imports JAX), joined in a
gloo process group through a ``FileStore`` in the test's temporary
directory, one thread each; a rank that does not finish within its timeout
fails the test. The JAX references run in this process (on the 8 virtual
CPU devices ``tests/conftest.py`` sets up) while the ranks run, once each.

Tolerances (the JAX package's own for its sharded paths,
``tests/test_parallel.py``): the 2-rank mapping step's loss within 1e-4
relative and its means and colours after Adam within 1e-6; the 2-rank
tracking's loss within 1e-4 relative and its pose within 5e-5. Replicas are
bitwise equal.

The mesh convergence parity (``tests/test_parallel.py``'s, marked slow
there) runs here on four ranks: 32 single-device ``map_window`` iterations
and 32 four-rank ``parallel_window_step``s from the same seeded map must
both bring the window loss below 0.8x the start, the mesh within 1.2x the
single device + 1e-3; the port's starting window loss is within 2e-3
relative of the JAX ``window_loss`` of the same map and window."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.core.config import MappingConfig as JMappingConfig
from gsorb_slam_tpu.core.config import TrackingConfig as JTrackingConfig
from gsorb_slam_tpu.core.transforms import se3_exp
from gsorb_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from gsorb_slam_tpu.parallel.mesh import parallel_window_step as jparallel_window_step
from gsorb_slam_tpu.parallel.mesh import replicate_map as jreplicate_map
from gsorb_slam_tpu.parallel.mesh import shard_frames as jshard_frames
from gsorb_slam_tpu.parallel.tracking import strided_tile_perm as jstrided_tile_perm
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster.binning import TileBins as JTileBins
from gsorb_slam_tpu.raster.tiled import render_tiled as jrender_tiled
from gsorb_slam_tpu.slam.mapping import _mapping_loss as j_mapping_loss
from gsorb_slam_tpu.slam.mapping import WindowFrames as JWindowFrames
from gsorb_slam_tpu.slam.mapping import seed_from_frame as jseed_from_frame
from gsorb_slam_tpu.slam.tracking import FeatureMatches as JFeatureMatches
from gsorb_slam_tpu.slam.tracking import track_frame as jtrack_frame
from gsorb_slam_tpu.splat.gaussians import GaussianMap as JGaussianMap
from gsorb_slam_tpu.splat.gaussians import empty_map as jempty_map
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.interop import (
    gaussian_map_from_numpy,
    gaussian_map_to_numpy,
    window_frames_from_numpy,
)
from gsorb_slam_tpu_torch.parallel import strided_tile_perm
from gsorb_slam_tpu_torch.raster import (
    RasterConfig,
    bin_gaussians,
    preprocess,
    render,
    render_tiled,
)
from gsorb_slam_tpu_torch.raster.binning import TileBins
from gsorb_slam_tpu_torch.slam.mapping import map_window, mapping_loss, seed_from_frame
from gsorb_slam_tpu_torch.splat.gaussians import empty_map

from tests import torch_parallel_workers as W

RANK_TIMEOUT_S = 240
MAP_CAM = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
MAP_RCFG = dict(tile=16, tile_capacity=2048, max_dup=16, chunk=128)
TRACK_CAM = dict(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)
TRACK_RCFG = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=6.0,
                  exact_stop=False)
TRACK_ITERS, TRACK_REBIN = 12, (6,)


def _np_map(jgm) -> dict:
    return jax.tree.map(np.asarray, {f.name: getattr(jgm, f.name)
                                     for f in dataclasses.fields(jgm)})


class Ranks:
    """``world`` spawned ranks running ``job`` of
    ``tests/torch_parallel_workers.py``; :meth:`results` joins them (the
    caller may compute its reference meanwhile)."""

    def __init__(self, tmp_path, job: str, world: int, **args):
        self.out, self.world = str(tmp_path), world
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=W.run_rank, args=(r, world, self.out, job, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self) -> list[dict]:
        for p in self.procs:
            p.join(RANK_TIMEOUT_S)
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        path = lambda r, ext: os.path.join(self.out, f"rank{r}.{ext}")
        errors = {r: open(path(r, "err")).read() for r in range(self.world)
                  if os.path.exists(path(r, "err"))}
        assert not hung, f"ranks {hung} did not finish within {RANK_TIMEOUT_S} s"
        assert not errors and all(p.exitcode == 0 for p in self.procs), errors
        results = [torch.load(path(r, "pt"), weights_only=False) for r in range(self.world)]
        assert not any(res["jax_imported"] for res in results)
        return results


def _assert_maps_bitwise(a: dict, b: dict) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(v[kk], b[k][kk], err_msg=f"{k}.{kk}")
        else:
            np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.parametrize("n_tiles,n_dev", [(12, 2), (20, 4), (30, 8), (7, 3), (1, 2)])
def test_strided_tile_perm_matches_jax(n_tiles, n_dev):
    perm, pad = strided_tile_perm(n_tiles, n_dev)
    jperm, jpad = jstrided_tile_perm(n_tiles, n_dev)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(pad.numpy(), np.asarray(jpad))


def window_case():
    """``tests/test_parallel.py``'s 2-frame window (64x48, a seeded map) as
    numpy arrays, and a function that runs the JAX ``parallel_window_step``
    on a 2-device mesh over it."""
    cam = JCamera(**MAP_CAM)
    mcfg = JMappingConfig(max_gaussians=4096)
    rcfg = JRasterConfig(**MAP_RCFG)
    depth0 = jnp.full((48, 64), 2.0)
    color0 = jnp.tile(jnp.linspace(0, 1, 64)[None, :, None], (48, 1, 3)).astype(jnp.float32)
    gm = jseed_from_frame(jempty_map(mcfg.max_gaussians), color0, depth0, jnp.eye(4), cam, mcfg)
    poses, bidx, bcnt = [], [], []
    for i in range(2):
        T = jnp.eye(4).at[0, 3].set(0.01 * i)
        b = jbin(jpreprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                             gm.active, T, cam), cam, rcfg)
        poses.append(T)
        bidx.append(b.indices)
        bcnt.append(b.counts)
    frames = JWindowFrames(
        colors=jnp.tile(color0[None], (2, 1, 1, 1)), depths=jnp.tile(depth0[None], (2, 1, 1)),
        poses=jnp.stack(poses), bins_indices=jnp.stack(bidx), bins_counts=jnp.stack(bcnt),
        n_frames=jnp.asarray(2, jnp.int32),
    )

    def reference():
        mesh = jmake_mesh(2)
        gm_par, loss_par = jax.jit(
            lambda g, f: jparallel_window_step(g, f, mesh, cam, mcfg, rcfg))(
            jreplicate_map(gm, mesh), jshard_frames(frames, mesh))
        return _np_map(gm_par), float(loss_par)

    return _np_map(gm), {k: np.asarray(v) for k, v in frames._asdict().items()}, reference


def test_parallel_window_step_matches_jax(tmp_path):
    """Two ranks, one frame each: the loss and the Adam step of the JAX
    package's 2-device step; rank 1 starts from a zeroed map, which
    ``replicate_map`` replaces with rank 0's; both ranks end bitwise equal."""
    gm, frames, reference = window_case()
    ranks = Ranks(tmp_path, "window_step", 2, gm=gm, frames=frames, cam=MAP_CAM, rcfg=MAP_RCFG)
    j_map, j_loss = reference()
    r0, r1 = ranks.results()
    assert r0["n_local"] == r1["n_local"] == 1
    assert r0["loss"] == pytest.approx(j_loss, rel=1e-4)
    np.testing.assert_allclose(r0["map"]["means"], j_map["means"], atol=1e-6)
    np.testing.assert_allclose(r0["map"]["rgb"], j_map["rgb"], atol=1e-6)
    assert int(r0["map"]["adam_t"]) == int(j_map["adam_t"]) == 1
    assert r0["loss"] == r1["loss"]
    _assert_maps_bitwise(r0["map"], r1["map"])


def track_case():
    """``tests/test_parallel.py``'s tracking scene (96x72, a map seeded from
    a random frame, gt rendered at a perturbed pose) as numpy arrays, and a
    function that runs JAX ``track_frame`` on it on its Pallas path
    (interpret mode), 12 iterations, a rebin at 6.

    The reference runs eagerly, op by op like the port: on this scene (bins
    saturated at capacity 256) the jitted JAX run lands 1.1e-4 away in pose
    from the eager one, XLA's fused arithmetic tipping a median-depth
    crossing, while the eager run and the port's agree to 1e-7."""
    cam = JCamera(**TRACK_CAM)
    rcfg = JRasterConfig(**TRACK_RCFG, backend="pallas", fused_tiles_per_step=2)
    mcfg = JMappingConfig(max_gaussians=8192)
    rng = np.random.default_rng(11)
    depth0 = jnp.asarray(1.5 + 0.5 * rng.uniform(size=(72, 96)), jnp.float32)
    color0 = jnp.asarray(rng.uniform(size=(72, 96, 3)), jnp.float32)
    gm = jseed_from_frame(jempty_map(mcfg.max_gaussians), color0, depth0, jnp.eye(4), cam, mcfg)
    T_gt = se3_exp(jnp.asarray([0.01, -0.015, 0.008, 0.004, -0.006, 0.01], jnp.float32))
    prep = jpreprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                       gm.active, T_gt, cam)
    out = jrender_tiled(prep, jbin(prep, cam, rcfg), cam, rcfg)

    def reference():
        res = jtrack_frame(
            gm, jnp.eye(4), out.color, out.depth, JFeatureMatches.empty(), cam,
            JTrackingConfig(num_iters=TRACK_ITERS, early_stop_delta=0.0), rcfg,
            rebin_iters=TRACK_REBIN)
        return np.asarray(res.T_cw), float(res.loss), int(res.n_iters)

    return (_np_map(gm), np.asarray(out.color), np.asarray(out.depth), np.asarray(T_gt),
            reference)


def test_parallel_track_frame_matches_jax(tmp_path):
    """Two ranks, each on its strided strip of the tiles: the single-device
    JAX ``track_frame``'s iterations, loss and pose; both ranks bitwise
    equal; the pose moved toward the gt."""
    gm, color, depth, T_gt, reference = track_case()
    ranks = Ranks(tmp_path, "track", 2, gm=gm, gt_color=color, gt_depth=depth, cam=TRACK_CAM,
                  rcfg=TRACK_RCFG, num_iters=TRACK_ITERS, rebin=TRACK_REBIN)
    j_T, j_loss, j_iters = reference()
    r0, r1 = ranks.results()
    assert r0["n_iters"] == j_iters == TRACK_ITERS
    assert r0["loss"] == pytest.approx(j_loss, rel=1e-4)
    np.testing.assert_allclose(r0["T_cw"], j_T, atol=5e-5)
    np.testing.assert_array_equal(r0["T_cw"], r1["T_cw"])
    assert r0["loss"] == r1["loss"]
    assert np.abs(T_gt - r0["T_cw"]).max() < 0.75 * np.abs(T_gt - np.eye(4)).max()


def test_system_use_mesh_one_rank_is_single_device(tmp_path):
    """At world size 1 ``use_mesh=True`` keeps the single-device path (the
    JAX System's rule on one device): the same trajectory and map as
    ``use_mesh=False``, bit for bit, over 2 frames (64x48)."""
    (r,) = Ranks(tmp_path, "system", 1, n_frames=2, small=True).results()
    assert not r["mesh_on"]
    assert r["paired_track_view"] == (True, 8)
    np.testing.assert_array_equal(r["poses"], r["poses_single"])
    _assert_maps_bitwise(r["map"], r["map_single"])


def test_system_use_mesh_two_ranks(tmp_path):
    """``System(use_mesh=True)`` on 2 ranks over 3 frames of a synthetic
    96x72 sequence (the JAX package's ``test_system_mesh_mapping_end_to_end``
    at 2 devices): the mesh is on, poses finite, both ranks' maps bitwise
    equal, the mesh mapping moved the map, and the paired tracking view is
    stripped to square tiles."""
    r0, r1 = Ranks(tmp_path, "system", 2, n_frames=3, small=False).results()
    assert r0["mesh_on"] and r1["mesh_on"]
    assert np.isfinite(r0["poses"]).all() and r0["poses"].shape == (3, 4, 4)
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    _assert_maps_bitwise(r0["map"], r1["map"])
    assert np.abs(r0["map"]["adam_m"]["rgb"]).sum() > 0
    assert r0["n_active"] > 1000
    assert r0["paired_track_view"] == (False, 16)


CONV_RCFG = dict(tile=16, tile_capacity=2048, max_dup=16, chunk=128, chunk_budget=128)
CONV_STEPS = 32


def convergence_case():
    """``tests/test_parallel.py::test_mesh_window_convergence_parity``'s
    window, made by the port on the CPU: 1,500 random splats from
    ``default_rng(3)`` rendered from four views 3 cm apart (64x48), a map
    seeded from view 0 (stride 2), each view's bins of that map. Returns
    the map and the frames as numpy arrays."""
    cam = Camera(**MAP_CAM)
    mcfg = MappingConfig(max_gaussians=4096)
    rcfg = RasterConfig(**CONV_RCFG)
    rng = np.random.default_rng(3)
    N = 1500
    means = np.stack([rng.uniform(-1, 1, N), rng.uniform(-0.8, 0.8, N),
                      rng.uniform(1.5, 3.0, N)], -1).astype(np.float32)
    rgb = rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    lop = np.full(N, 5.0, np.float32)
    lsc = np.log(rng.uniform(0.04, 0.1, (N, 3)).astype(np.float32))
    t = torch.as_tensor
    poses, colors, depths = [], [], []
    with torch.no_grad():
        for i in range(4):
            T = torch.eye(4)
            T[0, 3] = 0.03 * i
            out = render(t(means), t(rgb), t(quats), t(lop), t(lsc),
                         torch.ones(N, dtype=torch.bool), T, cam, rcfg)
            poses.append(T)
            colors.append(torch.clamp(out.color, 0, 1))
            depths.append(torch.where(out.alpha > 0.5, out.median_depth, torch.zeros(())))
        gm0 = seed_from_frame(empty_map(mcfg.max_gaussians, "cpu"), colors[0], depths[0],
                              poses[0], cam, mcfg, stride=2)
        bins = [bin_gaussians(preprocess(gm0.means, gm0.rgb, gm0.quats, gm0.logit_opacities,
                                         gm0.log_scales, gm0.active, T, cam), cam, rcfg)
                for T in poses]
    frames = {"colors": torch.stack(colors).numpy(), "depths": torch.stack(depths).numpy(),
              "poses": torch.stack(poses).numpy(),
              "bins_indices": torch.stack([b.indices for b in bins]).numpy(),
              "bins_counts": torch.stack([b.counts for b in bins]).numpy(), "n_frames": 4}
    return gaussian_map_to_numpy(gm0), frames


def jax_window_loss(gm: dict, frames: dict) -> float:
    """The JAX test's ``window_loss`` of the map ``gm`` (numpy) over
    ``frames`` (numpy), jitted."""
    cam = JCamera(**MAP_CAM)
    mcfg = JMappingConfig(max_gaussians=4096)
    rcfg = JRasterConfig(**CONV_RCFG)
    jgm = jax.tree.map(jnp.asarray, JGaussianMap(**gm))

    def loss(g, colors, depths, poses, bidx, bcnt):
        total = 0.0
        for i in range(4):
            prep = jpreprocess(g.means, g.rgb, g.quats, g.logit_opacities, g.log_scales,
                               g.active, poses[i], cam, mcfg.scale_modifier)
            bins = JTileBins(indices=bidx[i], counts=bcnt[i], n_dropped=jnp.zeros((), jnp.int32))
            out = jrender_tiled(prep, bins, cam, rcfg, bg=mcfg.background_color)
            total = total + j_mapping_loss(g, out, colors[i], depths[i], mcfg, False)
        return total / 4.0

    return float(jax.jit(loss)(jgm, *(jnp.asarray(frames[k]) for k in (
        "colors", "depths", "poses", "bins_indices", "bins_counts"))))


def _window_loss(gm, frames, cam, mcfg, rcfg) -> float:
    """The mean mapping loss over the window's frames (the plain blend)."""
    total = 0.0
    with torch.no_grad():
        for i in range(frames.colors.shape[0]):
            prep = preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                              gm.active, frames.poses[i], cam, mcfg.scale_modifier)
            bins = TileBins(indices=frames.bins_indices[i], counts=frames.bins_counts[i],
                            n_dropped=frames.bins_counts.new_zeros(()))
            out = render_tiled(prep, bins, cam, rcfg, bg=mcfg.background_color)
            total += float(mapping_loss(gm, out, frames.colors[i], frames.depths[i], mcfg, False))
    return total / frames.colors.shape[0]


def test_mesh_window_convergence_parity(tmp_path):
    """Map quality parity of the two mapping modes at equal optimizer steps:
    the single device's one-frame-per-iteration ``map_window`` and the
    four-rank batched ``parallel_window_step`` both converge the window
    loss, to a similar level (the JAX test's three assertions)."""
    gm_np, frames_np = convergence_case()
    ranks = Ranks(tmp_path, "window_steps", 4, gm=gm_np, frames=frames_np, cam=MAP_CAM,
                  rcfg=CONV_RCFG, steps=CONV_STEPS)
    cam, mcfg = Camera(**MAP_CAM), MappingConfig(max_gaussians=4096)
    rcfg = RasterConfig(**CONV_RCFG)
    gm0 = gaussian_map_from_numpy(gm_np, device="cpu")
    frames = window_frames_from_numpy(frames_np, device="cpu")
    loss0 = _window_loss(gm0, frames, cam, mcfg, rcfg)
    assert loss0 == pytest.approx(jax_window_loss(gm_np, frames_np), rel=2e-3)
    ids = np.random.default_rng(0).integers(0, 4, CONV_STEPS).tolist()
    with torch.no_grad():
        gm_s, _ = map_window(gm0, frames, ids, cam, mcfg, rcfg)
    loss_s = _window_loss(gm_s, frames, cam, mcfg, rcfg)
    results = ranks.results()
    for r in results[1:]:
        _assert_maps_bitwise(results[0]["map"], r["map"])
    assert results[0]["all_reduce"] == CONV_STEPS
    loss_m = _window_loss(gaussian_map_from_numpy(results[0]["map"], device="cpu"), frames, cam,
                          mcfg, rcfg)
    assert loss_s < 0.8 * loss0, (loss_s, loss0)
    assert loss_m < 0.8 * loss0, (loss_m, loss0)
    assert loss_m < 1.2 * loss_s + 1e-3, (loss_m, loss_s)
