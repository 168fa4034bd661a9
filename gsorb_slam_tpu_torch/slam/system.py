"""The RGB-D SLAM System: the per-frame orchestration (counterpart of
``gsorb_slam_tpu/slam/system.py`` for ``frontend="render"``).

Equivalent of ``System`` / ``Tracking::TrackWithGaussian``
(``src/System.cc:34-229``, ``src/Tracking.cc:293-451``). Per frame:

1. motion-model pose prediction,
2. tracking-by-rendering (``slam/tracking.py``: K2f, K1 / K7 / K8, K2b),
3. the keyframe decision by novel-view overlap or frame gap,
4. prune, a render at the tracked pose (K3) and densification,
5. the optimization window (``slam/window.py``) and ``numIters`` mapping
   Adam steps over it (``slam/mapping.py``: K4, K5).

One host loop drives the device work, as in the JAX package; the keyframe
images and cached tile bins live in fixed device pools, allocated once, so
window assembly is a gather on the device. Bins are built once per frame at
the tracked pose and again after densification (the window's current frame);
cached keyframe bins refresh round-robin when older than ``bins_ttl``
frames, and unconditionally after a compaction or a recycling densify.

Randomness: a numpy ``default_rng(seed)`` for the keyframe reference points
and the window's random fill, as in the JAX package, and a CPU
``torch.Generator`` seeded from ``seed`` for the mapping iterations' frame
draws, all drawn through :meth:`System._mapping_draws`.

Multi-device (``use_mesh=True``): one System per rank of an initialised
``torch.distributed`` process group, every rank fed the same frames. With
more than one rank, tracking is tile-sharded
(``parallel.tracking.parallel_track_frame``) and the window mapping after
the first frame is data-parallel (``parallel.mesh.parallel_window_step``:
the window padded to a multiple of the ranks, one frame per rank per Adam
step, one gradient ``all_reduce``); the paired tracking view is stripped
(the sharded tracking shards square tiles). With one rank, or no process
group, the System keeps the single-device path, as the JAX System does on
one device.

The ORB frontend (``frontend="orb"``), loop closing and the monocular and
stereo entry points are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import SystemConfig, load_config
from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy
from gsorb_slam_tpu_torch.parallel import mesh as PM
from gsorb_slam_tpu_torch.parallel import tracking as PT
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians, tile_grid_shape
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.tiled import render_binned
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.slam import mapping as M
from gsorb_slam_tpu_torch.slam import tracking as T
from gsorb_slam_tpu_torch.slam import window as W
from gsorb_slam_tpu_torch.splat.gaussians import (
    PARAM_NAMES,
    GaussianMap,
    compact,
    empty_map,
    prefix_view,
    prefix_writeback,
    prune_to_budget,
)


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    T_cw: np.ndarray
    is_keyframe: bool
    track_loss: float
    track_iters: int


@dataclasses.dataclass
class _ForcedTrackResult:
    """Stand-in track result when a pose is injected (``gt_pose``)."""

    T_cw: np.ndarray
    loss: float = 0.0
    n_iters: int = 0


class System:
    """The reference ``System`` facade for RGB-D, tracking by rendering from
    the motion model (the reference's own fallback when ORB fails,
    ``src/Tracking.cc:339-350``). Runs on ``device`` (the card by default)."""

    @staticmethod
    def default_raster_config(width: int = 320) -> RasterConfig:
        """The production raster configuration, the JAX package's field for
        field: tile 16, render / mapping capacity 2048, tracking capacity
        512, chunk 256, dilate 2 px up to 400 px of width and 4 px above (the
        same pose drift between rebins is twice the pixels at VGA), fast
        stop. The bf16 and per-step layout fields only shape the TPU
        kernels; the port computes in float32."""
        return RasterConfig(
            tile=16, tile_capacity=2048, track_tile_capacity=512,
            max_dup=16, chunk=256, chunk_unroll=2, fused_tiles_per_step=4,
            dilate_px=2.0 if width <= 400 else 4.0,
            exact_stop=False,
            blend_bf16=True,
            elem_bf16=True,
        )

    def __init__(
        self,
        config: SystemConfig | str | dict,
        max_keyframes: int = 128,
        raster: Optional[RasterConfig] = None,
        bins_ttl: int = 10,
        bins_refresh_per_frame: int = 3,
        seed: int = 0,
        frontend: str = "render",
        use_mesh: bool = False,
        device: torch.device | str = "cuda",
    ):
        if frontend != "render":
            raise NotImplementedError(f"frontend={frontend!r}: only 'render' is ported")
        self.device = torch.device(device)
        self.cfg = config if isinstance(config, SystemConfig) else load_config(config)
        cc = self.cfg.camera
        self.cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width,
                          height=cc.height)
        self.rcfg = raster or System.default_raster_config(self.cam.width)
        # The multi-device path, on only with more than one rank (the JAX
        # System's len(jax.devices()) > 1).
        self.mesh: Optional[PM.Mesh] = None
        if use_mesh and dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            self.mesh = PM.make_mesh()
        # The tracking view: its own capacity and, with paired=True, 16x8
        # rect tiles (not with the mesh: it shards square tiles); mapping
        # and renders keep the square grid.
        self.rcfg_t = T.tracking_raster_config(
            self.rcfg if self.mesh is None else dataclasses.replace(self.rcfg, paired=False))
        self.gm: GaussianMap = empty_map(self.cfg.mapping.max_gaussians, device=self.device)
        self.rng = np.random.default_rng(seed)
        self._map_gen = torch.Generator().manual_seed(seed)
        # Raises the smallest prefix bucket (see _prefix_bucket).
        self.prefix_bucket_floor = 0

        self.max_keyframes = max_keyframes
        self.bins_ttl = bins_ttl
        self.bins_refresh_per_frame = bins_refresh_per_frame

        # Device keyframe pools (uint8 colors to quarter the footprint).
        H, Wd = self.cam.height, self.cam.width
        ty, tx = tile_grid_shape(self.cam, self.rcfg)
        cap = self.rcfg.tile_capacity
        dev = self.device
        self._kf_colors = torch.zeros((max_keyframes, H, Wd, 3), dtype=torch.uint8, device=dev)
        self._kf_depths = torch.zeros((max_keyframes, H, Wd), dtype=torch.float32, device=dev)
        self._kf_bins_idx = torch.full((max_keyframes, ty * tx, cap), -1, dtype=torch.int32,
                                       device=dev)
        self._kf_bins_cnt = torch.zeros((max_keyframes, ty * tx), dtype=torch.int32, device=dev)

        self.keyframes: list[W.KeyFrameMeta] = []
        self.last_kf: Optional[W.KeyFrameMeta] = None  # most recent KF meta
        self._kf_created = 0  # monotonic count of keyframes ever created
        self._last_compact_frame = -1
        # Last frame where densify recycled dead slots below the high-water
        # mark: bins cached before it may index a recycled row.
        self._last_recycle_frame = -1
        self.trajectory: list[FrameRecord] = []
        self.frame_id = 0
        self.last_kf_frame_id = -(10**9)
        self.velocity = np.eye(4, dtype=np.float32)  # T_cur_prev motion model
        self.last_T_cw = np.eye(4, dtype=np.float32)
        self.max_frames_between_kf = int(self.cfg.camera.fps)

        self.timings = {
            "track": 0.0, "map": 0.0, "n_track": 0, "n_map": 0,
            "frontend": 0.0, "kf": 0.0, "n_kf": 0,
        }
        # Kernel build seconds during this System's life (the port's only
        # compile; see shutdown_summary).
        self._build_s_at_init = _build.build_seconds_total
        self.loop_events: list[tuple[int, int, int]] = []
        self.densify_added: list[int] = []  # per-frame splat add counts
        # (kept, dropped) instance counts per binning episode (device scalars).
        self._bin_stats: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._profiler: Optional[torch.profiler.profile] = None  # start_trace
        self._trace_dir = ""

    # ------------------------------------------------------------ device ops

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefix_bucket(self) -> int:
        """Power-of-two bucket over the live prefix, at least 2^14 (or
        ``prefix_bucket_floor``): render-path work scales with it, not with
        the map's capacity."""
        n = int(self.gm.count)
        b = max(1 << 14, int(self.prefix_bucket_floor))
        while b < n:
            b *= 2
        return min(b, self.gm.capacity)

    def _preprocess(self, gm: GaussianMap, T_cw: np.ndarray):
        return preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities, gm.log_scales,
                          gm.active, self._t(T_cw), self.cam, self.cfg.mapping.scale_modifier)

    def _bin(self, T_cw: np.ndarray, rcfg: Optional[RasterConfig] = None) -> TileBins:
        """Bins of the live prefix at ``T_cw`` in the render view (each such
        episode records its kept and dropped instances) or in ``rcfg``."""
        with torch.no_grad():
            prep = self._preprocess(prefix_view(self.gm, self._prefix_bucket()), T_cw)
            bins = bin_gaussians(prep, self.cam, rcfg or self.rcfg)
        if rcfg is None:
            self._bin_stats.append((bins.counts.sum(), bins.n_dropped))
        return bins

    def _bin_track(self, T_cw: np.ndarray) -> TileBins:
        """Bins in the tracking view; its tighter capacity truncates on
        purpose, so it stays out of the truncation telemetry."""
        if self.rcfg_t == self.rcfg:
            return self._bin(T_cw)
        return self._bin(T_cw, self.rcfg_t)

    def _render(self, T_cw: np.ndarray, bins: TileBins) -> RenderOutput:
        with torch.no_grad():
            prep = self._preprocess(prefix_view(self.gm, self._prefix_bucket()), T_cw)
            return render_binned(prep, bins, self.cam, self.rcfg,
                                 bg=self.cfg.mapping.background_color)

    def _track(self, T_init: np.ndarray, color, depth, matches, bins, n_iters: int):
        """Track one frame; with the mesh tile-sharded (it bins its own
        strips, ``bins`` is None)."""
        with torch.no_grad():
            gm = prefix_view(self.gm, self._prefix_bucket())
            if self.mesh is not None:
                return PT.parallel_track_frame(
                    gm, self._t(T_init), color, depth, matches, self.cam, self.cfg.tracking,
                    self.rcfg_t, self.mesh, num_iters=n_iters,
                    scale_modifier=self.cfg.mapping.scale_modifier,
                )
            return T.track_frame(
                gm, self._t(T_init), color, depth, matches, self.cam, self.cfg.tracking,
                self.rcfg_t, num_iters=n_iters, bins=bins,
                scale_modifier=self.cfg.mapping.scale_modifier,
            )

    def _mapping_draws(self, n_iters: int, n_frames: int) -> list[int]:
        """The window frame of each of ``n_iters`` mapping iterations, drawn
        uniformly from the System's generator."""
        n = max(int(n_frames), 1)
        return torch.randint(0, n, (n_iters,), generator=self._map_gen).tolist()

    def _map(self, frames: M.WindowFrames, n_iters: int, init_mode: bool) -> torch.Tensor:
        """``n_iters`` mapping iterations over the live prefix; the map is
        written back in place of ``self.gm``. With the mesh, the window
        mapping after the first frame is data-parallel instead."""
        if self.mesh is not None and not init_mode:
            return self._map_window_mesh(frames, n_iters)
        budget = M.window_chunk_budget(frames.bins_counts, self.rcfg.chunk)
        draws = self._mapping_draws(n_iters, frames.n_frames)
        with torch.no_grad():
            gm_p, losses = M.map_window(
                prefix_view(self.gm, self._prefix_bucket()), frames, draws, self.cam,
                self.cfg.mapping, self.rcfg, init_mode=init_mode, chunk_budget=budget,
            )
            self.gm = prefix_writeback(self.gm, gm_p)
        return losses

    def _map_window_mesh(self, frames: M.WindowFrames, n_iters: int) -> torch.Tensor:
        """Data-parallel mapping over the whole map (the JAX System's
        ``_map_window_mesh``): pad the window to a multiple of the ranks with
        copies of its first frame, shard it and run ``n_iters`` batched
        steps, step ``it`` on each rank's frame ``it % local_count``. As in
        the JAX package, the slots past ``n_frames`` (pool slot 0 at the
        identity pose) are rendered like live frames."""
        pad = (-frames.colors.shape[0]) % self.mesh.size
        if pad:
            rep = lambda a: torch.cat([a, a[:1].repeat((pad,) + (1,) * (a.ndim - 1))])
            frames = M.WindowFrames(
                colors=rep(frames.colors), depths=rep(frames.depths), poses=rep(frames.poses),
                bins_indices=rep(frames.bins_indices), bins_counts=rep(frames.bins_counts),
                n_frames=frames.n_frames,
            )
        gm = PM.replicate_map(self.gm, self.mesh)
        local = PM.shard_frames(frames, self.mesh)
        aux = PM.window_pack_aux(local, gm.capacity)
        losses = []
        with torch.no_grad():
            for it in range(n_iters):
                gm, loss = PM.parallel_window_step(gm, local, self.mesh, self.cam,
                                                   self.cfg.mapping, self.rcfg, local_idx=it,
                                                   pack_aux=aux)
                losses.append(loss)
        self.gm = gm
        return torch.stack(losses)

    def _gather_window(self, win_ids: list[int], color, depth, T_cw: np.ndarray,
                       cur_bins: TileBins) -> M.WindowFrames:
        """The window: the current frame, then the pool keyframes ``win_ids``,
        padded to ``window_size`` with pool slot 0 and identity poses."""
        pad = max(0, (self.cfg.mapping.window_size - 1) - len(win_ids))
        ids = torch.as_tensor(np.pad(np.asarray(win_ids, np.int64), (0, pad)),
                              device=self.device)
        kf_poses = np.stack([self.keyframes[i].T_cw for i in win_ids]
                            + [np.eye(4, dtype=np.float32)] * pad).astype(np.float32)
        return M.WindowFrames(
            colors=torch.cat([color[None], self._kf_colors[ids].to(torch.float32) / 255.0]),
            depths=torch.cat([depth[None], self._kf_depths[ids]]),
            poses=torch.cat([self._t(T_cw)[None], self._t(kf_poses)]),
            bins_indices=torch.cat([cur_bins.indices[None], self._kf_bins_idx[ids]]),
            bins_counts=torch.cat([cur_bins.counts[None], self._kf_bins_cnt[ids]]),
            n_frames=1 + len(win_ids),
        )

    # ------------------------------------------------------------- keyframes

    def _create_keyframe(self, color, depth, T_cw: np.ndarray) -> W.KeyFrameMeta:
        kf_id = self._kf_created
        if kf_id >= self.max_keyframes:
            # Pool full: round-robin over the non-anchor slots, driven by the
            # monotonic creation counter.
            kf_id = 4 + ((self._kf_created - self.max_keyframes) % (self.max_keyframes - 4))
        self._kf_created += 1
        ref_pts = W.sample_reference_points(
            depth.cpu().numpy(), self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            n_points=self.cfg.tracking.n_ref_points, rng=self.rng,
        )
        meta = W.KeyFrameMeta(kf_id=kf_id, frame_id=self.frame_id,
                              T_cw=np.asarray(T_cw, np.float32), ref_points_cam=ref_pts)
        self._kf_colors[kf_id] = torch.clamp(color * 255.0, 0, 255).to(torch.uint8)
        self._kf_depths[kf_id] = depth
        if kf_id < len(self.keyframes):
            self.keyframes[kf_id] = meta
        else:
            self.keyframes.append(meta)
        self.last_kf = meta
        self.last_kf_frame_id = self.frame_id
        return meta

    def _refresh_kf_bins(self, kf_ids: list[int]) -> None:
        """Rebuild cached bins: unconditionally those built before the last
        compaction or recycling densify (their splat rows moved), and up to
        ``bins_refresh_per_frame`` of those older than ``bins_ttl``, oldest
        first."""
        stale_event = max(self._last_compact_frame, self._last_recycle_frame)
        invalid = [i for i in kf_ids if self.keyframes[i].bins_built_at <= stale_event]
        stale = [
            i for i in kf_ids
            if i not in set(invalid)
            and self.frame_id - self.keyframes[i].bins_built_at > self.bins_ttl
        ]
        stale.sort(key=lambda i: self.keyframes[i].bins_built_at)
        for i in invalid + stale[: self.bins_refresh_per_frame]:
            kf = self.keyframes[i]
            bins = self._bin(kf.T_cw)
            self._kf_bins_idx[i] = bins.indices
            self._kf_bins_cnt[i] = bins.counts
            kf.bins_built_at = self.frame_id

    def _invalidate_all_bins(self) -> None:
        for kf in self.keyframes:
            kf.bins_built_at = -(10**9)

    # ----------------------------------------------------------------- track

    def track_rgbd(
        self,
        rgb,
        depth,
        timestamp: float = 0.0,
        matches: Optional[T.FeatureMatches] = None,
        gt_pose: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Process one RGB-D frame (``rgb [H, W, 3]`` in [0, 1], ``depth
        [H, W]`` meters, numpy arrays or tensors); returns the estimated T_cw
        ``[4, 4]``.

        ``gt_pose`` (evaluation harnesses only) skips the pose optimization
        and runs keyframing, densify and mapping at the given T_cw."""
        color = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        if matches is None:
            matches = T.FeatureMatches.empty(8, device=self.device)
        if self.frame_id == 0:
            T_cw = (np.eye(4, dtype=np.float32) if gt_pose is None
                    else np.asarray(gt_pose, np.float32))
            self._initialize(color, d, T_cw)
        else:
            T_cw = self._track_and_map(color, d, matches, forced_pose=gt_pose)
        self.last_T_cw = T_cw
        self.trajectory[-1].timestamp = timestamp
        self.frame_id += 1
        return T_cw

    def _initialize(self, color, depth, T_cw: np.ndarray) -> None:
        """Frame 0: dense seed and warm-up (``StereoInitialization`` ->
        ``Render::InitWorld``, ``src/Tracking.cc:741-830``)."""
        t0 = time.perf_counter()
        with torch.no_grad():
            self.gm = M.seed_from_frame(self.gm, color, depth, self._t(T_cw), self.cam,
                                        self.cfg.mapping)
        bins = self._bin(T_cw)
        frames = M.WindowFrames(
            colors=color[None], depths=depth[None], poses=self._t(T_cw)[None],
            bins_indices=bins.indices[None], bins_counts=bins.counts[None], n_frames=1,
        )
        self._map(frames, self.cfg.mapping.init_iters, init_mode=True)
        self._create_keyframe(color, depth, T_cw)
        self._refresh_kf_bins([self.last_kf.kf_id])
        self._sync()
        self.timings["map"] += time.perf_counter() - t0
        self.timings["n_map"] += 1
        self.trajectory.append(FrameRecord(self.frame_id, 0.0, T_cw, True, 0.0, 0))

    def _track_and_map(self, color, depth, matches, forced_pose=None) -> np.ndarray:
        cfg = self.cfg
        # Motion model (Tracking::TrackWithMotionModel's seed).
        T_init = (self.velocity @ self.last_T_cw).astype(np.float32)
        t0 = time.perf_counter()
        if forced_pose is not None:
            T_cw = np.asarray(forced_pose, np.float32)
            res = _ForcedTrackResult(T_cw=T_cw)
        else:
            bins = None if self.mesh is not None else self._bin_track(T_init)
            res = self._track(T_init, color, depth, matches, bins, cfg.tracking.num_iters)
            T_cw = res.T_cw.cpu().numpy()
        if not np.isfinite(T_cw).all():
            # Diverged tracking: keep the motion-model prediction rather than
            # poisoning the trajectory (src/Tracking.cc:699-707's analog).
            T_cw = np.asarray(T_init, np.float32)
        self.timings["track"] += time.perf_counter() - t0
        self.timings["n_track"] += 1
        self.velocity = (T_cw @ np.linalg.inv(self.last_T_cw)).astype(np.float32)

        # Keyframe decision: novel-view overlap or the frame gap.
        ref_kf = self.last_kf
        is_kf = False
        if ref_kf is not None:
            novel = W.need_new_keyframe_visual(
                ref_kf, T_cw, self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
                self.cam.width, self.cam.height, cfg.tracking.overlap_threshold,
            )
            is_kf = novel or (self.frame_id - self.last_kf_frame_id >= self.max_frames_between_kf)
        if is_kf:
            t_kf = time.perf_counter()
            self._create_keyframe(color, depth, T_cw)
            self.timings["kf"] += time.perf_counter() - t_kf
            self.timings["n_kf"] += 1

        t0 = time.perf_counter()
        # Periodic prune (mask only: cached bins stay valid); near capacity
        # every frame, with a budget prune so densify finds free rows.
        near_cap = int(self.gm.n_active()) > 0.85 * self.gm.capacity
        if self.frame_id % cfg.mapping.prune_every == 0 or near_cap:
            self.gm = M.prune_map(self.gm, cfg.mapping)
            if near_cap:
                self.gm = prune_to_budget(self.gm, target_frac=0.8)
                self.timings["n_budget_prune"] = self.timings.get("n_budget_prune", 0) + 1
        # Compaction permutes splat rows: every cached bin is stale after it.
        if int(self.gm.count) > 0.9 * self.gm.capacity:
            self.gm = compact(self.gm)
            self._invalidate_all_bins()
            self._last_compact_frame = self.frame_id

        # Render at the tracked pose with fresh full-capacity bins, then
        # densify outside the bin-saturated tiles.
        bins = self._bin(T_cw)
        out = self._render(T_cw, bins)
        # Dead rows below the high-water mark fill first: adds then make
        # older cached bins stale.
        dead_below_hwm = int(self.gm.count) - int(self.gm.n_active())
        with torch.no_grad():
            self.gm, n_added = M.densify_frame(
                self.gm, out, color, depth, self._t(T_cw), self.cam, cfg.mapping,
                sat_tiles=bins.counts >= self.rcfg.tile_capacity, rcfg=self.rcfg,
            )
        n_added = int(n_added)
        if dead_below_hwm > 0 and n_added > 0:
            self._last_recycle_frame = self.frame_id
        self.densify_added.append(n_added)

        # Window selection and mapping.
        sel = W.select_window(
            self.keyframes, ref_kf, self.frame_id,
            self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            self.cam.width, self.cam.height, self.rng,
            n_covis=cfg.mapping.covis_window,
            n_random_fill=cfg.mapping.window_size - cfg.mapping.covis_window,
            n_recent_ba=cfg.mapping.recent_ba_window,
            n_anchor=cfg.mapping.anchor_frames,
        )
        win_ids = sel.kf_ids[: cfg.mapping.window_size - 1]
        self._refresh_kf_bins(win_ids)
        # Fresh bins after densify: the window's current frame must see the
        # new splats.
        cur_bins = self._bin(T_cw)
        frames = self._gather_window(win_ids, color, depth, T_cw, cur_bins)
        self._map(frames, cfg.mapping.num_iters, init_mode=False)
        self._sync()
        self.timings["map"] += time.perf_counter() - t0
        self.timings["n_map"] += 1

        self.trajectory.append(
            FrameRecord(self.frame_id, 0.0, T_cw, is_kf, float(res.loss), int(res.n_iters))
        )
        return T_cw

    def reset(self) -> None:
        """``System::Reset`` (``src/System.cc``, ``Tracking::Reset``) for the
        render frontend: drop the map, the keyframes, the trajectory, the
        motion model and the run's statistics. The keyframe pools are zeroed
        in place (no new allocation). The config, camera, device, timings,
        the built kernels, the process group (``use_mesh``) and the random
        state survive, as in the JAX package (its key is not reset either):
        the next ``track_rgbd`` starts a fresh session."""
        self.gm = empty_map(self.cfg.mapping.max_gaussians, device=self.device)
        self._kf_colors.zero_()
        self._kf_depths.zero_()
        self._kf_bins_idx.fill_(-1)
        self._kf_bins_cnt.zero_()
        self.keyframes = []
        self.last_kf = None
        self._kf_created = 0
        self._last_compact_frame = -1
        self._last_recycle_frame = -1
        self.trajectory = []
        self.frame_id = 0
        self.last_kf_frame_id = -(10**9)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_T_cw = np.eye(4, dtype=np.float32)
        self.loop_events = []
        self.densify_added = []
        self._bin_stats = []

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, path: str) -> None:
        """Mid-run checkpoint in the JAX package's format (``gaussians.npz``:
        splat parameters and Adam state; ``state.pkl``: keyframe graph,
        motion model and trajectory; ``kf_pools.npz``: keyframe images), so a
        checkpoint of either package loads into the other."""
        os.makedirs(path, exist_ok=True)
        gm = self.gm
        host = lambda x: x.detach().cpu().numpy()
        np.savez_compressed(
            os.path.join(path, "gaussians.npz"),
            **{k: host(getattr(gm, k)) for k in PARAM_NAMES},
            **{k: host(getattr(gm, k))
               for k in ("active", "count", "adam_t", "scene_radius", "max_z")},
            **{f"m_{k}": host(v) for k, v in gm.adam_m.items()},
            **{f"v_{k}": host(v) for k, v in gm.adam_v.items()},
        )
        meta = {
            "frame_id": self.frame_id,
            "last_kf_frame_id": self.last_kf_frame_id,
            "velocity": self.velocity,
            "last_T_cw": self.last_T_cw,
            "kf_created": self._kf_created,
            "last_kf_id": self.last_kf.kf_id if self.last_kf is not None else -1,
            "loop_events": self.loop_events,
            "keyframes": [
                dict(kf_id=kf.kf_id, frame_id=kf.frame_id, T_cw=kf.T_cw,
                     ref_points_cam=kf.ref_points_cam, rendered_num=kf.rendered_num,
                     fe_kf_id=kf.fe_kf_id)
                for kf in self.keyframes
            ],
            "frontend": None,
            "trajectory": [
                dict(frame_id=r.frame_id, timestamp=r.timestamp, T_cw=r.T_cw,
                     is_keyframe=r.is_keyframe, track_loss=r.track_loss,
                     track_iters=r.track_iters)
                for r in self.trajectory
            ],
        }
        with open(os.path.join(path, "state.pkl"), "wb") as f:
            pickle.dump(meta, f)
        np.savez_compressed(os.path.join(path, "kf_pools.npz"), colors=host(self._kf_colors),
                            depths=host(self._kf_depths))

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` state (this package's or the JAX
        package's, render frontend) and continue tracking. Cached keyframe
        bins are rebuilt at first use."""
        z = np.load(os.path.join(path, "gaussians.npz"))
        self.gm = gaussian_map_from_numpy(
            {**{k: z[k] for k in (*PARAM_NAMES, "active", "count", "adam_t", "scene_radius",
                                  "max_z")},
             "adam_m": {k: z[f"m_{k}"] for k in PARAM_NAMES},
             "adam_v": {k: z[f"v_{k}"] for k in PARAM_NAMES}},
            device=self.device,
        )
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            meta = pickle.load(f)
        if meta.get("frontend") is not None:
            raise NotImplementedError("the checkpoint holds ORB frontend state (not ported)")
        self.frame_id = meta["frame_id"]
        self.last_kf_frame_id = meta["last_kf_frame_id"]
        self.velocity = np.asarray(meta["velocity"], np.float32)
        self.last_T_cw = np.asarray(meta["last_T_cw"], np.float32)
        self._kf_created = meta.get("kf_created", len(meta["keyframes"]))
        self.loop_events = meta.get("loop_events", [])
        self.keyframes = [
            W.KeyFrameMeta(kf_id=d["kf_id"], frame_id=d["frame_id"], T_cw=d["T_cw"],
                           ref_points_cam=d["ref_points_cam"], rendered_num=d["rendered_num"],
                           fe_kf_id=d.get("fe_kf_id", -1))
            for d in meta["keyframes"]
        ]
        last_kf_id = meta.get("last_kf_id", -1)
        self.last_kf = (
            self.keyframes[last_kf_id] if 0 <= last_kf_id < len(self.keyframes)
            else (self.keyframes[-1] if self.keyframes else None)
        )
        self.trajectory = [
            FrameRecord(frame_id=d["frame_id"], timestamp=d["timestamp"], T_cw=d["T_cw"],
                        is_keyframe=d["is_keyframe"], track_loss=d["track_loss"],
                        track_iters=d["track_iters"])
            for d in meta["trajectory"]
        ]
        pools = np.load(os.path.join(path, "kf_pools.npz"))
        self._kf_colors = torch.as_tensor(pools["colors"], device=self.device)
        self._kf_depths = torch.as_tensor(pools["depths"], device=self.device)
        self._invalidate_all_bins()

    # ------------------------------------------------------------------ eval

    def get_trajectory(self) -> list[tuple[float, np.ndarray]]:
        return [(r.timestamp, r.T_cw) for r in self.trajectory]

    def render_view(self, T_cw: np.ndarray) -> RenderOutput:
        """Render any pose (the ``Render::Viwer`` hook, ``src/Render.cc:179-193``)."""
        return self._render(T_cw, self._bin(T_cw))

    # --------------------------------------------------------- observability

    def start_trace(self, log_dir: str) -> None:
        """Begin a trace with ``torch.profiler`` (host ops, and the CUDA
        kernels on the card): the structured upgrade of the reference's
        chrono counters (``src/Render.cc:34-41``). :meth:`stop_trace` writes it."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace_dir = log_dir
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def stop_trace(self) -> str:
        """End the trace that :meth:`start_trace` began and write it into its
        ``log_dir`` as a Chrome trace (chrome://tracing, Perfetto); returns
        the file's path."""
        prof, self._profiler = self._profiler, None
        self._sync()
        prof.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path

    def shutdown_summary(self) -> dict:
        """The timing and statistics contract of ``SavePlyAndPrintTime``
        (``src/Render.cc:167-174``). ``compile_s`` is the kernel build time
        during this System's life (its first frame pays it)."""
        t = self.timings
        return {
            "total_gaussians": int(self.gm.n_active()),
            "avg_tracking_s": t["track"] / max(t["n_track"], 1),
            "avg_mapping_s": t["map"] / max(t["n_map"], 1),
            "total_tracking_s": t["track"],
            "total_mapping_s": t["map"],
            "total_frontend_s": t["frontend"],
            "total_kf_chain_s": t["kf"],
            "compile_s": round(_build.build_seconds_total - self._build_s_at_init, 3),
            "avg_kf_chain_s": t["kf"] / max(t["n_kf"], 1),
            "n_keyframes": len(self.keyframes),
            "n_frames": self.frame_id,
            "densify_added_mean": (
                float(np.mean(self.densify_added)) if self.densify_added else 0.0
            ),
            "densify_added_max": int(np.max(self.densify_added)) if self.densify_added else 0,
            "capacity_frac": float(int(self.gm.count) / self.gm.capacity),
            **self._bin_truncation_stats(),
        }

    def _bin_truncation_stats(self) -> dict:
        """The share of tile instances dropped past the per-tile capacity
        over every render-view binning episode (the CUDA pipeline's dynamic
        ranges never drop; ``rasterizer_impl.cu:117-139``)."""
        if not self._bin_stats:
            return {"bin_instances_total": 0, "bin_dropped_total": 0, "bin_dropped_frac": 0.0}
        kept = int(sum(int(k) for k, _ in self._bin_stats))
        dropped = int(sum(int(d) for _, d in self._bin_stats))
        return {
            "bin_instances_total": kept + dropped,
            "bin_dropped_total": dropped,
            "bin_dropped_frac": dropped / max(kept + dropped, 1),
        }
