"""The RGB-D SLAM System: the per-frame orchestration (counterpart of
``gsorb_slam_tpu/slam/system.py`` for RGB-D input).

Equivalent of ``System`` / ``Tracking::TrackWithGaussian``
(``src/System.cc:34-229``, ``src/Tracking.cc:293-451``). Per frame:

1. motion-model pose prediction; with ``frontend="orb"`` the geometric
   frontend (``slam/geometric.py``) refines it by ORB matching against the
   local map, and its inlier matches enter the tracking loss as the
   reprojection term,
2. tracking-by-rendering (``slam/tracking.py``: K2f, K1 / K7 / K8, K2b),
3. the keyframe decision by novel-view overlap, frame gap or (ORB) weak
   matching; an ORB keyframe runs the frontend's local mapping and loop
   closing (``slam/loop.py``: BoW detection, Sim3 verification, essential-
   graph correction, SearchAndFuse and a global BA),
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

With ``frontend="orb"``, 3 frames in a row without an ORB pose spend the
lost-mode tracking budget and try relocalization (BoW candidates and
PnP). The loop closer runs when ``Debug.useLoop`` is set, with the
packaged vocabulary unless one is passed. The monocular and stereo entry
points are not ported yet and raise.
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
from gsorb_slam_tpu_torch.core.camera import Camera, Distortion
from gsorb_slam_tpu_torch.core.config import SystemConfig, load_config
from gsorb_slam_tpu_torch.frontend.orb import ORBFeatures
from gsorb_slam_tpu_torch.interop import frontend_state_from_numpy, gaussian_map_from_numpy
from gsorb_slam_tpu_torch.parallel import mesh as PM
from gsorb_slam_tpu_torch.parallel import tracking as PT
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians, tile_grid_shape
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.tiled import render_binned
from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.slam import mapping as M
from gsorb_slam_tpu_torch.slam import tracking as T
from gsorb_slam_tpu_torch.slam import window as W
from gsorb_slam_tpu_torch.slam.geometric import FrontendResult, GeometricFrontend
from gsorb_slam_tpu_torch.slam.loop import LoopCloser
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
    """The reference ``System`` facade for RGB-D. ``frontend="render"``
    tracks by rendering from the motion model (the reference's own fallback
    when ORB fails, ``src/Tracking.cc:339-350``); ``frontend="orb"`` seeds
    each frame with the geometric frontend's pose and matches. Runs on
    ``device`` (the card by default)."""

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
        frontend: str = "render",  # "render" | "orb"
        vocabulary=None,  # frontend.vocab.Vocabulary for loop closing
        use_mesh: bool = False,
        device: torch.device | str = "cuda",
    ):
        if frontend not in ("render", "orb"):
            raise ValueError(f"frontend={frontend!r}: 'render' or 'orb'")
        self.device = torch.device(device)
        self.cfg = config if isinstance(config, SystemConfig) else load_config(config)
        cc = self.cfg.camera
        self.cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width,
                          height=cc.height)
        self.frontend_mode = frontend
        self.fe: Optional[GeometricFrontend] = None
        self.loop_closer: Optional[LoopCloser] = None
        if frontend == "orb":
            self.fe = self._new_frontend()
            if vocabulary is None and self.cfg.debug.use_loop:
                # System::System loads the vocabulary at start
                # (src/System.cc:86-96): the packaged synthetic-domain one.
                from gsorb_slam_tpu_torch.frontend.vocab import default_vocabulary

                vocabulary = default_vocabulary()
            if vocabulary is not None and self.cfg.debug.use_loop:
                self.loop_closer = LoopCloser(vocabulary)
        self._lost_streak = 0
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

    def _new_frontend(self) -> GeometricFrontend:
        cc = self.cfg.camera
        return GeometricFrontend(
            self.cam, self.cfg.orb, th_depth=cc.bf / cc.fx * cc.th_depth,
            dist=Distortion(k1=cc.k1, k2=cc.k2, p1=cc.p1, p2=cc.p2, k3=cc.k3), bf=cc.bf,
            device=self.device,
        )

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

    def _create_keyframe(self, color, depth, T_cw: np.ndarray,
                         fe_kf_id: int = -1) -> W.KeyFrameMeta:
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
                              T_cw=np.asarray(T_cw, np.float32), ref_points_cam=ref_pts,
                              fe_kf_id=fe_kf_id)
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

    # --------------------------------------------------------- orb frontend

    def _sync_frontend_poses(self) -> None:
        """Copy the frontend's BA-refined keyframe poses into the rendering
        keyframes (the shared map: the window selection reads BA'd poses,
        ``src/Render.cc:353-367``), linked by ``fe_kf_id`` (pool slots
        recycle; frontend ids do not), and count local-BA touches."""
        if self.fe is None:
            return
        adjusted = set(self.fe.last_adjusted or [])
        by_fe_id = {fe_kf.kf_id: fe_kf for fe_kf in self.fe.keyframes}
        for meta in self.keyframes:
            fe_kf = by_fe_id.get(meta.fe_kf_id)
            if fe_kf is None:
                continue
            meta.T_cw = np.asarray(fe_kf.T_cw, np.float32)
            if fe_kf.kf_id in adjusted:
                meta.rendered_num += 1

    def _maybe_close_loop(self, fe_kf) -> None:
        """``LoopClosing::Run`` per keyframe (``src/LoopClosing.cc``): add it
        to the database, detect, verify and correct; then SearchAndFuse over
        the query, the match and the query's covisible keyframes (``:590``)
        and a global BA (``RunGlobalBundleAdjustment`` ``:648``); every
        cached keyframe bin is stale after it."""
        lc = self.loop_closer
        if lc is None or self.fe is None:
            return
        lc.add_keyframe(fe_kf)
        recent = {kf.kf_id for kf in self.fe.keyframes if fe_kf.kf_id - kf.kf_id < lc.min_gap}
        cand = lc.detect(fe_kf, recent)
        if cand is None:
            return
        # By kf_id, not list position: keyframe culling leaves holes.
        match_kf = next((kf for kf in self.fe.keyframes if kf.kf_id == cand), None)
        if match_kf is None:
            return
        T_corr = lc.verify(fe_kf, match_kf, self.fe, cam=self.cam)
        if T_corr is None:
            return
        covis = [(fe_kf.kf_id, other_id, float(w))
                 for other_id, w in self.fe.covisibility(fe_kf)[:10]]
        corrected, point_corr = lc.correct(self.fe.keyframes, fe_kf.kf_id, cand, T_corr, covis,
                                           device=self.device)
        for kf in self.fe.keyframes:
            kf.T_cw = corrected[kf.kf_id]
        if point_corr is not None:
            # 7-DoF closure: move each map point through its reference
            # keyframe's old -> new world Sim3 (LoopClosing::CorrectLoop).
            fe = self.fe
            for p in np.nonzero(fe.pt_valid)[0]:
                corr_mat = point_corr.get(int(fe.pt_first_kf[p]))
                if corr_mat is not None:
                    fe.pt_pos[p] = corr_mat[:3, :3] @ fe.pt_pos[p] + corr_mat[:3, 3]
        by_id = {kf.kf_id: kf for kf in self.fe.keyframes}
        for kid in dict.fromkeys([fe_kf.kf_id, cand] + [cid for _q, cid, _w in covis]):
            kf = by_id.get(kid)
            if kf is not None:
                self.fe.fuse_duplicates(kf)
        self.fe.last_adjusted = self.fe.global_ba()
        self._sync_frontend_poses()
        self._invalidate_all_bins()
        lc.last_closed_kf = fe_kf.kf_id
        self.loop_events.append((self.frame_id, fe_kf.kf_id, cand))

    # ----------------------------------------------------------------- track

    def track_rgbd(
        self,
        rgb,
        depth,
        timestamp: float = 0.0,
        matches: Optional[T.FeatureMatches] = None,
        stereo_aux: Optional[dict] = None,
        gt_pose: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Process one RGB-D frame (``rgb [H, W, 3]`` in [0, 1], ``depth
        [H, W]`` meters, numpy arrays or tensors); returns the estimated T_cw
        ``[4, 4]``.

        ``stereo_aux`` may carry the frame's ``feats`` (``ORBFeatures``,
        skipping the extraction) and ``kp_depth`` (per-keypoint depth in
        place of the depth-image lookup) for the ORB frontend. ``gt_pose``
        (evaluation harnesses only) skips the pose optimization and runs
        keyframing, densify and mapping at the given T_cw."""
        color = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        d = torch.as_tensor(depth, dtype=torch.float32, device=self.device)
        match_cap = self.fe.match_capacity if self.fe is not None else 8
        if matches is None:
            matches = T.FeatureMatches.empty(match_cap, device=self.device)
        aux = stereo_aux or {}
        fe_res = None
        depth_np = None
        t_fe = time.perf_counter()
        if self.fe is not None:
            depth_np = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth, np.float32)
            gray = 0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
            if self.frame_id == 0:
                feats0 = aux.get("feats")
                if feats0 is None:
                    feats0 = self.fe._extract(gray)
                T0 = (np.eye(4, dtype=np.float32) if gt_pose is None
                      else np.asarray(gt_pose, np.float32))
                # Frame 0's keyframe belongs to the keyframe-chain timer.
                self.timings["frontend"] += time.perf_counter() - t_fe
                t_kf0 = time.perf_counter()
                kf0 = self.fe.create_keyframe(feats0, depth_np, T0, frame_id=0,
                                              kp_depth=aux.get("kp_depth"))
                # The first keyframe enters the BoW database too.
                if self.loop_closer is not None:
                    self.loop_closer.add_keyframe(kf0)
                self.timings["kf"] += time.perf_counter() - t_kf0
                self.timings["n_kf"] += 1
                t_fe = time.perf_counter()
            else:
                T_pred = (self.velocity @ self.last_T_cw).astype(np.float32)
                fe_res = self.fe.process_frame(gray, T_pred, feats=aux.get("feats"),
                                               kp_ur=aux.get("kp_ur"))
        self.timings["frontend"] += time.perf_counter() - t_fe
        if self.frame_id == 0:
            T_cw = (np.eye(4, dtype=np.float32) if gt_pose is None
                    else np.asarray(gt_pose, np.float32))
            self._initialize(color, d, T_cw, fe_kf_id=0 if self.fe is not None else -1)
        else:
            T_cw = self._track_and_map(color, d, matches, fe_res, depth_np,
                                       kp_depth=aux.get("kp_depth"), forced_pose=gt_pose)
        self.last_T_cw = T_cw
        self.trajectory[-1].timestamp = timestamp
        self.frame_id += 1
        return T_cw

    def _initialize(self, color, depth, T_cw: np.ndarray, fe_kf_id: int = -1) -> None:
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
        self._create_keyframe(color, depth, T_cw, fe_kf_id=fe_kf_id)
        self._refresh_kf_bins([self.last_kf.kf_id])
        self._sync()
        self.timings["map"] += time.perf_counter() - t0
        self.timings["n_map"] += 1
        self.trajectory.append(FrameRecord(self.frame_id, 0.0, T_cw, True, 0.0, 0))

    def _track_and_map(self, color, depth, matches, fe_res: Optional[FrontendResult] = None,
                       depth_np=None, kp_depth=None, forced_pose=None) -> np.ndarray:
        cfg = self.cfg
        # Motion model (Tracking::TrackWithMotionModel's seed), replaced by
        # the ORB-optimized pose when the geometric frontend succeeded
        # (TrackWithMotionModel -> TrackLocalMapWithGaussian).
        T_init = (self.velocity @ self.last_T_cw).astype(np.float32)
        n_track_iters = cfg.tracking.num_iters
        if fe_res is not None:
            if fe_res.T_orb is not None:
                T_init = fe_res.T_orb.astype(np.float32)
                matches = fe_res.matches
                self._lost_streak = 0
            else:
                # ORB lost: the GS tracker takes over with the lost-mode budget
                # (src/Tracking.cc:339-350); after 3 lost frames, relocalize.
                n_track_iters = cfg.tracking.lost_num_iters
                self._lost_streak += 1
                if self._lost_streak >= 3:
                    T_reloc = self.fe.relocalize(
                        fe_res.feats, kfdb=self.loop_closer.db if self.loop_closer else None)
                    if T_reloc is not None:
                        T_init = T_reloc.astype(np.float32)
                        self.velocity = np.eye(4, dtype=np.float32)
                        self._lost_streak = 0
        t0 = time.perf_counter()
        if forced_pose is not None:
            T_cw = np.asarray(forced_pose, np.float32)
            res = _ForcedTrackResult(T_cw=T_cw)
        else:
            bins = None if self.mesh is not None else self._bin_track(T_init)
            res = self._track(T_init, color, depth, matches, bins, n_track_iters)
            T_cw = res.T_cw.cpu().numpy()
        if not np.isfinite(T_cw).all():
            # Diverged tracking: keep the motion-model prediction rather than
            # poisoning the trajectory (src/Tracking.cc:699-707's analog).
            T_cw = np.asarray(T_init, np.float32)
        self.timings["track"] += time.perf_counter() - t0
        self.timings["n_track"] += 1
        self.velocity = (T_cw @ np.linalg.inv(self.last_T_cw)).astype(np.float32)

        # Keyframe decision: novel-view overlap, the frame gap or weak ORB
        # tracking (fewer than 40 inliers, zero included).
        ref_kf = self.last_kf
        is_kf = False
        if ref_kf is not None:
            novel = W.need_new_keyframe_visual(
                ref_kf, T_cw, self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
                self.cam.width, self.cam.height, cfg.tracking.overlap_threshold,
            )
            weak_orb = fe_res is not None and fe_res.n_inliers < 40
            is_kf = novel or weak_orb or (
                self.frame_id - self.last_kf_frame_id >= self.max_frames_between_kf)
        if is_kf:
            t_kf = time.perf_counter()
            fe_kf = None
            if self.fe is not None and fe_res is not None:
                fe_kf = self.fe.create_keyframe(fe_res.feats, depth_np, T_cw, self.frame_id,
                                                kp_depth=kp_depth)
            self._create_keyframe(color, depth, T_cw,
                                  fe_kf_id=fe_kf.kf_id if fe_kf is not None else -1)
            if fe_kf is not None:
                self._sync_frontend_poses()
                self._maybe_close_loop(fe_kf)
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
        """``System::Reset`` (``src/System.cc``, ``Tracking::Reset``): drop the
        map, the keyframes, the trajectory, the motion model, the run's
        statistics and, with the ORB frontend, its map points, keyframes and
        loop database (the vocabulary stays). The keyframe pools are zeroed
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
        self._lost_streak = 0
        self.loop_events = []
        self.densify_added = []
        self._bin_stats = []
        if self.fe is not None:
            self.fe = self._new_frontend()
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(self.loop_closer.db.vocab)

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
            "frontend": self._frontend_state(),
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
        self._restore_frontend(meta.get("frontend"))

    def _frontend_state(self) -> Optional[dict]:
        """The geometric frontend's and the loop closer's state in the JAX
        package's checkpoint format (numpy arrays, descriptors as
        ``np.uint32``), or None without the ORB frontend."""
        fe = self.fe
        if fe is None:
            return None
        n = fe.n_points

        def feats_np(f: ORBFeatures) -> dict:
            out = {k: (v.detach().cpu().numpy() if v is not None else None)
                   for k, v in f._asdict().items()}
            out["descriptors"] = out["descriptors"].view(np.uint32)
            return out

        state = {
            "n_points": n,
            **{k: getattr(fe, k)[:n].copy() for k in ("pt_pos", "pt_desc", "pt_valid",
                                                     "pt_visible", "pt_found", "pt_first_kf")},
            "kf_counter": fe.kf_counter,
            "keyframes": [
                dict(kf_id=kf.kf_id, frame_id=kf.frame_id, feats=feats_np(kf.feats),
                     point_ids=kf.point_ids.copy(), T_cw=kf.T_cw.copy())
                for kf in fe.keyframes
            ],
        }
        if self.loop_closer is not None:
            db = self.loop_closer.db
            state["loop_db"] = {
                "inverted": {w: sorted(s) for w, s in db.inverted.items()},
                "bows": db.bows,
                "consistency": self.loop_closer.consistency,
            }
        return state

    def _restore_frontend(self, state: Optional[dict]) -> None:
        """Load :meth:`_frontend_state`'s dict (this package's or the JAX
        package's) into the frontend and the loop closer."""
        if self.fe is None or state is None:
            return
        frontend_state_from_numpy(state, self.fe, self.loop_closer)

    # ------------------------------------------------------------------ eval

    def get_trajectory(self) -> list[tuple[float, np.ndarray]]:
        return [(r.timestamp, r.T_cw) for r in self.trajectory]

    def render_view(self, T_cw: np.ndarray) -> RenderOutput:
        """Render any pose (the ``Render::Viwer`` hook, ``src/Render.cc:179-193``)."""
        return self._render(T_cw, self._bin(T_cw))

    # --------------------------------------------------------- other sensors

    def track_stereo(self, left, right, timestamp: float = 0.0) -> np.ndarray:
        """The stereo entry point (``System::TrackStereo``): not ported yet."""
        raise NotImplementedError("track_stereo: the stereo entry point is not ported yet")

    def track_monocular(self, image, timestamp: float = 0.0):
        """The monocular entry point (``System::TrackMonocular``): not ported
        yet."""
        raise NotImplementedError("track_monocular: the monocular entry point is not ported yet")

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
        during this System's life (its first frame pays it); ``phase_*`` are
        the ORB frontend's wall seconds per phase."""
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
            # The ORB frontend's wall seconds per phase (fe.* / kf.*).
            **({f"phase_{k}": round(v, 3) for k, v in self.fe.timings.items()}
               if self.fe is not None else {}),
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
