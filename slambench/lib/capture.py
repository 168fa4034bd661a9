"""The benchmark's hooks on the program: wrappers around the module-level
functions the System calls, installed from the benchmark's own files.

They change nothing that the program computes. Each passes its arguments
through and returns what the wrapped function returned. Two things ride on
them:

- **Capture** for the check that decides ``correct``: on the frame the
  seed draws (or the first after it whose ORB frontend reaches its pose
  optimisation), the pose optimisation's inputs and answer
  (``frontend.ba.pose_optimization`` inside ``process_frame``, with its
  keywords: on a stereo frame ``obs_ur`` and ``bf``, the stereo edges) and the
  seed pose and matches that frame's tracking solve was handed; on the
  frame the seed draws, the tracking solve's inputs, every iteration's
  pose, inlier gate, loss and pose gradient, and the pose of each binning episode
  (``tracking.pose_loop``); and one mapping iteration on the window's
  current frame: the map before it (with Adam's moments), its loss and
  gradients, the map after its step, and the map its tile lists were built
  from (``mapping.map_window`` / ``mapping.map_loss_and_grads``). Only
  small device clones are taken, and no value is read on the host.
- **Ranges** for the traced run: ``torch.profiler.record_function`` around
  the calls into the layers (``slambench.track``, ``slambench.map_window``,
  ``slambench.frontend``, ``slambench.kf``, ``slambench.densify``,
  ``slambench.bins``, ``slambench.render``, ``slambench.gather``), so
  that kernels and idle gaps can be charged to the layer the host was in.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from slambench.lib.correctness import track_targets

PARAMS = ("means", "rgb", "quats", "logit_opacities", "log_scales")


def clone_rows(gm: Any, adam: bool = False) -> dict[str, torch.Tensor]:
    """Device clones of a map's rows (and with ``adam`` its moments)."""
    out = {k: getattr(gm, k).detach().clone() for k in PARAMS}
    out["active"] = gm.active.clone()
    out["scene_radius"] = torch.as_tensor(gm.scene_radius).clone()
    if adam:
        out["adam_m"] = {k: v.clone() for k, v in gm.adam_m.items()}
        out["adam_v"] = {k: v.clone() for k, v in gm.adam_v.items()}
        out["adam_t"] = torch.as_tensor(gm.adam_t).clone()
    return out


class Hooks:
    """Install with :meth:`install`, remove with :meth:`remove`."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.trace_ranges = False
        self.track_armed = False
        self.map_armed = False
        self.render_armed = False
        self.fe_armed = False
        self.frontend: Optional[dict] = None  # the captured ORB pose optimisation and seed
        self.track: Optional[dict] = None  # the captured tracking solve
        self.render: Optional[dict] = None  # the captured render (K3) at the tracked pose
        self.map: Optional[dict] = None  # the captured mapping iteration
        self.map_windows: list[dict] = []  # per profiled frame (rooflines)
        self.track_solves: list[dict] = []  # per profiled frame (rooflines)
        self.profiling = False
        self._undo: list[Callable[[], None]] = []
        self._map_iter: Optional[dict] = None
        self._rec: Optional[dict] = None
        self._in_frontend = False
        self._fe_rec: Optional[dict] = None

    # --------------------------------------------------------------- install

    def _patch(self, owner: Any, name: str, make: Callable[[Callable], Callable]) -> None:
        orig = getattr(owner, name)
        setattr(owner, name, functools.wraps(orig)(make(orig)))
        self._undo.append(lambda: setattr(owner, name, orig))

    def install(self) -> None:
        from gsorb_slam_tpu_torch.frontend import ba as BA
        from gsorb_slam_tpu_torch.slam import geometric as G
        from gsorb_slam_tpu_torch.slam import mapping as M
        from gsorb_slam_tpu_torch.slam import system as S
        from gsorb_slam_tpu_torch.slam import tracking as T

        self._patch(T, "track_frame", self._track_frame)
        self._patch(T, "pose_loop", self._pose_loop)
        self._patch(T, "tracking_loss_grad", self._tracking_loss_grad)
        self._patch(M, "map_window", self._map_window)
        self._patch(M, "map_loss_and_grads", self._map_loss_and_grads)
        self._patch(G.GeometricFrontend, "process_frame", self._process_frame)
        self._patch(BA, "pose_optimization", self._pose_optimization)
        self._patch(G.GeometricFrontend, "create_keyframe",
                    lambda f: self._ranged("slambench.kf", f))
        self._patch(M, "densify_frame", lambda f: self._ranged("slambench.densify", f))
        self._patch(S.System, "_bin", lambda f: self._ranged("slambench.bins", f))
        self._patch(S.System, "_render", self._render)
        self._patch(S.System, "_gather_window", lambda f: self._ranged("slambench.gather", f))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _range(self, name: str):
        if self.trace_ranges:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _ranged(self, name: str, f: Callable) -> Callable:
        def wrapped(*a, **kw):
            with self._range(name):
                return f(*a, **kw)
        return wrapped

    # -------------------------------------------------------------- frontend

    def _process_frame(self, f: Callable) -> Callable:
        def wrapped(*a, **kw):
            self._in_frontend = True
            try:
                with self._range("slambench.frontend"):
                    return f(*a, **kw)
            finally:
                self._in_frontend = False
        return wrapped

    def _pose_optimization(self, f: Callable) -> Callable:
        def wrapped(T_init, world, obs_uv, inv_sigma2, valid, cam, *a, **kw):
            res = f(T_init, world, obs_uv, inv_sigma2, valid, cam, *a, **kw)
            if self.fe_armed and self._in_frontend and self._fe_rec is None:
                self._fe_rec = dict(
                    T_pred=T_init.detach().clone(), world=world.clone(), obs_uv=obs_uv.clone(),
                    inv_sigma2=inv_sigma2.clone(), valid=valid.clone(),
                    options=dict(zip(("rounds", "iters_per_round", "damping"), a), **{
                        k: (v.clone() if torch.is_tensor(v) else v) for k, v in kw.items()}),
                    T_cw=res.T_cw.detach().clone(), inliers=res.inliers.clone())
            return res
        return wrapped

    # -------------------------------------------------------------- tracking

    def _track_frame(self, f: Callable) -> Callable:
        def wrapped(gm, T_cw_init, gt_color, gt_depth, matches, cam, tcfg, rcfg, num_iters=None,
                    bins=None, scale_modifier=1.0, rebin_iters=None):
            fe = self._fe_rec
            if fe is not None and "T_seed" not in fe:
                # The tracking solve of the frame whose pose optimisation was
                # captured: the seed and the matches it was handed.
                fe.update(T_seed=T_cw_init.detach().clone(),
                          matches={k: v.clone() for k, v in matches._asdict().items()})
                self.frontend = fe
                self.fe_armed = False
            rec = None
            if self.track_armed or self.profiling:
                rec = dict(rows=clone_rows(gm), T_init=T_cw_init.detach().clone(),
                           color=gt_color.clone(), depth=gt_depth.clone(),
                           matches={k: v.clone() for k, v in matches._asdict().items()},
                           num_iters=int(num_iters or tcfg.num_iters), iters=[], episodes=[],
                           d_screen={}, targets=track_targets(int(num_iters or tcfg.num_iters)))
                self._rec = rec
            with self._range("slambench.track"):
                res = f(gm, T_cw_init, gt_color, gt_depth, matches, cam, tcfg, rcfg,
                        num_iters=num_iters, bins=bins, scale_modifier=scale_modifier,
                        rebin_iters=rebin_iters)
            if rec is not None:
                self._rec = None
                rec.update(T_best=res.T_cw.detach().clone(), best_loss=res.loss.detach().clone(),
                           n_iters=res.n_iters.clone())
                if self.track_armed:
                    self.track = rec
                    self.track_armed = False
                else:
                    self.track_solves.append(rec)
            return res
        return wrapped

    def _pose_loop(self, f: Callable) -> Callable:
        def wrapped(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                    value_and_grad):
            rec = self._rec
            if rec is None:
                return f(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, episode,
                         value_and_grad)

            def ep(T_cw):
                pose = T_cw_init if T_cw is None else T_cw
                rec["episodes"].append((len(rec["iters"]), pose.detach().clone()))
                return episode(T_cw)

            def vg(quat, trans, inliers, *operands):
                loss, gq, gt = value_and_grad(quat, trans, inliers, *operands)
                rec["iters"].append(dict(q=quat.detach().clone(), t=trans.detach().clone(),
                                         inliers=inliers.clone(), loss=loss.detach().clone(),
                                         gq=gq.detach().clone(), gt=gt.detach().clone()))
                return loss, gq, gt

            return f(T_cw_init, matches, cam, tcfg, num_iters, rebin_iters, ep, vg)
        return wrapped

    def _tracking_loss_grad(self, f: Callable) -> Callable:
        def wrapped(*a, **kw):
            img, dep, d_screen = f(*a, **kw)
            rec = self._rec
            if rec is not None and self.track_armed and len(rec["iters"]) in rec["targets"]:
                rec["d_screen"][len(rec["iters"])] = d_screen.detach().clone()
            return img, dep, d_screen
        return wrapped

    def _render(self, f: Callable) -> Callable:
        def wrapped(system, T_cw, bins):
            from gsorb_slam_tpu_torch.splat.gaussians import prefix_view

            with self._range("slambench.render"):
                out = f(system, T_cw, bins)
            if self.render_armed:
                self.render_armed = False
                self.render = dict(
                    rows=clone_rows(prefix_view(system.gm, system._prefix_bucket())),
                    out={"color": out.color.detach().clone(),
                         "depth": out.depth.detach().clone()})
            return out
        return wrapped

    # --------------------------------------------------------------- mapping

    def _map_window(self, f: Callable) -> Callable:
        def wrapped(gm, frames, frame_ids, cam, mcfg, rcfg, init_mode=False, chunk_budget=None):
            self._map_iter = None
            if self.map_armed and not init_mode:
                # Iterations on the window's current frame (slot 0, bins
                # fresh at this map) that have a next iteration to read the
                # stepped map from.
                cand = [i for i, k in enumerate(frame_ids[:-1]) if int(k) == 0]
                if cand:
                    i = int(cand[int(self.rng.integers(len(cand)))])
                    self._map_iter = dict(
                        target=i, calls=0, bins_rows=clone_rows(gm),
                        color=frames.colors[0].clone(), depth=frames.depths[0].clone(),
                        pose=frames.poses[0].clone(), frame_ids=list(frame_ids))
            if self.profiling and not init_mode:
                self.map_windows.append(dict(
                    rows=clone_rows(gm), poses=frames.poses[: frames.n_frames].clone(),
                    frame_ids=list(frame_ids)))
            with self._range("slambench.map_window"):
                out = f(gm, frames, frame_ids, cam, mcfg, rcfg, init_mode=init_mode,
                        chunk_budget=chunk_budget)
            if self._map_iter is not None and "after" in self._map_iter:
                self.map = self._map_iter
                self.map_armed = False
            self._map_iter = None
            return out
        return wrapped

    def _map_loss_and_grads(self, f: Callable) -> Callable:
        def wrapped(gm, frames, k, layout, cam, mcfg, rcfg, init_mode=False):
            it = self._map_iter
            if it is not None:
                i = it["calls"]
                it["calls"] += 1
                if i == it["target"] + 1:
                    it["after"] = clone_rows(gm)
                if i == it["target"]:
                    it["before"] = clone_rows(gm, adam=True)
            loss, grads = f(gm, frames, k, layout, cam, mcfg, rcfg, init_mode)
            if it is not None and i == it["target"]:
                it["loss"] = loss.detach().clone()
                it["grads"] = {n: g.detach().clone() for n, g in grads.items()}
            return loss, grads
        return wrapped
