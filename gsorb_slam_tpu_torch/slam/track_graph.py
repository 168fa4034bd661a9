"""The pose-tracking iteration replayed as CUDA graphs (the port's own; the
JAX package jits ``track_frame`` instead).

Issued from Python, one tracking iteration is about 284 small launches (the
pose chain, its autograd, the feature chi^2 term, the pose Adam step and
the best-pose keep around K2f, K1 and K2b), and the host issues them
several times slower than the card runs them. On CUDA tensors with square
tiles :func:`~gsorb_slam_tpu_torch.slam.tracking.track_frame` therefore
replays three graphs per iteration, captured from the eager code, so the
card runs the same kernels in the same order:

- ``G_fwd``: pose -> matrix -> ``rt`` -> K2f into a fixed screen pack, and
  the feature chi^2 term's forward;
- ``G_bwd``: autograd back from the screen pack's cotangent (K2b) and the
  chi^2 term to the pose, and the iteration's loss;
- ``G_step``: the best-loss keep, the early-stop flag and the pose Adam
  step, written in place into the loop's state.

Between ``G_fwd`` and ``G_bwd`` the fused tracking kernel (K1 or K7) stays
an eager call of ``tracking.tracking_loss_grad``, looked up in its module
at each call: it writes its cotangent straight into a fixed buffer and its
loss rows are added into another. So ``tracking.pose_loop``, the
``value_and_grad`` and ``episode`` it is handed and ``tracking_loss_grad``
stay Python calls, once per iteration and per episode, with that
iteration's values. The loop's host side is unchanged: the stop read, the
iteration count, the rebins (eager; their packs are copied into the fixed
buffers) and the halfway inlier re-gate (eager; it writes the fixed inlier
gate).

A :class:`TrackGraph` holds a frame's operands and state in fixed device
buffers: the episode's raw pack, counts and gt tiles, the matches, the
inlier gate, the K1 cotangent, the loss before the feature term and the
loop's :class:`~gsorb_slam_tpu_torch.slam.tracking.StepState`. The first
iteration of a call that finds no graph for its key runs eagerly on those
buffers (it warms up every operation the capture then records), and the
graphs are captured after its step. Graphs are kept under a key of what the
call observes: the pack, counts, gt-tile and match shapes, ``use_features``,
the camera, tracking and raster configurations, ``scale_modifier`` and the
module-level functions the captured code looks up (so a patched function
is what gets captured); at most the newest per device and ``use_features``.
"""

from __future__ import annotations

from typing import Callable

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.raster.preprocess_kernel import N_SCREEN
from gsorb_slam_tpu_torch.utils import trace

# The graphs kept, by (device, use_features).
_GRAPHS: dict[tuple[torch.device, bool], "TrackGraph"] = {}


class TrackGraph:
    """A tracking solve's operands and state in fixed device buffers, and
    the three graphs of its iteration.

    ``fwd_fn(graph)`` runs the iteration's forward from the buffers and
    returns its outputs (a tuple whose ``screen`` is the screen pack);
    ``bwd_fn(graph, fwd)`` the backward from ``graph.d_screen`` and
    ``graph.base_loss``, returning ``(loss, g_quat, g_trans)``;
    ``step_fn(graph, loss, g_quat, g_trans)`` steps ``graph.state`` in
    place. Each runs eagerly once, then is captured."""

    def __init__(self, key: tuple, raw: torch.Tensor, counts: torch.Tensor, gt4: torch.Tensor,
                 matches, fwd_fn: Callable, bwd_fn: Callable, step_fn: Callable):
        self.key = key
        self.raw = torch.empty_like(raw)
        self.counts = torch.empty_like(counts)
        self.gt4 = torch.empty_like(gt4)
        self.matches = type(matches)(*(torch.empty_like(m) for m in matches))
        self.inliers = torch.empty_like(matches.valid)
        n_tiles, _, cap = raw.shape
        self.d_screen = raw.new_empty((n_tiles, N_SCREEN, cap))
        self.base_loss = raw.new_empty(())
        self.state = None  # the loop's StepState, allocated by the first start()
        self._fwd_fn, self._bwd_fn, self._step_fn = fwd_fn, bwd_fn, step_fn
        self._graphs: tuple[torch.cuda.CUDAGraph, ...] | None = None
        self._fwd = None  # the forward's outputs (captured: the graph's)
        self._out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self._launches: dict[str, int] = {}  # kernel launches per replayed iteration

    def load(self, raw: torch.Tensor, counts: torch.Tensor, gt4: torch.Tensor) -> None:
        """Copy a binning episode's pack, counts and gt tiles into the buffers."""
        self.raw.copy_(raw)
        self.counts.copy_(counts)
        self.gt4.copy_(gt4)

    def start(self, state, inliers: torch.Tensor, matches) -> tuple:
        """Copy a solve's initial loop state, inlier gate and matches into
        the buffers; returns ``(state, inliers)``, the buffers."""
        if self.state is None:
            self.state = state.clone()
        else:
            self.state.copy_(state)
        self.inliers.copy_(inliers)
        for buf, m in zip(self.matches, matches):
            buf.copy_(m)
        return self.state, self.inliers

    def forward(self):
        """This iteration's forward: ``G_fwd`` replayed, or the eager code
        before the capture."""
        if self._graphs is None:
            self._fwd = self._fwd_fn(self)
        else:
            self._graphs[0].replay()
        return self._fwd

    def backward(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """This iteration's ``(loss, g_quat, g_trans)``: ``G_bwd`` replayed,
        or the eager code before the capture."""
        if self._graphs is None:
            return self._bwd_fn(self, self._fwd)
        self._graphs[1].replay()
        for name, n in self._launches.items():
            _build.launches[name] += n
        trace.count("track_graph_replays", 1)
        return self._out

    def step(self, loss: torch.Tensor, g_quat: torch.Tensor, g_trans: torch.Tensor) -> None:
        """The loop's step: ``G_step`` replayed, or the eager code followed
        by the capture of the three graphs."""
        if self._graphs is None:
            self._step_fn(self, loss, g_quat, g_trans)
            self._capture()
        else:
            self._graphs[2].replay()

    def _capture(self) -> None:
        before = dict(_build.launches)
        g_fwd, g_bwd, g_step = (torch.cuda.CUDAGraph() for _ in range(3))
        with torch.cuda.graph(g_fwd):
            self._fwd = self._fwd_fn(self)
        with torch.cuda.graph(g_bwd, pool=g_fwd.pool()):
            self._out = self._bwd_fn(self, self._fwd)
        with torch.cuda.graph(g_step, pool=g_fwd.pool()):
            self._step_fn(self, *self._out)
        # A capture launches nothing: what it counted is what each replay
        # of the three launches.
        self._launches = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
        _build.launches.update(before)
        self._graphs = (g_fwd, g_bwd, g_step)
        trace.count("track_graph_captures", 1)


def frame_graph(raw: torch.Tensor, counts: torch.Tensor, gt4: torch.Tensor, matches,
                use_features: bool, observed: tuple, fwd_fn: Callable, bwd_fn: Callable,
                step_fn: Callable) -> TrackGraph:
    """The graph for this solve's shapes (``raw``, ``counts``, ``gt4``: its
    first episode's); a new key drops the graph kept for its ``(device,
    use_features)`` and starts a new one. ``observed`` is the rest of the
    key (configurations and looked-up functions)."""
    key = (tuple(raw.shape), tuple(counts.shape), tuple(gt4.shape),
           tuple(tuple(m.shape) for m in matches), use_features) + observed
    slot = (raw.device, use_features)
    graph = _GRAPHS.get(slot)
    if graph is None or graph.key != key:
        _GRAPHS.pop(slot, None)
        graph = _GRAPHS[slot] = TrackGraph(key, raw, counts, gt4, matches, fwd_fn, bwd_fn,
                                           step_fn)
    return graph
