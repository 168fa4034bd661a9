"""The pose-tracking iteration replayed as CUDA graphs (the port's own; the
JAX package jits ``track_frame`` instead).

On CUDA tensors with square tiles
:func:`~gsorb_slam_tpu_torch.slam.tracking.track_frame` runs each iteration
(about 284 launches from Python) as three bodies of a
:class:`~gsorb_slam_tpu_torch.utils.cuda_graphs.Replay`:

- ``G_fwd``: pose -> matrix -> ``rt`` -> K2f into a fixed screen pack, and
  the feature chi^2 term's forward;
- ``G_bwd``: autograd back from the screen pack's cotangent (K2b) and the
  chi^2 term to the pose, and the iteration's loss;
- ``G_step``: the best-loss keep, the early-stop flag and the pose Adam
  step, written in place into the loop's state.

Between ``G_fwd`` and ``G_bwd`` the fused tracking kernel (K1 or K7) stays
an eager call of ``tracking.tracking_loss_grad``, looked up in its module at
each call; it writes its cotangent and loss rows into fixed buffers. The
stop read, the rebins (their packs copied into the buffers) and the halfway
inlier re-gate (into the fixed gate) stay eager on the host.

A :class:`TrackGraph` holds a solve's operands and loop state in fixed
device buffers. It is kept (``cuda_graphs.kept``, slot ``("track", device,
use_features)``) under a key of the pack, counts, gt-tile and match shapes,
``use_features``, the camera, tracking and raster configurations,
``scale_modifier`` and the module-level functions the bodies look up, so a
patched function is what gets captured.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from gsorb_slam_tpu_torch.raster.preprocess_kernel import N_SCREEN
from gsorb_slam_tpu_torch.utils import cuda_graphs


class TrackGraph:
    """A tracking solve's operands and state in fixed device buffers, and
    the replay of its iteration.

    ``fwd_fn(graph)`` runs the iteration's forward from the buffers and
    returns its outputs (a tuple whose ``screen`` is the screen pack);
    ``bwd_fn(graph, fwd)`` the backward from ``graph.d_screen`` and
    ``graph.base_loss``, returning ``(loss, g_quat, g_trans)``;
    ``step_fn(graph, loss, g_quat, g_trans)`` steps ``graph.state`` in
    place."""

    def __init__(self, raw: torch.Tensor, counts: torch.Tensor, gt4: torch.Tensor, matches,
                 fwd_fn: Callable, bwd_fn: Callable, step_fn: Callable):
        self.raw = torch.empty_like(raw)
        self.counts = torch.empty_like(counts)
        self.gt4 = torch.empty_like(gt4)
        self.matches = type(matches)(*(torch.empty_like(m) for m in matches))
        self.inliers = torch.empty_like(matches.valid)
        n_tiles, _, cap = raw.shape
        self.d_screen = raw.new_empty((n_tiles, N_SCREEN, cap))
        self.base_loss = raw.new_empty(())
        self.state = None  # the loop's StepState, allocated by the first start()
        me, fwd, bwd = weakref.proxy(self), None, None  # a proxy: no cycle keeps a dropped graph

        def g_fwd():
            nonlocal fwd
            fwd = fwd_fn(me)
            return fwd

        def g_bwd():
            nonlocal bwd
            bwd = bwd_fn(me, fwd)
            return bwd

        self._replay = cuda_graphs.Replay((g_fwd, g_bwd, lambda: step_fn(me, *bwd)),
                                          "track_graph")

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
        """This iteration's forward (``G_fwd``)."""
        return self._replay.run(0)

    def backward(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """This iteration's ``(loss, g_quat, g_trans)`` (``G_bwd``)."""
        return self._replay.run(1)

    def step(self) -> None:
        """The loop's step on the backward's outputs (``G_step``)."""
        self._replay.run(2)


def frame_graph(raw: torch.Tensor, counts: torch.Tensor, gt4: torch.Tensor, matches,
                use_features: bool, observed: tuple, fwd_fn: Callable, bwd_fn: Callable,
                step_fn: Callable) -> TrackGraph:
    """The graph for this solve's shapes (``raw``, ``counts``, ``gt4``: its
    first episode's). ``observed`` is the rest of the key (configurations
    and looked-up functions)."""
    key = (tuple(raw.shape), tuple(counts.shape), tuple(gt4.shape),
           tuple(tuple(m.shape) for m in matches), use_features) + observed
    return cuda_graphs.kept(
        ("track", raw.device, use_features), key,
        lambda: TrackGraph(raw, counts, gt4, matches, fwd_fn, bwd_fn, step_fn))
