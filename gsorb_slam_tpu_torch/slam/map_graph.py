"""The mapping iteration replayed as CUDA graphs (the port's own; the JAX
package jits ``map_window`` instead).

Issued from Python, one mapping iteration is about 1,180 small launches,
and the host issues them slower than the card runs them. On CUDA tensors
:func:`~gsorb_slam_tpu_torch.slam.mapping.map_window` therefore replays two
graphs per iteration, captured from the eager code, so the card runs the
same kernels in the same order:

- ``G_grad``: the loss on this iteration's window frame and its gradient
  w.r.t. the five splat parameter groups (preprocess, pack gather, K4,
  the loss with SSIM, K5, the sorted segment sum, the preprocess
  adjoint);
- ``G_step``: the masked Adam step over the five groups, written in place
  into the map's fixed buffers.

Two graphs and not one, because ``map_step`` keeps calling
``map_loss_and_grads`` once per iteration as a Python call that returns
``(loss, grads)`` (the call replays ``G_grad``), and then the step.

A :class:`MapGraph` holds a window's inputs and state in fixed device
buffers: the map's prefix rows, ``active``, the scene radius and Adam's
moments and step, copied in once per call; the window's colours, depths
and poses; the frames' flat-chunk layouts stacked along a frame axis
(:class:`StackedLayouts`); the iterations' frame draws and an iteration
counter that ``G_step`` advances. So the frame of each iteration is picked
on the device (:func:`select_frame`), and no host value enters an
iteration; each iteration's loss lands in its own slot.

The first iteration of a call that finds no graph for its shapes runs
eagerly on those buffers (it warms up every operation the capture then
records), and the graphs are captured after it. Graphs are kept under a
key of what the call observes: the prefix rows, the window, image and
layout shapes (the chunk budget among them), the draw capacity, the
camera and configurations, ``init_mode``, and the module-level functions
the captured code looks up (so a patched function is what gets
captured); at most the newest per device and ``init_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.raster.binning import ChunkBins
from gsorb_slam_tpu_torch.raster.blend_kernels import PackAux
from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES, GaussianMap
from gsorb_slam_tpu_torch.utils import trace

# The graphs kept, by (device, init_mode).
_GRAPHS: dict[tuple[torch.device, bool], "MapGraph"] = {}


@dataclasses.dataclass
class StackedLayouts:
    """The window frames' flat-chunk layouts (``ChunkBins`` and ``PackAux``)
    stacked along a leading frame axis. ``table`` is padded to ``L``
    columns with the slot count, the index of the segment sum's zero row,
    so a padded column adds +0.0 to a sum that starts at +0.0."""

    indices: torch.Tensor  # [W, MC, K] int32
    chunk_tile: torch.Tensor  # [W, MC] int32
    chunk_pos: torch.Tensor  # [W, MC] int32
    n_chunks: torch.Tensor  # [W] int32
    tile_start: torch.Tensor  # [W, T + 1] int32
    flat_idx: torch.Tensor  # [W, MC K] int64
    table: torch.Tensor  # [W, C, L] int64

    @classmethod
    def like(cls, layout, n_frames: int, L: int) -> "StackedLayouts":
        """Zeroed buffers for ``n_frames`` layouts shaped as ``layout`` (a
        ``mapping.FrameLayout``), tables ``L`` wide."""
        cb, aux = layout.cbins, layout.pack_aux
        z = lambda t, *shape: t.new_zeros((n_frames,) + (shape or tuple(t.shape)))
        return cls(indices=z(cb.indices), chunk_tile=z(cb.chunk_tile),
                   chunk_pos=z(cb.chunk_pos), n_chunks=z(cb.n_chunks),
                   tile_start=z(cb.tile_start), flat_idx=z(aux.flat_idx),
                   table=z(aux.table, aux.table.shape[0], L))

    def fill(self, layouts: list) -> None:
        """Copy layout ``f`` of ``layouts`` into slot ``f``."""
        n_slots = self.flat_idx.shape[1]
        for f, lay in enumerate(layouts):
            cb, aux = lay.cbins, lay.pack_aux
            for name in ("indices", "chunk_tile", "chunk_pos", "n_chunks", "tile_start"):
                getattr(self, name)[f].copy_(getattr(cb, name))
            self.flat_idx[f].copy_(aux.flat_idx)
            L = aux.table.shape[1]
            self.table[f, :, :L].copy_(aux.table)
            self.table[f, :, L:].fill_(n_slots)

    def select(self, k: torch.Tensor) -> tuple[ChunkBins, PackAux]:
        """Frame ``k`` (a ``[1]`` int64 tensor on the device)."""
        pick = lambda t: t.index_select(0, k)[0]
        return (ChunkBins(indices=pick(self.indices), chunk_tile=pick(self.chunk_tile),
                          chunk_pos=pick(self.chunk_pos), n_chunks=pick(self.n_chunks),
                          tile_start=pick(self.tile_start)),
                PackAux(flat_idx=pick(self.flat_idx), table=pick(self.table)))


def select_frame(
    colors: torch.Tensor, depths: torch.Tensor, poses: torch.Tensor,
    layouts: StackedLayouts, k: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, ChunkBins, PackAux]:
    """Window frame ``k`` (a ``[1]`` int64 tensor) picked on the device:
    ``(pose, colour, depth, chunk bins, pack residuals)``, without reading
    ``k`` on the host."""
    pick = lambda t: t.index_select(0, k)[0]
    return (pick(poses), pick(colors), pick(depths)) + layouts.select(k)


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class MapGraph:
    """A mapping window's inputs and state in fixed device buffers, and the
    two graphs of its iteration.

    ``grads_fn(graph)`` computes the iteration's ``(loss, grads)`` from the
    buffers; ``step_fn(graph, grads)`` steps the map and writes it back
    through :meth:`write_state`. Both run eagerly once, then are captured.
    ``graph[k]`` is the graph itself: it stands in for every frame's layout
    in ``map_step``, which picks the frame on the device."""

    def __init__(self, key: tuple, gm: GaussianMap, frames, layouts: list, L: int,
                 n_draws: int, grads_fn: Callable, step_fn: Callable):
        self.key = key
        self.gm = dataclasses.replace(
            gm, **{n: torch.empty_like(getattr(gm, n)) for n in PARAM_NAMES},
            active=torch.empty_like(gm.active),
            adam_m={n: torch.empty_like(v) for n, v in gm.adam_m.items()},
            adam_v={n: torch.empty_like(v) for n, v in gm.adam_v.items()},
            adam_t=torch.empty_like(gm.adam_t), scene_radius=torch.empty_like(gm.scene_radius),
        )
        self.colors = torch.empty_like(frames.colors)
        self.depths = torch.empty_like(frames.depths)
        self.poses = torch.empty_like(frames.poses)
        self.layouts = StackedLayouts.like(layouts[0], frames.colors.shape[0], L)
        dev = gm.device
        self.draws = torch.zeros(n_draws, dtype=torch.long, device=dev)
        self.losses = torch.zeros(n_draws, dtype=torch.float32, device=dev)
        self.it = torch.zeros((), dtype=torch.long, device=dev)
        self._grads_fn, self._step_fn = grads_fn, step_fn
        self._graphs: tuple[torch.cuda.CUDAGraph, torch.cuda.CUDAGraph] | None = None
        self._out: tuple[torch.Tensor, dict[str, torch.Tensor]] | None = None
        self._launches: dict[str, int] = {}  # kernel launches per replayed iteration

    def __getitem__(self, k: int) -> "MapGraph":
        return self

    def load(self, gm: GaussianMap, frames, layouts: list, frame_ids: list[int]) -> None:
        """Copy a call's map, frames, layouts and draws into the buffers."""
        st = self.gm
        for n in PARAM_NAMES:
            getattr(st, n).copy_(getattr(gm, n))
            st.adam_m[n].copy_(gm.adam_m[n])
            st.adam_v[n].copy_(gm.adam_v[n])
        for n in ("active", "adam_t", "scene_radius"):
            getattr(st, n).copy_(getattr(gm, n))
        self.colors.copy_(frames.colors)
        self.depths.copy_(frames.depths)
        self.poses.copy_(frames.poses)
        self.layouts.fill(layouts)
        draws = torch.tensor(list(frame_ids), dtype=torch.long)
        self.draws[: len(frame_ids)].copy_(draws.pin_memory(), non_blocking=True)
        self.it.zero_()

    def draw(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, ChunkBins, PackAux]:
        """This iteration's window frame (see :func:`select_frame`)."""
        k = self.draws.index_select(0, self.it.view(1))
        return select_frame(self.colors, self.depths, self.poses, self.layouts, k)

    def record_loss(self, loss: torch.Tensor) -> None:
        self.losses.index_copy_(0, self.it.view(1), loss.view(1))

    def write_state(self, new: GaussianMap) -> None:
        """Write a stepped map's rows, moments and step into the buffers and
        advance the iteration counter."""
        st = self.gm
        for n in PARAM_NAMES:
            getattr(st, n).copy_(getattr(new, n))
            st.adam_m[n].copy_(new.adam_m[n])
            st.adam_v[n].copy_(new.adam_v[n])
        st.adam_t.copy_(new.adam_t)
        self.it.add_(1)

    def grads(self) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """This iteration's ``(loss, grads)``: ``G_grad`` replayed, or the
        eager code before the capture."""
        if self._graphs is None:
            return self._grads_fn(self)
        self._graphs[0].replay()
        for name, n in self._launches.items():
            _build.launches[name] += n
        trace.count("map_graph_replays", 1)
        return self._out

    def step(self, grads: dict[str, torch.Tensor]) -> GaussianMap:
        """The Adam step: ``G_step`` replayed, or the eager code followed by
        the capture of both graphs. Returns the map's buffers."""
        if self._graphs is None:
            self._step_fn(self, grads)
            self._capture()
        else:
            self._graphs[1].replay()
        return self.gm

    def _capture(self) -> None:
        before = dict(_build.launches)
        g_grads, g_step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_grads):
            self._out = self._grads_fn(self)
        with torch.cuda.graph(g_step, pool=g_grads.pool()):
            self._step_fn(self, self._out[1])
        # A capture launches nothing: what it counted is what each replay
        # of the pair launches.
        self._launches = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
        _build.launches.update(before)
        self._graphs = (g_grads, g_step)
        trace.count("map_graph_captures", 1)

    def result(self, gm: GaussianMap, n_iters: int) -> tuple[GaussianMap, torch.Tensor]:
        """``(map, per-iteration losses)`` of the call, as copies: ``gm`` (the
        call's input) with the buffers' rows, moments and step."""
        st = self.gm
        return dataclasses.replace(
            gm, **{n: getattr(st, n).clone() for n in PARAM_NAMES},
            adam_m={n: v.clone() for n, v in st.adam_m.items()},
            adam_v={n: v.clone() for n, v in st.adam_v.items()},
            adam_t=st.adam_t.clone(),
        ), self.losses[:n_iters].clone()


def window_graph(gm: GaussianMap, frames, layouts: list, frame_ids: list[int],
                 init_mode: bool, observed: tuple, grads_fn: Callable,
                 step_fn: Callable) -> MapGraph:
    """The graph for this window's shapes, loaded with its map, frames,
    layouts and draws; a new key drops the graph kept for its
    ``(device, init_mode)`` and starts a new one. ``observed`` is the rest
    of the key (configurations and looked-up functions)."""
    L = _pow2_at_least(max(lay.pack_aux.table.shape[1] for lay in layouts), 16)
    n_draws = _pow2_at_least(len(frame_ids), 64)
    lay = layouts[0]
    key = (gm.capacity, tuple(frames.colors.shape), tuple(lay.cbins.indices.shape),
           tuple(lay.cbins.tile_start.shape), L, n_draws, init_mode) + observed
    slot = (gm.device, init_mode)
    graph = _GRAPHS.get(slot)
    if graph is None or graph.key != key:
        _GRAPHS.pop(slot, None)
        graph = _GRAPHS[slot] = MapGraph(key, gm, frames, layouts, L, n_draws, grads_fn,
                                         step_fn)
    graph.load(gm, frames, layouts, frame_ids)
    return graph
