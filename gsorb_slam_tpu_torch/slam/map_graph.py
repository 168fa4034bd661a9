"""The mapping iteration replayed as CUDA graphs (the port's own; the JAX
package jits ``map_window`` instead).

On CUDA tensors :func:`~gsorb_slam_tpu_torch.slam.mapping.map_window` runs
each iteration (about 320 launches from Python) as two bodies of a
:class:`~gsorb_slam_tpu_torch.utils.cuda_graphs.Replay`:

- ``G_grad``: the loss on this iteration's window frame and its gradient
  w.r.t. the five splat parameter groups (K10f's attribute table, pack
  gather, K4, the loss with SSIM's K11f, K11b, K5, the sorted segment sum,
  K10b);
- ``G_step``: the masked Adam step over the five groups, written in place
  into the map's fixed buffers.

Two bodies, because ``map_step`` calls ``map_loss_and_grads`` (which runs
``G_grad``) once per iteration for its ``(loss, grads)``, then the step.

A :class:`MapGraph` holds a window's inputs and state in fixed device
buffers: the map's prefix rows and Adam state, the window's colours, depths
and poses, its frames' flat-chunk layouts stacked along a frame axis
(:class:`StackedLayouts`), the iterations' frame draws and an iteration
counter that ``G_step`` advances. So each iteration's frame is picked on
the device (:func:`select_frame`) and its loss lands in its own slot. It is
kept (``cuda_graphs.kept``, slot ``("map", device, init_mode)``) under a key
of the prefix rows, the window, image and layout shapes (the chunk budget
among them), the draw capacity, the camera and configurations,
``init_mode`` and the module-level functions the bodies look up, so a
patched function is what gets captured.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import torch

from gsorb_slam_tpu_torch.raster.binning import ChunkBins
from gsorb_slam_tpu_torch.raster.blend_kernels import PackAux
from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES, GaussianMap
from gsorb_slam_tpu_torch.utils import cuda_graphs


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
    replay of its iteration.

    ``grads_fn(graph)`` computes the iteration's ``(loss, grads)`` from the
    buffers; ``step_fn(graph, grads)`` steps the map and writes it back
    through :meth:`write_state`. ``graph[k]`` is the graph itself: it
    stands in for every frame's layout in ``map_step``, which picks the
    frame on the device."""

    def __init__(self, gm: GaussianMap, frames, layouts: list, L: int, n_draws: int,
                 grads_fn: Callable, step_fn: Callable):
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
        me, out = weakref.proxy(self), None  # a proxy: no cycle keeps a dropped graph

        def g_grads():
            nonlocal out
            out = grads_fn(me)
            return out

        def g_step():
            step_fn(me, out[1])
            return me.gm

        self._replay = cuda_graphs.Replay((g_grads, g_step), "map_graph")

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
        """This iteration's ``(loss, grads)`` (``G_grad``)."""
        return self._replay.run(0)

    def step(self) -> GaussianMap:
        """The Adam step on the gradients (``G_step``); returns the map's
        buffers."""
        return self._replay.run(1)

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
    """The graph for this window's shapes. ``observed`` is the rest of the
    key (configurations and looked-up functions)."""
    L = _pow2_at_least(max(lay.pack_aux.table.shape[1] for lay in layouts), 16)
    n_draws = _pow2_at_least(len(frame_ids), 64)
    lay = layouts[0]
    key = (gm.capacity, tuple(frames.colors.shape), tuple(lay.cbins.indices.shape),
           tuple(lay.cbins.tile_start.shape), L, n_draws, init_mode) + observed
    return cuda_graphs.kept(
        ("map", gm.device, init_mode), key,
        lambda: MapGraph(gm, frames, layouts, L, n_draws, grads_fn, step_fn))
