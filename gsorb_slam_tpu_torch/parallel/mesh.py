"""Multi-device window mapping over ``torch.distributed`` (counterpart of
``gsorb_slam_tpu/parallel/mesh.py``).

One process per device (a rank), joined in a process group that the caller
initialises: NCCL on the card, gloo on the CPU. The view axis of the JAX
package's mesh is the group's ranks:

- the Gaussian map (parameters and Adam moments) is replicated:
  :func:`replicate_map` broadcasts rank 0's;
- the window frames are sharded over the view axis: rank r keeps the
  contiguous block ``[r W / n, (r + 1) W / n)`` (:func:`shard_frames`, as
  ``NamedSharding(P("view"))`` lays the rows out);
- each rank renders one frame of its block with ``render_binned`` (K3 and its
  backward K6 on the card) and takes the mapping loss's gradients;
- one ``all_reduce(SUM)`` of a single buffer (the five gradient groups and
  the loss) divided by n is the JAX package's ``psum / n_dev``;
- every rank takes the same masked Adam step, so the replicas stay bitwise
  equal with no parameter traffic.

This is the "batched window" mode: one step optimizes against n frames at
once. The single-device loop stays in ``slam/mapping.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.raster.binning import TileBins
from gsorb_slam_tpu_torch.raster.blend_kernels import PackAux, tile_pack_grad_aux
from gsorb_slam_tpu_torch.raster.preprocess import preprocess
from gsorb_slam_tpu_torch.raster.tiled import render_binned
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.mapping import WindowFrames, mapping_loss
from gsorb_slam_tpu_torch.splat.gaussians import (
    PARAM_NAMES,
    GaussianMap,
    adam_step,
    map_learning_rates,
)

VIEW_AXIS = "view"


@dataclasses.dataclass
class Mesh:
    """The view axis over the initialised process group: the group, this
    process's rank in it, its size, and the collectives issued over it, by
    kind."""

    group: Any  # the torch.distributed ProcessGroup
    rank: int
    size: int
    collectives: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "broadcast": 0})


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the whole process group, which must be initialised;
    ``n_devices``, if given, must be its size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, not {n_devices}")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the mesh in place (every rank gets the same bits)."""
    mesh.collectives["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _broadcast(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    mesh.collectives["broadcast"] += 1
    x = x.clone()
    dist.broadcast(x, src=0, group=mesh.group)
    return x


def replicate_map(gm: GaussianMap, mesh: Mesh) -> GaussianMap:
    """Rank 0's map on every rank."""
    fields = {}
    for f in dataclasses.fields(gm):
        v = getattr(gm, f.name)
        fields[f.name] = ({k: _broadcast(t, mesh) for k, t in v.items()} if isinstance(v, dict)
                          else _broadcast(v, mesh))
    return GaussianMap(**fields)


def shard_frames(frames: WindowFrames, mesh: Mesh) -> WindowFrames:
    """This rank's contiguous block of the view axis; the view count must be
    a multiple of the mesh size (pad with repeated frames if needed).
    ``n_frames`` stays the window's."""
    W = frames.colors.shape[0]
    if W % mesh.size:
        raise ValueError(f"{W} window frames do not shard over {mesh.size} ranks")
    n = W // mesh.size
    sl = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return WindowFrames(
        colors=frames.colors[sl], depths=frames.depths[sl], poses=frames.poses[sl],
        bins_indices=frames.bins_indices[sl], bins_counts=frames.bins_counts[sl],
        n_frames=frames.n_frames,
    )


def _frame_bins(frames: WindowFrames, k: int) -> TileBins:
    return TileBins(indices=frames.bins_indices[k], counts=frames.bins_counts[k],
                    n_dropped=frames.bins_counts.new_zeros(()))


def window_pack_aux(frames: WindowFrames, capacity: int) -> list[PackAux]:
    """The pack's slot table of each frame of ``frames`` for a map of
    ``capacity`` rows. A window's bins stay fixed over its steps, so a loop
    of :func:`parallel_window_step` builds these once and passes them."""
    return [tile_pack_grad_aux(_frame_bins(frames, k), capacity)
            for k in range(frames.colors.shape[0])]


def parallel_window_step(
    gm: GaussianMap,
    frames: WindowFrames,
    mesh: Mesh,
    cam: Camera,
    mcfg: MappingConfig,
    rcfg: RasterConfig,
    local_idx: int,
    pack_aux: list[PackAux],
) -> tuple[GaussianMap, torch.Tensor]:
    """ONE data-parallel mapping Adam step: each rank renders the
    ``local_idx % local_count``-th frame of ITS shard (``frames`` is
    :func:`shard_frames`' block; callers rotate ``local_idx`` over the
    iterations so every window frame takes part). ``pack_aux`` is
    :func:`window_pack_aux` of ``frames``, built once for the loop.

    Returns (the updated replicated map, the loss averaged over the ranks).
    The only collective is one ``all_reduce`` of the gradients and the loss."""
    k = int(local_idx) % frames.colors.shape[0]
    params = {n: getattr(gm, n).detach().requires_grad_(True) for n in PARAM_NAMES}
    with torch.enable_grad():
        g2 = dataclasses.replace(gm, **params)
        prep = preprocess(
            g2.means, g2.rgb, g2.quats, g2.logit_opacities, g2.log_scales, g2.active,
            frames.poses[k], cam, mcfg.scale_modifier,
        )
        out = render_binned(prep, _frame_bins(frames, k), cam, rcfg, bg=mcfg.background_color,
                            pack_aux=pack_aux[k])
        loss = mapping_loss(g2, out, frames.colors[k], frames.depths[k], mcfg, False)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
    buf = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]),
                         mesh) / mesh.size
    mean_grads, off = {}, 0
    for n, p in params.items():
        mean_grads[n] = buf[off:off + p.numel()].reshape(p.shape)
        off += p.numel()
    return adam_step(gm, mean_grads, map_learning_rates(mcfg)), buf[off]
