"""The mapping path's pack gathers and their backward at the real shapes
(counterpart of ``scripts/profile_gather.py``).

At the bench scene with the render view (tile 16, capacity 2048, chunk 256,
dilate 2 px), identity pose:

    flat pack gather        ``pack_instances_flat``: the live chunks of the
                            System's chunk budget (K4 / K5's input, the
                            single-device ``map_window``)
    per-tile pack gather    ``pack_instances`` with its slot table: every
                            slot of the tile grid, live or not (K3 / K6's
                            input, the window-sharded mapping step)
    sorted backward         ``sorted_segment_sum`` of each pack's gradient
                            rows (a fixed order: bitwise reproducible)
    index_add_              the same rows summed by ``index_add_`` (atomics
                            on the card: the order varies run to run)

The TPU script's synthetic gathers, scatters and bf16 probes measured the
TPU's memory system; these are the port's own calls at its own shapes.

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_gather [--cpu]``.
"""

from __future__ import annotations

import argparse

import torch

from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, chunk_layout, preprocess
from gsorb_slam_tpu_torch.raster.binning import tile_grid_shape
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    N_ATTR,
    flat_pack_grad_aux,
    pack_instances,
    sorted_segment_sum,
    tile_pack_grad_aux,
)
from gsorb_slam_tpu_torch.raster.flat_kernels import pack_instances_flat
from gsorb_slam_tpu_torch.slam.mapping import window_chunk_budget


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--reps", type=int, default=20, help="calls per timed run")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    cfg = common.bench_raster_config()
    C = gm.capacity
    with torch.no_grad():
        prep = preprocess(*common.map_params(gm), torch.eye(4, device=dev), cam)
        bins = bin_gaussians(prep, cam, cfg)
        ty, tx = tile_grid_shape(cam, cfg)
        budget = window_chunk_budget(bins.counts[None], cfg.chunk)
        cb = chunk_layout(bins, ty * tx, cfg.chunk, budget)
    aux_f = flat_pack_grad_aux(cb.indices, C)
    aux_t = tile_pack_grad_aux(bins, C)
    n_flat, n_tile = aux_f.flat_idx.numel(), aux_t.flat_idx.numel()
    gen = torch.Generator().manual_seed(0)
    g_f = torch.randn((n_flat, N_ATTR), generator=gen).to(dev)
    g_t = torch.randn((n_tile, N_ATTR), generator=gen).to(dev)
    print(f"# live instances {int(bins.counts.sum())}; flat pack {n_flat} slots "
          f"({int(cb.n_chunks)} live chunks of budget {budget}); per-tile pack {n_tile} slots; "
          f"map capacity {C}; {common.device_info(dev)['name']}", flush=True)

    def index_add(g, aux):
        return lambda: g.new_zeros((C + 1, N_ATTR)).index_add_(0, aux.flat_idx, g)

    pieces = {
        "flat pack gather": lambda: pack_instances_flat(prep, cb, aux_f),
        "per-tile pack gather": lambda: pack_instances(prep, bins, aux_t),
        "flat pack backward, sorted_segment_sum": lambda: sorted_segment_sum(g_f, aux_f),
        "flat pack backward, index_add_": index_add(g_f, aux_f),
        "per-tile pack backward, sorted_segment_sum": lambda: sorted_segment_sum(g_t, aux_t),
        "per-tile pack backward, index_add_": index_add(g_t, aux_t),
    }
    res = {**common.device_info(dev), "flat_slots": n_flat, "tile_slots": n_tile, "ms": {}}
    with torch.no_grad():
        for name, fn in pieces.items():
            ms = common.time_ms(fn, dev, args.reps)
            res["ms"][name] = ms
            common.report(name, ms)
    return res


if __name__ == "__main__":
    main()
