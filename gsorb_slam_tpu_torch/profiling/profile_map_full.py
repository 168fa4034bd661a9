"""One mapping iteration's budget at the bench workload (counterpart of
``scripts/profile_map_full.py``).

Times the ``map_window`` iteration (the flat-chunk blend K4 / K5, the
reference's loss mix, masked Adam) on a one-frame window at the identity
pose (the render of the map itself is the gt) with the System's raster
configuration and chunk budget, and variants that each take one piece away,
so the differences attribute the budget:

    full          the production iteration (``map_window``)
    no_ssim       lam = 1: the L1-only image loss (SSIM's cost)
    fwd_only      the loss without its gradient (the backward's cost)
    grad_no_adam  the loss and gradients through autograd's scatter in the
                  pack's backward (``index_put_`` with accumulation: atomics,
                  order varies run to run), no Adam
    grad_sorted   the same through the port's fixed-order sorted backward
                  (what ``map_window`` runs), no Adam
    adam_only     the masked Adam step alone on fixed gradients

Usage: ``python -m gsorb_slam_tpu_torch.profiling.profile_map_full
[--iters 20] [--cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from gsorb_slam_tpu_torch.core.config import MappingConfig
from gsorb_slam_tpu_torch.profiling import common
from gsorb_slam_tpu_torch.raster import bin_gaussians, preprocess
from gsorb_slam_tpu_torch.raster.flat_kernels import render_flat
from gsorb_slam_tpu_torch.slam.mapping import (
    FrameLayout,
    WindowFrames,
    map_loss_and_grads,
    map_window,
    mapping_loss,
    window_chunk_budget,
    window_layouts,
)
from gsorb_slam_tpu_torch.slam.system import System
from gsorb_slam_tpu_torch.splat.gaussians import adam_step, map_learning_rates


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_args(ap)
    ap.add_argument("--iters", type=int, default=20, help="mapping iterations per timed call")
    ap.add_argument("--runs", type=int, default=3, help="timed calls (best taken)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    cam = common.bench_camera(args.width, args.height)
    gm = common.bench_scene(dev, cam, args.splats, args.map_capacity)
    rcfg = System.default_raster_config(cam.width)
    mcfg = MappingConfig(num_iters=args.iters)
    T = torch.eye(4, device=dev)
    with torch.no_grad():
        bins = bin_gaussians(preprocess(*common.map_params(gm), T, cam), cam, rcfg)
    gt_color, gt_depth = common.gt_images(gm, T, cam, rcfg)
    # The running depth and scene radius a System takes from its first
    # frame (the bench map leaves them unset): the scale regularizers read them.
    max_z = gm.means[:, 2].max()
    gm = dataclasses.replace(gm, max_z=max_z, scene_radius=max_z / mcfg.radius_depth_ratio)
    frames = WindowFrames(colors=gt_color[None], depths=gt_depth[None], poses=T[None],
                          bins_indices=bins.indices[None], bins_counts=bins.counts[None],
                          n_frames=1)
    budget = window_chunk_budget(frames.bins_counts, rcfg.chunk)
    layout = window_layouts(frames, gm.capacity, cam, rcfg, budget)[0]
    print(f"# instances {int(bins.counts.sum())}, live chunks {int(layout.cbins.n_chunks)}, "
          f"budget {budget}, K {rcfg.chunk}, dilate {rcfg.dilate_px} px; "
          f"{common.device_info(dev)['name']}", flush=True)
    draws = [0] * args.iters
    lrs = map_learning_rates(mcfg)

    def loop(step):
        def run():
            for _ in range(args.iters):
                step()
        return run

    def grads(lay):
        return lambda: map_loss_and_grads(gm, frames, 0, lay, cam, mcfg, rcfg)

    def fwd():
        with torch.no_grad():
            prep = preprocess(*common.map_params(gm), T, cam, mcfg.scale_modifier)
            out = render_flat(prep, layout.cbins, cam, rcfg, bg=mcfg.background_color)
            return mapping_loss(gm, out, gt_color, gt_depth, mcfg, False)

    _, g_fixed = grads(layout)()
    variants = {
        "full": lambda: map_window(gm, frames, draws, cam, mcfg, rcfg, chunk_budget=budget),
        "no_ssim": lambda: map_window(gm, frames, draws, cam, dataclasses.replace(mcfg, lam=1.0),
                                      rcfg, chunk_budget=budget),
        "fwd_only": loop(fwd),
        "grad_no_adam": loop(grads(FrameLayout(layout.cbins, None))),
        "grad_sorted": loop(grads(layout)),
        "adam_only": loop(lambda: adam_step(gm, g_fixed, lrs)),
    }
    res = {**common.device_info(dev), "iters": args.iters, "live_chunks":
           int(layout.cbins.n_chunks), "chunk_budget": budget, "ms_per_iter": {}}
    for name, fn in variants.items():
        ms = common.wall_ms(fn, dev, runs=args.runs) / args.iters
        res["ms_per_iter"][name] = ms
        common.report(f"map iteration: {name}", ms)
        if name == "full":
            res["profile"] = common.profile_call(variants["full"], dev, best_ms=ms * args.iters)
            for line in common.profile_lines(res["profile"], f"{args.iters} map_window iterations"):
                print(line, flush=True)
    t = res["ms_per_iter"]
    res["split_ms"] = {
        "ssim": t["full"] - t["no_ssim"],
        "backward": t["grad_sorted"] - t["fwd_only"],
        "adam": t["adam_only"],
        "sorted_vs_scatter_backward": t["grad_sorted"] - t["grad_no_adam"],
        "loop_rest": t["full"] - t["grad_sorted"] - t["adam_only"],
    }
    print("# " + ", ".join(f"{k} {v:.4f}" for k, v in res["split_ms"].items()) + " ms per "
          "iteration", flush=True)
    return res


if __name__ == "__main__":
    main()
