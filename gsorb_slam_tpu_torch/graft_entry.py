"""Entry points of the port (counterpart of ``__graft_entry__.py``): the
flagship forward step, and a dry run of the data-parallel train step over
n ranks.

- :func:`entry` returns ``(fn, example_args)``: ``fn`` is one
  differentiable splat render and tracking-style loss at 320x240 over
  20,000 random splats in a 32,768-slot map: ``preprocess`` ->
  ``render_binned`` (K3 on the card, its backward K6 when differentiated;
  the plain blend on the CPU) -> ``l1_tracking`` on ``alpha > 0.99``,
  against bins built once at the identity pose.
- :func:`dryrun_multichip` runs one ``parallel_window_step`` (the map
  replicated, the window's views sharded, one gradient ``all_reduce``) and
  one 3-iteration ``parallel_track_frame`` (the tile grid sharded) over
  ``n_devices`` ranks at tiny shapes, and raises unless the losses and the
  pose are finite. On the card each rank is a process on its own card in
  an NCCL group; it raises when there are fewer cards than ranks. With
  ``device="cpu"`` the ranks are processes in a gloo group. Either group
  meets through a ``FileStore`` in a temporary directory (no network
  port).

Usage (the entry's forward once; ``dryrun_multichip`` is called from
Python, e.g. ``dryrun_multichip(2, device="cpu")``):
    python -m gsorb_slam_tpu_torch.graft_entry [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

RANK_TIMEOUT_S = 600


def _scene(n=20000, capacity=32768, seed=0, w=320, h=240, f=300.0, device="cuda"):
    """``__graft_entry__._scene``'s camera and splats (the same
    ``default_rng(seed)`` draws in the same order) as tensors on ``device``."""
    from gsorb_slam_tpu_torch.core.camera import Camera

    rng = np.random.default_rng(seed)
    cam = Camera(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    means = np.zeros((capacity, 3), np.float32)
    means[:n] = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.1, 1.1, n),
                          rng.uniform(1.5, 4.0, n)], -1)
    active = np.zeros(capacity, bool)
    active[:n] = True
    quats = rng.normal(size=(capacity, 4)).astype(np.float32)
    rgb = rng.uniform(0, 1, (capacity, 3)).astype(np.float32)
    logit_opacities = rng.uniform(1, 4, capacity).astype(np.float32)
    log_scales = np.log(rng.uniform(0.01, 0.04, (capacity, 3)).astype(np.float32))
    t = lambda a: torch.as_tensor(a, device=device)
    return cam, dict(means=t(means), rgb=t(rgb), quats=t(quats),
                     logit_opacities=t(logit_opacities), log_scales=t(log_scales),
                     active=t(active))


def entry(device=None):
    """``(fn, example_args)``: ``fn(means, rgb, quats, logit_op, log_scales,
    T_cw)`` returns ``(loss, color)``, differentiable w.r.t. every argument;
    ``example_args`` are the scene's tensors on ``device`` (default the
    card) and the identity pose."""
    from gsorb_slam_tpu_torch.ops.losses import l1_tracking
    from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess, render_binned

    device = torch.device(device or "cuda")
    cam, scene = _scene(device=device)
    rcfg = RasterConfig(tile=16, tile_capacity=512, max_dup=16, chunk=128)
    T_cw = torch.eye(4, device=device)
    with torch.no_grad():
        prep0 = preprocess(scene["means"], scene["rgb"], scene["quats"],
                           scene["logit_opacities"], scene["log_scales"], scene["active"],
                           T_cw, cam)
        bins = bin_gaussians(prep0, cam, rcfg)
    target = torch.zeros((cam.height, cam.width, 3), device=device)

    def fn(means, rgb, quats, logit_op, log_scales, T_cw):
        prep = preprocess(means, rgb, quats, logit_op, log_scales, scene["active"], T_cw, cam)
        out = render_binned(prep, bins, cam, rcfg)
        loss = l1_tracking(out.color, target, out.alpha > 0.99)
        return loss, out.color

    example_args = (scene["means"], scene["rgb"], scene["quats"], scene["logit_opacities"],
                    scene["log_scales"], T_cw)
    return fn, example_args


def _dryrun_step(n_devices: int, device: torch.device) -> dict:
    """One mapping step and one 3-iteration tracking run on the initialised
    process group (``__graft_entry__.dryrun_multichip``'s shapes)."""
    from gsorb_slam_tpu_torch import _build
    from gsorb_slam_tpu_torch.core.config import MappingConfig, TrackingConfig
    from gsorb_slam_tpu_torch.parallel import (
        make_mesh,
        parallel_track_frame,
        parallel_window_step,
        replicate_map,
        shard_frames,
        window_pack_aux,
    )
    from gsorb_slam_tpu_torch.raster import RasterConfig, bin_gaussians, preprocess
    from gsorb_slam_tpu_torch.slam.mapping import WindowFrames, seed_from_frame
    from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches
    from gsorb_slam_tpu_torch.splat.gaussians import empty_map

    cam, _ = _scene(n=500, capacity=1024, w=64, h=48, f=60.0, device=device)
    mcfg = MappingConfig(max_gaussians=2048)
    rcfg = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=128)
    mesh = make_mesh(n_devices)
    _build.reset_launches()

    # A small map seeded from a synthetic frame.
    eye = torch.eye(4, device=device)
    depth0 = torch.full((cam.height, cam.width), 2.0, device=device)
    color0 = torch.linspace(0, 1, cam.width, device=device)[None, :, None].expand(
        cam.height, cam.width, 3).contiguous()
    gm = seed_from_frame(empty_map(mcfg.max_gaussians, device), color0, depth0, eye, cam, mcfg,
                         stride=2)

    # n_devices window views 1 cm apart, each with its bins.
    poses, bidx, bcnt = [], [], []
    with torch.no_grad():
        for i in range(n_devices):
            T = eye.clone()
            T[0, 3] = 0.01 * i
            b = bin_gaussians(preprocess(gm.means, gm.rgb, gm.quats, gm.logit_opacities,
                                         gm.log_scales, gm.active, T, cam), cam, rcfg)
            poses.append(T)
            bidx.append(b.indices)
            bcnt.append(b.counts)
    frames = WindowFrames(colors=color0[None].repeat(n_devices, 1, 1, 1),
                          depths=depth0[None].repeat(n_devices, 1, 1), poses=torch.stack(poses),
                          bins_indices=torch.stack(bidx), bins_counts=torch.stack(bcnt),
                          n_frames=n_devices)
    gm = replicate_map(gm, mesh)
    local = shard_frames(frames, mesh)
    gm2, loss = parallel_window_step(gm, local, mesh, cam, mcfg, rcfg, 0,
                                     window_pack_aux(local, gm.capacity))
    if not torch.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    # Tile-sharded tracking: with the mapping step above, the SLAM loop's
    # full train step under the mesh.
    tcfg = TrackingConfig(num_iters=3, early_stop_delta=0.0)
    rcfg_t = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=128, exact_stop=False)
    res = parallel_track_frame(gm2, eye, color0, depth0, FeatureMatches.empty(device=device),
                               cam, tcfg, rcfg_t, mesh)
    if not (torch.isfinite(res.T_cw).all() and torch.isfinite(res.loss)):
        raise RuntimeError(f"non-finite tracking result: pose {res.T_cw}, loss {res.loss}")
    return {"loss": float(loss), "track_loss": float(res.loss), "T_cw": res.T_cw.cpu().numpy(),
            "collectives": dict(mesh.collectives), "launches": dict(_build.launches)}


def _dryrun_rank(rank: int, world: int, out: str, device_type: str) -> None:
    """A rank of :func:`dryrun_multichip`: joins the group, runs the step,
    writes ``rank<r>.pt`` (a traceback to ``rank<r>.err``)."""
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device, backend = torch.device("cuda", rank), "nccl"
        else:
            torch.set_num_threads(1)
            device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(out, "store"), world),
                                rank=rank, world_size=world)
        try:
            result = _dryrun_step(world, device)
        finally:
            dist.destroy_process_group()
        result["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """The data-parallel train step over ``n_devices`` ranks, one process
    each: on the card (default) an NCCL group with one card per rank, with
    ``device="cpu"`` a gloo group. Returns each rank's result (the two
    losses, the pose, its collectives and kernel launches by kind); raises
    if a rank fails or does not finish within ``RANK_TIMEOUT_S``."""
    import torch.multiprocessing as mp

    device = torch.device(device or "cuda")
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices; "
                           f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, out, device.type))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(RANK_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        path = lambda r, ext: os.path.join(out, f"rank{r}.{ext}")
        errors = {r: open(path(r, "err")).read() for r in range(n_devices)
                  if os.path.exists(path(r, "err"))}
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {hung} did not finish "
                               f"within {RANK_TIMEOUT_S} s; exit codes "
                               f"{[p.exitcode for p in procs]}; errors {errors}")
        results = [torch.load(path(r, "pt"), weights_only=False) for r in range(n_devices)]
    print(f"dryrun_multichip({n_devices}): ok, loss={results[0]['loss']:.4f}, "
          f"track_loss={results[0]['track_loss']:.4f}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain blend)")
    args = ap.parse_args(argv)
    fn, example_args = entry("cpu" if args.cpu else "cuda")
    with torch.no_grad():
        loss, color = fn(*example_args)
    print("entry ok:", (tuple(loss.shape), tuple(color.shape)), f"loss={float(loss):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
