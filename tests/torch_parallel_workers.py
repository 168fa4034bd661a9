"""Rank processes of ``tests/test_torch_parallel.py``: the port's
multi-device path over ``torch.distributed`` with gloo on the CPU.

This module imports torch and the port only, never JAX: the test spawns it
(``torch.multiprocessing``, start method ``spawn``) once per rank. Each
rank joins a gloo process group through a ``FileStore`` (no network port),
runs one job and writes its results to ``<out>/rank<r>.pt``; a failure
writes the traceback to ``<out>/rank<r>.err``.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist


def run_rank(rank: int, world: int, out: str, job: str, args: dict) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                                rank=rank, world_size=world)
        try:
            result = JOBS[job](rank, **args)
        finally:
            dist.destroy_process_group()
        result["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _map_numpy(gm) -> dict:
    from gsorb_slam_tpu_torch.interop import gaussian_map_to_numpy

    return gaussian_map_to_numpy(gm)


def window_step(rank: int, gm: dict, frames: dict, cam: dict, rcfg: dict) -> dict:
    """One ``parallel_window_step`` from the replicated map; every rank but
    0 starts from a zeroed map, which ``replicate_map`` must overwrite."""
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import MappingConfig
    from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy, window_frames_from_numpy
    from gsorb_slam_tpu_torch.parallel import (
        make_mesh,
        parallel_window_step,
        replicate_map,
        shard_frames,
        window_pack_aux,
    )
    from gsorb_slam_tpu_torch.raster.types import RasterConfig

    if rank:
        gm = {k: ({kk: np.zeros_like(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else np.zeros_like(v)) for k, v in gm.items()}
    mesh = make_mesh(2)
    tgm = replicate_map(gaussian_map_from_numpy(gm, device="cpu"), mesh)
    local = shard_frames(window_frames_from_numpy(frames, device="cpu"), mesh)
    tgm, loss = parallel_window_step(tgm, local, mesh, Camera(**cam),
                                     MappingConfig(max_gaussians=4096), RasterConfig(**rcfg),
                                     0, window_pack_aux(local, tgm.capacity))
    return {"map": _map_numpy(tgm), "loss": float(loss), "n_local": local.colors.shape[0]}


def window_steps(rank: int, gm: dict, frames: dict, cam: dict, rcfg: dict, steps: int) -> dict:
    """``steps`` ``parallel_window_step``s from the replicated map, each rank
    on its shard (``local_idx`` rotating over it), every frame's pack slot
    table built once."""
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import MappingConfig
    from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy, window_frames_from_numpy
    from gsorb_slam_tpu_torch.parallel import (
        make_mesh,
        parallel_window_step,
        replicate_map,
        shard_frames,
        window_pack_aux,
    )
    from gsorb_slam_tpu_torch.raster.types import RasterConfig

    mesh = make_mesh()
    tgm = replicate_map(gaussian_map_from_numpy(gm, device="cpu"), mesh)
    local = shard_frames(window_frames_from_numpy(frames, device="cpu"), mesh)
    aux = window_pack_aux(local, tgm.capacity)
    mcfg, cam, rcfg = MappingConfig(max_gaussians=tgm.capacity), Camera(**cam), RasterConfig(**rcfg)
    losses = []
    for it in range(steps):
        tgm, loss = parallel_window_step(tgm, local, mesh, cam, mcfg, rcfg, it, aux)
        losses.append(float(loss))
    return {"map": _map_numpy(tgm), "losses": losses, "all_reduce": mesh.collectives["all_reduce"]}


def track(rank: int, gm: dict, gt_color, gt_depth, cam: dict, rcfg: dict, num_iters: int,
          rebin: tuple) -> dict:
    """``parallel_track_frame`` from the identity pose."""
    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import TrackingConfig
    from gsorb_slam_tpu_torch.interop import gaussian_map_from_numpy
    from gsorb_slam_tpu_torch.parallel import make_mesh, parallel_track_frame
    from gsorb_slam_tpu_torch.raster.types import RasterConfig
    from gsorb_slam_tpu_torch.slam.tracking import FeatureMatches

    res = parallel_track_frame(
        gaussian_map_from_numpy(gm, device="cpu"), torch.eye(4), torch.as_tensor(gt_color),
        torch.as_tensor(gt_depth), FeatureMatches.empty(device="cpu"), Camera(**cam),
        TrackingConfig(num_iters=num_iters, early_stop_delta=0.0), RasterConfig(**rcfg),
        make_mesh(), rebin_iters=rebin,
    )
    return {"T_cw": res.T_cw.numpy(), "loss": float(res.loss), "n_iters": int(res.n_iters)}


def _system_config(width: int, height: int, f: float, **mapping):
    from gsorb_slam_tpu_torch.core import config as C

    return C.SystemConfig(
        camera=C.CameraConfig(width=width, height=height, fx=f, fy=f, cx=width / 2,
                              cy=height / 2, fps=10),
        mapping=C.MappingConfig(**mapping),
        tracking=C.TrackingConfig(num_iters=10),
    )


def system(rank: int, n_frames: int, small: bool) -> dict:
    """``System(use_mesh=True)`` over a synthetic sequence: 96x72 with the
    JAX package's ``test_system_mesh_mapping_end_to_end`` settings, or with
    ``small`` a 64x48 one, which also runs ``use_mesh=False`` on the same
    frames."""
    import dataclasses

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.raster.types import RasterConfig
    from gsorb_slam_tpu_torch.slam.dataset import SyntheticDataset
    from gsorb_slam_tpu_torch.slam.system import System

    if small:
        rcfg = RasterConfig(tile=16, tile_capacity=256, max_dup=16, chunk=64, dilate_px=4.0,
                            exact_stop=False)
        cam = Camera(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
        cfg = _system_config(64, 48, 60.0, num_iters=5, init_iters=10, max_gaussians=8192,
                             window_size=4, covis_window=2)
        n_splats = 600
    else:
        rcfg = RasterConfig(tile=16, tile_capacity=512, max_dup=16, chunk=128, dilate_px=8.0,
                            exact_stop=False)
        cam = Camera(fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72)
        cfg = _system_config(96, 72, 90.0, num_iters=8, init_iters=10, max_gaussians=16384,
                             window_size=4, covis_window=2)
        n_splats = 2500
    frames = list(SyntheticDataset(cam, n_frames=n_frames, n_splats=n_splats, seed=3,
                                   motion_scale=0.05, device="cpu"))

    def run(use_mesh):
        sys_ = System(cfg, max_keyframes=8, raster=rcfg, use_mesh=use_mesh, device="cpu")
        poses = np.stack([sys_.track_rgbd(fr.rgb, fr.depth, fr.timestamp) for fr in frames])
        return sys_, poses

    sys_m, poses = run(True)
    paired = System(cfg, max_keyframes=8, raster=dataclasses.replace(rcfg, paired=True),
                    use_mesh=True, device="cpu")
    result = {
        "mesh_on": sys_m.mesh is not None,
        "poses": poses,
        "map": _map_numpy(sys_m.gm),
        "n_active": int(sys_m.gm.n_active()),
        "paired_track_view": (paired.rcfg_t.paired, paired.rcfg_t.tile_h_px),
    }
    if small:
        sys_s, poses_s = run(False)
        result.update(poses_single=poses_s, map_single=_map_numpy(sys_s.gm))
    return result


JOBS = {"window_step": window_step, "window_steps": window_steps, "track": track,
        "system": system}
