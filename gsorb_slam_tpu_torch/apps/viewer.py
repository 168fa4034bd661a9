"""Offline map viewer: render flythroughs and novel views of a saved model
(counterpart of ``gsorb_slam_tpu/apps/viewer.py``).

The stand-in for the reference's Pangolin / GLFW+ImGui viewers
(``src/Viewer.cc``, ``src/Viewer2.cc``): render any pose with the port's
rasterizer (``Render::Viwer`` semantics, ``src/Render.cc:179-193``; K3 on
the card, its plain version with ``--cpu``) at the JAX app's raster
configuration (tile 16, capacity 1024, max_dup 16, chunk 128) and write
``view_%04d.png`` frames that any client can display. ``--mode orbit``
circles the map's centroid; ``--mode replay`` follows a TUM-format
trajectory. ``--config`` takes a ``.json`` file as every app of the port
does (a YAML file needs PyYAML).

Usage:
    python -m gsorb_slam_tpu_torch.apps.viewer --ply out/GaussianModel.ply \\
        --config cfg.json --mode orbit --frames 60 --out viewer_out/ [--cpu]
    python -m gsorb_slam_tpu_torch.apps.viewer --ply ... --traj traj.txt --mode replay
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def orbit_poses(means: np.ndarray, frames: int, radius: float) -> list[np.ndarray]:
    """``frames`` T_cw around the centroid of ``means``, ``radius`` off it,
    backed off by the centroid's distance from the origin (2 m at the
    origin), looking at it (y down)."""
    center = np.asarray(means).mean(axis=0)
    poses = []
    for i in range(frames):
        ang = 2 * np.pi * i / frames
        offset = np.array([radius * np.sin(ang), 0.0, -radius * np.cos(ang)])
        eye = center + offset - np.array([0, 0, np.linalg.norm(center) or 2.0])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R_wc = np.stack([right, up2, fwd], axis=1)
        T_cw = np.eye(4, dtype=np.float32)
        T_cw[:3, :3] = R_wc.T
        T_cw[:3, 3] = -R_wc.T @ eye
        poses.append(T_cw)
    return poses


def save_png(path: str, img: np.ndarray) -> None:
    """``[H, W, 3]`` RGB in [0, 1] -> an 8-bit PNG (cv2, else Pillow)."""
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        from PIL import Image

        Image.fromarray(arr).save(path)
    else:
        cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", default="orbit", choices=["orbit", "replay"])
    ap.add_argument("--traj", default=None, help="trajectory for replay mode")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--out", default="viewer_out")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="render on the CPU (plain versions)")
    args = ap.parse_args(argv)

    import torch

    from gsorb_slam_tpu_torch.core.camera import Camera
    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval.ply import load_gaussian_ply
    from gsorb_slam_tpu_torch.raster import RasterConfig, render

    dev = torch.device("cpu" if args.cpu else "cuda")
    cc = load_config(args.config).camera
    cam = Camera(fx=cc.fx, fy=cc.fy, cx=cc.cx, cy=cc.cy, width=cc.width, height=cc.height)
    model = load_gaussian_ply(args.ply)
    p = {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in model.items()}
    active = torch.ones(len(model["means"]), dtype=torch.bool, device=dev)
    rcfg = RasterConfig(tile=16, tile_capacity=1024, max_dup=16, chunk=128)
    os.makedirs(args.out, exist_ok=True)

    if args.mode == "replay":
        from gsorb_slam_tpu_torch.eval.trajectory import load_tum

        poses = [T for _, T in load_tum(args.traj)][:: args.stride]
    else:
        poses = orbit_poses(model["means"], args.frames, args.radius)

    for i, T_cw in enumerate(poses):
        with torch.no_grad():
            out = render(p["means"], p["rgb"], p["quats"], p["logit_opacities"],
                         p["log_scales"], active,
                         torch.as_tensor(np.asarray(T_cw, np.float32), device=dev), cam, rcfg)
        save_png(os.path.join(args.out, f"view_{i:04d}.png"), out.color.cpu().numpy())
        if i % 10 == 0:
            print(f"rendered {i + 1}/{len(poses)}")
    print(f"wrote {len(poses)} frames to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
