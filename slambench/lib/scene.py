"""Analytic scenes ray-cast on the device: the benchmark's own frames.

A scene is a JSON file under ``slambench/scenes/``: a list of axis-aligned
boxes in a z-up world, each with a base colour and a procedural texture.
One box may be ``"inside": true`` (the room, seen from within); the others
are solid cuboids (a desk, clutter, furniture). A ray takes the nearest
hit over all boxes. Nothing here comes from the program under test.

The texture is sharp-edged on purpose, so that an ORB extractor finds
corners and the tracking loss sees gradients: a grid of cells of random
grey level (``cell`` metres), a finer grid on top (``fine_cell``) and, per
box, its base colour. Both grids are hashed from the integer cell
coordinates and the box index, so a scene is the same on every device and
seed: the seed moves the camera and the sensor noise, never the room.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch


@dataclass(frozen=True)
class Box:
    lo: tuple[float, float, float]
    hi: tuple[float, float, float]
    inside: bool
    color: tuple[float, float, float]
    cell: float
    fine_cell: float
    contrast: float


@dataclass(frozen=True)
class Scene:
    name: str
    boxes: tuple[Box, ...]


def load_scene(path: Path) -> Scene:
    spec = json.loads(Path(path).read_text())
    boxes = []
    for b in spec["boxes"]:
        tex = {**spec.get("texture", {}), **b.get("texture", {})}
        boxes.append(Box(
            lo=tuple(float(x) for x in b["min"]), hi=tuple(float(x) for x in b["max"]),
            inside=bool(b.get("inside", False)), color=tuple(float(x) for x in b["color"]),
            cell=float(tex["cell"]), fine_cell=float(tex["fine_cell"]),
            contrast=float(tex["contrast"]),
        ))
    if sum(b.inside for b in boxes) > 1:
        raise ValueError(f"scene {spec['name']}: at most one box may be seen from inside")
    return Scene(name=spec["name"], boxes=tuple(boxes))


def _hash01(i: torch.Tensor, j: torch.Tensor, k: torch.Tensor, salt: int) -> torch.Tensor:
    """A value in [0, 1) from integer lattice coordinates (int64 tensors),
    by an integer mix that is exact on every device."""
    h = (i * 73856093) ^ (j * 19349663) ^ (k * 83492791) ^ (salt * 2654435761)
    h = h & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177
    h = h & 0x7FFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65536.0


def _texture(p: torch.Tensor, box_idx: int, box: Box) -> torch.Tensor:
    """Grey level in [0, 1] at world points ``p [N, 3]`` on ``box``."""
    c = torch.floor(p / box.cell).to(torch.int64)
    f = torch.floor(p / box.fine_cell).to(torch.int64)
    coarse = _hash01(c[:, 0], c[:, 1], c[:, 2], 2 * box_idx + 1)
    fine = _hash01(f[:, 0], f[:, 1], f[:, 2], 2 * box_idx + 2)
    g = 0.65 * coarse + 0.35 * fine
    return (1.0 - box.contrast) + box.contrast * g


def cast(scene: Scene, origins: torch.Tensor, dirs: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of rays ``origins + t dirs`` (``[N, 3]`` each, world
    frame). Returns ``(t [N], rgb [N, 3])``; ``t`` is +inf where no box is
    hit (black there)."""
    n = dirs.shape[0]
    dev = dirs.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_box = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    for bi, box in enumerate(scene.boxes):
        lo = torch.tensor(box.lo, device=dev)
        hi = torch.tensor(box.hi, device=dev)
        t0 = (lo - origins) * inv
        t1 = (hi - origins) * inv
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        if box.inside:
            t = torch.where(t_far > 1e-6, t_far, torch.full_like(t_far, float("inf")))
        else:
            hit = (t_near <= t_far) & (t_near > 1e-6)
            t = torch.where(hit, t_near, torch.full_like(t_near, float("inf")))
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_box = torch.where(closer, torch.full_like(best_box, bi), best_box)
    p = origins + best_t.clamp(max=1e6)[:, None] * dirs
    rgb = torch.zeros((n, 3), device=dev)
    for bi, box in enumerate(scene.boxes):
        sel = best_box == bi
        if not bool(sel.any()):
            continue
        # Nudge the point into the box face, so the lattice cell of a
        # point on a face is that face's, not its neighbour's.
        ps = p[sel]
        g = _texture(ps + 1e-5 * dirs[sel], bi, box)
        rgb[sel] = g[:, None] * torch.tensor(box.color, device=dev)[None, :]
    return best_t, rgb
