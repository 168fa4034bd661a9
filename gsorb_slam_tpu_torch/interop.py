"""Carrying state across from the JAX package as plain numpy arrays.

The port imports nothing of ``gsorb_slam_tpu``; a caller that holds a JAX
``GaussianMap`` or ``RasterConfig`` converts it to numpy arrays / a dict
(``np.asarray`` on each field, ``dataclasses.asdict``) and hands them here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.splat.gaussians import PARAM_NAMES, GaussianMap


def gaussian_map_from_numpy(
    d: Mapping[str, Any], device: torch.device | str = "cuda"
) -> GaussianMap:
    """Build the port's map from the JAX ``GaussianMap``'s fields as numpy
    arrays: ``means``, ``rgb``, ``quats``, ``logit_opacities``,
    ``log_scales``, ``active``, ``count``, ``max_z``, ``scene_radius`` and,
    optionally, the Adam state ``adam_m`` / ``adam_v`` (dicts keyed by
    parameter name) and ``adam_t`` (zeros where absent)."""

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    params = {k: f32(d[k]) for k in PARAM_NAMES}

    def moments(key):
        src = d.get(key) or {}
        return {
            k: f32(src[k]) if k in src else torch.zeros_like(params[k]) for k in PARAM_NAMES
        }

    return GaussianMap(
        **params,
        active=torch.as_tensor(np.array(d["active"], bool), device=device),
        count=torch.as_tensor(np.array(d["count"], np.int32), device=device),
        adam_m=moments("adam_m"),
        adam_v=moments("adam_v"),
        adam_t=torch.as_tensor(np.array(d.get("adam_t", 0), np.int32), device=device),
        scene_radius=f32(d["scene_radius"]),
        max_z=f32(d["max_z"]),
    )


def gaussian_map_to_numpy(gm: GaussianMap) -> dict[str, Any]:
    """The inverse of :func:`gaussian_map_from_numpy`."""
    out: dict[str, Any] = {k: getattr(gm, k).detach().cpu().numpy() for k in PARAM_NAMES}
    for k in ("active", "count", "adam_t", "scene_radius", "max_z"):
        out[k] = getattr(gm, k).detach().cpu().numpy()
    out["adam_m"] = {k: v.detach().cpu().numpy() for k, v in gm.adam_m.items()}
    out["adam_v"] = {k: v.detach().cpu().numpy() for k, v in gm.adam_v.items()}
    return out


def raster_config_from_dict(d: Mapping[str, Any]) -> RasterConfig:
    """The port's ``RasterConfig`` from the JAX one's fields
    (``dataclasses.asdict`` of it). Unknown keys raise."""
    names = {f.name for f in dataclasses.fields(RasterConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown RasterConfig fields: {sorted(unknown)}")
    return RasterConfig(**dict(d))
