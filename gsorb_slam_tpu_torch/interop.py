"""Carrying state across from the JAX package as plain numpy arrays.

The port imports nothing of ``gsorb_slam_tpu``; a caller that holds a JAX
``GaussianMap``, ``WindowFrames`` or ``RasterConfig`` converts it to numpy
arrays / a dict (``np.asarray`` on each field, ``dataclasses.asdict`` or
``_asdict``) and hands them here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from gsorb_slam_tpu_torch.core import config as C
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.slam.mapping import WindowFrames
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


def window_frames_from_numpy(
    d: Mapping[str, Any], device: torch.device | str = "cuda"
) -> WindowFrames:
    """The port's ``WindowFrames`` from the JAX one's fields as numpy arrays:
    ``colors``, ``depths``, ``poses``, ``bins_indices``, ``bins_counts`` and
    ``n_frames``."""

    def t(x, dtype):
        return torch.as_tensor(np.array(x, dtype), device=device)

    return WindowFrames(
        colors=t(d["colors"], np.float32),
        depths=t(d["depths"], np.float32),
        poses=t(d["poses"], np.float32),
        bins_indices=t(d["bins_indices"], np.int32),
        bins_counts=t(d["bins_counts"], np.int32),
        n_frames=int(d["n_frames"]),
    )


def system_config_from_dict(d: Mapping[str, Any]) -> C.SystemConfig:
    """The port's ``SystemConfig`` from a reference-format dict (the keys of
    ``configs/*.yaml``), without PyYAML."""
    return C.load_config(dict(d))
