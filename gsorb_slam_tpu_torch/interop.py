"""Carrying state across from the JAX package as plain numpy arrays.

The port imports nothing of ``gsorb_slam_tpu``; a caller that holds a JAX
``GaussianMap``, ``WindowFrames``, ``RasterConfig``, ``ORBFeatures``,
``Vocabulary`` or the ORB System's frontend state converts it to numpy
arrays / a dict (``np.asarray`` on each field, ``dataclasses.asdict`` or
``_asdict``; the frontend state is the dict of the JAX System's
``_frontend_state``) and hands them here. Descriptors cross as
``np.uint32`` words and live in the port as ``int32`` with the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from gsorb_slam_tpu_torch.core import config as C
from gsorb_slam_tpu_torch.frontend.orb import ORBFeatures
from gsorb_slam_tpu_torch.frontend.vocab import Vocabulary
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


def orb_features_from_numpy(d: Mapping[str, Any],
                            device: torch.device | str = "cuda") -> ORBFeatures:
    """The port's ``ORBFeatures`` from the JAX one's fields as numpy arrays
    (``uv``, ``response``, ``angle``, ``octave``, ``descriptors`` as
    ``uint32``, ``valid`` and, optionally, ``uv_raw``)."""

    def t(x, dtype):
        return torch.as_tensor(np.array(x, dtype), device=device)

    desc = np.ascontiguousarray(d["descriptors"])
    if desc.dtype != np.int32:
        desc = desc.astype(np.uint32).view(np.int32)
    uv_raw = d.get("uv_raw")
    return ORBFeatures(
        uv=t(d["uv"], np.float32), response=t(d["response"], np.float32),
        angle=t(d["angle"], np.float32), octave=t(d["octave"], np.int32),
        descriptors=torch.as_tensor(desc, device=device), valid=t(d["valid"], bool),
        uv_raw=t(uv_raw, np.float32) if uv_raw is not None else None,
    )


def vocabulary_from_numpy(d: Mapping[str, Any]) -> Vocabulary:
    """The port's ``Vocabulary`` from the JAX one's fields
    (``dataclasses.asdict`` of it)."""
    return Vocabulary(
        k=int(d["k"]), L=int(d["L"]), children=np.array(d["children"], np.int32),
        node_desc=np.array(d["node_desc"], np.uint32), word_id=np.array(d["word_id"], np.int32),
        weights=np.array(d["weights"], np.float32), n_words=int(d["n_words"]),
    )


def frontend_state_from_numpy(state: Mapping[str, Any], fe, loop_closer=None) -> None:
    """Load the ORB System's frontend state, the dict that the JAX System's
    ``_frontend_state`` writes (and the port's), into the geometric
    frontend ``fe`` and, where the dict has a ``loop_db``, ``loop_closer``:
    the map points (``n_points``, ``pt_pos``, ``pt_desc``, ``pt_valid``,
    ``pt_visible``, ``pt_found``, ``pt_first_kf``), ``kf_counter``, the
    keyframes (features, point ids, poses) and the BoW database with its
    consistency streaks. What the dict does not hold keeps its value, as in
    the JAX restore."""
    from gsorb_slam_tpu_torch.slam.geometric import KeyFrameFeatures

    n = int(state["n_points"])
    fe.n_points = n
    for name in ("pt_pos", "pt_desc", "pt_valid", "pt_visible", "pt_found", "pt_first_kf"):
        getattr(fe, name)[:n] = state[name]
    fe.kf_counter = int(state["kf_counter"])
    fe.keyframes = [
        KeyFrameFeatures(kf_id=int(d["kf_id"]), frame_id=int(d["frame_id"]),
                         feats=orb_features_from_numpy(d["feats"], fe.device),
                         point_ids=np.array(d["point_ids"], np.int32),
                         T_cw=np.array(d["T_cw"], np.float32))
        for d in state["keyframes"]
    ]
    if loop_closer is not None and "loop_db" in state:
        db = loop_closer.db
        db.inverted = {int(w): set(int(k) for k in ks)
                       for w, ks in state["loop_db"]["inverted"].items()}
        db.bows = {int(k): {int(w): float(v) for w, v in bow.items()}
                   for k, bow in state["loop_db"]["bows"].items()}
        loop_closer.consistency = {int(k): int(v)
                                   for k, v in state["loop_db"]["consistency"].items()}
