"""Faults planted under the timed path, for showing that the check catches
them: by the harness tests on the CPU (``slambench/tests``) and, at a
cell's own size on the card, by ``run.py --fault <name>`` (a diagnostic
run, never a benchmark run).

Each fault takes ``setattr`` (or pytest's ``monkeypatch.setattr``) and
replaces one function of the program with a broken one. The faults a cell
of this benchmark can have: a step that returns its state unchanged (the
frontend's pose optimisation, the pose's Adam step, the map's Adam step),
half of the batch left out with the mean taken over the rest (half of the
tracking tiles, half of the mapping image), and an answer altered where it
is produced (the tracked pose, the frontend's seed, 1 cm off). No cell runs
on more than one chip, so there is no exchange to leave out. A stereo cell
can also lose its stereo edges (the pose optimisation called without the
right-image coordinates): :func:`faults_for` lists a sensor's faults.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


def frontend_step_unchanged(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.frontend.ba as BA

    orig = BA.pose_optimization

    def unchanged(T_init, *a, **k):
        return orig(T_init, *a, **k)._replace(T_cw=T_init)

    setattr_(BA, "pose_optimization", unchanged)


def seed_altered(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.frontend.ba as BA

    orig = BA.pose_optimization

    def altered(*a, **k):
        res = orig(*a, **k)
        T_cw = res.T_cw.clone()
        T_cw[0, 3] += 0.01
        return res._replace(T_cw=T_cw)

    setattr_(BA, "pose_optimization", altered)


def pose_step_unchanged(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.slam.tracking as T

    setattr_(T, "pose_adam_step", lambda ps, *a, **k: ps)


def map_step_unchanged(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.slam.mapping as M

    setattr_(M, "adam_step", lambda gm, grads, lrs: gm)


def half_the_tracking_tiles(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.slam.tracking as T

    orig = T.tracking_loss_grad

    def half(packed, counts, *a, **k):
        c = counts.clone()
        c[1::2] = 0
        img, dep, d = orig(packed, c, *a, **k)
        return 2 * img, 2 * dep, 2 * d

    setattr_(T, "tracking_loss_grad", half)


def half_the_mapping_image(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.slam.mapping as M

    orig = M.l1_mapping

    def half(pred, target, mask=None):
        h = pred.shape[0] // 2
        return orig(pred[:h], target[:h], None if mask is None else mask[:h])

    setattr_(M, "l1_mapping", half)


def pose_altered(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.slam.tracking as T

    orig = T.track_frame

    def altered(*a, **k):
        res = orig(*a, **k)
        T_cw = res.T_cw.clone()
        T_cw[0, 3] += 0.01
        return dataclasses.replace(res, T_cw=T_cw)

    setattr_(T, "track_frame", altered)


def stereo_edges_dropped(setattr_: Callable) -> None:
    import gsorb_slam_tpu_torch.frontend.ba as BA

    orig = BA.pose_optimization

    def monocular(*a, obs_ur=None, bf=0.0, **k):
        return orig(*a, **k)

    setattr_(BA, "pose_optimization", monocular)


FAULTS = {f.__name__: f for f in (
    frontend_step_unchanged, seed_altered, pose_step_unchanged, map_step_unchanged,
    half_the_tracking_tiles, half_the_mapping_image, pose_altered, stereo_edges_dropped)}
STEREO_ONLY = ("stereo_edges_dropped",)


def faults_for(sensor: str) -> list[str]:
    """The faults a cell of ``sensor`` (``"rgbd"`` or ``"stereo"``) can
    have, by name."""
    return sorted(f for f in FAULTS if sensor == "stereo" or f not in STEREO_ONLY)
