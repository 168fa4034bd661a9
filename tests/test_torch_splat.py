"""The port's Gaussian map and pose optimizer state against the JAX package:
``empty_map``, ``add_points`` (dead-slot recycling, capacity clamp),
``pose_adam_step``, the numpy interop round trip and the raster config's
conversion. Tolerance 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.config import TrackingConfig as JTrackingConfig
from gsorb_slam_tpu.raster.types import RasterConfig as JRasterConfig
from gsorb_slam_tpu.splat import gaussians as jg
from gsorb_slam_tpu_torch.core.config import TrackingConfig
from gsorb_slam_tpu_torch.interop import (
    TPU_LAYOUT_FIELDS,
    gaussian_map_from_numpy,
    gaussian_map_to_numpy,
    raster_config_from_dict,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig
from gsorb_slam_tpu_torch.splat import gaussians as tg

torch.set_num_threads(1)

TOL = 1e-6
FX, FY = 60.0, 58.0


def _jax_map_numpy(gm) -> dict:
    d = {f.name: getattr(gm, f.name) for f in dataclasses.fields(gm)}
    out = {k: np.asarray(v) for k, v in d.items() if not isinstance(v, dict)}
    out["adam_m"] = {k: np.asarray(v) for k, v in gm.adam_m.items()}
    out["adam_v"] = {k: np.asarray(v) for k, v in gm.adam_v.items()}
    return out


def _assert_maps_equal(tm, jm):
    a, b = gaussian_map_to_numpy(tm), _jax_map_numpy(jm)
    for k in ("means", "rgb", "quats", "logit_opacities", "log_scales",
              "scene_radius", "max_z"):
        np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=TOL, err_msg=k)
    for k in ("active", "count", "adam_t"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for mom in ("adam_m", "adam_v"):
        for k in b[mom]:
            np.testing.assert_allclose(a[mom][k], b[mom][k], atol=TOL, err_msg=f"{mom}.{k}")


def _candidates(rng, m):
    means = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(0.5, 4.0, m)
    rgb = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) < 0.8
    return means, rgb, means[:, 2].copy(), valid


def _add(jm, tm, cand):
    means, rgb, z, valid = cand
    jm = jg.add_points(jm, jnp.asarray(means), jnp.asarray(rgb), jnp.asarray(z),
                       jnp.asarray(valid), FX, FY)
    tm = tg.add_points(tm, torch.as_tensor(means), torch.as_tensor(rgb),
                       torch.as_tensor(z), torch.as_tensor(valid), FX, FY)
    return jm, tm


def test_empty_map_matches_jax():
    _assert_maps_equal(tg.empty_map(32, device="cpu"), jg.empty_map(32))


def test_add_points_recycles_and_clamps_like_jax(rng):
    cap = 64
    jm, tm = jg.empty_map(cap), tg.empty_map(cap, device="cpu")
    jm, tm = _add(jm, tm, _candidates(rng, 40))
    _assert_maps_equal(tm, jm)
    # Kill some rows below the high-water mark (a prune), with nonzero Adam
    # state on the survivors, then add more than the free slots hold.
    dead = rng.uniform(size=cap) < 0.3
    mom = rng.normal(size=(cap, 3)).astype(np.float32)
    jm = dataclasses.replace(
        jm, active=jm.active & ~jnp.asarray(dead),
        adam_m={**jm.adam_m, "means": jnp.asarray(mom)},
    )
    tm = dataclasses.replace(
        tm, active=tm.active & ~torch.as_tensor(dead),
        adam_m={**tm.adam_m, "means": torch.as_tensor(mom)},
    )
    jm, tm = _add(jm, tm, _candidates(rng, 80))
    _assert_maps_equal(tm, jm)
    assert int(tm.active.sum()) == cap  # clamped at capacity
    v = tg.prefix_view(tm, int(tm.count))
    assert v.means.shape[0] == int(tm.count)
    np.testing.assert_array_equal(v.active.numpy(), tm.active.numpy()[: int(tm.count)])


def test_pose_adam_step_matches_jax(rng):
    q = rng.normal(size=4).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    jps = jg.init_pose_state(jnp.asarray(q), jnp.asarray(t))
    tps = tg.init_pose_state(torch.as_tensor(q), torch.as_tensor(t))
    jc, tc = JTrackingConfig(), TrackingConfig()
    for _ in range(5):
        gq = rng.normal(size=4).astype(np.float32)
        gt = rng.normal(size=3).astype(np.float32)
        jps = jg.pose_adam_step(jps, jnp.asarray(gq), jnp.asarray(gt), jc)
        tps = tg.pose_adam_step(tps, torch.as_tensor(gq), torch.as_tensor(gt), tc)
    for k in ("quat", "trans", "m_quat", "v_quat", "m_trans", "v_trans"):
        np.testing.assert_allclose(getattr(tps, k).numpy(), np.asarray(getattr(jps, k)),
                                   atol=TOL, rtol=TOL, err_msg=k)
    assert int(tps.t) == int(jps.t)


def test_interop_round_trip(rng):
    jm = jg.empty_map(48)
    jm = jg.add_points(jm, *map(jnp.asarray, _candidates(rng, 30)), FX, FY)
    d = _jax_map_numpy(jm)
    tm = gaussian_map_from_numpy(d, device="cpu")
    _assert_maps_equal(tm, jm)
    back = gaussian_map_to_numpy(tm)
    for k in ("means", "active", "count", "max_z"):
        np.testing.assert_array_equal(back[k], d[k])
    jr = JRasterConfig(tile=16, tile_capacity=512, track_tile_capacity=256, chunk=64,
                       dilate_px=2.0, exact_stop=False, elem_bf16=True)
    tr = raster_config_from_dict(dataclasses.asdict(jr))
    assert dataclasses.asdict(tr) == {k: getattr(jr, k) for k in dataclasses.asdict(tr)}
    assert (tr.tile_w_px, tr.tile_h_px) == (jr.tile_w_px, jr.tile_h_px)


def test_raster_config_from_jax_drops_the_tpu_layout_fields():
    """The port's ``RasterConfig`` has the JAX one's 12 fields that are not
    TPU layout. A JAX config with every field off its default converts to
    a port config equal to it on those 12; any other unknown key raises."""
    names = [f.name for f in dataclasses.fields(RasterConfig)]
    jfields = {f.name: f.default for f in dataclasses.fields(JRasterConfig)}
    assert len(names) == 12 and set(jfields) - set(names) == set(TPU_LAYOUT_FIELDS)

    def off(v):
        if isinstance(v, bool):
            return not v
        return "pallas" if isinstance(v, str) else 2 * v + 1

    jr = JRasterConfig(**{k: off(v) for k, v in jfields.items()})
    assert all(getattr(jr, k) != v for k, v in jfields.items())
    d = dataclasses.asdict(jr)
    tr = raster_config_from_dict(d)
    assert {k: getattr(tr, k) for k in names} == {k: getattr(jr, k) for k in names}
    with pytest.raises(ValueError, match="not_a_field"):
        raster_config_from_dict(dict(d, not_a_field=1))
