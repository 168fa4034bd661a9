"""The port's profiling path on the CPU: K9's plain version against the JAX
ablation kernel, ``truncation_weight_report`` against the JAX package's, and
every profiler of ``gsorb_slam_tpu_torch.profiling`` end to end with
``--cpu`` at a toy size.

- K9 (``raster.blend_kernels.tracking_loss_grad_ablate_plain``) against the
  ``pallas_call`` of ``scripts/profile_fused_ablate.py`` with every part on
  (the ``full`` variant), in interpret mode: loss 2e-3 relative, gradient
  rows 0-9 8e-4 absolute + 2e-3 relative (the fast-path tolerances of
  ``tests/test_pallas.py``). The reference runs at unit weights, takes its
  depth loss row from the median depth and its depth cotangent from the
  blended depth, so its color loss and gradients are compared with the
  plain version at ``use_sur=False`` and its depth loss at ``use_sur=True``.
- ``truncation_weight_report``: every field within 1e-5.
- Each profiler's ``main(["--cpu", ...])`` at 64x48 (160x120 for
  ``profile_frontend``: ORB needs 32-px cells inside its 19-px border)
  returns finite numbers under its keys. A CPU run times PyTorch's CPU kernels, so those numbers
  say nothing of the card; the tests check only that they exist.
"""

import dataclasses
import functools
import importlib
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsorb_slam_tpu.core.camera import Camera as JCamera
from gsorb_slam_tpu.ops.metrics import truncation_weight_report as jtruncation_weight_report
from gsorb_slam_tpu.raster import RasterConfig as JRasterConfig
from gsorb_slam_tpu.raster import bin_gaussians as jbin
from gsorb_slam_tpu.raster import preprocess as jpreprocess
from gsorb_slam_tpu.raster import render_tiled as jrender_tiled
from gsorb_slam_tpu.raster.pallas_raster import _pack_instances as jpack
from gsorb_slam_tpu.raster.pallas_raster import tile_gt_images as jtile_gt
from gsorb_slam_tpu_torch.core.camera import Camera
from gsorb_slam_tpu_torch.ops.metrics import truncation_weight_report
from gsorb_slam_tpu_torch.raster import preprocess
from gsorb_slam_tpu_torch.raster.blend_kernels import (
    ABLATE_CHUNKS,
    ablate_view,
    tile_gt_images,
    tracking_loss_grad_ablate,
    tracking_loss_grad_ablate_plain,
)
from gsorb_slam_tpu_torch.raster.types import RasterConfig

from tests.scenes import random_cloud_scene, tiny_camera

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG_KW = dict(tile=16, tile_capacity=256, max_dup=16, chunk=64)
KEYS = ("means", "rgb", "quats", "logit_opacities", "log_scales", "active")


def _t(x):
    return torch.as_tensor(np.array(x))


def _load_ablate_script():
    """``scripts/profile_fused_ablate.py`` as a module; its import sets two
    JAX compilation-cache options, which are restored afterwards."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    try:
        spec = importlib.util.spec_from_file_location(
            "profile_fused_ablate_ref", ROOT / "scripts" / "profile_fused_ablate.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return mod


def _reference_ablate(ref, packed, counts, gt4, cam, cfg, B=4):
    """The reference's ``full`` variant, built as its ``run_variant`` builds
    it (``do_exp = do_mxu = do_bwd = True``), in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    cap = packed.shape[2]
    dims = ref._dims_for(cam, cfg, cap)
    T = dims.n_tiles
    assert T % B == 0
    grads, loss = pl.pallas_call(
        functools.partial(ref._kernel, dims=dims, B=B, do_exp=True, do_mxu=True, do_bwd=True,
                          mxu_fast=False, elem_bf16=False),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(T // B,),
            in_specs=[
                pl.BlockSpec((B, ref.N_ATTR, cap), lambda t, *_: (t, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((B, 8, dims.px), lambda t, *_: (t, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=[
                pl.BlockSpec((B, ref.N_ATTR, cap), lambda t, *_: (t, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((B, 1, dims.px), lambda t, *_: (t, 0, 0), memory_space=pltpu.VMEM),
            ],
            scratch_shapes=[
                pltpu.VMEM((cap, dims.px), jnp.float32),
                pltpu.VMEM((cap, dims.px), jnp.float32),
                pltpu.VMEM((8, dims.px), jnp.float32),
                pltpu.VMEM((8, dims.px), jnp.bfloat16),
                pltpu.VMEM((dims.K, dims.K), jnp.bfloat16),
                pltpu.VMEM((dims.K, dims.K), jnp.bfloat16),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((T, ref.N_ATTR, cap), jnp.float32),
            jax.ShapeDtypeStruct((T, 1, dims.px), jnp.float32),
        ],
        interpret=True,
    )(counts, packed, gt4)
    return np.asarray(grads), np.asarray(loss)[:, 0, :2]


@pytest.fixture(scope="module")
def ablate_case():
    """The pack of one random cloud and the gt rendered from another (as
    ``tests/test_pallas.py:134``), at tile capacity 256 and chunk 64, so
    K9's F K = 128 slots leave zero gradient rows past them."""
    rng = np.random.default_rng(0)
    jcfg = JRasterConfig(**CFG_KW, exact_stop=False)
    jc = tiny_camera()
    scene = random_cloud_scene(rng, n=300, capacity=384)
    prep = jpreprocess(*(scene[k] for k in KEYS), jnp.eye(4), jc)
    bins = jbin(prep, jc, jcfg)
    packed = jpack(prep, bins)
    scene2 = random_cloud_scene(rng, n=300, capacity=384)
    prep2 = jpreprocess(*(scene2[k] for k in KEYS), jnp.eye(4), jc)
    ref2 = jrender_tiled(prep2, jbin(prep2, jc, jcfg), jc, jcfg)
    gt_color = ref2.color
    gt_depth = jnp.where(ref2.alpha > 0.3, ref2.median_depth, 0.0)
    gt4 = jtile_gt(gt_color, gt_depth, jc, jcfg)
    ref = _load_ablate_script()
    j_grads, j_loss = _reference_ablate(ref, packed, bins.counts, gt4, jc, jcfg)
    cam = Camera(fx=jc.fx, fy=jc.fy, cx=jc.cx, cy=jc.cy, width=jc.width, height=jc.height)
    tcfg = RasterConfig(**CFG_KW, exact_stop=False)
    tgt4 = tile_gt_images(_t(gt_color), _t(gt_depth), cam, tcfg)
    return dict(packed=_t(packed), gt4=tgt4, cam=cam, cfg=tcfg, j_grads=j_grads, j_loss=j_loss,
                counts=np.asarray(bins.counts))


def test_k9_plain_matches_ablation_kernel(ablate_case):
    c = ablate_case
    packed, gt4, cam, cfg = c["packed"], c["gt4"], c["cam"], c["cfg"]
    fk = ABLATE_CHUNKS * cfg.chunk
    assert fk < packed.shape[2]
    img, dep_b, grads = tracking_loss_grad_ablate_plain(packed, gt4, cam, cfg, 1.0, 1.0, False)
    _, dep_m, _ = tracking_loss_grad_ablate_plain(packed, gt4, cam, cfg, 1.0, 1.0, True)
    j_color, j_depth = c["j_loss"].sum(0)
    assert j_color > 0 and j_depth > 0
    np.testing.assert_allclose(float(img), j_color, rtol=2e-3)
    np.testing.assert_allclose(float(dep_m), j_depth, rtol=2e-3)
    np.testing.assert_allclose(grads[:, :10].numpy(), c["j_grads"][:, :10], atol=8e-4, rtol=2e-3)
    assert float(np.abs(c["j_grads"][:, :10]).max()) > 1e-2  # a non-trivial gradient
    assert not grads[:, :, fk:].any() and not grads[:, 10:].any()
    # The wrapper takes the plain version for CPU tensors; fwd keeps full's
    # loss rows and has no gradient.
    w_img, w_dep, w_grads = tracking_loss_grad_ablate(packed, gt4, cam, cfg, 1.0, 1.0, False)
    assert torch.equal(w_grads, grads) and float(w_img) == float(img)
    f_img, f_dep, f_grads = tracking_loss_grad_ablate(packed, gt4, cam, cfg, 1.0, 1.0, False,
                                                      variant="fwd")
    assert float(f_img) == float(img) and float(f_dep) == float(dep_b) and not f_grads.any()


@pytest.mark.parametrize("variant", ["noexp", "noreduce", "min", "half2", "nope"])
def test_k9_timing_variants_raise_on_cpu(ablate_case, variant):
    c = ablate_case
    with pytest.raises(ValueError):
        tracking_loss_grad_ablate(c["packed"], c["gt4"], c["cam"], c["cfg"], 1.0, 1.0, True,
                                  variant=variant)


def test_k9_view_needs_two_chunks():
    cfg = RasterConfig(**dict(CFG_KW, chunk=256))
    with pytest.raises(ValueError):
        ablate_view(torch.zeros((12, 16, 256)), cfg)


def test_truncation_weight_report_matches_jax(rng):
    """``tests/test_raster.py:312``'s saturated scene through both packages."""
    from tests.scenes import identity_pose

    jc = tiny_camera()
    n = 1200
    means = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.2, 0.2, n),
                      rng.uniform(1.2, 3.0, n)], -1).astype(np.float32)
    args = (means, rng.uniform(0, 1, (n, 3)).astype(np.float32),
            np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
            np.full((n,), 6.0, np.float32), np.full((n, 3), np.log(0.3), np.float32),
            np.ones((n,), bool))
    jprep = jpreprocess(*(jnp.asarray(a) for a in args), identity_pose(), jc)
    want = jtruncation_weight_report(jprep, jc, JRasterConfig(**dict(CFG_KW, tile_capacity=64)),
                                     oracle_capacity=4096)
    cam = Camera(fx=jc.fx, fy=jc.fy, cx=jc.cx, cy=jc.cy, width=jc.width, height=jc.height)
    prep = preprocess(*(torch.as_tensor(a) for a in args), torch.eye(4), cam)
    got = truncation_weight_report(prep, cam, RasterConfig(**dict(CFG_KW, tile_capacity=64)),
                                   oracle_capacity=4096)
    assert set(got) == set(want)
    assert got["oracle_dropped"] == want["oracle_dropped"] == 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["inst_dropped_frac"] > 0.5  # truncation is exercised


def _finite(d) -> bool:
    """Every number in a nested result is finite (strings are labels)."""
    if isinstance(d, dict):
        return all(_finite(v) for v in d.values())
    if isinstance(d, (list, tuple)):
        return all(_finite(v) for v in d)
    if isinstance(d, (int, float)):
        return math.isfinite(d)
    return d is None or isinstance(d, str)


SMALL = ["--cpu", "--width", "64", "--height", "48", "--splats", "2000", "--map-capacity", "4096"]
PROFILERS = [
    ("profile_fused_ablate", SMALL + ["--reps", "1", "--chunk", "64"],
     lambda r: [r["k1_ms"], *(r["variants"][v]["ms"] for v in ("full", "fwd"))]),
    ("profile_track", SMALL + ["--iters", "2", "--runs", "1"],
     lambda r: [r["variants"]["bench config"]["ms_per_iter"], r["bare_loop_ms_per_iter"],
                r["value_and_grad_ms"], r["pose_adam_ms"]]),
    ("profile_map_full", SMALL + ["--iters", "1", "--runs", "1"],
     lambda r: [r["ms_per_iter"][k] for k in ("full", "no_ssim", "fwd_only", "grad_no_adam",
                                              "grad_sorted", "adam_only")]),
    ("profile_map_iter", SMALL + ["--reps", "1", "--capacity", "256"], lambda r: r["ms"].values()),
    ("profile_raster", SMALL + ["--reps", "1", "--capacity", "256"], lambda r: r["ms"].values()),
    ("profile_fused", SMALL + ["--reps", "1", "--chunks", "64,128"],
     lambda r: [v for c in r["chunks"].values() for v in c.values()]),
    ("profile_paired_parts", SMALL + ["--reps", "1"], lambda r: r["ms"].values()),
    ("profile_gather", SMALL + ["--reps", "1"], lambda r: r["ms"].values()),
    ("profile_mapping_quality",
     ["--cpu", "--frames", "2", "--wh", "64", "48", "--map-iters", "2", "--init-iters", "2",
      "--max-gaussians", "8192", "--splat-spacing", "0.2", "--ablate", "base,lr2"],
     lambda r: [v for a in r["ablations"].values() for v in (a["psnr"], a["depth_l1"],
                                                             a["wall_s"])]),
    ("profile_frontend",
     ["--cpu", "--frames", "3", "--width", "160", "--height", "120", "--splat-spacing", "0.1",
      "--top", "3"],
     lambda r: [r["ms_per_frame"], r["first_extract_s"], *r["phase_ms_per_frame"].values()]),
]


@pytest.mark.parametrize("name,argv,numbers", PROFILERS, ids=[p[0] for p in PROFILERS])
def test_profiler_runs_on_cpu(name, argv, numbers):
    """Each profiler's ``main`` with ``--cpu`` at 64x48 returns finite numbers
    under its keys, names the CPU as its device, and measures no device
    metric there."""
    mod = importlib.import_module(f"gsorb_slam_tpu_torch.profiling.{name}")
    res = mod.main(argv)
    assert res["device"] == "cpu"
    vals = list(numbers(res))
    assert vals and all(isinstance(v, float) and math.isfinite(v) and v >= 0 for v in vals)
    assert _finite(res)
    profiles = [res.get("profile")] + [v.get("profile") for v in res.get("variants", {}).values()
                                       if isinstance(v, dict)]
    assert all(p is None for p in profiles)


def test_profilers_need_a_card_or_cpu(monkeypatch):
    """Without ``--cpu`` a profiler runs on the card, and raises without one."""
    from gsorb_slam_tpu_torch.profiling import profile_gather

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        profile_gather.main(["--width", "64", "--height", "48", "--splats", "100"])


def test_count_pairs_batches_add_up():
    """``count_pairs`` counts a view tile batch by tile batch: the sums
    equal one blend over every tile, and each warp visits at least the
    pairs its lanes applied."""
    from gsorb_slam_tpu_torch.profiling import count_pairs

    res = count_pairs.main(SMALL + ["--tile-batch", "5"])
    whole = count_pairs.main(SMALL + ["--tile-batch", "1000"])
    assert res["device"] == "cpu"
    for name in ("K1", "K7", "K8", "K3 / K6 (render bins)"):
        assert res[name] == whole[name]
        assert 0 < res[name]["applied"] <= res[name]["warp_visits"]


def test_compare_trees_needs_a_card(monkeypatch):
    """The tree comparison (``compare_trees.py`` at the repository's root)
    measures on the card only."""
    spec = importlib.util.spec_from_file_location("compare_trees", ROOT / "compare_trees.py")
    compare_trees = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(compare_trees)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        compare_trees.main(["--run", "change=."])
