"""Typed configuration with YAML parity.

The port's own copy of ``gsorb_slam_tpu/core/config.py`` (kept field for
field, so a config converts one to one; the port imports nothing of the JAX
package). The reference scatters yaml-cpp reads across the System/Tracking/
Render/Gaussian constructors (``src/System.cc:61-67``, ``src/Tracking.cc:57``,
``src/Render.cc:71``, ``src/Gaussian.cc:11``). Here the whole surface is one
frozen dataclass tree, loadable from the reference's YAML files
(``Examples/RGB-D/*.yaml``) so existing configs keep working.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "synthetic"
    type: str = "tum"  # tum | replica | scannet | kitti
    path: str = ""


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 640
    height: int = 480
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    fps: float = 30.0
    bf: float = 40.0  # stereo baseline * fx (Camera.bf)
    th_depth: float = 40.0  # close/far point threshold in baselines (ThDepth)
    depth_map_factor: float = 5000.0  # raw depth -> meters divisor (DepthMapFactor)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    rgb: int = 1  # 0: BGR, 1: RGB (Camera.RGB)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    # ORBextractor.* (Examples/RGB-D/tum/TUM1.yaml:37-46)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    # Mapping.* (Examples/RGB-D/tum/TUM1.yaml:88-107), consumed by
    # src/Render.cc:71-106 and src/Gaussian.cc:11-19.
    num_iters: int = 100
    im_weight: float = 1.0
    depth_weight: float = 0.7
    sur_depth_weight: float = 0.35
    reg_long_weight: float = 5.0
    reg_scalar_weight: float = 10.0
    lam: float = 0.8  # Mapping.lambda: L1 vs (1-SSIM) mix
    lr_mean3d: float = 0.0001
    lr_rgb: float = 0.0025
    lr_unnorm_rotation: float = 0.001
    lr_logit_opacities: float = 0.05
    lr_log_scales: float = 0.001
    background_color: float = 0.0
    prune_opacities: float = 0.005
    scale_modifier: float = 1.0
    init_scalar_method: int = 2  # 0: 3-NN, 1: clamped 3-NN, 2: SinglePixel
    radius_depth_ratio: float = 3.0
    madien_mul: float = 10.0  # densify threshold = mean + madienMul * median
    # Worst-first per-frame densify budget (0 = unbounded, the reference's
    # behavior). Bounded capacity needs bounded growth: VGA runs added up
    # to 92k splats in ONE frame on noisy depth, saturating the map (and
    # its tile bins) by mid-sequence. 16384 leaves QVGA (typical 3-8k
    # adds) untouched and caps the VGA spikes.
    max_adds_per_frame: int = 16384
    use_radius_filter: bool = False
    # --- Capacity knobs (no reference analog: the reference reallocates
    # tensors on densify; both packages keep a fixed-capacity map) ---
    # 1M-splat safety capacity. Render-path cost scales with the live
    # prefix (splat/gaussians.prefix_view), not this number.
    max_gaussians: int = 2 ** 20
    window_size: int = 20  # optimization window (src/Render.cc:238-239)
    covis_window: int = 11  # covisible KFs in window (src/Render.cc:262-347)
    recent_ba_window: int = 5  # recently-BA'd KFs (src/Render.cc:353-367)
    anchor_frames: int = 4  # global anchor KFs (src/Render.cc:247-258)
    prune_every: int = 50  # prune cadence in frames (src/Render.cc:211-217)
    init_iters: int = 200  # frame-0 warm-up iters (src/Render.cc:520-549)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    # Tracking.* (Examples/RGB-D/tum/TUM1.yaml:108-115), src/Render.cc:985-1141.
    num_iters: int = 200
    lr_cam_quat: float = 0.002
    lr_cam_trans: float = 0.00215
    im_weight: float = 0.7
    feature_weight: float = 0.1
    depth_weight: float = 1.0
    use_sur_depth: bool = True
    lost_num_iters: int = 200  # iters when ORB fails (src/Tracking.cc:339-350)
    early_stop_delta: float = 1e-3  # |dloss| stop (src/Render.cc:1101-1111)
    n_ref_points: int = 1600  # keyframe ref points (src/Tracking.cc:1331-1343)
    overlap_threshold: float = 0.87  # new-KF overlap gate (src/Tracking.cc:1373)
    # In-loop rebinning iterations: rebuild tile bins at the current pose at
    # these iterations so a small dilate_px covers the remaining drift (the
    # reference re-sorts every rasterization). None = derive from num_iters
    # via default_rebin_iters(): long budgets need mid-run refreshes, since
    # a 200-iteration pose walk with one early rebin drifts out of the bins'
    # validity (the JAX package's drift experiment, PLAN.md round 3).
    rebin_iters: tuple | None = None


def default_rebin_iters(num_iters: int) -> tuple:
    """Rebin cadence for a tracking budget: one early rebin after the bulk
    of the correction for short budgets, geometric refreshes for long ones
    (stale bins cost convergence)."""
    if num_iters <= 60:
        return (16,)
    if num_iters <= 120:
        return (8, 40)
    return (8, 40, 120)


@dataclasses.dataclass(frozen=True)
class DebugConfig:
    use_wandb: bool = False
    use_loop: bool = True


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    enable: bool = True
    save_ply: bool = True
    save_root_path: str = "experiments"


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    dataset: DatasetConfig = DatasetConfig()
    camera: CameraConfig = CameraConfig()
    orb: ORBConfig = ORBConfig()
    mapping: MappingConfig = MappingConfig()
    tracking: TrackingConfig = TrackingConfig()
    debug: DebugConfig = DebugConfig()
    eval: EvalConfig = EvalConfig()

    def replace(self, **kw: Any) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def _get(node: Mapping[str, Any], *keys: str, default: Any = None) -> Any:
    for k in keys:
        if node is not None and k in node:
            return node[k]
    return default


def _sub(root: Mapping[str, Any], name: str) -> Mapping[str, Any]:
    node = root.get(name, {}) or {}
    # yaml-cpp also reads flat "Section.key" legacy keys; merge them in.
    prefix = name + "."
    flat = {k[len(prefix):]: v for k, v in root.items() if k.startswith(prefix)}
    merged = dict(flat)
    merged.update(node if isinstance(node, Mapping) else {})
    return merged


def load_config(path_or_dict: Any) -> SystemConfig:
    """Load a :class:`SystemConfig` from a reference-format dict, a YAML
    file (needs PyYAML) or the same tree as a ``.json`` file (read with the
    standard library, for machines without PyYAML)."""
    if isinstance(path_or_dict, Mapping):
        root = dict(path_or_dict)
    elif str(path_or_dict).lower().endswith(".json"):
        with open(path_or_dict) as f:
            root = json.load(f) or {}
    else:
        try:  # only YAML files need PyYAML; dicts load without it
            import yaml
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("PyYAML unavailable; pass a dict instead") from e
        with open(path_or_dict) as f:
            root = yaml.safe_load(f) or {}

    ds = _sub(root, "Dataset")
    cam = _sub(root, "Camera")
    orb = _sub(root, "ORBextractor")
    mp = _sub(root, "Mapping")
    tr = _sub(root, "Tracking")
    dbg = _sub(root, "Debug")
    ev = _sub(root, "Evalution")

    d = SystemConfig()
    return SystemConfig(
        dataset=DatasetConfig(
            name=str(_get(ds, "name", default=d.dataset.name)),
            type=str(_get(ds, "type", default=d.dataset.type)),
            path=str(_get(ds, "path", default=d.dataset.path)),
        ),
        camera=CameraConfig(
            width=int(_get(cam, "width", default=d.camera.width)),
            height=int(_get(cam, "height", default=d.camera.height)),
            fx=float(_get(cam, "fx", default=d.camera.fx)),
            fy=float(_get(cam, "fy", default=d.camera.fy)),
            cx=float(_get(cam, "cx", default=d.camera.cx)),
            cy=float(_get(cam, "cy", default=d.camera.cy)),
            fps=float(_get(cam, "fps", default=d.camera.fps)),
            bf=float(_get(cam, "bf", default=d.camera.bf)),
            th_depth=float(_get(root, "ThDepth", default=d.camera.th_depth)),
            depth_map_factor=float(
                _get(root, "DepthMapFactor", default=d.camera.depth_map_factor)
            ),
            k1=float(_get(cam, "k1", default=0.0)),
            k2=float(_get(cam, "k2", default=0.0)),
            p1=float(_get(cam, "p1", default=0.0)),
            p2=float(_get(cam, "p2", default=0.0)),
            k3=float(_get(cam, "k3", default=0.0)),
            rgb=int(_get(cam, "RGB", default=d.camera.rgb)),
        ),
        orb=ORBConfig(
            n_features=int(_get(orb, "nFeatures", default=d.orb.n_features)),
            scale_factor=float(_get(orb, "scaleFactor", default=d.orb.scale_factor)),
            n_levels=int(_get(orb, "nLevels", default=d.orb.n_levels)),
            ini_th_fast=int(_get(orb, "iniThFAST", default=d.orb.ini_th_fast)),
            min_th_fast=int(_get(orb, "minThFAST", default=d.orb.min_th_fast)),
        ),
        mapping=MappingConfig(
            num_iters=int(_get(mp, "numIters", default=d.mapping.num_iters)),
            im_weight=float(_get(mp, "imWeight", default=d.mapping.im_weight)),
            depth_weight=float(_get(mp, "depthWeight", default=d.mapping.depth_weight)),
            sur_depth_weight=float(
                _get(mp, "surDepthWeight", default=d.mapping.sur_depth_weight)
            ),
            reg_long_weight=float(
                _get(mp, "regLongWeight", default=d.mapping.reg_long_weight)
            ),
            reg_scalar_weight=float(
                _get(mp, "regScalarWeight", default=d.mapping.reg_scalar_weight)
            ),
            lam=float(_get(mp, "lambda", default=d.mapping.lam)),
            lr_mean3d=float(_get(mp, "lrsMean3D", default=d.mapping.lr_mean3d)),
            lr_rgb=float(_get(mp, "lrsRgb", default=d.mapping.lr_rgb)),
            lr_unnorm_rotation=float(
                _get(mp, "lrsUnnormRotation", default=d.mapping.lr_unnorm_rotation)
            ),
            lr_logit_opacities=float(
                _get(mp, "lrsLogitOpacities", default=d.mapping.lr_logit_opacities)
            ),
            lr_log_scales=float(
                _get(mp, "lrsLogScales", default=d.mapping.lr_log_scales)
            ),
            background_color=float(
                _get(mp, "backgroundColor", default=d.mapping.background_color)
            ),
            prune_opacities=float(
                _get(mp, "pruneOpcities", default=d.mapping.prune_opacities)
            ),
            scale_modifier=float(
                _get(mp, "scaleModifier", default=d.mapping.scale_modifier)
            ),
            init_scalar_method=int(
                _get(mp, "initScalarMethod", default=d.mapping.init_scalar_method)
            ),
            radius_depth_ratio=float(
                _get(mp, "raduisDepthRatio", default=d.mapping.radius_depth_ratio)
            ),
            madien_mul=float(_get(mp, "madienMul", default=d.mapping.madien_mul)),
            use_radius_filter=bool(
                _get(mp, "useRadiusFilter", default=d.mapping.use_radius_filter)
            ),
            max_gaussians=int(_get(mp, "maxGaussians", default=d.mapping.max_gaussians)),
        ),
        tracking=TrackingConfig(
            num_iters=int(_get(tr, "numIters", default=d.tracking.num_iters)),
            lr_cam_quat=float(_get(tr, "lrsCamQuat", default=d.tracking.lr_cam_quat)),
            lr_cam_trans=float(
                _get(tr, "lrsCamTrans", default=d.tracking.lr_cam_trans)
            ),
            im_weight=float(_get(tr, "imWeight", default=d.tracking.im_weight)),
            feature_weight=float(
                _get(tr, "featureWeight", default=d.tracking.feature_weight)
            ),
            depth_weight=float(
                _get(tr, "depthWeight", default=d.tracking.depth_weight)
            ),
            use_sur_depth=bool(
                _get(tr, "useSurDepth", default=d.tracking.use_sur_depth)
            ),
        ),
        debug=DebugConfig(
            use_wandb=bool(_get(dbg, "useWandb", default=d.debug.use_wandb)),
            use_loop=bool(_get(dbg, "useLoop", default=d.debug.use_loop)),
        ),
        eval=EvalConfig(
            enable=bool(_get(ev, "enable", default=d.eval.enable)),
            save_ply=bool(_get(ev, "savePly", default=d.eval.save_ply)),
            save_root_path=str(
                _get(ev, "saveRootPath", default=d.eval.save_root_path)
            ),
        ),
    )
