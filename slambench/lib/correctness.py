"""The check that decides ``correct``: the plain reference
(``slambench.reference``) against what the timed path produced.

The reference follows the program step by step from the program's own
state: the ORB frontend's predicted pose and matches (the map points its
search found, which the check takes as given), the map when the sampled
frame was tracked with the seed pose and matches, the pose of each
tracking iterate, the map before a mapping iteration with its Adam
moments. Re-running a whole frame's 200
tracking and 100 mapping iterations in plain PyTorch would take minutes.
At each step it works out the tile lists, the projection, the blend, the
loss, the gradients and the Adam step itself, from the map rows and the
frame's images.

Four numbers, one per layer the window drives; each is the widest of its
parts:

- ``frontend`` (the ORB frontend's pose seed, ``frontend/ba.py`` as
  ``slam/geometric.py`` calls it): the pose the program's motion-only
  bundle adjustment returned against the reference's solve
  (``slambench.reference.pose``, float64) from the same predicted pose
  and matches (on a stereo frame with the same right-image coordinates:
  the program's SGBM depth and stereo matches are taken as given); the
  seed the tracking solve was handed against the reference's (its pose where it keeps 10 inliers or more, else the
  prediction); and the share of the handed match slots that differ from
  the reference's inliers in order. Poses in metres and rotation entries,
  the widest entry of the 3x4 gap;
- ``track`` (K2f, K1, K2b and the pose solve), at the sampled iterates:
  the fused kernel's gradient for every tile instance (``d_screen``)
  against the reference's; the pose gradient against the reference's
  adjoint of the program's ``d_screen`` (plus its feature term); the
  program's pose steps over the whole solve against Adam's from the
  program's moments and gradients; and the pose the System returned
  against the program's best iterate;
- ``map`` (preprocess, K4, K5, the losses and Adam), on one mapping
  iteration on the window's current frame: the gradient of every splat row
  against the reference's, and the program's stepped map against Adam from
  its moments and gradient;
- ``render`` (K3, the render at the tracked pose that densification
  reads): every pixel's colour and depth against the reference's render of
  the same map at the program's best tracking iterate.

Gradient and image gaps are 90th percentiles over elements, each element's
gap scaled by the mean magnitude of its kind in the reference. Where a
pixel's alpha sits on a gate (the 0.99 mask, the 1/255 cut, the stop, the
median's T = 0.5 crossing) a rounding flips its decision and moves its
splats' gradients by far more than rounding: a few hundred of a frame's
hundreds of thousands of elements, which a sum would carry and a
percentile does not. The control (TF32 in the reference's matrix
products, the precision below the configuration's) moves every element.
Step and answer gaps are relative norms.

The control puts the reference computed with TF32 in the program's place:
its own pose seed and matches, d_screen, pose gradient, Adam steps, map
gradients and render.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from slambench.reference import pose as P
from slambench.reference import render as R
from slambench.reference.optim import adam_moments, adam_update

CHI2_INLIER = 5.991  # 95% chi^2, 2 degrees of freedom (the source's gate)
QUANTILE = 0.9
NAMES = ("means", "rgb", "quats", "logit_opacities", "log_scales")


@dataclass
class Setting:
    """What the reference needs from the configuration."""

    cam: R.Cam
    track_tiling: R.Tiling
    render_tiling: R.Tiling
    tw: dict  # tracking weights and learning rates
    mw: dict  # mapping weights and learning rates
    betas: tuple[float, float]
    eps: float
    scale_modifier: float


def setting_from_config(cfg: dict) -> Setting:
    sysc = cfg["system"]
    cam = sysc["Camera"]
    rs = cfg["raster"]
    tr, mp = sysc["Tracking"], sysc["Mapping"]
    return Setting(
        cam=R.Cam(fx=float(cam["fx"]), fy=float(cam["fy"]), cx=float(cam["cx"]),
                  cy=float(cam["cy"]), width=int(cam["width"]), height=int(cam["height"])),
        track_tiling=R.Tiling(rs["tile"], rs["track_tile_capacity"], rs["max_dup"],
                              float(rs["dilate_px"])),
        render_tiling=R.Tiling(rs["tile"], rs["tile_capacity"], rs["max_dup"],
                               float(rs["dilate_px"])),
        tw=dict(im_weight=float(tr["imWeight"]), depth_weight=float(tr["depthWeight"]),
                feature_weight=float(tr["featureWeight"]), use_sur_depth=bool(tr["useSurDepth"]),
                lr_q=float(tr["lrsCamQuat"]), lr_t=float(tr["lrsCamTrans"])),
        mw=dict(lam=float(mp["lambda"]), im_weight=float(mp["imWeight"]),
                depth_weight=float(mp["depthWeight"]),
                sur_depth_weight=float(mp["surDepthWeight"]),
                reg_long_weight=float(mp["regLongWeight"]),
                reg_scalar_weight=float(mp["regScalarWeight"]),
                lr={"means": float(mp["lrsMean3D"]), "rgb": float(mp["lrsRgb"]),
                    "quats": float(mp["lrsUnnormRotation"]),
                    "logit_opacities": float(mp["lrsLogitOpacities"]),
                    "log_scales": float(mp["lrsLogScales"])}),
        betas=tuple(float(b) for b in cfg["optimizer"]["betas"]),
        eps=float(cfg["optimizer"]["eps"]),
        scale_modifier=float(mp.get("scaleModifier", 1.0)),
    )


def track_targets(num_iters: int) -> tuple[int, ...]:
    """The tracking iterates the check reads: the second, the middle one
    and the one before the last (each has a next iterate)."""
    return tuple(sorted({i for i in (1, num_iters // 2, num_iters - 2) if i >= 0}))


def splats(rows: dict, requires_grad: bool = False) -> R.Splats:
    p = {k: rows[k].detach().clone().requires_grad_(requires_grad) for k in NAMES}
    return R.Splats(active=rows["active"], **p)


def _rel(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None) -> float:
    """||a - b|| / ||scale or b||, in float64."""
    a, b = a.detach().double(), b.detach().double()
    s = b if scale is None else scale.detach().double()
    return float((a - b).norm() / s.norm().clamp(min=1e-30))


def elem_gap(p: torch.Tensor, r: torch.Tensor, live: torch.Tensor | None = None) -> float:
    """The 90th percentile of |p - r| / mean |r| over the elements of one
    kind (``live`` selects them)."""
    p, r = p.detach().double(), r.detach().double()
    if live is not None:
        p, r = p[live], r[live]
    if r.numel() == 0:
        return 0.0
    scale = r.abs().mean().clamp(min=1e-30)
    d = ((p - r).abs() / scale).flatten()
    if d.numel() > 1 << 24:  # quantile's input limit: a fixed stride sample
        d = d[:: -(-d.numel() // (1 << 24))]
    return float(torch.quantile(d.float(), QUANTILE))


# ------------------------------------------------------------------ frontend

MIN_SEED_INLIERS = 10  # fewer inliers and the motion model seeds the tracker


def frontend_pose(rec: dict, st: Setting, dtype: torch.dtype) -> tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """The reference's pose solve from the captured inputs; on a stereo
    frame with the right-image coordinates and ``bf`` the program was
    handed (its ORB stereo matches, taken as given)."""
    c, opts = st.cam, rec["options"]
    return P.pose_only(rec["T_pred"].to(dtype), rec["world"].to(dtype), rec["obs_uv"],
                       rec["inv_sigma2"], rec["valid"], c.fx, c.fy, c.cx, c.cy,
                       obs_ur=opts.get("obs_ur"), bf=opts.get("bf", 0.0))


def _seed_and_matches(rec: dict, T: torch.Tensor, inliers: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """The seed and the padded matches a pose ``T`` with ``inliers`` hands
    to the tracker: the inliers in order, as many as the slots hold."""
    n_slots = rec["matches"]["valid"].shape[0]
    sel = torch.nonzero(inliers).flatten()[:n_slots]
    if int(inliers.sum()) < MIN_SEED_INLIERS:
        return rec["T_pred"].double(), None
    k = sel.numel()
    m = {"obs_uv": torch.zeros_like(rec["matches"]["obs_uv"]),
         "world": torch.zeros_like(rec["matches"]["world"]),
         "inv_sigma2": torch.ones_like(rec["matches"]["inv_sigma2"]),
         "valid": torch.zeros_like(rec["matches"]["valid"])}
    m["obs_uv"][:k] = rec["obs_uv"][sel]
    m["world"][:k] = rec["world"][sel].to(m["world"].dtype)
    m["inv_sigma2"][:k] = rec["inv_sigma2"][sel]
    m["valid"][:k] = True
    return T.double(), m


def _match_gap(got: dict, want: dict | None) -> float:
    """The share of match slots that differ (valid flag, or any value of a
    valid slot), over the slots valid on either side."""
    gv = got["valid"]
    if want is None:  # the motion model seeds: no feature term
        return float(gv.any())
    wv = want["valid"]
    diff = gv != wv
    both = gv & wv
    for k in ("obs_uv", "world", "inv_sigma2"):
        a, b = got[k][both], want[k][both]
        d = (a != b).reshape(a.shape[0], -1).any(-1) if a.numel() else torch.zeros(
            0, dtype=torch.bool, device=gv.device)
        diff[both] |= d
    return float(diff.sum()) / max(int((gv | wv).sum()), 1)


def frontend_numbers(rec: dict, st: Setting, control: bool = False) -> dict[str, float]:
    """The program's (or, with ``control``, the TF32 reference's) pose
    optimisation, seed and matches against the float64 reference's."""
    opts = rec["options"]
    if any(opts.get(k, d) != d for k, d in (("rounds", P.ROUNDS), ("iters_per_round", P.ITERS))):
        return {"frontend": float("inf")}  # not the pose optimisation the reference follows
    T_ref, inl_ref = frontend_pose(rec, st, torch.float64)
    seed_ref, m_ref = _seed_and_matches(rec, T_ref, inl_ref)
    if control:
        set_tf32(True)
        T_p, inl_p = frontend_pose(rec, st, torch.float32)
        set_tf32(False)
        seed_p, m_p = _seed_and_matches(rec, T_p, inl_p)
        if m_p is None:
            m_p = {**rec["matches"], "valid": torch.zeros_like(rec["matches"]["valid"])}
    else:
        T_p, seed_p, m_p = rec["T_cw"], rec["T_seed"], rec["matches"]
    pose = float((T_p.double() - T_ref)[:3].abs().max())
    seed = float((seed_p.double() - seed_ref)[:3].abs().max())
    matches = _match_gap(m_p, m_ref)
    out = {"frontend": max(pose, seed, matches), "frontend.pose": pose, "frontend.seed": seed,
           "frontend.matches": matches, "frontend.inliers": float(inl_ref.sum())}
    if opts.get("obs_ur") is not None:
        out["frontend.stereo_edges"] = float((opts["obs_ur"] >= 0).sum())
    return out


# ------------------------------------------------------------------ tracking


def _episode_pose(rec: dict, i: int) -> torch.Tensor:
    pose = rec["episodes"][0][1]
    for start, p in rec["episodes"]:
        if start <= i:
            pose = p
    return pose


def _inliers(rec: dict, i: int, st: Setting) -> torch.Tensor:
    """The feature gate at iteration ``i``: all matches until the re-gate
    that follows iteration ``num_iters // 2``, then chi^2 < 5.991 at that
    iteration's pose."""
    m = rec["matches"]
    regate = int(rec["num_iters"]) // 2
    if i <= regate or regate >= len(rec["iters"]):
        return torch.ones_like(m["valid"])
    it = rec["iters"][regate]
    with torch.no_grad():
        return R.chi2(R.pose_matrix(it["q"], it["t"]), m["obs_uv"], m["world"], m["inv_sigma2"],
                      st.cam) < CHI2_INLIER


def _chi2_grad(rec: dict, q, t, i: int, st: Setting):
    m = rec["matches"]
    q = q.detach().clone().requires_grad_(True)
    t = t.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        c2 = R.chi2(R.pose_matrix(q, t), m["obs_uv"], m["world"], m["inv_sigma2"], st.cam)
        use = m["valid"] & _inliers(rec, i, st)
        f = st.tw["feature_weight"] * torch.where(use, c2, torch.zeros_like(c2)).sum()
        gq, gt = torch.autograd.grad(f, [q, t])
    return gq, gt


def _best_iterate(rec: dict) -> int:
    losses = torch.stack([x["loss"] for x in rec["iters"]]).double()
    losses = torch.where(torch.isfinite(losses), losses, torch.full_like(losses, float("inf")))
    return int(torch.argmin(losses))


def track_values(rec: dict, st: Setting) -> dict:
    """The reference's own values at each captured iterate: its instance
    gradients ``d_inst`` and pose gradient (its adjoint of its own
    ``d_inst`` plus the feature term)."""
    s = splats(rec["rows"])
    out = {}
    for i in sorted(rec["d_screen"]):
        it = rec["iters"][i]
        loss, d_inst, counts, idx = R.tracking_instance_grads(
            s, it["q"], it["t"], _episode_pose(rec, i), rec["color"], rec["depth"], st.cam,
            st.track_tiling, st.tw, st.scale_modifier)
        gq, gt = R.pose_vjp(s, it["q"], it["t"], idx, d_inst, st.cam, st.scale_modifier)
        cq, ct = _chi2_grad(rec, it["q"], it["t"], i, st)
        out[i] = dict(loss=loss, d_inst=d_inst, counts=counts, idx=idx, gq=gq + cq, gt=gt + ct)
    return out


def track_numbers(rec: dict, T_returned: np.ndarray, ref: dict, prog: dict, prog_steps: list,
                  st: Setting) -> dict[str, float]:
    """``prog``: the program's values at the captured iterates
    (:func:`track_program_values`) or the control's
    (:func:`track_control_values`); ``prog_steps``: for every iterate, the
    gradient and the next iterate (None where there is none or it is not
    checked)."""
    s = splats(rec["rows"])
    its = rec["iters"]
    b1, b2 = st.betas
    ds, pg = 0.0, 0.0
    g1 = None
    for i in sorted(ref):
        r, p = ref[i], prog[i]
        live = torch.arange(r["d_inst"].shape[1], device=r["d_inst"].device)[None] \
            < r["counts"][:, None]
        ds = max(ds, max(elem_gap(p["d_inst"][..., c], r["d_inst"][..., c], live)
                         for c in range(r["d_inst"].shape[-1])))
        # The pose gradient: the reference's adjoint of the program's d_inst
        # and its feature term, relative to the larger of this iterate's
        # gradient and the first sampled one (near the optimum the gradient
        # is a sum of terms that cancel).
        aq, at = R.pose_vjp(s, its[i]["q"], its[i]["t"], r["idx"], p["d_inst"], st.cam,
                            st.scale_modifier)
        cq, ct = _chi2_grad(rec, its[i]["q"], its[i]["t"], i, st)
        if g1 is None:
            g1 = (r["gq"], r["gt"])
        pg = max(pg, _rel(p["gq"], aq + cq, torch.maximum(r["gq"].abs(), g1[0].abs())),
                 _rel(p["gt"], at + ct, torch.maximum(r["gt"].abs(), g1[1].abs())))
    # The steps: Adam from the moments of the gradients before each, with
    # its own gradient. Compared over the whole solve: the program's steps
    # stacked against Adam's, a relative norm for the rotation and one for
    # the translation. A single step's relative gap is not compared: where
    # the moments cancel, Adam's step shrinks to a few float32 spacings of
    # the stored pose, and its gap is that rounding; it is logged, with
    # where it sits, as ``track.step.widest*``.
    got = {"q": [], "t": []}
    want = {"q": [], "t": []}
    mq, vq = torch.zeros_like(its[0]["gq"]), torch.zeros_like(its[0]["gq"])
    mt, vt = torch.zeros_like(its[0]["gt"]), torch.zeros_like(its[0]["gt"])
    for i, (gq, gt, q_next, t_next) in enumerate(prog_steps):
        if q_next is not None:
            q1 = adam_update(its[i]["q"], mq, vq, gq, i + 1, st.tw["lr_q"], b1, b2, st.eps)
            t1 = adam_update(its[i]["t"], mt, vt, gt, i + 1, st.tw["lr_t"], b1, b2, st.eps)
            got["q"].append((i, q_next - its[i]["q"]))
            want["q"].append((i, q1 - its[i]["q"]))
            got["t"].append((i, t_next - its[i]["t"]))
            want["t"].append((i, t1 - its[i]["t"]))
        mq, vq = adam_moments([its[i]["gq"]], b1, b2, mq, vq)
        mt, vt = adam_moments([its[i]["gt"]], b1, b2, mt, vt)
    step, widest = 0.0, {"track.step.widest": 0.0}
    for k in ("q", "t"):
        if not got[k]:
            continue
        at = [i for i, _ in got[k]]
        a = torch.stack([d for _, d in got[k]]).double()
        b = torch.stack([d for _, d in want[k]]).double()
        step = max(step, _rel(a, b))
        w, p = max((_rel(a[p], b[p]), p) for p in range(len(at)))
        if w > widest["track.step.widest"]:
            # Where it sits: the iterate, Adam's step there against the
            # median step, and the gap in float32 spacings of the pose.
            size = b.norm(dim=-1)
            spacing = float(torch.finfo(torch.float32).eps) * float(its[at[p]][k].abs().max())
            widest = {"track.step.widest": w, "track.step.widest_at": float(at[p]),
                      "track.step.widest_size": float(size[p] / size.median().clamp(min=1e-30)),
                      "track.step.widest_spacings": float((a[p] - b[p]).abs().max()
                                                          / max(spacing, 1e-45))}
    j = _best_iterate(rec)
    T_best = R.pose_matrix(its[j]["q"], its[j]["t"]).double()
    T_ret = torch.as_tensor(np.asarray(T_returned, np.float64), device=T_best.device)
    ret = float((T_ret - T_best).abs().max())
    return {"track": max(ds, pg, step, ret), "track.d_screen": ds, "track.pose_grad": pg,
            "track.step": step, **widest, "track.returned": ret}


def track_program_values(rec: dict) -> tuple[dict, list]:
    its = rec["iters"]
    vals = {i: dict(d_inst=d[:, :10, :].transpose(1, 2), gq=its[i]["gq"], gt=its[i]["gt"])
            for i, d in rec["d_screen"].items()}
    steps = [(x["gq"], x["gt"], nx["q"], nx["t"]) for x, nx in zip(its, its[1:])]
    return vals, steps + [(its[-1]["gq"], its[-1]["gt"], None, None)]


def track_control_values(rec: dict, ctl: dict, st: Setting) -> tuple[dict, list]:
    """The control in the program's place: its d_inst and pose gradient at
    the captured iterates, and the Adam steps it takes with them."""
    its = rec["iters"]
    b1, b2 = st.betas
    vals = {i: dict(d_inst=c["d_inst"], gq=c["gq"], gt=c["gt"]) for i, c in ctl.items()}
    steps = []
    for i, x in enumerate(its):
        c = ctl.get(i)
        if c is None or i + 1 >= len(its):
            steps.append((x["gq"], x["gt"], None, None))
            continue
        mq, vq = adam_moments([y["gq"] for y in its[:i]] or [torch.zeros_like(c["gq"])], b1, b2)
        mt, vt = adam_moments([y["gt"] for y in its[:i]] or [torch.zeros_like(c["gt"])], b1, b2)
        steps.append((c["gq"], c["gt"],
                      adam_update(x["q"], mq, vq, c["gq"], i + 1, st.tw["lr_q"], b1, b2, st.eps),
                      adam_update(x["t"], mt, vt, c["gt"], i + 1, st.tw["lr_t"], b1, b2, st.eps)))
    return vals, steps


# ------------------------------------------------------------------- mapping


def map_grads(rec: dict, st: Setting) -> dict[str, torch.Tensor]:
    """The reference's mapping-loss gradient at the captured map."""
    before = rec["before"]
    s = splats(before, requires_grad=True)
    with torch.enable_grad():
        loss = R.mapping_loss(s, before["scene_radius"], rec["pose"], rec["color"], rec["depth"],
                              st.cam, st.render_tiling, st.mw, splats(rec["bins_rows"]),
                              st.scale_modifier)
        gs = torch.autograd.grad(loss, [getattr(s, n) for n in NAMES], allow_unused=True)
    return {n: torch.zeros_like(before[n]) if g is None else g for n, g in zip(NAMES, gs)}


def _adam_map(rec: dict, grads: dict, st: Setting) -> dict[str, torch.Tensor]:
    before = rec["before"]
    b1, b2 = st.betas
    t = int(before["adam_t"]) + 1
    return {n: adam_update(before[n], before["adam_m"][n], before["adam_v"][n], grads[n], t,
                           st.mw["lr"][n], b1, b2, st.eps, mask=before["active"]) for n in NAMES}


def map_numbers(rec: dict, ref_grads: dict, grads: dict, after: dict, st: Setting
                ) -> dict[str, float]:
    """``grads`` and ``after``: the program's gradient and stepped map (or
    the control's)."""
    act = rec["before"]["active"]
    g = max(elem_gap(grads[n], ref_grads[n], act) for n in NAMES)
    want = _adam_map(rec, grads, st)
    before = rec["before"]
    step = max(_rel(after[n] - before[n], want[n] - before[n]) for n in NAMES)
    return {"map": max(g, step), "map.grad": g, "map.step": step}


# -------------------------------------------------------------------- render


def _render_at_best(rec: dict, track_rec: dict, st: Setting) -> dict:
    j = _best_iterate(track_rec)
    T = R.pose_matrix(track_rec["iters"][j]["q"], track_rec["iters"][j]["t"])
    with torch.no_grad():
        return R.render(splats(rec["rows"]), T, st.cam, st.render_tiling, st.scale_modifier)


def render_numbers(ref: dict, out: dict) -> dict[str, float]:
    """The program's (or the control's) render ``out`` against the
    reference's ``ref``."""
    c = max(elem_gap(out["color"][..., k], ref["color"][..., k]) for k in range(3))
    d = elem_gap(out["depth"], ref["depth"])
    return {"render": max(c, d), "render.color": c, "render.depth": d}


# -------------------------------------------------------------------- driver


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def evaluate(cap, T_returned: np.ndarray | None, st: Setting, control: bool = False
             ) -> dict[str, float]:
    """Every number of the check from the captures ``cap``
    (``slambench.lib.capture.Hooks``). ``control``: the reference computed
    with TF32 takes the program's place."""
    nums: dict[str, float] = {}
    set_tf32(False)
    if cap.frontend is not None:
        nums.update(frontend_numbers(cap.frontend, st, control))
    if cap.track is not None and cap.track["d_screen"]:
        ref = track_values(cap.track, st)
        if control:
            set_tf32(True)
            ctl = track_values(cap.track, st)
            set_tf32(False)
            prog, steps = track_control_values(cap.track, ctl, st)
        else:
            prog, steps = track_program_values(cap.track)
        nums.update(track_numbers(cap.track, T_returned, ref, prog, steps, st))
    if cap.map is not None:
        ref_g = map_grads(cap.map, st)
        if control:
            set_tf32(True)
            g = map_grads(cap.map, st)
            set_tf32(False)
            after = _adam_map(cap.map, g, st)
        else:
            g, after = cap.map["grads"], cap.map["after"]
        nums.update(map_numbers(cap.map, ref_g, g, after, st))
    if cap.render is not None and cap.track is not None:
        ref_r = _render_at_best(cap.render, cap.track, st)
        if control:
            set_tf32(True)
            out = _render_at_best(cap.render, cap.track, st)
            set_tf32(False)
        else:
            out = cap.render["out"]
        nums.update(render_numbers(ref_r, out))
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in nums.items()}


def judge(nums: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit. A number that
    was not read (no capture) counts as failed."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = nums.get(name, float("inf"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks
