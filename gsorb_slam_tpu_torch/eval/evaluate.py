"""Sequence evaluation: render every estimated pose and score it against the
sensor images (counterpart of ``gsorb_slam_tpu/eval/evaluate.py``).

Equivalent of the reference's in-process ``Evalution`` (``src/Utils.cc:
365-473``: re-render each frame at its estimated pose, PSNR / SSIM /
MS-SSIM / LPIPS and depth L1) and the ATE hook (``scripts/tum_ate.py``).
The renders and metrics run on the System's device.
"""

from __future__ import annotations

import numpy as np
import torch

from gsorb_slam_tpu_torch.eval.ate import ate_rmse
from gsorb_slam_tpu_torch.ops import metrics as MM


def evaluate_sequence(system, dataset, stride: int = 1, compute_lpips: bool = False) -> dict:
    """Render every ``stride``-th frame at its estimated pose and score it
    against the sensor images (stride 1 scores every frame, as the reference
    does); the ATE RMSE against the ground truth where the dataset has one."""
    psnrs, ssims, msssims, lpipss, dl1s = [], [], [], [], []
    est = [rec.T_cw for rec in system.trajectory]
    gt = []
    dev = system.device
    for i, fr in enumerate(dataset):
        if i >= len(est):
            break
        if fr.gt_T_cw is not None:
            gt.append((i, fr.gt_T_cw))
        if i % stride != 0:
            continue
        with torch.no_grad():
            out = system.render_view(est[i])
            pred = torch.clamp(out.color, 0.0, 1.0)
            target = torch.as_tensor(np.asarray(fr.rgb, np.float32), device=dev)
            depth = torch.as_tensor(np.asarray(fr.depth, np.float32), device=dev)
            mask = depth > 0
            psnrs.append(float(MM.psnr(pred, target, mask)))
            ssims.append(float(MM.ssim(pred, target)))
            if min(pred.shape[:2]) >= 176:
                msssims.append(float(MM.ms_ssim(pred, target)))
            if compute_lpips:
                lpipss.append(MM.lpips(pred, target))
            dl1s.append(float(MM.depth_l1(out.median_depth, depth, mask)))

    result = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "ms_ssim": float(np.mean(msssims)) if msssims else float("nan"),
        "lpips": float(np.nanmean(lpipss)) if lpipss else float("nan"),
        "depth_l1": float(np.mean(dl1s)) if dl1s else float("nan"),
        "n_eval_frames": len(psnrs),
    }
    if len(gt) >= 3:
        idxs = [i for i, _ in gt]
        result["ate_rmse"] = ate_rmse([est[i] for i in idxs], [T for _, T in gt])
    return result
