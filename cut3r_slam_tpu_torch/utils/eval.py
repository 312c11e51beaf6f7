"""Rendering / trajectory evaluation metrics (port of ``cut3r_slam_tpu/
utils/eval.py``): PSNR, SSIM (``ops/ssim.py``), LPIPS through torchmetrics
when it is installed (None otherwise), depth L1, a JSON summary of a set
of renders, and the Umeyama-aligned ATE RMSE of a trajectory."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.ssim import ssim as _ssim

__all__ = ["psnr", "ssim", "lpips", "depth_l1", "ate_rmse",
           "evaluate_renders", "align_trajectory"]


def psnr(img: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(img, np.float64)
                         - np.asarray(gt, np.float64)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def ssim(img: np.ndarray, gt: np.ndarray) -> float:
    return float(_ssim(torch.as_tensor(np.asarray(img, np.float32)),
                       torch.as_tensor(np.asarray(gt, np.float32))))


_lpips_model = None


def lpips(img: np.ndarray, gt: np.ndarray) -> Optional[float]:
    """LPIPS (alex) through torchmetrics; None when it is unavailable."""
    global _lpips_model
    try:
        if _lpips_model is None:
            from torchmetrics.image.lpip import (
                LearnedPerceptualImagePatchSimilarity)
            _lpips_model = LearnedPerceptualImagePatchSimilarity(
                net_type="alex", normalize=True)

        def to_t(x):
            return torch.from_numpy(np.asarray(x, np.float32).transpose(
                2, 0, 1))[None].clamp(0, 1)
        with torch.no_grad():
            return float(_lpips_model(to_t(img), to_t(gt)))
    except Exception:
        return None


def depth_l1(depth: np.ndarray, gt: np.ndarray) -> float:
    m = (np.asarray(gt) > 0) & (np.asarray(depth) > 0)
    if m.sum() == 0:
        return 0.0
    return float(np.abs(np.asarray(depth)[m] - np.asarray(gt)[m]).mean())


def evaluate_renders(renders: List[np.ndarray], gts: List[np.ndarray],
                     depths: Optional[List[np.ndarray]] = None,
                     gt_depths: Optional[List[np.ndarray]] = None,
                     out_json: Optional[str] = None) -> Dict:
    res = {
        "psnr": float(np.mean([psnr(r, g) for r, g in zip(renders, gts)])),
        "ssim": float(np.mean([ssim(r, g) for r, g in zip(renders, gts)])),
    }
    lp = [lpips(r, g) for r, g in zip(renders, gts)]
    res["lpips"] = (float(np.mean([x for x in lp if x is not None]))
                    if any(x is not None for x in lp) else None)
    if depths is not None and gt_depths is not None:
        res["depth_l1"] = float(np.mean(
            [depth_l1(d, g) for d, g in zip(depths, gt_depths)]))
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(res, f, indent=2)
    return res


def align_trajectory(est_t: np.ndarray, gt_t: np.ndarray,
                     with_scale: bool = True):
    """Umeyama alignment of estimated to gt positions (in f32)."""
    from ..geometry.pointmap import umeyama_alignment
    R, t, s = umeyama_alignment(
        torch.as_tensor(np.asarray(est_t, np.float32)),
        torch.as_tensor(np.asarray(gt_t, np.float32)), with_scale=with_scale)
    return R.numpy(), t.numpy(), float(s)


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray,
             align: bool = True, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, 3) positions at matching
    timestamps, after a similarity alignment when ``align`` (N >= 3)."""
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    if align and len(est) >= 3:
        R, t, s = align_trajectory(est, gt, with_scale)
        est = s * est @ R.T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))
