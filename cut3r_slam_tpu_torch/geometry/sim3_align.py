"""Weighted and robust Sim(3) point-set alignment: Umeyama with confidence
weights and Huber IRLS (port of ``cut3r_slam_tpu/geometry/sim3_align.py``).

As in the JAX package: invalid points get zero weight instead of being
indexed out (no data-dependent shapes), the IRLS loop runs a fixed number
of iterations (a converged solve is a fixed point), and the 3x3 SVD keeps
the reflection fix (the last row of Vt flipped by the sign of det).
"""
from __future__ import annotations

import torch

__all__ = ["weighted_estimate_sim3", "huber_loss",
           "robust_weighted_estimate_sim3", "weighted_align_point_maps"]


def weighted_estimate_sim3(src: torch.Tensor, tgt: torch.Tensor,
                           weights: torch.Tensor):
    """Closed-form weighted Sim(3): (s, R, t) with tgt ~ s R src + t.
    src / tgt (N, 3); weights (N,) >= 0 (zero = ignored)."""
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    mu_s = (w[:, None] * src).sum(0)
    mu_t = (w[:, None] * tgt).sum(0)
    sc = src - mu_s
    tc = tgt - mu_t
    scale_s = torch.sqrt((w * (sc * sc).sum(1)).sum() + 1e-24)
    scale_t = torch.sqrt((w * (tc * tc).sum(1)).sum() + 1e-24)
    s = scale_t / scale_s
    H = (s * sc * w[:, None]).T @ tc
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    flip = torch.ones(3, 1, dtype=H.dtype, device=H.device)
    flip[2] = torch.where(det < 0, -1.0, 1.0)
    Vt = Vt * flip
    R = Vt.T @ U.T
    t = mu_t - s * R @ mu_s
    return s, R, t


def huber_loss(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def robust_weighted_estimate_sim3(src: torch.Tensor, tgt: torch.Tensor,
                                  init_weights: torch.Tensor,
                                  delta: float = 0.1, max_iters: int = 20):
    """Huber-IRLS Sim(3): reweight by delta / |residual| above the Huber
    threshold and re-solve, ``max_iters`` times. Returns (s, R, t)."""
    s, R, t = weighted_estimate_sim3(src, tgt, init_weights)
    for _ in range(max_iters):
        transformed = s * (src @ R.T) + t
        res = torch.sqrt(((tgt - transformed) ** 2).sum(1) + 1e-24)
        hub = torch.where(res > delta, delta / torch.clamp(res, min=1e-12),
                          torch.ones_like(res))
        cw = init_weights * hub
        cw = cw / (cw.sum() + 1e-12)
        s, R, t = weighted_estimate_sim3(src, tgt, cw)
    return s, R, t


def weighted_align_point_maps(pm1, conf1, pm2, conf2, conf_threshold: float,
                              delta: float = 0.1, max_iters: int = 5):
    """Align point map 2 to point map 1. pm1 / pm2 (B, H, W, 3) world
    points; conf1 / conf2 (B, H, W); pixels at or below the threshold in
    either map get weight 0. Returns (s, R, t)."""
    pm1 = torch.as_tensor(pm1).reshape(-1, 3)
    pm2 = torch.as_tensor(pm2).reshape(-1, 3)
    c1 = torch.as_tensor(conf1).reshape(-1)
    c2 = torch.as_tensor(conf2).reshape(-1)
    valid = (c1 > conf_threshold) & (c2 > conf_threshold)
    w = torch.where(valid, torch.sqrt(torch.clamp(c1 * c2, min=0.0)),
                    torch.zeros_like(c1))
    return robust_weighted_estimate_sim3(pm2, pm1, w, delta=delta,
                                         max_iters=max_iters)
