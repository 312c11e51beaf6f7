"""SSIM with an 11-tap Gaussian window (port of ``cut3r_slam_tpu/ops/
ssim.py``): separable depthwise blur, same padding, per-channel windows."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim"]


def _gaussian_kernel(size: int, sigma: float, device):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """img*: (..., H, W, C) in [0, 1]. Returns the mean SSIM over all
    leading dims (a scalar), or per leading item when ``img*`` is batched
    (B, H, W, C) -> (B,)."""
    batched = img1.dim() == 4
    x1 = img1 if batched else img1[None]
    x2 = img2 if batched else img2[None]
    C = x1.shape[-1]
    g = _gaussian_kernel(window, sigma, x1.device)
    kh = g.view(1, 1, window, 1).repeat(C, 1, 1, 1)
    kw = g.view(1, 1, 1, window).repeat(C, 1, 1, 1)
    pad = window // 2

    def blur(x):                      # (B, H, W, C) -> (B, H, W, C)
        y = x.permute(0, 3, 1, 2)
        y = F.conv2d(y, kh, padding=(pad, 0), groups=C)
        y = F.conv2d(y, kw, padding=(0, pad), groups=C)
        return y.permute(0, 2, 3, 1)

    mu1 = blur(x1)
    mu2 = blur(x2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    s1 = blur(x1 * x1) - mu1_sq
    s2 = blur(x2 * x2) - mu2_sq
    s12 = blur(x1 * x2) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) \
        / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    m = m.flatten(1).mean(1)
    return m if batched else m[0]
