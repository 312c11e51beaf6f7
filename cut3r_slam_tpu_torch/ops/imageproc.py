"""Shared image-space math: TV loss, Sobel edges, Gaussian blur (port of
``cut3r_slam_tpu/ops/imageproc.py``).

Images are channel-last, as in the JAX package; the small fixed stencils
are sums of zero-padded shifted copies, in the JAX package's order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["total_variance", "tv_loss", "sobel_edges", "gaussian_blur"]


def total_variance(img: torch.Tensor):
    """Forward differences with the last one repeated. img (..., H, W) or
    a channel-last (..., H, W, C) with C in (1, 2, 3). Returns (grad_x,
    grad_y), each shaped as ``img``."""
    if img.dim() >= 3 and img.shape[-1] in (1, 2, 3):
        h_ax, w_ax = img.dim() - 3, img.dim() - 2
    else:
        h_ax, w_ax = img.dim() - 2, img.dim() - 1

    def diff(x, ax):
        n = x.shape[ax]
        d = x.narrow(ax, 0, n - 1) - x.narrow(ax, 1, n - 1)
        return torch.cat([d, d.narrow(ax, n - 2, 1)], ax)

    return diff(img, w_ax), diff(img, h_ax)


def tv_loss(depth: torch.Tensor, normal: Optional[torch.Tensor] = None,
            image: Optional[torch.Tensor] = None,
            conf_masks: Optional[torch.Tensor] = None):
    """Edge-aware total-variation smoothness loss. depth (B, H, W); normal
    (B, H, W, 3); image (B, H, W, 3) RGB in [0, 1]; conf_masks (B, H, W).
    Returns (loss, weights): weights exp(-5 |grad gray|) with an image,
    ones without."""
    dgx, dgy = total_variance(depth)
    if image is not None:
        gray = (0.2989 * image[..., 0] + 0.5870 * image[..., 1]
                + 0.1140 * image[..., 2])
        igx, igy = total_variance(gray)
        weights = torch.exp(-torch.sqrt(igx * igx + igy * igy) * 5.0)
    else:
        weights = torch.ones_like(dgx)
    if conf_masks is None:
        conf_masks = torch.ones_like(dgx)
    loss = (dgx.abs() * weights * conf_masks).mean() \
        + (dgy.abs() * weights * conf_masks).mean()
    if normal is not None:
        ngx, ngy = total_variance(normal)
        loss = loss + 0.05 * (
            (ngx.abs().mean(-1) * weights * conf_masks).mean()
            + (ngy.abs().mean(-1) * weights * conf_masks).mean())
    return loss, weights


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[i - dy, j - dx] over the first two axes, zero out of range."""
    H, W = x.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0) * (x.dim() - 2) + (1, 1, 1, 1))
    return xp[1 - dy:1 - dy + H, 1 - dx:1 - dx + W]


def sobel_edges(img: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel edge magnitude sqrt(gx^2 + gy^2 + 1e-6) with zero
    padding (torch ``conv2d(padding=1)``'s cross-correlation). img
    (H, W, C) or (H, W)."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    s = {(a, b): _shift2d(x, -a, -b) for a in (-1, 0, 1) for b in (-1, 0, 1)}
    gx = (s[(-1, -1)] - s[(-1, 1)] + 2 * (s[(0, -1)] - s[(0, 1)])
          + s[(1, -1)] - s[(1, 1)])
    gy = (s[(-1, -1)] + 2 * s[(-1, 0)] + s[(-1, 1)]
          - s[(1, -1)] - 2 * s[(1, 0)] - s[(1, 1)])
    e = torch.sqrt(gx * gx + gy * gy + 1e-6)
    return e[..., 0] if squeeze else e


def gaussian_blur(img: torch.Tensor, kernel_size: int = 5,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur with zero padding (the reference's grouped
    ``conv2d(padding=k // 2)``). img (H, W, C) or (H, W)."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    half = kernel_size // 2
    coords = torch.arange(kernel_size, dtype=x.dtype, device=x.device) - half
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()

    def pass_axis(y, axis):
        n = y.shape[axis]
        pad = [0, 0] * y.dim()
        pad[2 * (y.dim() - 1 - axis):2 * (y.dim() - axis)] = [half, half]
        yp = F.pad(y, pad)
        out = torch.zeros_like(y)
        for k in range(kernel_size):
            out = out + g[k] * yp.narrow(axis, k, n)
        return out

    out = pass_axis(pass_axis(x, 0), 1)
    return out[..., 0] if squeeze else out
