"""All-pairs correlation pyramid and radius lookup, DROID / RAFT style
(port of ``cut3r_slam_tpu/ops/corr.py``).

A 4-level average-pooled all-pairs correlation volume (one batched matrix
product, as in the JAX package, where it is XLA and no Pallas kernel),
then a (2r+1)^2 window sampled bilinearly around each target at each
level, zeros outside the volume. The layout is the JAX package's: window
channels dy-major, levels concatenated level-major, channels last. The
lookup also reads a pool of volumes by row (the DROID tracker's cache of
per-edge pyramids, ``slam/droid_frontend.CorrCache``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["build_corr_pyramid", "corr_lookup", "corr_volume"]


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) x2 -> (N, H, W, H, W) all-pairs correlation / 16."""
    N, H, W, C = fmap1.shape
    f1 = fmap1.reshape(N, H * W, C) / 4.0
    f2 = fmap2.reshape(N, H * W, C) / 4.0
    return torch.bmm(f1, f2.transpose(1, 2)).reshape(N, H, W, H, W)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """[(N, H, W, H / 2^i, W / 2^i)] for i in [0, num_levels): 2x2 average
    pools with VALID windows (odd sizes floor, down to empty levels)."""
    corr = corr_volume(fmap1, fmap2)
    N, H, W = corr.shape[:3]
    pyramid = [corr]
    c = corr.reshape(N * H * W, corr.shape[3], corr.shape[4])
    for _ in range(1, num_levels):
        h2, w2 = c.shape[1] // 2, c.shape[2] // 2
        c = c[:, :2 * h2, :2 * w2].reshape(N * H * W, h2, 2, w2, 2).sum(
            (2, 4)) / 4.0
        pyramid.append(c.reshape(N, H, W, h2, w2))
    return pyramid


def _bilinear_window_sample(vol: torch.Tensor, coords: torch.Tensor,
                            radius: int, rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One level's (2r+1)^2 window around coords (N, H, W, 2), the target
    (x, y) in level coordinates. vol: (N, H, W, h2, w2), a volume per
    pixel; or, with ``rows`` (N, H, W), a pool (R, h2, w2) of which row
    ``rows[n, y, x]`` is that pixel's volume. The taps are read in the
    coordinates' dtype; returns (N, H, W, (2r+1)^2) in it."""
    h2, w2 = vol.shape[-2:]
    r = radius
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")   # dy-major window order
    cx = (coords[..., 0:1] + dx.reshape(-1))
    cy = (coords[..., 1:2] + dy.reshape(-1))
    if h2 == 0 or w2 == 0:  # a level pooled away: every tap is outside
        return torch.zeros_like(cx)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx = cx - x0
    wy = cy - y0
    flat = vol.reshape(*vol.shape[:-2], h2 * w2)

    def gather(yi, xi):
        ok = (xi >= 0) & (xi < w2) & (yi >= 0) & (yi < h2)
        # the cell's index formed in the coordinates' dtype (exact for
        # any volume under 2^24 cells), one cast to int64
        idx = (yi.clamp(0, h2 - 1) * w2 + xi.clamp(0, w2 - 1)).long()
        if rows is None:
            vals = torch.gather(flat, -1, idx)
        else:
            vals = flat[rows[..., None], idx]
        vals = vals.to(cx.dtype)
        return torch.where(ok, vals, torch.zeros_like(vals))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
                radius: int = 3, rows: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """coords (N, H, W, 2) pixel coordinates in the level-0 frame. Returns
    (N, H, W, L * (2r+1)^2) stacked window correlations, channels last, in
    the coordinates' dtype. With ``rows`` each level is a pool of volumes
    (R, h_l, w_l) and ``rows`` (N, H, W) picks each pixel's."""
    return torch.cat([_bilinear_window_sample(vol, coords / (2 ** i), radius,
                                              rows)
                      for i, vol in enumerate(pyramid)], -1)
