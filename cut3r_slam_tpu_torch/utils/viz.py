"""Headless dumps (port of ``save_image``, ``save_depth_png``,
``save_pcd_ply`` and ``save_gaussians_ply`` from
``cut3r_slam_tpu/utils/viz.py``): images, colourized depth, point-cloud
and Gaussian PLYs."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["save_image", "save_depth_png", "save_pcd_ply",
           "save_gaussians_ply"]


def save_image(path: str, arr: np.ndarray):
    """Write an image array (uint8 RGB / gray or uint16 depth) with cv2."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    cv2.imwrite(path, arr)


def _turbo(x: np.ndarray) -> np.ndarray:
    """Compact turbo-like colormap for depth viz."""
    x = np.clip(x, 0, 1)
    r = np.clip(1.6 - np.abs(4 * x - 3.2), 0, 1)
    g = np.clip(1.6 - np.abs(4 * x - 1.8), 0, 1)
    b = np.clip(1.6 - np.abs(4 * x - 0.6), 0, 1)
    return np.stack([r, g, b], -1)


def save_depth_png(path: str, depth: np.ndarray, colorize: bool = True):
    """Depth as an 8-bit PNG: turbo-coloured over its positive range, or
    gray (depth x 255, clipped)."""
    d = np.asarray(depth, np.float32)
    if colorize:
        v = d[d > 0]
        lo, hi = (v.min(), v.max()) if v.size else (0, 1)
        img = (_turbo((d - lo) / max(hi - lo, 1e-6)) * 255).astype(np.uint8)
    else:
        img = np.clip(d * 255, 0, 255).astype(np.uint8)
    save_image(path, img)


def save_pcd_ply(path: str, points: np.ndarray,
                 colors: Optional[np.ndarray] = None) -> int:
    """ASCII PLY of points (N, 3) with colors (N, 3) in [0, 1]."""
    pts = np.asarray(points).reshape(-1, 3)
    cols = (np.asarray(colors).reshape(-1, 3) if colors is not None
            else np.full_like(pts, 0.7))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cu8 = np.clip(cols * 255, 0, 255).astype(int)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(pts, cu8):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
    return len(pts)


def save_gaussians_ply(path: str, arena, max_points: int = 500_000) -> int:
    """Gaussian centers colored by SH0 (the 3dgs_final.ply analog)."""
    from ..slam.gaussian_map import SH2RGB
    alive = arena.alive.cpu().numpy()
    xyz = arena.xyz.detach().cpu().numpy()[alive][:max_points]
    cols = np.clip(SH2RGB(arena.f_dc.detach()).cpu().numpy()[alive]
                   [:max_points], 0, 1)
    return save_pcd_ply(path, xyz, cols)
