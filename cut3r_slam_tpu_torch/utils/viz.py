"""Headless map dumps (port of ``save_pcd_ply`` / ``save_gaussians_ply``
from ``cut3r_slam_tpu/utils/viz.py``)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["save_pcd_ply", "save_gaussians_ply"]


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
