"""Pointmap / pose utilities shared by tracking and mapping (port of
``cut3r_slam_tpu/geometry/pointmap.py``: ``geotrf``, ``depth_to_pointmap``,
``pointmap_to_depth``, ``depth_to_normal``, ``pose_vec_to_matrix``,
``matrix_to_pose_vec``, ``umeyama_alignment``).

Pose vector convention at the SLAM layer: ``[t(3), quat xyzw]``
camera-to-world.
"""
from __future__ import annotations

import torch

from .quaternion import quat_normalize
from .lie import se3_from_matrix, se3_matrix

__all__ = ["geotrf", "depth_to_pointmap", "pointmap_to_depth",
           "pose_vec_to_matrix", "matrix_to_pose_vec", "umeyama_alignment",
           "depth_to_normal"]


def geotrf(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or (..., 4, 4)) transform to (..., 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...j->...i", R, pts) + t


def depth_to_pointmap(depth: torch.Tensor, intrinsics: torch.Tensor,
                      c2w: torch.Tensor = None) -> torch.Tensor:
    """depth (..., H, W), intrinsics (..., 4) -> pointmap (..., H, W, 3);
    world frame when ``c2w`` (..., 4, 4) is given."""
    ht, wd = depth.shape[-2:]
    K = intrinsics[..., None, None, :]
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    y = torch.arange(ht, dtype=depth.dtype, device=depth.device)
    x = torch.arange(wd, dtype=depth.dtype, device=depth.device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    X = (gx - cx) / fx * depth
    Y = (gy - cy) / fy * depth
    pts = torch.stack([X, Y, depth.expand(X.shape)], -1)
    if c2w is not None:
        pts = geotrf(c2w.reshape(c2w.shape[:-2] + (1, 1, 4, 4)), pts)
    return pts


def pointmap_to_depth(pts: torch.Tensor) -> torch.Tensor:
    return pts[..., 2]


def pose_vec_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """[t, quat xyzw] (..., 7) -> (..., 4, 4)."""
    return se3_matrix(torch.cat([pose[..., :3],
                                 quat_normalize(pose[..., 3:7])], -1))


def matrix_to_pose_vec(m: torch.Tensor) -> torch.Tensor:
    return se3_from_matrix(m)


def umeyama_alignment(x: torch.Tensor, y: torch.Tensor,
                      with_scale: bool = True):
    """Least-squares similarity aligning point sets x -> y (N, 3) (Umeyama
    1991): (R (3, 3), t (3,), s) with y ~ s R x + t; s = 1 without
    ``with_scale``."""
    mu_x, mu_y = x.mean(0), y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    n = x.shape[0]
    U, D, Vt = torch.linalg.svd(yc.T @ xc / n)
    S = torch.eye(3, dtype=x.dtype, device=x.device)
    if torch.linalg.det(U) * torch.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_x = (xc * xc).sum() / n
    s = torch.trace(torch.diag(D) @ S) / torch.clamp(var_x, min=1e-12) \
        if with_scale else torch.ones((), dtype=x.dtype, device=x.device)
    return R, mu_y - s * R @ mu_x, s


def depth_to_normal(depth: torch.Tensor, intrinsics: torch.Tensor
                    ) -> torch.Tensor:
    """Cross-product normals from a depth map (..., H, W) -> (..., H, W, 3):
    central differences of the camera-frame pointmap, zero on the 1-pixel
    border."""
    pts = depth_to_pointmap(depth, intrinsics)
    dx = pts[..., 2:, 1:-1, :] - pts[..., :-2, 1:-1, :]
    dy = pts[..., 1:-1, 2:, :] - pts[..., 1:-1, :-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
