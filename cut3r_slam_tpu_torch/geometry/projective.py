"""Pinhole projective geometry with analytic Jacobians (port of
``cut3r_slam_tpu/geometry/projective.py``).

DROID-style projective ops: inverse projection, projection, and the
frame-to-frame ``projective_transform`` that builds the dense-BA
residuals. Jacobians are dense per-pixel blocks, ready for the Hessian
scatter of ``ops/ba.py``.

Conventions: disparity parameterization (d = 1/Z) as DROID; poses are
SE3 7-vectors (world-to-camera, composed as ``g_ij = g_j * g_i^{-1}``);
intrinsics ``[fx, fy, cx, cy]``.
"""
from __future__ import annotations

import torch

from .lie import se3_inv, se3_mul, se3_matrix

__all__ = ["iproj", "proj", "actp", "projective_transform", "coords_grid"]

MIN_DEPTH = 0.2


def coords_grid(ht: int, wd: int, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """Pixel coordinate grid (ht, wd, 2) with (x, y) order."""
    y = torch.arange(ht, dtype=dtype, device=device)
    x = torch.arange(wd, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], -1)


def _unpack_intrinsics(intrinsics):
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor,
          jacobian: bool = False):
    """Inverse projection: disparity map -> homogeneous points
    X = (x, y, 1, d). disps (..., H, W); intrinsics (..., 4). Returns pts
    (..., H, W, 4) [and dX/dd (..., H, W, 4) with ``jacobian``]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _unpack_intrinsics(intrinsics)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    x = (grid[..., 0] - cx) / fx
    y = (grid[..., 1] - cy) / fy
    ones = torch.ones_like(disps)
    pts = torch.stack([x * ones, y * ones, ones, disps], -1)
    if jacobian:
        zeros = torch.zeros_like(disps)
        return pts, torch.stack([zeros, zeros, zeros, ones], -1)
    return pts


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False,
         return_depth: bool = False):
    """Pinhole projection of homogeneous points (..., H, W, 4) -> pixel
    coordinates; z below half ``MIN_DEPTH`` is replaced by 1."""
    fx, fy, cx, cy = _unpack_intrinsics(intrinsics)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        coords = torch.stack([x, y, D * d], -1)
    else:
        coords = torch.stack([x, y], -1)
    if not jacobian:
        return coords
    B = torch.zeros_like(d)
    # d(coords)/d(X4): rows = output dims, columns = (X, Y, Z, D)
    rows = [torch.stack([fx * d, B, -fx * X * d * d, B], -1),
            torch.stack([B, fy * d, -fy * Y * d * d, B], -1)]
    if return_depth:
        rows.append(torch.stack([B, B, -D * d * d, d], -1))
    return coords, torch.stack(rows, -2)


def actp(g_ij: torch.Tensor, X0: torch.Tensor, jacobian: bool = False):
    """Apply a relative SE3 (..., 7) to homogeneous points (..., H, W, 4):
    X1 = (R x + d t, d). With ``jacobian`` also dX1/dxi (..., H, W, 4, 6)
    in the [tau, phi] tangent layout."""
    M = se3_matrix(g_ij)
    R = M[..., :3, :3][..., None, None, :, :]
    t = M[..., :3, 3][..., None, None, :]
    p = X0[..., :3]
    d = X0[..., 3:]
    x1 = (R @ p[..., None])[..., 0] + d * t
    X1 = torch.cat([x1, d], -1)
    if not jacobian:
        return X1
    X, Y, Z = x1.unbind(-1)
    O = torch.zeros_like(X)
    dd = d[..., 0]
    # generators of SE(3) acting on (X, Y, Z, d): translation scaled by d
    Ja = torch.stack([
        torch.stack([dd, O, O, O, Z, -Y], -1),
        torch.stack([O, dd, O, -Z, O, X], -1),
        torch.stack([O, O, dd, Y, -X, O], -1),
        torch.stack([O, O, O, O, O, O], -1),
    ], -2)
    return X1, Ja


def _hat(v):
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)


def projective_transform(poses: torch.Tensor, disps: torch.Tensor,
                         intrinsics: torch.Tensor, ii: torch.Tensor,
                         jj: torch.Tensor, jacobian: bool = False,
                         return_depth: bool = False):
    """Map the pixels of frames ``ii`` into frames ``jj``.

    poses (N, 7) world-to-camera SE3; disps (N, H, W); intrinsics (N, 4)
    or (4,); ii / jj (E,) edge indices. Returns coords (E, H, W, 2[+1])
    and a validity mask (E, H, W, 1) (both X0 and X1 deeper than
    ``MIN_DEPTH``); with ``jacobian`` also (Ji, Jj, Jz): the pose
    Jacobians (E, H, W, 2, 6) of frames i and j and the disparity
    Jacobian (E, H, W, 2, 1).
    """
    intr = intrinsics if intrinsics.dim() == 2 else \
        intrinsics.expand(poses.shape[0], 4)
    gi, gj = poses[ii], poses[jj]
    g_ij = se3_mul(gj, se3_inv(gi))

    X0 = iproj(disps[ii], intr[ii])
    X1, Ja = actp(g_ij, X0, jacobian=True)
    coords, Jp = proj(X1, intr[jj], jacobian=True, return_depth=return_depth)

    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))[..., None]
    valid = valid.to(disps.dtype)
    if not jacobian:
        return coords, valid

    # chain rule through the j-frame perturbation
    Jj = Jp @ Ja
    # i-frame perturbation: Ji = -Jj Ad(g_ij)
    M = se3_matrix(g_ij)
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    zeros = torch.zeros_like(R)
    adT = torch.cat([torch.cat([R, _hat(t) @ R], -1),
                     torch.cat([zeros, R], -1)], -2)
    Ji = -(Jj @ adT[:, None, None])
    # disparity Jacobian: dX1/dd = (t, 1) since X1 = (R p + d t, d)
    dX1_dd = torch.cat([t[:, None, None, :].expand(X1[..., :3].shape),
                        torch.ones_like(X1[..., 3:])], -1)
    Jz = (Jp @ dX1_dd[..., None])
    return coords, valid, (Ji, Jj, Jz)
