"""SO(3) / SE(3) Lie groups in PyTorch (port of the SO3/SE3 part of
``cut3r_slam_tpu/geometry/lie.py``; Sim(3) serves loop closure only and
waits with it).

Storage conventions (lietorch's): SO3 quaternion ``[x, y, z, w]``; SE3
7-vector ``[tx, ty, tz, qx, qy, qz, qw]``; se3 tangent ``[tau(3), phi(3)]``.
Small-angle branches use Taylor expansions with the "safe where" pattern
so gradients stay finite; everything is differentiable.
"""
from __future__ import annotations

import torch

from .quaternion import (quat_conjugate, quat_multiply, quat_normalize,
                         quat_rotate, quat_to_matrix, matrix_to_quat)

__all__ = ["so3_exp", "so3_log", "se3_exp", "se3_log", "se3_inv", "se3_mul",
           "se3_act", "se3_matrix", "se3_from_matrix"]

_SMALL = 1e-8


def _safe_div(num, den, eps=1e-12):
    small = torch.abs(den) < eps
    return num / torch.where(small, torch.where(den < 0, -eps, eps)
                             .to(den.dtype), den)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) tangent (..., 3) -> unit quaternion xyzw (..., 4)."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _SMALL
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    _safe_div(torch.sin(0.5 * theta), theta))
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([phi * k, w], -1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion xyzw -> so(3) tangent (..., 3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    w = q[..., 3:4]
    vn_sq = (v * v).sum(-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn_sq, min=1e-24))
    small = vn_sq < _SMALL
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, _safe_div(torch.full_like(w, 2.0), w)
                    * (1.0 - vn_sq / (3.0 * torch.clamp(w * w, min=1e-12))),
                    _safe_div(theta, vn))
    return v * k


def _so3_left_jacobian_terms(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _SMALL
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    _safe_div(1.0 - torch.cos(theta), theta_sq))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    _safe_div(theta - torch.sin(theta), theta_sq * theta))
    return a, b


def _apply_V_inv(phi, rho):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _SMALL
    half = 0.5 * theta
    cot = _safe_div(torch.cos(half), torch.sin(half))
    k = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    _safe_div(1.0 - 0.5 * theta * cot, theta_sq))
    c1 = _cross(phi, rho)
    c2 = _cross(phi, c1)
    return rho - 0.5 * c1 + k * c2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (..., 6) [tau, phi] -> SE3 7-vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    a, b = _so3_left_jacobian_terms(phi)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([tau + a * c1 + b * c2, q], -1)


def se3_log(g: torch.Tensor) -> torch.Tensor:
    phi = so3_log(g[..., 3:7])
    return torch.cat([_apply_V_inv(phi, g[..., :3]), phi], -1)


def se3_inv(g: torch.Tensor) -> torch.Tensor:
    qinv = quat_conjugate(g[..., 3:7])
    return torch.cat([-quat_rotate(qinv, g[..., :3]), qinv], -1)


def se3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1 = g1[..., :3], g1[..., 3:7]
    t2, q2 = g2[..., :3], g2[..., 3:7]
    return torch.cat([t1 + quat_rotate(q1, t2),
                      quat_normalize(quat_multiply(q1, q2))], -1)


def se3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def se3_matrix(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    R = quat_to_matrix(quat_normalize(q))
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype,
                          device=g.device).expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def se3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], -1)
