"""SO(3) / SE(3) / Sim(3) Lie groups in PyTorch (port of
``cut3r_slam_tpu/geometry/lie.py``).

Storage conventions (lietorch's): SO3 quaternion ``[x, y, z, w]``; SE3
7-vector ``[tx, ty, tz, qx, qy, qz, qw]``; Sim3 8-vector ``[t, q xyzw, s]``
(scale stored directly); tangents se3 ``[tau(3), phi(3)]`` and sim3
``[tau(3), phi(3), sigma(1)]``. Small-angle branches use Taylor
expansions with the "safe where" pattern so gradients stay finite;
everything is differentiable, and nothing writes in place or reads a
value back to the host, so the functions also run under
``torch.func.vmap`` / ``jacfwd`` (the Sim(3) PGBA's edge Jacobians).
"""
from __future__ import annotations

import torch

from .quaternion import (quat_conjugate, quat_multiply, quat_normalize,
                         quat_rotate, quat_to_matrix, matrix_to_quat)

__all__ = ["so3_exp", "so3_log", "so3_inv", "so3_mul", "so3_act",
           "so3_matrix", "se3_exp", "se3_log", "se3_inv", "se3_mul",
           "se3_act", "se3_matrix", "se3_from_matrix", "se3_identity",
           "se3_retr", "sim3_identity",
           "sim3_exp", "sim3_log", "sim3_inv", "sim3_mul", "sim3_act",
           "sim3_matrix", "sim3_from_matrix", "sim3_retr"]

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


def so3_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_conjugate(q)


def so3_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    return quat_multiply(q1, q2)


def so3_act(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, p)


def so3_matrix(q: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(quat_normalize(q))


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


def se3_identity(shape=(), dtype=torch.float32, device="cpu"
                 ) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,))


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


def _homogeneous(R, t):
    top = torch.cat([R, t[..., None]], -1)
    # the [0, 0, 0, 1] row made from t on its device: no host-to-device
    # copy, so no host wait and nothing a CUDA graph capture refuses
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])],
                       -1)[..., None, :]
    return torch.cat([top, bottom], -2)


def se3_matrix(g: torch.Tensor) -> torch.Tensor:
    return _homogeneous(quat_to_matrix(quat_normalize(g[..., 3:7])),
                        g[..., :3])


def se3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], -1)


def se3_retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """lietorch-style retraction: exp(xi) * g."""
    return se3_mul(se3_exp(xi), g)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_identity(shape=(), dtype=torch.float32, device="cpu"
                  ) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (8,))


def _sim3_W(phi, sigma):
    """Coefficients (A, B, C) of W = A I + B [phi]x + C [phi]x^2, the
    matrix that maps tau to the translation of Sim(3) exp (Strasdat's
    thesis). Every branch and threshold is the JAX package's: they are set
    by f32 cancellation, not by the mathematical singularities."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    # expm1 avoids the exp(sigma) - 1 cancellation for |sigma| < ~1e-2
    e = torch.expm1(sigma)
    s = 1.0 + e
    small_th = theta_sq < 1e-4          # theta < 1e-2
    small_sg = torch.abs(sigma) < 0.05

    A = torch.where(torch.abs(sigma) < 1e-8,
                    1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    _safe_div(e, sigma))

    sig2_th2 = sigma * sigma + theta_sq
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)

    # large-theta closed forms (Sophus Sim3::exp)
    denom = torch.clamp(sig2_th2, min=1e-24)
    a_l = _safe_div(s * sin_t * sigma + (1.0 - s * cos_t) * theta,
                    denom * theta)
    c_inner = _safe_div((s * cos_t - 1.0) * sigma + s * sin_t * theta, denom)
    c_l = _safe_div(A - c_inner, torch.clamp(theta_sq, min=1e-24))

    # theta -> 0 limits: sigma series below |sigma| < 0.05 (the closed
    # forms cancel catastrophically in f32 there), closed forms above
    sg2 = sigma * sigma
    b_series = 0.5 + sigma / 3.0 + sg2 / 8.0 + sg2 * sigma / 30.0
    c_series = 1.0 / 6.0 + sigma / 8.0 + sg2 / 20.0 + sg2 * sigma / 72.0
    b_closed = _safe_div(sigma * s - e, torch.clamp(sg2, min=1e-24))
    # sign-preserving clamp: sigma^3 keeps sigma's sign
    sig3 = torch.where(sigma < 0, torch.clamp(sg2 * sigma, max=-1e-24),
                       torch.clamp(sg2 * sigma, min=1e-24))
    c_closed = _safe_div(e, sig3) - _safe_div(
        s - s * sigma / 2.0, torch.clamp(sg2, min=1e-24))
    b_s = torch.where(small_sg, b_series, b_closed)
    c_s = torch.where(small_sg, c_series, c_closed)

    B = torch.where(small_th, b_s, a_l)
    C = torch.where(small_th, c_s, c_l)
    return A, B, C


def _hat(v):
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1)], -2)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent (..., 7) [tau, phi, sigma] -> Sim3 8-vector."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = so3_exp(phi)
    A, B, C = _sim3_W(phi, sigma)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([A * tau + B * c1 + C * c2, q, torch.exp(sigma)], -1)


def sim3_log(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(torch.clamp(s, min=1e-24))
    A, B, C = _sim3_W(phi, sigma)
    # solve (A I + B [phi]x + C [phi]x^2) tau = t by Cramer's rule (W is
    # near the identity): torch.linalg.solve's forward-mode derivative
    # under vmap gave wrong edge Jacobians (off by up to 5e7 on the graph
    # of tests/test_torch_sim3.py; right one edge at a time)
    Phi = _hat(phi)
    eye = torch.eye(3, dtype=g.dtype, device=g.device).expand(Phi.shape)
    W = A[..., None] * eye + B[..., None] * Phi + C[..., None] * (Phi @ Phi)
    r0, r1, r2 = W[..., 0, :], W[..., 1, :], W[..., 2, :]
    c0, c1, c2 = _cross(r1, r2), _cross(r2, r0), _cross(r0, r1)
    det = (r0 * c0).sum(-1, keepdim=True)
    tau = (c0 * t[..., 0:1] + c1 * t[..., 1:2] + c2 * t[..., 2:3]) / det
    return torch.cat([tau, phi, sigma], -1)


def sim3_inv(g: torch.Tensor) -> torch.Tensor:
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qinv = quat_conjugate(q)
    sinv = 1.0 / torch.clamp(s, min=1e-24)
    return torch.cat([-sinv * quat_rotate(qinv, t), qinv, sinv], -1)


def sim3_mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    return torch.cat([t1 + s1 * quat_rotate(q1, t2),
                      quat_normalize(quat_multiply(q1, q2)), s1 * s2], -1)


def sim3_act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return g[..., 7:8] * quat_rotate(g[..., 3:7], p) + g[..., :3]


def sim3_matrix(g: torch.Tensor) -> torch.Tensor:
    R = quat_to_matrix(quat_normalize(g[..., 3:7])) * g[..., 7:8, None]
    return _homogeneous(R, g[..., :3])


def sim3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    sR = m[..., :3, :3]
    det = torch.linalg.det(sR)
    s = (torch.sign(det) * torch.abs(det) ** (1.0 / 3.0))[..., None]
    q = matrix_to_quat(sR / s[..., None])
    return torch.cat([m[..., :3, 3], q, s], -1)


def sim3_retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return sim3_mul(sim3_exp(xi), g)
