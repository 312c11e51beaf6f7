"""Quaternion algebra in PyTorch (port of ``cut3r_slam_tpu/geometry/
quaternion.py``).

Layouts: ``xyzw`` (scipy / lietorch) is the internal convention of every
function here unless the name says otherwise; ``wxyz`` is the CUT3R
pose-head layout, converted at the model boundary. All functions broadcast
over leading batch dims and are differentiable.
"""
from __future__ import annotations

import torch

__all__ = [
    "quat_multiply", "quat_conjugate", "quat_normalize", "quat_rotate",
    "quat_to_matrix", "matrix_to_quat", "standardize_quat", "wxyz_to_xyzw",
    "xyzw_to_wxyz",
]


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:4], q[..., 0:1]], -1)


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:4], q[..., 0:3]], -1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt keeps the gradient finite at an all-zero quat
    return q / torch.sqrt((q * q).sum(-1, keepdim=True) + eps * eps)


def standardize_quat(q: torch.Tensor) -> torch.Tensor:
    """Normalize and flip sign so the scalar (w, last) component is >= 0."""
    q = quat_normalize(q)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    qv, v = torch.broadcast_tensors(q[..., :3], v)
    qw = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion xyzw with w >= 0.
    Branch-free Shepperd's method: the four candidates are blended by a
    one-hot argmax so the selected branch is always the stable one."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    branch = torch.argmax(qs, -1)

    def _safe(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = _safe(1.0 + tr) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = _safe(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = _safe(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = _safe(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)
    qcand = torch.stack([q0, q1, q2, q3], -2)
    onehot = torch.nn.functional.one_hot(branch, 4).to(m.dtype)[..., None]
    return standardize_quat((qcand * onehot).sum(-2))
