"""Training of the benchmark's reference: a frozen float32 copy of the
port's CUT3R loss (``cut3r_total_loss``: the confidence-weighted self and
cross pointmap regression with average-distance normalization, the pose
translation and rotation terms, the RGB term) and of its optimizer (clip
by global norm 1.0, then AdamW with b1 0.9, b2 0.95, eps 1e-8, weight
decay on every parameter, on optax's warmup-cosine schedule evaluated at
the count of updates applied). Plain PyTorch; it imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["total_loss", "AdamW", "lr_at"]

B1, B2, EPS, MAX_NORM = 0.9, 0.95, 1e-8, 1.0


def _geotrf(T, pts):
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], pts) \
        + T[..., :3, 3]


def _matrix_to_quat_xyzw(m):
    """Rotation matrix -> unit quaternion xyzw with w >= 0 (Shepperd)."""
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
    q = (qcand * onehot).sum(-2)
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    return torch.where(q[..., 3:4] < 0, -q, q)


def _avg_dis(pts, valid):
    """Mean point norm over each batch element's valid points: (B,)."""
    dis = torch.linalg.norm(pts, dim=-1)
    m = valid.to(pts.dtype)
    return torch.clamp((dis * m).sum((0, 2, 3))
                       / torch.clamp(m.sum((0, 2, 3)), min=1.0), min=1e-8)


def total_loss(pred, gt, alpha=0.2, pose_weight=1.0, rgb_weight=1.0):
    """pred: pts3d_in_self_view / pts3d_in_other_view (V, B, H, W, 3),
    conf_self / conf (V, B, H, W), camera_pose (V, B, 7; t, q wxyz), rgb;
    gt: pts3d (V, B, H, W, 3) world, camera_pose (V, B, 4, 4) c2w,
    valid_mask (V, B, H, W), img. Returns the scalar loss."""
    c2w = gt["camera_pose"]
    valid = gt["valid_mask"]
    in_cam0 = torch.linalg.inv(c2w[0])
    gt_self = _geotrf(torch.linalg.inv(c2w)[:, :, None, None], gt["pts3d"])
    gt_cross = _geotrf(in_cam0[None, :, None, None], gt["pts3d"])
    pr_self, pr_cross = pred["pts3d_in_self_view"], pred["pts3d_in_other_view"]
    valid2 = torch.cat([valid, valid], 2)
    nf_pr = _avg_dis(torch.cat([pr_self, pr_cross], 2),
                     valid2)[None, :, None, None, None]
    nf_gt = _avg_dis(torch.cat([gt_self, gt_cross], 2),
                     valid2)[None, :, None, None, None]
    l_self = torch.linalg.norm(pr_self / nf_pr - gt_self / nf_gt, dim=-1)
    l_cross = torch.linalg.norm(pr_cross / nf_pr - gt_cross / nf_gt, dim=-1)

    gt_rel = torch.einsum("bij,vbjk->vbik", in_cam0, c2w)
    gt_t = gt_rel[..., :3, 3]
    pr_t = pred["camera_pose"][..., :3]
    nf_gt_t = torch.clamp(torch.linalg.norm(gt_t, dim=-1).mean(0), min=1e-8)
    nf_pr_t = torch.clamp(torch.linalg.norm(pr_t, dim=-1).mean(0), min=1e-8)
    l_trans = torch.linalg.norm(pr_t / nf_pr_t[None, :, None]
                                - gt_t / nf_gt_t[None, :, None], dim=-1)
    q_gt = _matrix_to_quat_xyzw(gt_rel[..., :3, :3])
    q_pr = torch.cat([pred["camera_pose"][..., 4:7],
                      pred["camera_pose"][..., 3:4]], -1)
    l_quat = 1.0 - torch.abs((q_gt * q_pr).sum(-1))

    m = valid.to(l_self.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)

    def conf_loss(l, conf):
        return ((conf * l - alpha * torch.log(conf)) * m).sum() / cnt

    loss = (conf_loss(l_self, pred["conf_self"])
            + conf_loss(l_cross, pred["conf"])
            + pose_weight * (l_trans.mean() + l_quat.mean()))
    if "rgb" in pred and "img" in gt:
        loss = loss + rgb_weight * (torch.abs(pred["rgb"] - gt["img"])
                                    * m[..., None]).sum() \
            / torch.clamp(m.sum() * 3, min=1.0)
    return loss


def lr_at(count, lr, warmup_steps, total_steps):
    """optax's warmup_cosine_decay_schedule(0, lr, warmup, total) at
    ``count``, in float32."""
    f = np.float32
    decay_steps = max(total_steps, warmup_steps + 1)
    if count < warmup_steps:
        frac = f(1) - f(count) / f(warmup_steps)
        return float(f(-lr) * frac + f(lr))
    t = f(min(count - warmup_steps, decay_steps - warmup_steps))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * t / f(decay_steps
                                                   - warmup_steps)))
    return float(f(lr) * cos)


class AdamW:
    """Clip the global gradient norm to 1, then AdamW, one parameter
    tensor at a time. ``mu`` and ``nu`` are the moments by name."""

    def __init__(self, named_params, lr=1e-4, weight_decay=0.05,
                 warmup_steps=100, total_steps=100_000):
        self.params = dict(named_params)
        self.lr, self.wd = lr, weight_decay
        self.warmup, self.total = warmup_steps, total_steps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values())).float()
        denom = torch.where(norm < MAX_NORM, torch.ones_like(norm),
                            norm / MAX_NORM)
        c = self.count + 1
        bc1 = 1 - float(np.float32(B1) ** np.float32(c))
        bc2 = 1 - float(np.float32(B2) ** np.float32(c))
        lr = lr_at(self.count, self.lr, self.warmup, self.total)
        for k, p in self.params.items():
            g = grads[k] / denom
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            p.add_(upd + self.wd * p, alpha=-lr)
        self.count = c
