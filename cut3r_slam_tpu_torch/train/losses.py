"""Training losses for CUT3R: Regr3DPose + ConfLoss + RGB (port of
``cut3r_slam_tpu/train/losses.py``).

Anchor-view-0 pointmap regression with average-distance normalization of
both prediction and ground truth, confidence weighting
``conf * l - alpha * log(conf)``, pose translation / rotation terms, the
per-sample criterion mix of Regr3DPoseBatchList (depth-only, single-view,
camera-only datasets) and the optimal gt -> prediction scale fit. Pure
functions over stacked view tensors (V, B, ...), as in the JAX package.

Pose orders: the predicted ``camera_pose`` is (t, quaternion wxyz) as the
heads emit it; the ground truth is a 4x4 camera-to-world matrix; the
quaternion distance is taken in the geometry package's xyzw order.

Data parallelism (``group``: the process group of the data-parallel ranks,
each holding a slice of B). The JAX step computes its means over the
WHOLE batch; a mean of per-rank means differs from that whenever the
ranks' valid counts differ. So every reduction over B takes its count over
``group`` (an ``all_reduce`` of the detached count) and each rank's loss
is its own part of the global one: its sum over that global count. The
parts add up to the global loss, and the ranks' gradients must be SUMMED
(``train_step``). The reductions over B, each audited:

* ``conf_loss``, ``rgb_loss``, ``masked_mean``: masked sums over the
  batch over the global mask count (the JAX losses.py:92-106, 154-156);
* ``regr3d_pose_loss``: ``loss_trans`` and ``loss_quat`` are means over
  (V, B): sums over the global element count; its normalizations
  (``_avg_dis_norm`` and the translation scales) are per batch element
  and stay on the element's rank;
* ``find_opt_scaling``, ``depth_scale_shift_inv_loss``, ``scale_inv_loss``
  and the BatchList criterion selection: per batch element or per map;
* the TBPTT step's mean over its chunks: a count every rank shares.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..geometry.pointmap import geotrf
from ..geometry.quaternion import matrix_to_quat, wxyz_to_xyzw

__all__ = ["regr3d_pose_loss", "conf_loss", "rgb_loss", "cut3r_total_loss",
           "depth_scale_shift_inv_loss", "scale_inv_loss", "masked_mean",
           "regr3d_pose_batchlist_loss", "cut3r_batchlist_total_loss",
           "find_opt_scaling"]

# IRLS iterations of the Weiszfeld scale fit (a fixed count: no early exit)
WEISZFELD_ITERS = 10


def _count(n: torch.Tensor, group) -> torch.Tensor:
    """A count over the batch: as it is, or summed over the data-parallel
    ``group`` (detached)."""
    if group is None:
        return n
    from ..parallel.mesh import all_reduce
    return all_reduce(n, group=group)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """``x.mean()`` over the whole batch of ``group``'s ranks."""
    if group is None:
        return x.mean()
    return x.sum() / _count(torch.tensor(float(x.numel()), device=x.device),
                            group)


def _avg_dis_norm(pts: torch.Tensor, valid: torch.Tensor, eps: float = 1e-8):
    """Average-distance normalization factor: mean point norm over the
    valid points of each batch element. pts (V, B, H, W, 3), valid
    (V, B, H, W) -> (B,)."""
    dis = torch.linalg.norm(pts, dim=-1)
    m = valid.to(pts.dtype)
    tot = (dis * m).sum((0, 2, 3))
    cnt = torch.clamp(m.sum((0, 2, 3)), min=1.0)
    return torch.clamp(tot / cnt, min=eps)


def _gt_frames(gt):
    """Ground-truth points in each view's own camera and in view 0's, and
    the anchor-relative camera-to-world poses."""
    c2w = gt["camera_pose"]
    w2c = torch.linalg.inv(c2w)
    in_cam0 = torch.linalg.inv(c2w[0])
    gt_self = geotrf(w2c[:, :, None, None], gt["pts3d"])
    gt_cross = geotrf(in_cam0[None, :, None, None], gt["pts3d"])
    return gt_self, gt_cross, in_cam0


def regr3d_pose_loss(pred: Dict[str, torch.Tensor],
                     gt: Dict[str, torch.Tensor], group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Per-pixel regression distances of the self and cross pointmaps, and
    the pose terms.

    pred: pts3d_in_self_view / pts3d_in_other_view (V, B, H, W, 3),
    camera_pose (V, B, 7; t, quaternion wxyz). gt: pts3d (V, B, H, W, 3)
    in the world frame, camera_pose (V, B, 4, 4) camera-to-world,
    valid_mask (V, B, H, W). Returns (l_self, l_cross, aux): l_* are
    (V, B, H, W) distances after normalization; aux holds loss_trans and
    loss_quat."""
    gt_self, gt_cross, in_cam0 = _gt_frames(gt)
    valid = gt["valid_mask"]
    pr_self = pred["pts3d_in_self_view"]
    pr_cross = pred["pts3d_in_other_view"]

    # both clouds normalized by their own average distance over the
    # self + cross concatenation
    valid2 = torch.cat([valid, valid], 2)
    nf_pr = _avg_dis_norm(torch.cat([pr_self, pr_cross], 2),
                          valid2)[None, :, None, None, None]
    nf_gt = _avg_dis_norm(torch.cat([gt_self, gt_cross], 2),
                          valid2)[None, :, None, None, None]
    l_self = torch.linalg.norm(pr_self / nf_pr - gt_self / nf_gt, dim=-1)
    l_cross = torch.linalg.norm(pr_cross / nf_pr - gt_cross / nf_gt, dim=-1)

    # pose terms: predicted pose (in the anchor frame) vs the gt relative one
    gt_rel = torch.einsum("bij,vbjk->vbik", in_cam0, gt["camera_pose"])
    gt_t = gt_rel[..., :3, 3]
    pr_t = pred["camera_pose"][..., :3]
    nf_gt_t = torch.clamp(torch.linalg.norm(gt_t, dim=-1).mean(0), min=1e-8)
    nf_pr_t = torch.clamp(torch.linalg.norm(pr_t, dim=-1).mean(0), min=1e-8)
    l_trans = torch.linalg.norm(pr_t / nf_pr_t[None, :, None]
                                - gt_t / nf_gt_t[None, :, None], dim=-1)
    # quaternion distance 1 - |<q_pred, q_gt>|, both xyzw
    q_gt = matrix_to_quat(gt_rel[..., :3, :3])
    q_pr = wxyz_to_xyzw(pred["camera_pose"][..., 3:7])
    l_quat = 1.0 - torch.abs((q_gt * q_pr).sum(-1))
    return l_self, l_cross, {"loss_trans": _mean(l_trans, group),
                             "loss_quat": _mean(l_quat, group)}


def conf_loss(l: torch.Tensor, conf: torch.Tensor, valid: torch.Tensor,
              alpha: float = 0.2, group=None) -> torch.Tensor:
    """ConfLoss: mean over valid pixels of conf * l - alpha * log(conf)
    (conf is the activated confidence, > 1)."""
    per_pix = conf * l - alpha * torch.log(conf)
    m = valid.to(l.dtype)
    return (per_pix * m).sum() / torch.clamp(_count(m.sum(), group), min=1.0)


def rgb_loss(pred_rgb: torch.Tensor, gt_img: torch.Tensor,
             valid: torch.Tensor, group=None) -> torch.Tensor:
    m = valid.to(pred_rgb.dtype)[..., None]
    return (torch.abs(pred_rgb - gt_img) * m).sum() \
        / torch.clamp(_count(m.sum(), group) * 3, min=1.0)


def depth_scale_shift_inv_loss(pred_z: torch.Tensor, gt_z: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Scale- and shift-invariant depth L1. pred_z / gt_z / mask
    (..., H, W); each leading-index map is normalized on its own (shift =
    masked mean, scale = masked mean |x - shift|, clamped at 1e-6).
    Returns the per-pixel masked distance map (zeros off the mask)."""
    m = mask.to(pred_z.dtype)
    cnt = torch.clamp(m.sum((-2, -1), keepdim=True), min=1.0)

    def _norm(x):
        shift = (x * m).sum((-2, -1), keepdim=True) / cnt
        cen = x - shift
        scale = (torch.abs(cen) * m).sum((-2, -1), keepdim=True) / cnt
        return cen / torch.clamp(scale, min=1e-6)

    return torch.abs(_norm(pred_z) - _norm(gt_z)) * m


def scale_inv_loss(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Scale-invariant pointmap loss. pred_pts / gt_pts (..., H, W, 3),
    mask (..., H, W); each map is divided by its masked mean point norm
    (clamped at 1e-6). Returns the per-pixel masked distance map."""
    m = mask.to(pred_pts.dtype)
    cnt = torch.clamp(m.sum((-2, -1), keepdim=True), min=1e-6)

    def _norm(x):
        n = torch.sqrt((x * x).sum(-1) + 1e-20)
        f = (n * m).sum((-2, -1), keepdim=True) / cnt
        return x / torch.clamp(f, min=1e-6)[..., None]

    d = _norm(pred_pts) - _norm(gt_pts)
    return torch.sqrt((d * d).sum(-1) + 1e-20) * m


def masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None
                ) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(_count(m.sum(), group), min=1.0)


def find_opt_scaling(gt_pts1: torch.Tensor, gt_pts2, pr_pts1: torch.Tensor,
                     pr_pts2=None, fit_mode: str = "weiszfeld_stop_grad",
                     valid1=None, valid2=None) -> torch.Tensor:
    """Per-batch optimal gt -> prediction scale: min_s ||pr - s gt|| over
    the valid points of one or two views. ``avg``: closed-form least
    squares; ``median``: the lower median of per-point ratios;
    ``weiszfeld``: ``WEISZFELD_ITERS`` IRLS steps with 1 / residual
    weights from the ``avg`` start. Modes ending in ``_stop_grad``
    detach the result. Invalid points get weight 0.

    gt / pr pts (B, H, W, 3); valid (B, H, W) bool or None (all valid).
    Returns (B,) scales clipped to >= 1e-3."""
    def flat(pts, valid):
        p = pts.reshape(pts.shape[0], -1, 3)
        m = torch.ones(p.shape[:2], dtype=pts.dtype, device=pts.device) \
            if valid is None else valid.reshape(p.shape[0], -1).to(pts.dtype)
        return p, m

    all_gt, m = flat(gt_pts1, valid1)
    all_pr, _ = flat(pr_pts1, valid1)
    if gt_pts2 is not None:
        g2, m2 = flat(gt_pts2, valid2)
        p2, _ = flat(pr_pts2, valid2)
        all_gt = torch.cat([all_gt, g2], 1)
        all_pr = torch.cat([all_pr, p2], 1)
        m = torch.cat([m, m2], 1)

    dot_gt_pr = (all_pr * all_gt).sum(-1)
    dot_gt_gt = (all_gt * all_gt).sum(-1)
    cnt = torch.clamp(m.sum(1), min=1.0)

    def wmean(x, w):
        return (x * w).sum(1) / torch.clamp(w.sum(1), min=1e-12)

    def avg():
        return ((dot_gt_pr * m).sum(1) / cnt) \
            / torch.clamp((dot_gt_gt * m).sum(1) / cnt, min=1e-12)

    if fit_mode.startswith("avg"):
        scaling = avg()
    elif fit_mode.startswith("median"):
        ratio = torch.where(m > 0, dot_gt_pr / torch.clamp(dot_gt_gt,
                                                           min=1e-12),
                            torch.full_like(dot_gt_pr, float("inf")))
        srt = torch.sort(ratio, dim=1).values
        k = torch.clamp(((m.sum(1) - 1) / 2).to(torch.int64), min=0)
        scaling = torch.gather(srt, 1, k[:, None])[:, 0]
    elif fit_mode.startswith("weiszfeld"):
        scaling = avg()
        for _ in range(WEISZFELD_ITERS):
            d = all_pr - scaling[:, None, None] * all_gt
            dis = torch.sqrt((d * d).sum(-1) + 1e-20)
            w = m / torch.clamp(dis, min=1e-8)
            scaling = wmean(dot_gt_pr, w) / torch.clamp(
                wmean(dot_gt_gt, w), min=1e-12)
    else:
        raise ValueError(f"bad {fit_mode=}")
    if fit_mode.endswith("stop_grad"):
        scaling = scaling.detach()
    return torch.clamp(scaling, min=1e-3)


def regr3d_pose_batchlist_loss(pred: Dict[str, torch.Tensor],
                               gt: Dict[str, torch.Tensor], group=None
                               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Regr3DPoseBatchList: per-sample criterion selection on top of the
    anchor-view regression. Optional gt flags, each (B,) bool:
    depth_only (scale / shift-invariant L1 on z), single_view (with
    is_metric off: scale-invariant pointmap loss), camera_only (the
    cross-view pixel losses are dropped). Samples with no flag use
    ``regr3d_pose_loss``. All variants are computed and selected per
    sample. aux gains valid_cross."""
    l_self_std, l_cross_std, aux = regr3d_pose_loss(pred, gt, group)
    valid = gt["valid_mask"]
    zeros = torch.zeros(valid.shape[1], dtype=torch.bool,
                        device=valid.device)
    depth_only = gt.get("depth_only", zeros)
    single_view = gt.get("single_view", zeros)
    is_metric = gt.get("is_metric", zeros)
    camera_only = gt.get("camera_only", zeros)

    gt_self, gt_cross, _ = _gt_frames(gt)
    sel_do = depth_only[None, :, None, None]
    sel_sv = (single_view & ~is_metric)[None, :, None, None]

    def _mix(l_std, pr, gtp):
        l_do = depth_scale_shift_inv_loss(pr[..., 2], gtp[..., 2], valid)
        l_sv = scale_inv_loss(pr, gtp, valid)
        return torch.where(sel_do, l_do, torch.where(sel_sv, l_sv, l_std))

    l_self = _mix(l_self_std, pred["pts3d_in_self_view"], gt_self)
    l_cross = _mix(l_cross_std, pred["pts3d_in_other_view"], gt_cross)
    valid_cross = valid & (~camera_only)[None, :, None, None]
    return l_self, l_cross, {**aux, "valid_cross": valid_cross}


def _total(l_self, l_cross, aux, pred, gt, valid_cross, alpha, pose_weight,
           rgb_weight, group):
    valid = gt["valid_mask"]
    loss = (conf_loss(l_self, pred["conf_self"], valid, alpha, group)
            + conf_loss(l_cross, pred["conf"], valid_cross, alpha, group)
            + pose_weight * (aux["loss_trans"] + aux["loss_quat"]))
    if "rgb" in pred and "img" in gt:
        loss = loss + rgb_weight * rgb_loss(pred["rgb"], gt["img"], valid,
                                            group)
    aux["total"] = loss
    return loss, aux


def cut3r_batchlist_total_loss(pred: Dict[str, torch.Tensor],
                               gt: Dict[str, torch.Tensor],
                               alpha: float = 0.2, pose_weight: float = 1.0,
                               rgb_weight: float = 1.0, group=None
                               ) -> Tuple[torch.Tensor, Dict]:
    """ConfLoss over the BatchList criterion mix, plus the pose and the
    optional RGB terms (``group``: see the module docstring)."""
    l_self, l_cross, aux = regr3d_pose_batchlist_loss(pred, gt, group)
    valid_cross = aux.pop("valid_cross")
    return _total(l_self, l_cross, aux, pred, gt, valid_cross, alpha,
                  pose_weight, rgb_weight, group)


def cut3r_total_loss(pred: Dict[str, torch.Tensor],
                     gt: Dict[str, torch.Tensor], alpha: float = 0.2,
                     pose_weight: float = 1.0, rgb_weight: float = 1.0,
                     group=None) -> Tuple[torch.Tensor, Dict]:
    """ConfLoss over the self and cross pointmaps, plus the pose and the
    optional RGB terms. Returns (loss, aux with loss_trans, loss_quat,
    total); with a data-parallel ``group`` each is this rank's part of
    the whole batch's (see the module docstring)."""
    l_self, l_cross, aux = regr3d_pose_loss(pred, gt, group)
    return _total(l_self, l_cross, aux, pred, gt, gt["valid_mask"], alpha,
                  pose_weight, rgb_weight, group)
