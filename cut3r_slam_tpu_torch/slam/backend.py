"""Loop-closure tracking backend: detection, LC re-tracking, submap PGO
(port of ``cut3r_slam_tpu/slam/backend.py``).

Per call: scan the recent keyframes for loop candidates (covisible edges
with a temporal gap > ``loop_gap``), NMS-pick the best match, re-run the
submap decode on [matched submap's keyframes + current keyframe]
scale-aligned to the matched anchor, then optimize per-submap rigid SE(3)
corrections (first submap fixed) with Adam against two L1 objectives:

* seam consistency: |last pointmap of submap b - first of submap b+1|
* loop consistency: |current pointmap (corrected) - LC-predicted pointmap|

and rigidly move every submap pointmap, keyframe pose and half-res
pointmap. Repeat closures run the multi-loop PGO: each earlier loop keeps
its LC cloud, each cloud gets a free SE(3), and a third objective anchors
the clouds to their matched submaps.

Each PGO is a plain loop of tensor ops on the keyframe store's device,
gradients by autograd, in full f32. The JAX package pads the submap count
to a multiple of 8 and the loop count to a multiple of 4 to bound XLA
recompiles; padded rows carry zero weight, get zero gradient and so take
zero Adam steps, so the port runs the real rows only. Adam is written out
as the JAX package writes it (``torch.optim.Adam`` orders the same
formula differently, which moves the f32 rounding over 2000 steps).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import full_f32
from ..geometry.lie import se3_exp, se3_matrix, se3_from_matrix
from ..geometry.pointmap import pose_vec_to_matrix
from .keyframe import KeyframeStore, SUBMAP_SIZE
from .factor_graph import FactorGraph
from .frontend import TrackFrontend, submap_postprocess

__all__ = ["TrackBackend", "pgo_align", "pgo_align_multi", "apply_pgo"]


def _se3_Rt(xi):
    T = se3_matrix(se3_exp(xi))
    return T[:, :3, :3], T[:, :3, 3]


def _zero_row(xi):
    return torch.cat([torch.zeros_like(xi[:1]), xi], 0)


def _seam_terms(submap_pts, seam_conf):
    """(first, last, conf): each submap's first and last (overlap) slot as
    (B, N, 3) points and its overlap slot's confidence mask (B, N)."""
    B = submap_pts.shape[0]
    return (submap_pts[:, 0].reshape(B, -1, 3),
            submap_pts[:, -1].reshape(B, -1, 3),
            (seam_conf.reshape(B, -1) > 0).float())


def _seam_loss(R, t, first, last, conf):
    """Confidence-masked mean L1 between submap b's last pointmap and
    submap b+1's first, both under their corrections; also returns the
    corrected first slots."""
    last_a = torch.einsum("bij,bnj->bni", R, last) + t[:, None, :]
    first_a = torch.einsum("bij,bnj->bni", R, first) + t[:, None, :]
    seam = torch.abs(last_a[:-1] - first_a[1:]).mean(-1)
    c = conf[:-1]
    return (seam * c).sum() / torch.clamp(c.sum(), min=1.0), first_a


def _align_loss(xi, first, last, conf, cur, cur_lc):
    """pgo_align's objective at the corrections xi (B-1, 6): seam loss
    plus |current keyframe's corrected pointmap - its LC prediction|."""
    R, t = _se3_Rt(_zero_row(xi))
    fl_loss, _ = _seam_loss(R, t, first, last, conf)
    cur_a = torch.einsum("ij,nj->ni", R[-1], cur) + t[-1]
    return fl_loss + torch.abs(cur_a - cur_lc).mean()


def _multi_loss(xi, xi_lc, first, last, conf, lc_first, lc_last, cur,
                cur_sub, matched_sub):
    """pgo_align_multi's objective: seam loss, plus per loop the LC
    cloud's first slot against its matched submap's first pointmap and
    the current keyframe's corrected pointmap against the cloud's last
    slot, each cloud under its free transform xi_lc (C, 6)."""
    C = lc_first.shape[0]
    R, t = _se3_Rt(_zero_row(xi))
    Rl, tl = _se3_Rt(xi_lc)
    fl_loss, first_a = _seam_loss(R, t, first, last, conf)
    lc_first_a = torch.einsum("cij,cnj->cni", Rl, lc_first) + tl[:, None, :]
    lc_last_a = torch.einsum("cij,cnj->cni", Rl, lc_last) + tl[:, None, :]
    matched_loss = torch.abs(lc_first_a - first_a[matched_sub]) \
        .mean((-1, -2)).sum() / C
    cur_a = torch.einsum("cij,cnj->cni", R[cur_sub], cur) \
        + t[cur_sub][:, None, :]
    lc_loss = torch.abs(cur_a - lc_last_a).mean((-1, -2)).sum() / C
    return fl_loss + lc_loss + matched_loss


def _adam_descent(loss_fn, params, iters, lr):
    """``iters`` steps of the JAX package's hand-written Adam on the
    tuple ``params``, in place; gradients by autograd."""
    m = tuple(torch.zeros_like(p) for p in params)
    v = tuple(torch.zeros_like(p) for p in params)
    for i in range(iters):
        x = tuple(p.detach().requires_grad_(True) for p in params)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(*x), x)
        it = torch.tensor(i + 1.0, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(0.9) ** it)
        bc2 = float(1 - torch.tensor(0.999) ** it)
        with torch.no_grad():
            for p, g, mm, vv in zip(params, grads, m, v):
                mm.copy_(0.9 * mm + 0.1 * g)
                vv.copy_(0.999 * vv + 0.001 * g * g)
                p.sub_(lr * (mm / bc1) / (torch.sqrt(vv / bc2) + 1e-8))
    return params


@full_f32()
def pgo_align(submap_pts: torch.Tensor, seam_conf: torch.Tensor,
              pts_current: torch.Tensor, pts_current_lc: torch.Tensor,
              iters: int = 2000, lr: float = 5e-4) -> torch.Tensor:
    """Per-submap SE(3) PGO of one closure.

    submap_pts (B, S+1, h, w, 3) world pointmaps (slot S = overlap);
    seam_conf (B, h, w) confidence of each submap's overlap slot;
    pts_current (h, w, 3) the current keyframe's pointmap in world, in the
    last submap; pts_current_lc (h, w, 3) the same keyframe re-predicted
    in the matched submap's frame. Returns xi (B, 6) with xi[0] = 0.
    """
    data = _seam_terms(submap_pts, seam_conf) + (
        pts_current.reshape(-1, 3), pts_current_lc.reshape(-1, 3))
    xi = torch.zeros(submap_pts.shape[0] - 1, 6, device=submap_pts.device)
    _adam_descent(lambda x: _align_loss(x, *data), (xi,), iters, lr)
    return _zero_row(xi)


@full_f32()
def pgo_align_multi(submap_pts: torch.Tensor, seam_conf: torch.Tensor,
                    lc_fl: torch.Tensor, cur_pts: torch.Tensor,
                    cur_sub: torch.Tensor, matched_sub: torch.Tensor,
                    iters: int = 2000, lr: float = 5e-4):
    """Multi-loop PGO with matched-anchor terms (repeat closures).

    submap_pts (B, S+1, h, w, 3); seam_conf (B, h, w); lc_fl (C, 2, h, w, 3)
    first/last slots of each closed loop's LC cloud (in the matched
    submap's frame); cur_pts (C, h, w, 3) each loop's current-keyframe
    pointmap in world; cur_sub / matched_sub (C,) submap indices.
    Optimizes the submap corrections (first fixed) and a free SE(3) per LC
    cloud. Returns (xi (B, 6), xi_lc (C, 6)).
    """
    C = lc_fl.shape[0]
    data = _seam_terms(submap_pts, seam_conf) + (
        lc_fl[:, 0].reshape(C, -1, 3), lc_fl[:, 1].reshape(C, -1, 3),
        cur_pts.reshape(C, -1, 3), cur_sub, matched_sub)
    dev = submap_pts.device
    xi, xi_lc = _adam_descent(
        lambda a, b: _multi_loss(a, b, *data),
        (torch.zeros(submap_pts.shape[0] - 1, 6, device=dev),
         torch.zeros(C, 6, device=dev)), iters, lr)
    return _zero_row(xi), xi_lc


@torch.no_grad()
@full_f32()
def apply_pgo(submap_pts: torch.Tensor, xi: torch.Tensor):
    """Rigidly transform all submap pointmaps by their corrections;
    returns (moved pointmaps, (B, 4, 4) transforms)."""
    T = se3_matrix(se3_exp(xi))
    out = torch.einsum("bij,bshwj->bshwi", T[:, :3, :3], submap_pts) \
        + T[:, None, None, None, :3, 3]
    return out, T


class TrackBackend:
    def __init__(self, frontend: TrackFrontend, keyframes: KeyframeStore,
                 graph: FactorGraph, loop_iters: int = 2000,
                 loop_gap: int = 8, nms_thresh: float = 0.4,
                 freeze_after: int = 20):
        self.fe = frontend
        self.kf = keyframes
        self.graph = graph
        self.loop_iters = loop_iters
        self.loop_gap = loop_gap
        self.nms_thresh = nms_thresh
        self.freeze_counter = 0
        self.freeze_after = freeze_after
        self.closed: List[int] = []
        # per closed loop: the matched / current keyframe indices and the
        # LC cloud's first and last slots (2, h, w, 3), world-consistent
        self.closed_loop: Dict[str, List] = {
            "idx_current": [], "idx_matched": [], "lc_fl": []}

    def lc_track(self, matched_idx: int, current_idx: int):
        """Re-run the submap decode on [matched submap's keyframes +
        current]; returns the half-res pointmaps and confidences in the
        matched submap's world-aligned frame (the current keyframe last)."""
        kf = self.kf
        t0 = (matched_idx // SUBMAP_SIZE) * SUBMAP_SIZE
        idxs = list(range(t0, t0 + SUBMAP_SIZE)) + [current_idx]
        pts_self, conf_self, c2w = self.fe.infer_views(idxs)
        anchor_c2w = pose_vec_to_matrix(torch.as_tensor(kf.pose[t0],
                                                        device=kf.device))
        prev_depth0 = torch.as_tensor(kf.depth[t0], device=kf.device)
        with torch.no_grad():
            _, _, _, pts_ds, _, conf_ds = submap_postprocess(
                pts_self, conf_self, c2w, anchor_c2w, prev_depth0,
                init=False, ds=self.fe.ds)
        return pts_ds, conf_ds

    @torch.no_grad()
    def loop_closure(self, matched_idx: int, current_idx: int
                     ) -> Dict[str, np.ndarray]:
        """PGO over submaps [0, current submap], then the writeback;
        returns the packet the mapper's ``gaussian_update`` takes. The
        first closure runs ``pgo_align``, repeat closures
        ``pgo_align_multi``."""
        kf = self.kf
        dev = kf.device
        lc_pts_all, _ = self.lc_track(matched_idx, current_idx)
        sub_cur = current_idx // SUBMAP_SIZE
        B = sub_cur + 1
        submap_pts = kf.submap_pts[:B]
        seam_conf = kf.submap_conf[:B, -1]
        lc_fl_new = torch.stack([lc_pts_all[0], lc_pts_all[-1]])
        if not self.closed_loop["idx_current"]:
            xi = pgo_align(submap_pts, seam_conf,
                           kf.submap_pts[sub_cur, current_idx % SUBMAP_SIZE],
                           lc_pts_all[-1], iters=self.loop_iters)
            xi_lc = torch.zeros(1, 6, device=dev)
            lc_fls = lc_fl_new[None]
        else:
            idx_cur = np.asarray(self.closed_loop["idx_current"]
                                 + [current_idx])
            idx_m = np.asarray(self.closed_loop["idx_matched"]
                               + [matched_idx])
            lc_fls = torch.stack(self.closed_loop["lc_fl"] + [lc_fl_new])
            cur_sub = torch.as_tensor(
                np.minimum(idx_cur // SUBMAP_SIZE, B - 1), device=dev)
            matched_sub = torch.as_tensor(
                np.minimum(idx_m // SUBMAP_SIZE, B - 1), device=dev)
            cur_pts = kf.submap_pts[
                cur_sub, torch.as_tensor(idx_cur % SUBMAP_SIZE, device=dev)]
            xi, xi_lc = pgo_align_multi(submap_pts, seam_conf, lc_fls,
                                        cur_pts, cur_sub, matched_sub,
                                        iters=self.loop_iters)
        new_pts, T = apply_pgo(submap_pts, xi)

        # keep the LC clouds world-consistent for the next closure
        with full_f32():
            Rl, tl = _se3_Rt(xi_lc)
            lc_fls = torch.einsum("cij,cfhwj->cfhwi", Rl, lc_fls) \
                + tl[:, None, None, None, :]
        self.closed_loop["idx_current"].append(current_idx)
        self.closed_loop["idx_matched"].append(matched_idx)
        self.closed_loop["lc_fl"] = list(lc_fls.unbind(0))

        # writeback: submap pointmaps, keyframe poses, half-res pointmaps
        kf.submap_pts[:B] = new_pts
        n_kf = min(kf.count, B * SUBMAP_SIZE + 1)
        bsel = torch.as_tensor(
            np.minimum(np.arange(n_kf) // SUBMAP_SIZE, B - 1), device=dev)
        Tk = T[bsel]
        with full_f32():
            c2w = pose_vec_to_matrix(torch.as_tensor(kf.pose[:n_kf],
                                                     device=dev))
            new_poses = se3_from_matrix(Tk @ c2w).cpu().numpy()
            kf.pts_ds[:n_kf] = torch.einsum(
                "nij,nhwj->nhwi", Tk[:, :3, :3], kf.pts_ds[:n_kf]) \
                + Tk[:, None, None, :3, 3]
        kf.pose[:n_kf] = new_poses
        self.closed.append(current_idx)
        return {
            "pose_updates": se3_from_matrix(T).cpu().numpy(),  # [t, q xyzw]
            "submap_idx": np.arange(B),
            "camera_idx": np.arange(n_kf),
            "camera_pose": new_poses.copy(),
        }

    def run(self, t1: int) -> Optional[Dict[str, np.ndarray]]:
        """Scan the recent keyframes for a loop and close the first one the
        NMS accepts; a closure freezes the scan for ``freeze_after``
        calls."""
        if self.freeze_counter > 0:
            self.freeze_counter -= 1
            return None
        kf = self.kf
        K4 = kf.intrinsic[0] / self.fe.ds
        for i in range(max(t1 - 6, SUBMAP_SIZE + 1), t1 - 1):
            cand = self.graph.detect_loop(i, temporal_window=self.loop_gap)
            if cand is None:
                continue
            cand = cand[cand < i - self.loop_gap]
            if len(cand) == 0:
                continue
            c2w_all = pose_vec_to_matrix(torch.as_tensor(kf.pose))
            pick = self.graph.nms(cand, i, c2w_all.numpy(), kf.pts_ds,
                                  kf.featI, K4, th=self.nms_thresh)
            if pick is None:
                continue
            updates = self.loop_closure(int(pick), i)
            self.freeze_counter = self.freeze_after
            return updates
        return None
