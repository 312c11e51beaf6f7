"""Tracking frontend: lazy-batched CUT3R submap tracking (port of
``cut3r_slam_tpu/slam/frontend.py``).

Waits for SUBMAP_SIZE new keyframes, then decodes KFs [t0-1, t1) jointly
(a 1-frame overlap with the previous submap) from the encoder tokens the
motion filter stored, always at V = SUBMAP_SIZE + 1 views (shorter
batches pad with the last KF). ``submap_postprocess`` makes the
predictions first-frame-relative, scale-aligns the submap to the previous
one on the shared overlap frame, moves pointmaps to world frame and
downsamples them; poses, depths and submap buffers are written back and
covisibility edges added per keyframe.

GT-injection test mode (``set_gt_injection``): the submap decode is
replaced by pointmaps built from ground-truth depth and submap-relative
ground-truth poses perturbed by seeded noise, so the loop-closure path can
be driven where the network's predictions carry no geometry (random
weights).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry.lie import se3_exp, se3_from_matrix, se3_matrix
from ..geometry.pointmap import depth_to_pointmap, geotrf, pose_vec_to_matrix
from ..geometry.quaternion import quat_to_matrix, wxyz_to_xyzw
from ..models import CUT3R
from ..models.patch_embed import patch_positions
from .keyframe import KeyframeStore, SUBMAP_SIZE
from .factor_graph import FactorGraph

__all__ = ["TrackFrontend", "submap_postprocess", "pose_vec_to_matrix_np"]


def conf_remap(conf: torch.Tensor) -> torch.Tensor:
    """conf in (1, inf) -> (0, 1): 1 - 1/conf."""
    return 1.0 - 1.0 / conf


def submap_postprocess(pred_pts_self, pred_conf_self, pred_pose_c2w,
                       anchor_c2w, prev_depth0, init: bool, ds: int = 2):
    """World-align one tracked submap.

    pred_pts_self (V, H, W, 3); pred_conf_self (V, H, W); pred_pose_c2w
    (V, 4, 4) model-frame c2w; anchor_c2w (4, 4) stored c2w of the overlap
    KF; prev_depth0 (H, W) its stored depth (both unused for init).
    Returns (poses_c2w, depths, pts_world, pts_ds, conf, conf_ds).
    """
    first_w2c = torch.linalg.inv(pred_pose_c2w[0])
    rel = torch.einsum("ij,vjk->vik", first_w2c, pred_pose_c2w)
    conf = conf_remap(pred_conf_self)
    depths = pred_pts_self[..., 2]
    dev = pred_pts_self.device
    if init:
        s = torch.ones((), device=dev)
        align_R = torch.eye(3, device=dev)
        align_t = torch.zeros(3, device=dev)
    else:
        log_scale = torch.mean(torch.log(torch.clamp(prev_depth0, min=1e-8))
                               - torch.log(torch.clamp(depths[0], min=1e-8)))
        s = torch.exp(log_scale)
        align_R = anchor_c2w[:3, :3]
        align_t = anchor_c2w[:3, 3]
    poses = torch.eye(4, device=dev).repeat(rel.shape[0], 1, 1)
    poses[:, :3, :3] = torch.einsum("ij,vjk->vik", align_R, rel[:, :3, :3])
    poses[:, :3, 3] = torch.einsum("ij,vj->vi", align_R,
                                   s * rel[:, :3, 3]) + align_t
    pts_world = geotrf(poses[:, None, None], s * pred_pts_self)
    depths = s * depths
    return (poses, depths, pts_world, pts_world[:, ::ds, ::ds], conf,
            conf[:, ::ds, ::ds])


def pose_vec_to_matrix_np(pose_vecs: np.ndarray) -> np.ndarray:
    """Host-side [t, q xyzw] -> (N, 4, 4)."""
    from scipy.spatial.transform import Rotation
    out = np.tile(np.eye(4, dtype=np.float32), (len(pose_vecs), 1, 1))
    q = pose_vecs[:, 3:7]
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    q = np.where(norms > 1e-8, q / np.maximum(norms, 1e-8),
                 np.array([0, 0, 0, 1.0], np.float32))
    out[:, :3, :3] = Rotation.from_quat(q).as_matrix()
    out[:, :3, 3] = pose_vecs[:, :3]
    return out


class TrackFrontend:
    def __init__(self, model: CUT3R, keyframes: KeyframeStore,
                 graph: Optional[FactorGraph] = None, downsample: int = 2,
                 backend_min_kf: int = 10):
        self.model = model
        self.keyframes = keyframes
        self.graph = graph or FactorGraph()
        self.warmup = SUBMAP_SIZE + 1
        self.ds = downsample
        self.backend_min_kf = backend_min_kf
        self.is_initialized = False
        self.t1 = 0
        self.V = SUBMAP_SIZE + 1
        self.gt_inject = None  # GT-injection test mode (set_gt_injection)

    def set_gt_injection(self, provider, sigma_t: float = 0.05,
                         sigma_r: float = 0.01, seed: int = 0):
        """GT-injection test mode: ``provider(tstamp) -> (depth (H, W),
        c2w (4, 4))``. Every view but a submap's anchor gets its relative
        pose perturbed by se3 noise (translation ``sigma_t``, rotation
        ``sigma_r``) drawn from ``np.random.default_rng(seed)``: the JAX
        package's generator, so both packages draw the same noise."""
        self.gt_inject = provider
        self._gt_rng = np.random.default_rng(seed)
        self._gt_sig = (float(sigma_t), float(sigma_r))

    def _gt_infer(self, idxs):
        kf = self.keyframes
        dev = kf.device
        _, c2w0 = self.gt_inject(int(kf.tstamp[idxs[0]]))
        inv0 = np.linalg.inv(np.asarray(c2w0, np.float64))
        pts, rels = [], []
        st, sr = self._gt_sig
        for k, i in enumerate(idxs):
            depth, c2w = self.gt_inject(int(kf.tstamp[i]))
            pts.append(depth_to_pointmap(
                torch.as_tensor(np.asarray(depth, np.float32), device=dev),
                torch.as_tensor(kf.intrinsic[i], device=dev)))
            rel = inv0 @ np.asarray(c2w, np.float64)
            if k > 0 and (st > 0 or sr > 0):
                xi = np.concatenate([self._gt_rng.normal(0, st, 3),
                                     self._gt_rng.normal(0, sr, 3)])
                rel = se3_matrix(se3_exp(torch.as_tensor(
                    xi, dtype=torch.float32))).numpy() @ rel
            rels.append(rel.astype(np.float32))
        H, W = kf.img_hw
        conf = torch.full((len(idxs), H, W), 9.0, device=dev)  # 1-1/c = .89
        return (torch.stack(pts), conf,
                torch.as_tensor(np.stack(rels), device=dev))

    @torch.inference_mode()
    def infer_views(self, idxs):
        """(pts_self, conf_self, submap-relative c2w) for KF indices ``idxs``
        (length V), decoded from the stored encoder tokens (the motion
        filter already ran the encoder per keyframe), or synthesized from
        ground truth in GT-injection mode."""
        if self.gt_inject is not None:
            return self._gt_infer(idxs)
        kf = self.keyframes
        H, W = kf.img_hw
        p = self.model.cfg.patch_size
        feat = kf.featI[torch.as_tensor(list(idxs), device=kf.device)]
        V = feat.shape[0]
        pos = patch_positions(V, H // p, W // p, feat.device)
        out, _ = self.model.decode_views(feat[:, None], pos[:, None], H, W,
                                         head_outputs=("self", "pose"))
        pose = out["camera_pose"][:, 0]                      # (V, 7) wxyz
        c2w = torch.eye(4, device=feat.device).repeat(V, 1, 1)
        c2w[:, :3, :3] = quat_to_matrix(wxyz_to_xyzw(pose[:, 3:7]))
        c2w[:, :3, 3] = pose[:, :3]
        return out["pts3d_in_self_view"][:, 0], out["conf_self"][:, 0], c2w

    @torch.inference_mode()
    def track(self, t0: int, t1: int, init: bool = False):
        """Track keyframes [t0, t1); t1 - t0 <= V (padded to V)."""
        kf = self.keyframes
        dev = kf.device
        n = t1 - t0
        assert 1 < n <= self.V
        idxs = list(range(t0, t1)) + [t1 - 1] * (self.V - n)
        pts_self, conf_self, c2w = self.infer_views(idxs)
        anchor_c2w = pose_vec_to_matrix(torch.as_tensor(kf.pose[t0],
                                                        device=dev))
        prev_depth0 = torch.as_tensor(kf.depth[t0], device=dev)
        poses, depths, _, pts_ds, _, conf_ds = submap_postprocess(
            pts_self, conf_self, c2w, anchor_c2w, prev_depth0, init=init,
            ds=self.ds)

        sub = t0 // SUBMAP_SIZE
        kf.pose[t0:t1] = se3_from_matrix(poses).cpu().numpy()[:n]
        kf.depth[t0:t1] = depths[:n].cpu().numpy()
        kf.set_submap(sub, pts_ds[:n], conf_ds[:n], slot0=0)
        kf.pts_ds[t0:t0 + n] = pts_ds[:n]

        if init:
            self.graph.add_neighborhood_factors(0, min(3, t1), r=3)
        K4 = kf.intrinsic.copy() / self.ds
        c2w_all = pose_vec_to_matrix_np(kf.pose)
        for i in range(t0, t1):
            if not init:
                self.graph.add_neighborhood_factors(max(i - 3, 0), i + 1, r=3)
            if i > 2:
                self.graph.add(i, c2w_all, kf.pts_ds, K4=K4[i],
                               valid_count=i + 1)
        return poses

    def run(self, tstamp: int, last_frame: bool = False
            ) -> Tuple[bool, Optional[range], Optional[int]]:
        """Per-frame trigger. Returns (run_backend, new_kf_range,
        submap_idx)."""
        kf = self.keyframes
        if not self.is_initialized and kf.count - 1 == self.warmup:
            t1 = kf.count - 1
            self.track(0, t1, init=True)
            self.is_initialized = True
            self.t1 = t1
            return False, range(0, t1), 0
        if self.is_initialized and self.t1 < kf.count - SUBMAP_SIZE:
            t0, t1 = self.t1 - 1, kf.count - 1
            self.track(t0, t1)
            self.t1 = t1
            return (t1 > self.backend_min_kf), range(t0, t1), \
                t0 // SUBMAP_SIZE
        if last_frame and self.is_initialized and kf.count - 1 > self.t1:
            t0, t1 = self.t1 - 1, kf.count - 1
            self.track(t0, t1)
            self.t1 = t1
            return False, range(t0, t1), t0 // SUBMAP_SIZE
        return False, None, None
