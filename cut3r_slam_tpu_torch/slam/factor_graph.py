"""Covisibility factor graph and loop detection (port of
``cut3r_slam_tpu/slam/factor_graph.py``).

The edge list is host numpy; the reprojection overlap of a keyframe's
half-res pointmap against every keyframe camera and the patch-feature
similarity run over the full fixed-capacity buffers on the device, in
full f32. ``add``: near frames (center distance <= 1.0) need
one-directional overlap > 0.3, far frames a bidirectional one; edges go
in both directions. ``detect_loop``: covisible keyframes more than
``temporal_window`` away; ``nms``: score = 0.8 * mean bidirectional
overlap + 0.2 * feature match ratio, accepted above ``th``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import full_f32

__all__ = ["FactorGraph"]


@torch.no_grad()
def _overlap_to_all(pointmap, c2w_all, K4, bidir_pts, cur_w2c):
    """Fraction of pixels landing in-frame: the current KF's pointmap in
    every KF camera (fwd) and every KF's pointmap in the current camera
    (rev). pointmap (h, w, 3); c2w_all (C, 4, 4); K4 scaled to (h, w)."""
    h, w = pointmap.shape[:2]
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    pts = pointmap.reshape(-1, 3)

    def frac(p):
        z = torch.clamp(p[..., 2], min=1e-5)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (p[..., 2] > 0)
        return ok.float().mean(-1)

    w2c = torch.linalg.inv(c2w_all)
    fwd = frac(torch.einsum("cij,nj->cni", w2c[:, :3, :3], pts)
               + w2c[:, None, :3, 3])
    q = torch.einsum("ij,cnj->cni", cur_w2c[:3, :3],
                     bidir_pts.reshape(bidir_pts.shape[0], -1, 3)) \
        + cur_w2c[:3, 3]
    return fwd, frac(q)


@torch.no_grad()
def _feat_sim_to_all(feat, feat_all, threshold: float = 0.7):
    """Patch-feature match ratio of ``feat`` (N, D) against every keyframe
    of ``feat_all`` (C, N, D), token 0 skipped: the fraction of tokens
    whose best cosine similarity exceeds ``threshold``. Full f32 (no
    TF32), so the threshold decisions are the JAX package's."""
    with full_f32():
        f0 = feat[1:]
        f0 = f0 / torch.clamp(torch.linalg.norm(f0, dim=1, keepdim=True),
                              min=1e-12)
        fa = feat_all[:, 1:]
        fa = fa / torch.clamp(torch.linalg.norm(fa, dim=2, keepdim=True),
                              min=1e-12)
        max_sim = torch.einsum("nd,cmd->cnm", f0, fa).amax(2)
    return (max_sim > threshold).float().mean(1)


class FactorGraph:
    def __init__(self, max_edges: int = 4096, near_dist: float = 1.0,
                 overlap_thresh: float = 0.3):
        self.max_edges = max_edges
        self.near_dist = near_dist
        self.overlap_thresh = overlap_thresh
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)

    def add_factors(self, ii, jj):
        """Append edges, dropping duplicates and self-edges."""
        ii = np.atleast_1d(np.asarray(ii, np.int64)).reshape(-1)
        jj = np.atleast_1d(np.asarray(jj, np.int64)).reshape(-1)
        existing = set(zip(self.ii.tolist(), self.jj.tolist()))
        keep = []
        for k in range(len(ii)):
            e = (int(ii[k]), int(jj[k]))
            if e not in existing and e[0] != e[1]:
                existing.add(e)
                keep.append(k)
        if not keep:
            return
        ii, jj = ii[keep], jj[keep]
        self.ii = np.concatenate([self.ii, ii])[-self.max_edges:]
        self.jj = np.concatenate([self.jj, jj])[-self.max_edges:]
        self.age = np.concatenate(
            [self.age, np.zeros(len(ii), np.int64)])[-self.max_edges:]

    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        idx = np.arange(t0, t1)
        ii, jj = np.meshgrid(idx, idx, indexing="ij")
        m = (np.abs(ii - jj) <= r) & (ii != jj)
        self.add_factors(ii[m], jj[m])

    def add(self, current_idx: int, c2w_all: np.ndarray, pts_all,
            K4=None, valid_count: Optional[int] = None):
        """Covisibility edges for the newest KF. c2w_all (C, 4, 4) host;
        pts_all (C, h, w, 3) device; K4 scaled to (h, w)."""
        n = valid_count if valid_count is not None else current_idx + 1
        cur_c2w = c2w_all[current_idx]
        fwd, rev = self._overlap(current_idx, c2w_all, pts_all, K4)
        dists = np.linalg.norm(c2w_all[:n, :3, 3] - cur_c2w[:3, 3], axis=1)
        near = dists <= self.near_dist
        sel = np.zeros(n, bool)
        sel[near] = fwd[:n][near] > self.overlap_thresh
        far = ~near
        sel[far] = (fwd[:n][far] > self.overlap_thresh) | \
            (rev[:n][far] > self.overlap_thresh)
        sel[current_idx] = False
        jj = np.arange(n)[sel]
        if len(jj):
            ii = np.full_like(jj, current_idx)
            self.add_factors(ii, jj)
            self.add_factors(jj, ii)
        self.age += 1
        return jj

    @staticmethod
    def _overlap(current_idx, c2w_all, pts_all, K4):
        """(fwd, rev) overlap of keyframe ``current_idx`` with every
        keyframe, as host arrays."""
        dev = pts_all.device

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        with full_f32():
            fwd, rev = _overlap_to_all(
                pts_all[current_idx], t(c2w_all), t(K4), pts_all,
                t(np.linalg.inv(c2w_all[current_idx])))
        return fwd.cpu().numpy(), rev.cpu().numpy()

    def detect_loop(self, current_idx: int, temporal_window: int = 8):
        """Covisible keyframes more than ``temporal_window`` away, or
        None."""
        covis = self.jj[self.ii == current_idx]
        cand = np.unique(covis[np.abs(covis - current_idx) > temporal_window])
        return cand if len(cand) else None

    def nms(self, cand: np.ndarray, current_idx: int, c2w_all: np.ndarray,
            pts_all, feat_all, K4, th: float = 0.4) -> Optional[int]:
        """The best-scoring loop candidate if its score exceeds ``th``."""
        fwd, rev = self._overlap(current_idx, c2w_all, pts_all, K4)
        feat_sim = _feat_sim_to_all(feat_all[current_idx],
                                    feat_all).cpu().numpy()
        scores = 0.8 * ((fwd + rev) / 2)[cand] + 0.2 * feat_sim[cand]
        if scores.max() > th:
            return int(cand[int(np.argmax(scores))])
        return None
