"""Keyframe selection by encoder-feature overlap (port of
``cut3r_slam_tpu/slam/motion_filter.py``): always keep frame 0 and the
last two frames; either a fixed ``kf_every`` interval, or every ``skip``
frames encode the image with the CUT3R ViT encoder and take it when the
patch-feature overlap with the previous keyframe drops below ``thresh``.
With a mono prior (``prior = (depth_fn, normal_fn)``, each taking the
(H, W, 3) uint8 image), every keyframe's prior maps are computed here and
stored in the keyframe store's prior buffers (``store_priors``, which
DROID's filter shares).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import CUT3R, normalize_images
from ..utils.profiling import count, span
from .keyframe import KeyframeStore

__all__ = ["MotionFilter", "patch_overlap_ratio", "store_priors"]


def patch_overlap_ratio(feat0: torch.Tensor, feat1: torch.Tensor,
                        threshold: float = 0.7) -> torch.Tensor:
    """feat*: (N, D) encoder tokens; skips token 0 like the reference."""
    f0, f1 = feat0[1:], feat1[1:]
    f0 = f0 / torch.clamp(torch.linalg.norm(f0, dim=1, keepdim=True),
                          min=1e-12)
    f1 = f1 / torch.clamp(torch.linalg.norm(f1, dim=1, keepdim=True),
                          min=1e-12)
    max_sim = (f0 @ f1.T).max(1).values
    return (max_sim > threshold).float().mean()


class MotionFilter:
    def __init__(self, model: CUT3R, keyframes: KeyframeStore,
                 thresh: float = 0.9, skip: int = 5, kf_every: int = 0,
                 prior=None):
        self.model = model
        self.keyframes = keyframes
        self.thresh = float(thresh)
        self.skip = int(skip)
        self.kf_every = int(kf_every)
        self.prior = prior
        if prior is not None:
            keyframes.ensure_prior_buffers()

    @torch.inference_mode()
    def encode(self, image_u8: np.ndarray) -> torch.Tensor:
        x = normalize_images(torch.as_tensor(np.asarray(image_u8),
                                             device=self.model.device))[None]
        feat, _ = self.model.encode_image(x)
        return feat[0]

    def __call__(self, tstamp: int, image_u8: np.ndarray,
                 intrinsic: Optional[np.ndarray] = None,
                 pose: Optional[np.ndarray] = None,
                 depth: Optional[np.ndarray] = None,
                 second_last: bool = False, last: bool = False,
                 image_map: Optional[np.ndarray] = None,
                 intrinsic_map: Optional[np.ndarray] = None) -> bool:
        """Run on every frame; returns True if a keyframe was added."""
        kf = self.keyframes
        take = kf.count == 0 or last or second_last
        feat = None
        if take:
            feat = self.encode(image_u8)
        elif self.kf_every > 0:
            if tstamp % self.kf_every == 0:
                feat = self.encode(image_u8)
                take = True
        elif tstamp % self.skip == 0:
            feat = self.encode(image_u8)
            ratio = float(patch_overlap_ratio(kf.last_feat(), feat))
            take = ratio < self.thresh
        if take:
            i = kf.append(tstamp, image_u8, feat, pose, depth, intrinsic,
                          image_map, intrinsic_map)
            if self.prior is not None:
                store_priors(kf, self.prior, i, image_u8)
        return take


@torch.no_grad()
def store_priors(keyframes: KeyframeStore, prior, idx: int,
                 image_u8: np.ndarray):
    """Keyframe ``idx``'s prior maps (``prior = (depth_fn, normal_fn)`` on
    its (H, W, 3) uint8 image) into the store's buffers on its device, with
    no host wait. Spans ``prior.depth`` and ``prior.normal`` (one map,
    its network and resizes), ``prior.store`` (the writes); counter
    ``prior.keyframes``."""
    depth_fn, normal_fn = prior
    with span("prior.depth"):
        depth = depth_fn(image_u8)
    with span("prior.normal"):
        normal = normal_fn(image_u8)
    with span("prior.store"):
        keyframes.prior_depth[idx] = depth
        keyframes.prior_normal[idx] = normal
    count("prior.keyframes")
