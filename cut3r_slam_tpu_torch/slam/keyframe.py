"""Fixed-capacity keyframe store (port of ``cut3r_slam_tpu/slam/
keyframe.py``).

Small per-frame metadata (poses, timestamps, intrinsics, images, depths)
lives in host numpy; the bulky per-keyframe tensors the tracking stages
read (encoder tokens, submap pointmaps/confidences, half-res pointmaps)
live on the device in preallocated buffers written in place. With the
mono prior on, each keyframe's prior depth and normal maps are kept on
the host (``prior_depth``, ``prior_normal``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["KeyframeStore", "SUBMAP_SIZE"]

SUBMAP_SIZE = 5  # keyframes per submap


class KeyframeStore:
    """Preallocated keyframe buffers; ``count`` is a host int."""

    def __init__(self, capacity: int, img_hw, feat_tokens: int,
                 feat_dim: int, map_hw=None, device="cpu"):
        H, W = img_hw
        self.capacity = int(capacity)
        self.img_hw = (H, W)
        self.map_hw = tuple(map_hw) if map_hw is not None else (H, W)
        self.count = 0
        self.device = torch.device(device)

        self.tstamp = np.full(capacity, -1, np.int64)
        self.pose = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                            (capacity, 1))  # c2w [t, q xyzw]
        self.intrinsic = np.zeros((capacity, 4), np.float32)
        self.image = np.zeros((capacity, H, W, 3), np.uint8)
        mH, mW = self.map_hw
        self.image_map = np.zeros((capacity, mH, mW, 3), np.uint8)
        self.intrinsic_map = np.zeros((capacity, 4), np.float32)
        self.depth = np.zeros((capacity, H, W), np.float32)

        dev = self.device
        self.featI = torch.zeros(capacity, feat_tokens, feat_dim, device=dev)
        n_submaps = capacity // SUBMAP_SIZE + 1
        self.submap_pts = torch.zeros(n_submaps, SUBMAP_SIZE + 1, H // 2,
                                      W // 2, 3, device=dev)
        self.submap_conf = torch.zeros(n_submaps, SUBMAP_SIZE + 1, H // 2,
                                       W // 2, device=dev)
        self.pts_ds = torch.zeros(capacity, H // 2, W // 2, 3, device=dev)

        # mono-prior maps, host numpy; allocated by ensure_prior_buffers()
        # when the configuration turns the prior on
        self.prior_depth: Optional[np.ndarray] = None
        self.prior_normal: Optional[np.ndarray] = None

    def ensure_prior_buffers(self):
        if self.prior_depth is None:
            H, W = self.img_hw
            self.prior_depth = np.zeros((self.capacity, H, W), np.float32)
            self.prior_normal = np.zeros((self.capacity, H, W, 3),
                                         np.float32)

    def append(self, tstamp: int, image: np.ndarray,
               feat: Optional[torch.Tensor] = None,
               pose: Optional[np.ndarray] = None,
               depth: Optional[np.ndarray] = None,
               intrinsic: Optional[np.ndarray] = None,
               image_map: Optional[np.ndarray] = None,
               intrinsic_map: Optional[np.ndarray] = None) -> int:
        i = self.count
        if i >= self.capacity:
            raise RuntimeError(f"keyframe buffer full ({self.capacity})")
        self.tstamp[i] = tstamp
        self.image[i] = image
        if pose is not None:
            self.pose[i] = pose
        if depth is not None:
            self.depth[i] = depth
        if intrinsic is not None:
            self.intrinsic[i] = intrinsic
        if image_map is not None:
            self.image_map[i] = image_map
        if intrinsic_map is not None:
            self.intrinsic_map[i] = intrinsic_map
        if feat is not None:
            self.featI[i] = feat
        self.count += 1
        return i

    def last_feat(self) -> torch.Tensor:
        return self.featI[self.count - 1]

    def set_submap(self, submap_idx: int, pts: torch.Tensor,
                   conf: torch.Tensor, slot0: int = 0):
        """Write pointmaps/conf for slots [slot0, slot0 + len) of a submap."""
        n = pts.shape[0]
        self.submap_pts[submap_idx, slot0:slot0 + n] = pts
        self.submap_conf[submap_idx, slot0:slot0 + n] = conf

    @property
    def n_submaps(self) -> int:
        return max(0, (self.count + SUBMAP_SIZE - 1) // SUBMAP_SIZE)
