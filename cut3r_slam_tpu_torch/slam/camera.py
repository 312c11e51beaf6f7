"""Fixed-capacity camera (viewpoint) buffer for the mapping backend (port of
``cut3r_slam_tpu/slam/camera.py``): w2c poses, uint8 images, bf16 depths
and per-view affine exposures, all in capacity-C tensors."""
from __future__ import annotations

import dataclasses

import torch

from ..geometry.lie import se3_exp, se3_matrix

__all__ = ["CameraBuffer", "se3_delta_to_matrix"]


def se3_delta_to_matrix(trans_delta: torch.Tensor,
                        rot_delta: torch.Tensor) -> torch.Tensor:
    """SE3_exp([trans, rot]) as (..., 4, 4) (tau-first order)."""
    return se3_matrix(se3_exp(torch.cat([trans_delta, rot_delta], -1)))


@dataclasses.dataclass
class CameraBuffer:
    """Capacity-C viewpoint tensors. Images uint8, depth bf16."""
    w2c: torch.Tensor         # (C, 4, 4)
    image: torch.Tensor       # (C, H, W, 3) uint8
    depth: torch.Tensor       # (C, H, W) bfloat16
    exposure_a: torch.Tensor  # (C, 3, 3)
    exposure_b: torch.Tensor  # (C, 3)
    valid: torch.Tensor       # (C,) bool

    @staticmethod
    def empty(capacity: int, h: int, w: int, device) -> "CameraBuffer":
        return CameraBuffer(
            w2c=torch.eye(4, device=device).repeat(capacity, 1, 1),
            image=torch.zeros(capacity, h, w, 3, dtype=torch.uint8,
                              device=device),
            depth=torch.zeros(capacity, h, w, dtype=torch.bfloat16,
                              device=device),
            exposure_a=torch.eye(3, device=device).repeat(capacity, 1, 1),
            exposure_b=torch.zeros(capacity, 3, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device))

    def add(self, idx: int, image_u8, depth, w2c):
        """In-place write of one viewpoint."""
        self.w2c[idx] = w2c
        self.image[idx] = image_u8
        self.depth[idx] = depth.to(torch.bfloat16)
        self.valid[idx] = True
