"""Patch embedding (port of ``cut3r_slam_tpu/models/patch_embed.py``):
conv patchify of channels-last images into row-major tokens with integer
(y, x) positions. The SLAM path feeds landscape images with H, W
multiples of 16; the training stack's ManyAR portrait branch waits."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["PatchEmbed", "patch_positions"]


def patch_positions(batch: int, nh: int, nw: int, device=None) -> torch.Tensor:
    """(B, nh*nw, 2) integer (y, x) positions, row-major."""
    gy, gx = torch.meshgrid(torch.arange(nh, device=device),
                            torch.arange(nw, device=device), indexing="ij")
    pos = torch.stack([gy, gx], -1).reshape(1, nh * nw, 2)
    return pos.expand(batch, nh * nw, 2)


class PatchEmbed(nn.Module):
    """(B, H, W, C) -> tokens (B, N, D), positions (B, N, 2). Computes in
    ``dtype`` (inputs and weights cast, like a flax Conv with dtype)."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, img: torch.Tensor):
        B, H, W, _ = img.shape
        p = self.patch_size
        dt = self.dtype
        x = F.conv2d(img.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=p)
        tokens = x.flatten(2).transpose(1, 2)
        return tokens, patch_positions(B, H // p, W // p, img.device)
