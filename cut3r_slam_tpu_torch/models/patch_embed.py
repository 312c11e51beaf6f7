"""Patch embedding (port of ``cut3r_slam_tpu/models/patch_embed.py``):
conv patchify of channels-last images into row-major tokens with integer
(y, x) positions.

The SLAM path feeds landscape images with H, W multiples of 16 and no
``portrait_mask``. The training stack's multi-aspect batches store
portrait images TRANSPOSED in the landscape container, with
``true_shape`` recording the real orientation (ManyAR): both
orientations are patchified at the same static shape and selected per
sample, as in the JAX package."""
from __future__ import annotations

from typing import Optional

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

    def _tokens(self, x_nchw: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(x_nchw.to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)

    def forward(self, img: torch.Tensor,
                portrait_mask: Optional[torch.Tensor] = None):
        """img (B, H, W, C) landscape container; portrait_mask (B,) bool:
        True rows hold a transposed portrait image whose tokens and
        positions follow the (W, H) grid."""
        B, H, W, _ = img.shape
        p = self.patch_size
        x = img.permute(0, 3, 1, 2)
        tokens = self._tokens(x)
        pos = patch_positions(B, H // p, W // p, img.device)
        if portrait_mask is not None and H != W:
            m = portrait_mask.reshape(B, 1, 1)
            tokens = torch.where(m, self._tokens(x.transpose(2, 3)), tokens)
            pos = torch.where(m, patch_positions(B, W // p, H // p,
                                                 img.device), pos)
        return tokens, pos
