"""Monocular depth / normal prior network (port of
``cut3r_slam_tpu/models/priors.py``): a ViT-S/16 with RoPE (384 wide, 12
blocks, 6 heads) feeding the DPT pyramid of the CUT3R heads, predicting a
positive depth (softplus) or a unit normal per pixel. ``SLAMSystem``
computes it per keyframe when ``motion_filter.use_prior`` is set.

Module names follow the JAX model's (``patch_embed``, ``blocks.<i>``,
``dpt``), so ``models/convert.params_from_jax`` carries its params.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from .blocks import Block
from .heads import DPTAdapter
from .patch_embed import PatchEmbed
from .rope import at_least_f32

__all__ = ["PriorNet", "normalize_imagenet"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] (..., 3) -> ImageNet-normalized f32."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_u8.device)
    return (img_u8.float() / 255.0 - mean) / std


class PriorNet(nn.Module):
    """ViT-S/16 + DPT head: a depth (1 channel) or normal (3) map."""

    def __init__(self, task: str = "depth", embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if task not in ("depth", "normal"):
            raise ValueError(f"unknown task {task!r}")
        self.task, self.depth = task, depth
        self.patch_embed = PatchEmbed(embed_dim, 16, dtype=dtype)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, 4.0, use_rope=True, dtype=dtype)
            for _ in range(depth)])
        self.dpt = DPTAdapter((embed_dim,) * 4,
                              1 if task == "depth" else 3)
        self.to(resolve_device(device))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) ImageNet-normalized, H, W multiples of 16 ->
        depth (B, H, W) or normals (B, H, W, 3)."""
        B, H, W, _ = img.shape
        x, pos = self.patch_embed(img)
        # DPT hooks at the 1/4, 1/2, 3/4 and final depths, clamped so a
        # depth below 4 still fills all four slots (repeats allowed)
        marks = [max(self.depth * k // 4, 1) - 1 for k in (1, 2, 3, 4)]
        hooks = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x, pos)
            for slot, m in enumerate(marks):
                if m == i:
                    hooks[slot] = at_least_f32(x)
        out = self.dpt([hooks[k] for k in range(4)], H, W)
        if self.task == "depth":
            return F.softplus(out[..., 0])
        return out / torch.sqrt((out * out).sum(-1, keepdim=True) + 1e-12)
