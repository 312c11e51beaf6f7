"""Two-view DUSt3R, ``AsymmetricCroCo3DStereo`` (port of
``cut3r_slam_tpu/models/dust3r_pair.py``), the model Spann3R wraps: a
shared ViT encoder with RoPE, two decoders (``dec_blocks`` and
``dec_blocks2``) whose layers each cross-attend to the other branch's
previous output, and per-branch pointmap + confidence heads, linear or
DPT with hooks (encoder, d/2, 3d/4, d). The default widths are those of
``DUSt3R_ViTLarge_BaseDecoder_512`` (1024 x 24 encoder, 768 x 12
decoders).

Module names are the public DUSt3R state-dict names (``patch_embed``,
``enc_blocks.<i>``, ``decoder_embed``, ``dec_blocks2.<i>``,
``downstream_head1.proj`` or ``downstream_head1.dpt.*``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn

from .. import resolve_device
from .blocks import Block, DecoderBlock, LayerNorm, Linear
from .heads import DPTAdapter, reg_dense_conf, reg_dense_depth
from .patch_embed import PatchEmbed
from .rope import at_least_f32

__all__ = ["Dust3rPairConfig", "AsymmetricCroCo3DStereo"]


@dataclasses.dataclass(frozen=True)
class Dust3rPairConfig:
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    patch_size: int = 16
    head: str = "linear"          # "linear" | "dpt"
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "Dust3rPairConfig":
        return Dust3rPairConfig(enc_embed_dim=64, enc_depth=2,
                                enc_num_heads=2, dec_embed_dim=48,
                                dec_depth=4, dec_num_heads=2)

    @property
    def dpt_hooks(self) -> Tuple[int, ...]:
        d = self.dec_depth
        return (0, d * 2 // 4, d * 3 // 4, d)


class _LinearHead(nn.Module):
    """LinearPts3d: the last decoder tokens -> ps^2 x 4 per patch, laid
    out (dy, dx, channel) as the JAX package's head reads them (not the
    channel-major ``pixel_shuffle`` layout of CUT3R's linear head)."""

    def __init__(self, cfg: Dust3rPairConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = nn.Linear(cfg.dec_embed_dim, cfg.patch_size ** 2 * 4)

    def forward(self, hooks, img_h, img_w):
        raw = self.proj(at_least_f32(hooks[-1]))
        B, ps = raw.shape[0], self.patch_size
        raw = raw.reshape(B, img_h // ps, img_w // ps, ps, ps, 4)
        return raw.permute(0, 1, 3, 2, 4, 5).reshape(B, img_h, img_w, 4)


class _DPTHead(nn.Module):
    def __init__(self, cfg: Dust3rPairConfig):
        super().__init__()
        self.hooks = cfg.dpt_hooks
        dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
        self.dpt = DPTAdapter(dims, 4, feature_dim=cfg.dpt_feature_dim,
                              last_dim=cfg.dpt_last_dim,
                              patch_size=cfg.patch_size)

    def forward(self, hooks, img_h, img_w):
        return self.dpt([at_least_f32(hooks[i]) for i in self.hooks],
                        img_h, img_w)


class AsymmetricCroCo3DStereo(nn.Module):
    def __init__(self, cfg: Dust3rPairConfig = Dust3rPairConfig(),
                 device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        if c.head not in ("linear", "dpt"):
            raise ValueError(f"unknown head {c.head!r}")
        self.patch_embed = PatchEmbed(c.enc_embed_dim, c.patch_size,
                                      dtype=dt)
        self.enc_blocks = nn.ModuleList([
            Block(c.enc_embed_dim, c.enc_num_heads, 4.0, True, dtype=dt)
            for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Linear(c.enc_embed_dim, c.dec_embed_dim,
                                    dtype=dt)
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, 4.0, True,
                         dtype=dt) for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, 4.0, True,
                         dtype=dt) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        head = _LinearHead if c.head == "linear" else _DPTHead
        self.downstream_head1 = head(c)
        self.downstream_head2 = head(c)
        self.to(resolve_device(device))

    def encode_image(self, img: torch.Tensor):
        """img (B, H, W, 3) in [-1, 1] -> (tokens (B, N, C), pos)."""
        x, pos = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2) -> Tuple[List, List]:
        """The two decoders, each layer reading the other branch's
        previous output; returns per-layer token lists [encoder, layer 1
        .. layer D] with ``dec_norm`` on the last."""
        h1, h2 = [f1], [f2]
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, pos1, pos2)[0], blk2(x2, x1, pos2, pos1)[0]
            h1.append(x1)
            h2.append(x2)
        h1[-1], h2[-1] = self.dec_norm(h1[-1]), self.dec_norm(h2[-1])
        return h1, h2

    def head(self, num: int, hooks: List, img_h: int, img_w: int):
        hd = self.downstream_head1 if num == 1 else self.downstream_head2
        raw = hd(hooks, img_h, img_w)
        return {"pts3d": reg_dense_depth(raw[..., :3]),
                "conf": reg_dense_conf(raw[..., 3])}

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        """Two views -> (view 1's pointmap in its frame, view 2's in view
        1's frame), each {pts3d (B, H, W, 3), conf (B, H, W)}."""
        H, W = img1.shape[1:3]
        f1, pos1 = self.encode_image(img1)
        f2, pos2 = self.encode_image(img2)
        h1, h2 = self.decode(f1, pos1, f2, pos2)
        return self.head(1, h1, H, W), self.head(2, h2, H, W)
