"""CroCo cross-view completion pretraining and the binocular stereo / flow
downstream model (port of ``cut3r_slam_tpu/models/croco_pretrain.py``).

Pretraining masks ``mask_ratio`` of view 1's patches, encodes the visible
ones and the whole of view 2, runs the joint decoder and regresses each
patch's pixels (per-patch normalized targets). The visible count is
static, ``n_vis = round(N (1 - mask_ratio))``; the visible token slots
come from the caller (``vis_idx``) or are drawn from a
``torch.Generator``: the JAX model draws them with
``jax.random.permutation``, which the port does not reproduce, so the
parity tests inject JAX's slots.

Module names follow the JAX model's, which follow the torch CroCo
(``patch_embed``, ``enc_blocks.<i>``, ``decoder_embed``, ``mask_token``,
``dec_blocks.<i>``, ``prediction_head``), so
``models/convert.params_from_jax`` carries its params.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from .blocks import Block, DecoderBlock, LayerNorm, Linear
from .patch_embed import PatchEmbed
from .rope import at_least_f32

__all__ = ["CroCoConfig", "CroCoPretrain", "croco_pretrain_loss",
           "CroCoDownstreamBinocular", "laplacian_nll", "patchify",
           "unpatchify"]


@dataclasses.dataclass(frozen=True)
class CroCoConfig:
    enc_embed_dim: int = 768
    enc_depth: int = 12
    enc_num_heads: int = 12
    dec_embed_dim: int = 512
    dec_depth: int = 8
    dec_num_heads: int = 16
    patch_size: int = 16
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    mask_ratio: float = 0.9
    norm_pix_loss: bool = True       # per-patch normalized targets
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "CroCoConfig":
        return CroCoConfig(enc_embed_dim=32, enc_depth=2, enc_num_heads=2,
                           dec_embed_dim=32, dec_depth=2, dec_num_heads=2,
                           mask_ratio=0.75)


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, p*p*3), channels last within a patch."""
    B, H, W, C = imgs.shape
    x = imgs.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x: torch.Tensor, hw: Tuple[int, int], p: int,
               channels: int = 3) -> torch.Tensor:
    """(B, N, p*p*c) -> (B, H, W, c)."""
    H, W = hw
    x = x.reshape(x.shape[0], H // p, W // p, p, p, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(x.shape[0], H, W, channels)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) at token slots idx (B, n)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class CroCoPretrain(nn.Module):
    """``pretrain_head=False`` leaves out the pixel ``prediction_head``
    (the downstream model's backbone, as the JAX one never creates it)."""

    def __init__(self, cfg: CroCoConfig = CroCoConfig(), device="cuda",
                 pretrain_head: bool = True):
        super().__init__()
        self.cfg = c = cfg
        dt = c.compute_dtype
        self.patch_embed = PatchEmbed(c.enc_embed_dim, c.patch_size,
                                      dtype=dt)
        self.enc_blocks = nn.ModuleList([
            Block(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, True,
                  c.rope_base, dt) for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Linear(c.enc_embed_dim, c.dec_embed_dim,
                                    dtype=dt)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, c.dec_embed_dim))
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, True,
                         c.rope_base, dt) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        if pretrain_head:
            self.prediction_head = nn.Linear(c.dec_embed_dim,
                                             c.patch_size ** 2 * 3)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.mask_token.device

    def n_visible(self, n_tokens: int) -> int:
        return max(1, int(round(n_tokens * (1.0 - self.cfg.mask_ratio))))

    def draw_visible(self, batch: int, n_tokens: int,
                     generator: torch.Generator) -> torch.Tensor:
        """(B, n_vis) visible token slots: the first ``n_vis`` of a random
        permutation per sample, drawn from ``generator``."""
        n = self.n_visible(n_tokens)
        keys = torch.rand(batch, n_tokens, generator=generator,
                          device=generator.device)
        return keys.argsort(-1)[:, :n].to(self.device)

    def encode_visible(self, img: torch.Tensor,
                       vis_idx: Optional[torch.Tensor] = None):
        """Encode the tokens at ``vis_idx`` (B, n_vis), or all of them when
        it is None. Returns (features (B, n, D), positions (B, N, 2),
        mask (B, N), True = masked)."""
        x, pos = self.patch_embed(img)
        B, N, _ = x.shape
        mask = torch.zeros(B, N, dtype=torch.bool, device=x.device)
        if vis_idx is not None:
            mask = torch.ones_like(mask).scatter_(1, vis_idx, False)
            x, p = _take(x, vis_idx), _take(pos, vis_idx)
        else:
            p = pos
        for blk in self.enc_blocks:
            x = blk(x, p)
        return self.enc_norm(x), pos, mask

    def _decoder(self, d1, d2, pos1, pos2):
        for blk in self.dec_blocks:
            d1, d2 = blk(d1, d2, pos1, pos2)
        return self.dec_norm(d1)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                vis_idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Masked view 1 and whole view 2, (B, H, W, 3) in [-1, 1]. The
        visible slots are ``vis_idx``, else drawn from ``generator``, else
        every slot is visible. Returns (pred (B, N, p^2 3), mask (B, N),
        target (B, N, p^2 3))."""
        c = self.cfg
        B, H, W, _ = img1.shape
        N = (H // c.patch_size) * (W // c.patch_size)
        if vis_idx is None and generator is not None:
            vis_idx = self.draw_visible(B, N, generator)
        f1v, pos1, mask = self.encode_visible(img1, vis_idx)
        f2, pos2, _ = self.encode_visible(img2)
        d1v, d2 = self.decoder_embed(f1v), self.decoder_embed(f2)
        if vis_idx is None:
            d1 = d1v
        else:
            d1 = self.mask_token.to(d1v.dtype).expand(B, N, -1).scatter(
                1, vis_idx[..., None].expand(-1, -1, d1v.shape[-1]), d1v)
        out = self._decoder(d1, d2, pos1, pos2)
        pred = self.prediction_head(at_least_f32(out))
        target = patchify(img1, c.patch_size)
        if c.norm_pix_loss:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, unbiased=False, keepdim=True)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        return pred, mask, target


def croco_pretrain_loss(pred, mask, target):
    """Mean squared error over the masked patches."""
    err = (pred - target).square().mean(-1)
    m = mask.to(err.dtype)
    return (err * m).sum() / torch.clamp(m.sum(), min=1.0)


class CroCoDownstreamBinocular(nn.Module):
    """Binocular downstream: both views encoded whole, the joint decoder,
    a per-patch linear head; ``num_channels`` 1 = stereo disparity, 2 =
    optical flow, with a softplus confidence when ``with_conf``."""

    def __init__(self, cfg: CroCoConfig = CroCoConfig(), num_channels: int = 2,
                 with_conf: bool = True, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.num_channels, self.with_conf = num_channels, with_conf
        self.croco = CroCoPretrain(cfg, device="cpu", pretrain_head=False)
        out_ch = num_channels + (1 if with_conf else 0)
        self.head = nn.Linear(cfg.dec_embed_dim, cfg.patch_size ** 2 * out_ch)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        H, W = img1.shape[1:3]
        cr = self.croco
        f1, pos1, _ = cr.encode_visible(img1)
        f2, pos2, _ = cr.encode_visible(img2)
        out = cr._decoder(cr.decoder_embed(f1), cr.decoder_embed(f2),
                          pos1, pos2)
        out_ch = self.num_channels + (1 if self.with_conf else 0)
        maps = unpatchify(self.head(at_least_f32(out)), (H, W),
                          self.cfg.patch_size, out_ch)
        pred = maps[..., :self.num_channels]
        if self.with_conf:
            return pred, F.softplus(maps[..., -1])
        return pred, None


def laplacian_nll(pred, gt, conf, valid=None):
    """Laplacian negative log-likelihood |e| / s + log s, s = conf clamped
    at 1e-3; the mean over ``valid`` pixels (all when None)."""
    err = (pred - gt).abs().sum(-1)
    s = torch.clamp(conf, min=1e-3)
    nll = err / s + torch.log(s)
    if valid is None:
        return nll.mean()
    v = torch.as_tensor(valid, device=nll.device).to(nll.dtype)
    return (nll * v).sum() / torch.clamp(v.sum(), min=1.0)
