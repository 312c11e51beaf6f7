"""Spann3R: two-view DUSt3R with a spatial memory (port of
``cut3r_slam_tpu/models/spann3r.py``). Module names are the upstream
``hislam2/modules/spann3r.py`` state-dict names, so a checkpoint loads
strictly through ``models/convert.load_spann3r_checkpoint``:

  dust3r.*              the two-view ``AsymmetricCroCo3DStereo``
  value_encoder.0-5     Blocks encoding predicted pointmaps into values
  value_norm/value_out
  pos_patch_embed       patch embedding of the predicted pts3d
  norm_q/norm_k/norm_v  LayerNorms of the memory queries, keys, values
  attn_head_1/2         (Linear, GELU, Linear) key heads over
                        [encoder features ; last decoder tokens]

The memory is the JAX package's fixed-size design: a working ring of
``work_mem_frames`` frames and a long-term arena of ``long_mem_tokens``
tokens. ``memory_read`` is softmax attention over both, the weights below
``attn_thresh`` cut and the rest renormalized, plus the query (residual);
each long-term slot accumulates the attention it receives. ``memory_write``
pushes a frame into the ring; the frame it displaces moves into the
arena's lowest-scoring slots (invalid slots first, ties in slot order: a
stable sort, as ``jnp.argsort``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from .. import resolve_device
from .blocks import Block, LayerNorm
from .dust3r_pair import AsymmetricCroCo3DStereo, Dust3rPairConfig
from .patch_embed import PatchEmbed

__all__ = ["Spann3RConfig", "Spann3R", "MemoryState"]


@dataclasses.dataclass(frozen=True)
class Spann3RConfig:
    dust3r: Dust3rPairConfig = Dust3rPairConfig()
    value_depth: int = 6
    value_num_heads: int = 16
    work_mem_frames: int = 5
    long_mem_tokens: int = 4000
    attn_thresh: float = 5e-4
    dtype: torch.dtype = torch.float32

    @property
    def enc_dim(self):
        return self.dust3r.enc_embed_dim

    @property
    def dec_dim(self):
        return self.dust3r.dec_embed_dim

    @staticmethod
    def tiny() -> "Spann3RConfig":
        return Spann3RConfig(dust3r=Dust3rPairConfig.tiny(),
                             value_depth=2, value_num_heads=2,
                             work_mem_frames=2, long_mem_tokens=64)


@dataclasses.dataclass
class MemoryState:
    work_k: torch.Tensor      # (B, W, P, C)
    work_v: torch.Tensor
    work_valid: torch.Tensor  # (B, W) bool
    work_head: torch.Tensor   # (B,) frames written so far (ring pointer)
    long_k: torch.Tensor      # (B, L, C)
    long_v: torch.Tensor
    long_valid: torch.Tensor  # (B, L) bool
    long_attn: torch.Tensor   # (B, L) accumulated attention (the score)


def _key_head(d_in: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_in), nn.GELU(),
                         nn.Linear(d_in, d_out))


class Spann3R(nn.Module):
    def __init__(self, cfg: Spann3RConfig = Spann3RConfig(), device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.dust3r = AsymmetricCroCo3DStereo(c.dust3r, device="cpu")
        self.value_encoder = nn.ModuleList([
            Block(c.enc_dim, c.value_num_heads, 4.0, True, dtype=c.dtype)
            for _ in range(c.value_depth)])
        self.value_norm = LayerNorm(c.enc_dim)
        self.value_out = nn.Linear(c.enc_dim, c.enc_dim)
        self.pos_patch_embed = PatchEmbed(c.enc_dim, c.dust3r.patch_size,
                                          dtype=c.dtype)
        self.norm_q = LayerNorm(c.enc_dim)
        self.norm_k = LayerNorm(c.enc_dim)
        self.norm_v = LayerNorm(c.enc_dim)
        self.attn_head_1 = _key_head(c.enc_dim + c.dec_dim, c.enc_dim)
        self.attn_head_2 = _key_head(c.enc_dim + c.dec_dim, c.enc_dim)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.value_out.weight.device

    def encode_feat_key(self, feat, dec_last, num: int):
        """A memory key from [encoder features ; last decoder tokens]."""
        head = self.attn_head_1 if num == 1 else self.attn_head_2
        return head(torch.cat([feat, dec_last.to(feat.dtype)], -1))

    def encode_value(self, pts3d):
        """A memory value: the predicted pointmap, patch-embedded and run
        through the value encoder."""
        x, pos = self.pos_patch_embed(pts3d)
        for blk in self.value_encoder:
            x = blk(x, pos)
        return self.value_out(self.value_norm(x))

    def init_memory(self, batch: int, n_patches: int) -> MemoryState:
        c, dev = self.cfg, self.device
        C, W, L = c.enc_dim, c.work_mem_frames, c.long_mem_tokens

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return MemoryState(
            work_k=z(batch, W, n_patches, C), work_v=z(batch, W, n_patches, C),
            work_valid=z(batch, W, dtype=torch.bool),
            work_head=z(batch, dtype=torch.int64),
            long_k=z(batch, L, C), long_v=z(batch, L, C),
            long_valid=z(batch, L, dtype=torch.bool), long_attn=z(batch, L))

    def memory_read(self, q: torch.Tensor, mem: MemoryState):
        """Attention of the queries q (B, P, C) over [ring ; arena] with
        the ``attn_thresh`` cut and renormalization, plus q. Returns
        (read (B, P, C), attention received by each arena slot (B, L))."""
        B, P, C = q.shape
        wk = mem.work_k.reshape(B, -1, C)
        wv = mem.work_v.reshape(B, -1, C)
        wmask = mem.work_valid.repeat_interleave(mem.work_k.shape[2], 1)
        k = torch.cat([wk, mem.long_k], 1)
        v = torch.cat([wv, mem.long_v], 1)
        mask = torch.cat([wmask, mem.long_valid], 1)[:, None, :]
        logits = (self.norm_q(q) @ self.norm_k(k).transpose(1, 2)) \
            * (C ** -0.5)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, -1) * mask
        if self.cfg.attn_thresh > 0:
            attn = torch.where(attn < self.cfg.attn_thresh,
                               torch.zeros_like(attn), attn)
            attn = attn / torch.clamp(attn.sum(-1, keepdim=True), min=1e-12)
        out = attn @ self.norm_v(v) + q
        return out, attn[..., wk.shape[1]:].sum(1)

    def memory_write(self, mem: MemoryState, k_new, v_new) -> MemoryState:
        """Push a frame's keys / values (B, P, C) into the ring; the frame
        it displaces, if valid, takes the arena's P lowest-scoring slots
        (invalid slots first), whose scores restart at 0."""
        B, P, C = k_new.shape
        W = self.cfg.work_mem_frames
        b = torch.arange(B, device=k_new.device)
        head = mem.work_head % W
        dk, dv = mem.work_k[b, head], mem.work_v[b, head]
        dval = mem.work_valid[b, head]
        work_k, work_v = mem.work_k.clone(), mem.work_v.clone()
        work_valid = mem.work_valid.clone()
        work_k[b, head], work_v[b, head] = k_new, v_new
        work_valid[b, head] = True

        score = torch.where(mem.long_valid, mem.long_attn,
                            torch.full_like(mem.long_attn, float("-inf")))
        order = torch.argsort(score, dim=-1, stable=True)[:, :P]  # (B, P)
        put = dval[:, None].expand(B, P)
        idx = order[..., None].expand(B, P, C)
        long_k = mem.long_k.scatter(1, idx, torch.where(
            put[..., None], dk, mem.long_k.gather(1, idx)))
        long_v = mem.long_v.scatter(1, idx, torch.where(
            put[..., None], dv, mem.long_v.gather(1, idx)))
        write = torch.zeros_like(mem.long_valid).scatter(1, order, put)
        return MemoryState(
            work_k=work_k, work_v=work_v, work_valid=work_valid,
            work_head=mem.work_head + 1, long_k=long_k, long_v=long_v,
            long_valid=mem.long_valid | write,
            long_attn=torch.where(write, torch.zeros_like(mem.long_attn),
                                  mem.long_attn))

    def forward_pair(self, img0: torch.Tensor, img1: torch.Tensor):
        """A plain two-view DUSt3R pass."""
        return self.dust3r(img0, img1)

    def step(self, carry: Optional[tuple], img1: torch.Tensor):
        """One recurrent frame: the memory read fuses the previous frame's
        query, the pair decodes, the previous frame's key and value enter
        the memory. carry: None for the first frame, else (feat0, pos0,
        Q0, mem). Returns ((feat1, pos1, Q1, mem'), (pred0, pred1))."""
        H, W = img1.shape[1:3]
        d = self.dust3r
        feat1, pos1 = d.encode_image(img1)
        if carry is None:
            mem = self.init_memory(feat1.shape[0], feat1.shape[1])
            feat0, pos0, Q0 = feat1, pos1, None
        else:
            feat0, pos0, Q0, mem = carry
        if Q0 is None:
            G0 = feat0
        else:
            G0, long_attn = self.memory_read(Q0, mem)
            mem = dataclasses.replace(mem,
                                      long_attn=mem.long_attn + long_attn)
        h0, h1 = d.decode(G0, pos0, feat1, pos1)
        pred0, pred1 = d.head(1, h0, H, W), d.head(2, h1, H, W)
        Q1 = self.encode_feat_key(feat1, h1[-1], 2)
        K0 = self.encode_feat_key(feat0, h0[-1], 1)
        V0 = self.encode_value(pred0["pts3d"]) + K0
        return (feat1, pos1, Q1, self.memory_write(mem, K0, V0)), \
            (pred0, pred1)

    def forward(self, imgs: torch.Tensor):
        """imgs (V, B, H, W, 3) in [-1, 1]: the recurrence over frames.
        Returns (each step's leading-view prediction, the final memory)."""
        carry, preds = None, []
        for v in range(imgs.shape[0]):
            carry, (p0, _) = self.step(carry, imgs[v])
            preds.append(p0)
        return preds, carry[3]
