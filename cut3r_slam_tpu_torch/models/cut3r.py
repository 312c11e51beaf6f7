"""CUT3R — recurrent multi-view pointmap transformer, PyTorch (port of
``cut3r_slam_tpu/models/cut3r.py``): the image and ray-map encoders,
``init_state``, ``LocalMemory``, ``decode_step`` with its update / reset
gating, the full ``forward`` over a view sequence (ManyAR ``true_shape``
included), ``forward_chunk`` / ``decode_views`` with an explicit carry
(the truncated-BPTT path of training) and the ray-map ``inference_step``.

Default config = the live checkpoint ``cut3r_512_dpt_4_64.pth`` (ViT-L/16
encoder 1024 x 24, decoder 768 x 12, 768 register tokens, LocalMemory 256,
a 2-block ray-map encoder, RoPE base 100, DPT self / cross / rgb / pose
heads); ``head_type="linear"`` builds the 224 checkpoints' linear head
(``heads.LinearPts3dPose``) in their place. Module and parameter names
follow the upstream ``ARCroco3DStereo`` state_dict so its public
checkpoint loads into this model;
``models/convert.params_from_jax`` maps the JAX model's flax params into
the same names. The decoder runs the plain per-layer interleave of the
state and image streams (the JAX ``fused_decoder`` is a TPU restructuring
of the same math) as a Python loop over views (the JAX ``nn.scan``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .. import resolve_device
from .blocks import Block, DecoderBlock, LayerNorm, Linear, init_random
from .heads import DPTPts3dPose, LinearPts3dPose
from .patch_embed import PatchEmbed
from .rope import at_least_f32

__all__ = ["CUT3RConfig", "CUT3R", "LocalMemory", "normalize_images",
           "HEAD_OUTPUTS"]

# every head of the DPT model; the SLAM tracking path asks for
# ("self", "pose") only
HEAD_OUTPUTS = ("self", "cross", "rgb", "pose")
# parameters added after the tracking slice; ``init_random`` draws them
# after all others so a seed gives the tracking modules the same tensors
# as before they existed
_LATE_PARAMS = ("masked_img_token", "masked_ray_map_token",
                "patch_embed_ray_map.", "enc_blocks_ray_map.",
                "enc_norm_ray_map.", "downstream_head.final_transform.",
                "downstream_head.dpt_cross.", "downstream_head.dpt_rgb.",
                "downstream_head.cross_proj.", "downstream_head.rgb_proj.")


@dataclasses.dataclass(frozen=True)
class CUT3RConfig:
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    state_size: int = 768
    state_dec_num_heads: int = 16
    local_mem_size: int = 256
    ray_enc_depth: int = 2
    patch_size: int = 16
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    has_rgb: bool = True
    head_type: str = "dpt"
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.head_type not in ("dpt", "linear"):
            raise ValueError(f"unknown head_type {self.head_type!r}")

    @staticmethod
    def tiny() -> "CUT3RConfig":
        """A CPU-testable miniature with identical topology (f32)."""
        return CUT3RConfig(
            enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
            state_size=16, state_dec_num_heads=2, local_mem_size=8,
            compute_dtype=torch.float32)


def normalize_images(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] HWC -> [-1, 1]."""
    return (img_u8.float() / 255.0 - 0.5) / 0.5


def _state_positions(state_size: int, batch: int, device) -> torch.Tensor:
    """2D positions of the register tokens (state_pe='2d')."""
    width = int(state_size ** 0.5)
    width = width + 1 if width % 2 == 1 else width
    idx = torch.arange(state_size, device=device)
    pos = torch.stack([torch.div(idx, width, rounding_mode="floor"),
                       idx % width], -1)[None]
    return pos.expand(batch, state_size, 2)


def _gate(mask: Optional[torch.Tensor], new, old):
    """new where ``mask`` (B,) is set, old elsewhere, as the JAX model's
    ``new * m + old * (1 - m)``; ``None`` keeps ``new``."""
    if mask is None:
        return new
    m = mask.to(torch.float32)[:, None, None]
    return new * m + old * (1 - m)


class LocalMemory(nn.Module):
    """Pose KV memory."""

    def __init__(self, size, k_dim, v_dim, num_heads, depth=2,
                 dtype=torch.float32):
        super().__init__()
        self.size, self.v_dim = size, v_dim
        self.proj_q = Linear(k_dim, v_dim, dtype=dtype)
        self.masked_token = nn.Parameter(torch.zeros(1, 1, v_dim))
        self.mem = nn.Parameter(torch.zeros(1, size, 2 * v_dim))
        self.write_blocks = nn.ModuleList([
            DecoderBlock(2 * v_dim, num_heads, dtype=dtype)
            for _ in range(depth)])
        self.read_blocks = nn.ModuleList([
            DecoderBlock(2 * v_dim, num_heads, dtype=dtype)
            for _ in range(depth)])

    def initial_mem(self, batch: int) -> torch.Tensor:
        return self.mem.expand(batch, self.size, 2 * self.v_dim)

    def update_mem(self, mem, feat_k, feat_v):
        feat = torch.cat([self.proj_q(feat_k), feat_v], -1)
        for blk in self.write_blocks:
            mem, _ = blk(mem, feat, None, None)
        return mem

    def inquire(self, query, mem):
        x = self.proj_q(query)
        x = torch.cat([x, self.masked_token.expand(x.shape[0], 1,
                                                   self.v_dim)], -1)
        for blk in self.read_blocks:
            x, _ = blk(x, mem, None, None)
        return x[..., -self.v_dim:]


class CUT3R(nn.Module):
    def __init__(self, cfg: CUT3RConfig = CUT3RConfig(), device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        dt = c.compute_dtype
        self.patch_embed = PatchEmbed(c.enc_embed_dim, c.patch_size, dtype=dt)
        self.enc_blocks = nn.ModuleList([
            Block(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, True,
                  c.rope_base, dt) for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Linear(c.enc_embed_dim, c.dec_embed_dim, dtype=dt)
        self.decoder_embed_state = Linear(c.enc_embed_dim, c.dec_embed_dim,
                                          dtype=dt)
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, True,
                         c.rope_base, dt) for _ in range(c.dec_depth)])
        self.dec_blocks_state = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.state_dec_num_heads, c.mlp_ratio,
                         True, c.rope_base, dt) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        self.dec_norm_state = LayerNorm(c.dec_embed_dim)
        self.register_tokens = nn.Embedding(c.state_size, c.enc_embed_dim)
        self.pose_token = nn.Parameter(torch.zeros(1, 1, c.dec_embed_dim))
        self.pose_retriever = LocalMemory(c.local_mem_size, c.enc_embed_dim,
                                          c.dec_embed_dim, c.dec_num_heads,
                                          dtype=dt)
        if c.head_type == "linear":
            self.downstream_head = LinearPts3dPose(
                c.dec_embed_dim, c.dec_num_heads, c.patch_size,
                has_rgb=c.has_rgb, rope_base=c.rope_base)
        else:
            self.downstream_head = DPTPts3dPose(
                c.enc_embed_dim, c.dec_embed_dim, c.dec_num_heads,
                has_rgb=c.has_rgb, rope_base=c.rope_base)
        # the ray-map encoder: its blocks have 16 heads at every width
        self.patch_embed_ray_map = PatchEmbed(c.enc_embed_dim, c.patch_size,
                                              in_chans=6, dtype=dt)
        self.enc_blocks_ray_map = nn.ModuleList([
            Block(c.enc_embed_dim, 16, 4.0, True, c.rope_base, dt)
            for _ in range(c.ray_enc_depth)])
        self.enc_norm_ray_map = LayerNorm(c.enc_embed_dim)
        self.masked_img_token = nn.Parameter(torch.zeros(1, c.enc_embed_dim))
        self.masked_ray_map_token = nn.Parameter(
            torch.zeros(1, c.enc_embed_dim))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.pose_token.device

    def init_random(self, generator: torch.Generator, std: float = 0.02):
        """Random weights from ``generator`` (``blocks.init_random``), the
        parameters under ``_LATE_PARAMS`` drawn last."""
        return init_random(self, generator, std, late=_LATE_PARAMS)

    # ------------------------------------------------------------------
    # encoders
    # ------------------------------------------------------------------
    def encode_image(self, img: torch.Tensor,
                     portrait_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img (B, H, W, 3) normalized to [-1, 1] -> tokens (B, N, D) f32,
        positions (B, N, 2). portrait_mask (B,) bool: ManyAR rows."""
        x, pos = self.patch_embed(img, portrait_mask)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def encode_ray_map(self, ray_map: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ray_map (B, H, W, 6) -> tokens (B, N, D) f32, positions."""
        x, pos = self.patch_embed_ray_map(ray_map)
        for blk in self.enc_blocks_ray_map:
            x = blk(x, pos)
        return self.enc_norm_ray_map(x), pos

    # ------------------------------------------------------------------
    # state and one recurrent decoder step
    # ------------------------------------------------------------------
    def init_state(self, batch: int):
        """(state_feat (B, S, dec) f32, state_pos (B, S, 2), mem f32)."""
        c = self.cfg
        reg = self.register_tokens.weight
        state_feat = self.decoder_embed_state(
            reg[None].expand(batch, c.state_size, c.enc_embed_dim))
        return (at_least_f32(state_feat),
                _state_positions(c.state_size, batch, self.device),
                at_least_f32(self.pose_retriever.initial_mem(batch)))

    def decode_step(self, state_feat, state_pos, mem, feat_i, pos_i,
                    is_first: bool, init_state_feat=None, init_mem=None,
                    update: Optional[torch.Tensor] = None,
                    reset: Optional[torch.Tensor] = None):
        """One view through the interleaved decoder. feat_i (B, N, enc).
        update / reset: (B,) masks: where ``update`` is off the carry keeps
        its old value, where ``reset`` is on it returns to the initial
        state (``init_state_feat``, ``init_mem``).
        Returns (state_feat', mem', hook_list)."""
        c = self.cfg
        B = feat_i.shape[0]
        global_feat = feat_i.mean(1, keepdim=True)
        if is_first:
            pose_feat = self.pose_token.expand(B, 1, c.dec_embed_dim)
        else:
            pose_feat = self.pose_retriever.inquire(global_feat, mem)
        pose_pos = -torch.ones(B, 1, 2, dtype=pos_i.dtype, device=pos_i.device)
        f_img = self.decoder_embed(feat_i)
        f_img = torch.cat([pose_feat.to(f_img.dtype), f_img], 1)
        pos_img = torch.cat([pose_pos, pos_i], 1)

        hooks = {0: at_least_f32(feat_i)}
        f_state = state_feat
        for layer, (blk_state, blk_img) in enumerate(
                zip(self.dec_blocks_state, self.dec_blocks), start=1):
            f_state_new, _ = blk_state(f_state, f_img, state_pos, pos_img)
            f_img_new, _ = blk_img(f_img, f_state, pos_img, state_pos)
            f_state, f_img = f_state_new, f_img_new
            if layer in (c.dec_depth * 2 // 4, c.dec_depth * 3 // 4):
                hooks[layer] = at_least_f32(f_img[:, 1:])
        f_state = self.dec_norm_state(f_state)
        f_img = self.dec_norm(f_img)
        hooks[c.dec_depth] = f_img
        new_mem = self.pose_retriever.update_mem(mem.to(global_feat.dtype),
                                                 global_feat, f_img[:, 0:1])
        state_feat = _gate(update, at_least_f32(f_state), state_feat)
        mem = _gate(update, at_least_f32(new_mem), mem)
        if reset is not None:
            state_feat = _gate(reset, init_state_feat, state_feat)
            mem = _gate(reset, init_mem, mem)
        hook_list = [hooks[0], hooks[c.dec_depth * 2 // 4],
                     hooks[c.dec_depth * 3 // 4], hooks[c.dec_depth]]
        return state_feat, mem, hook_list

    def _decode_sequence(self, feat, pos, carry, chunk_start, update=None,
                         reset=None):
        """The recurrence over views: (hooks stacked over V*B, carry)."""
        V, B = feat.shape[:2]
        init_state, state_pos, init_mem = self.init_state(B)
        state_feat, mem = (init_state, init_mem) if carry is None else carry
        hooks = []
        for v in range(V):
            state_feat, mem, hl = self.decode_step(
                state_feat, state_pos, mem, feat[v], pos[v],
                (chunk_start + v) == 0, init_state, init_mem,
                update=None if update is None else update[v],
                reset=None if reset is None else reset[v])
            hooks.append(hl)
        stacked = [torch.cat([h[k] for h in hooks], 0) for k in range(4)]
        return stacked, (state_feat, mem)

    # ------------------------------------------------------------------
    # ray-map-conditioned single-view inference
    # ------------------------------------------------------------------
    def inference_step(self, ray_map: torch.Tensor, state_feat: torch.Tensor,
                       mem: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Query the state with a (B, H, W, 6) ray map in place of an image;
        the state and memory are not updated. Returns the head outputs of
        the queried view, each (B, ...)."""
        B, H, W, _ = ray_map.shape
        feat, pos = self.encode_ray_map(ray_map)
        init_state, state_pos, init_mem = self.init_state(B)
        off = torch.zeros(B, dtype=torch.bool, device=feat.device)
        _, _, hook_list = self.decode_step(
            state_feat, state_pos, mem, feat, pos, False, init_state,
            init_mem, update=off)
        return self.downstream_head(hook_list, H, W, pos)

    # ------------------------------------------------------------------
    # chunked forward with an explicit carry (truncated BPTT)
    # ------------------------------------------------------------------
    def forward_chunk(self, imgs: torch.Tensor, carry, chunk_start: int):
        """Like ``forward`` but threads an explicit recurrent carry.
        imgs (V, B, H, W, 3); carry (state_feat, mem) or None for a fresh
        state; chunk_start: global index of view 0 (the learned pose token
        is used only at index 0). Returns (out dict, carry)."""
        V, B, H, W, _ = imgs.shape
        feat, pos = self.encode_image(imgs.reshape(V * B, H, W, 3))
        return self.decode_views(feat.reshape(V, B, *feat.shape[1:]),
                                 pos.reshape(V, B, *pos.shape[1:]), H, W,
                                 carry, chunk_start)

    def decode_views(self, feat: torch.Tensor, pos: torch.Tensor, H: int,
                     W: int, carry=None, chunk_start: int = 0,
                     head_outputs=HEAD_OUTPUTS):
        """Decoder-only pass over precomputed encoder tokens.
        feat (V, B, N, enc_dim); pos (V, B, N, 2). Returns (out dict of
        (V, B, ...) tensors, (state_feat, mem))."""
        V, B, N = feat.shape[:3]
        stacked, carry = self._decode_sequence(feat, pos, carry, chunk_start)
        out = self.downstream_head(stacked, H, W, pos.reshape(V * B, N, 2),
                                   outputs=head_outputs)
        out = {k: x.reshape((V, B) + x.shape[1:]) for k, x in out.items()}
        return out, carry

    # ------------------------------------------------------------------
    # full forward over a batch of view sequences
    # ------------------------------------------------------------------
    def forward(self, imgs: torch.Tensor,
                update: Optional[torch.Tensor] = None,
                reset: Optional[torch.Tensor] = None,
                ret_state: bool = False, head_outputs=HEAD_OUTPUTS,
                true_shape: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """imgs (V, B, H, W, 3) in [-1, 1]; update / reset (V, B) bool;
        true_shape (V, B, 2) int (height, width) per sample: rows with
        height > width are ManyAR portrait images stored transposed in the
        landscape container; the heads run once more at (W, H) and each
        sample takes its orientation's maps.

        Returns a dict of (V, B, ...) outputs: pts3d_in_self_view,
        conf_self, pts3d_in_other_view, conf, camera_pose (7, quaternion
        wxyz), rgb; and ``state`` = (state_feat, mem) with ``ret_state``."""
        V, B, H, W, _ = imgs.shape
        pmask = None
        if true_shape is not None and H != W:
            pmask = (true_shape[..., 0] > true_shape[..., 1]).reshape(V * B)
        feat, pos = self.encode_image(imgs.reshape(V * B, H, W, 3), pmask)
        N = feat.shape[1]
        stacked, state = self._decode_sequence(
            feat.reshape(V, B, N, -1), pos.reshape(V, B, N, 2), None, 0,
            update, reset)
        out = self.downstream_head(stacked, H, W, pos, outputs=head_outputs)
        if pmask is not None:
            out_p = self.downstream_head(stacked, W, H, pos,
                                         outputs=head_outputs)
            for k, land in out.items():
                port = out_p[k]
                if port.dim() >= 3 and tuple(port.shape[1:3]) == (W, H):
                    m = pmask.reshape((-1,) + (1,) * (land.dim() - 1))
                    out[k] = torch.where(m, port.transpose(1, 2), land)
        out = {k: x.reshape((V, B) + x.shape[1:]) for k, x in out.items()}
        if ret_state:
            out["state"] = state
        return out
