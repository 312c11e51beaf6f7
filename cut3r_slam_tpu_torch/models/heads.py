"""Prediction heads (port of ``cut3r_slam_tpu/models/heads.py``'s DPT
head, ``DPTPts3dPose``): the pose MLP, the DPT self-pointmap pyramid, the
cross-view pyramid behind two pose-conditioned ``final_transform``
blocks, the rgb pyramid, and their activations. The SLAM tracking path
asks for ``("self", "pose")`` only; training takes all four. The linear
head of the 224 checkpoints (``LinearPts3dPose``) is not ported.

Convolutions run NCHW in f32; inputs and outputs are channels-last like
the JAX heads. Module names follow the upstream ``DPTOutputAdapter_fix``
state_dict (``act_postprocess.{i}.{j}``, ``scratch.layer{k}_rn``,
``scratch.refinenet{k}``, ``head.{0,2,4}``). Upsampling is torch's
bilinear ``align_corners=True``.

The heads' ReLUs go through ``relu``: inside ``ReluBranches`` they record
their masks (input > 0) in call order, or follow the masks of another
run, so that two runs whose pre-activations straddle zero at rounding
level take one branch and a gradient comparison measures rounding only
(tests/test_torch_f64_oracle.py, phase 9 of chip_smoke.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConditionModulationBlock, Mlp
from .rope import at_least_f32

__all__ = ["DPTAdapter", "PoseDecoder", "DPTPts3dPose", "LinearPts3dPose",
           "reg_dense_depth", "reg_dense_conf", "postprocess_pose",
           "ReluBranches", "relu"]

_BRANCHES = None  # the active ReluBranches, if any


class ReluBranches:
    """Context manager over every head ReLU run inside it, in call order.
    ``ReluBranches()`` records each ReLU's mask (input > 0, on the CPU);
    ``ReluBranches(masks)`` replays recorded masks: each ReLU returns
    ``x * mask`` (gradient ``mask``) and must meet a mask of its shape.
    ``flips`` counts the elements whose own sign disagreed with the mask
    they followed, ``margin`` is the smallest |input| / max |input| over
    all recorded or replayed ReLUs: how near a kink the inputs sat."""

    def __init__(self, masks=None):
        self.replay = masks is not None
        self.masks = list(masks) if self.replay else []
        self.calls = 0
        self.flips = 0
        self.margin = float("inf")

    def __enter__(self):
        global _BRANCHES
        if _BRANCHES is not None:
            raise RuntimeError("ReluBranches do not nest")
        _BRANCHES = self
        return self

    def __exit__(self, *exc):
        global _BRANCHES
        _BRANCHES = None
        if exc[0] is None and self.replay and self.calls != len(self.masks):
            raise RuntimeError(f"{self.calls} ReLUs ran, {len(self.masks)} "
                               "masks were recorded")

    def __call__(self, x):
        with torch.no_grad():
            own = x > 0
            top = float(x.abs().max())
            if top > 0:
                self.margin = min(self.margin, float(x.abs().min()) / top)
        if not self.replay:
            self.masks.append(own.cpu())
            self.calls += 1
            return F.relu(x)
        if self.calls >= len(self.masks):
            raise RuntimeError("more ReLUs ran than masks were recorded")
        mask = self.masks[self.calls].to(x.device)
        if mask.shape != x.shape:
            raise RuntimeError(f"ReLU {self.calls}: mask {tuple(mask.shape)}"
                               f" for input {tuple(x.shape)}")
        self.calls += 1
        self.flips += int((own != mask).sum())
        return x * mask.to(x.dtype)


def relu(x):
    """F.relu, or the active ``ReluBranches``' record or replay."""
    return F.relu(x) if _BRANCHES is None else _BRANCHES(x)


def _resize(x, h, w):
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(relu(self.conv1(relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, with_res=True):
        super().__init__()
        if with_res:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        x = _resize(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(x)


class _Interpolate(nn.Module):
    """head.1: resize to the image size (set per call)."""

    def forward(self, x, size):
        return _resize(x, *size)


class _ReLU(nn.Module):
    """head.3 (``relu``)."""

    def forward(self, x):
        return relu(x)


class DPTAdapter(nn.Module):
    """4 hook features -> dense prediction (hooks from decoder layers
    0, depth/2, 3·depth/4, depth)."""

    def __init__(self, in_dims: Sequence[int], num_channels: int,
                 layer_dims=(96, 192, 384, 768), feature_dim: int = 256,
                 last_dim: int = 128, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        ld = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_dims[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(in_dims[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(in_dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(in_dims[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = nn.Module()
        for k in range(4):
            setattr(self.scratch, f"layer{k + 1}_rn",
                    nn.Conv2d(ld[k], feature_dim, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}",
                    FeatureFusionBlock(feature_dim, with_res=k < 4))
        self.head = nn.ModuleList([
            nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1),
            _Interpolate(),
            nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1),
            _ReLU(),
            nn.Conv2d(last_dim, num_channels, 1),
        ])

    def forward(self, tokens, img_h: int, img_w: int):
        """tokens: 4 tensors (B, N, C_i) -> (B, H, W, num_channels)."""
        nh, nw = img_h // self.patch_size, img_w // self.patch_size
        feats = [at_least_f32(t).transpose(1, 2)
                 .reshape(t.shape[0], -1, nh, nw) for t in tokens]
        layers = [act(f) for act, f in zip(self.act_postprocess, feats)]
        s = self.scratch
        rn = [getattr(s, f"layer{k + 1}_rn")(l) for k, l in enumerate(layers)]
        p = s.refinenet4(rn[3])
        p = p[..., : rn[2].shape[-2], : rn[2].shape[-1]]
        p = s.refinenet3(p, rn[2])
        p = p[..., : rn[1].shape[-2], : rn[1].shape[-1]]
        p = s.refinenet2(p, rn[1])
        p = p[..., : rn[0].shape[-2], : rn[0].shape[-1]]
        p = s.refinenet1(p, rn[0])
        h = self.head[0](p)
        h = self.head[1](h, (img_h, img_w))
        h = self.head[3](self.head[2](h))
        return self.head[4](h).permute(0, 2, 3, 1)


class PoseDecoder(nn.Module):
    """MLP pose head: (B, C) -> (B, 7) raw [t(3), quat wxyz(4)]."""

    def __init__(self, hidden_dim):
        super().__init__()
        self.mlp = Mlp(hidden_dim, hidden_dim * 4, out_dim=7)

    def forward(self, pose_feat):
        return self.mlp(pose_feat)


def reg_dense_depth(xyz: torch.Tensor, pos_z: bool = False) -> torch.Tensor:
    """exp mode: unit(xyz) * expm1(|xyz|) (norm clamped at 60); ``pos_z``
    flips the sign so that z >= 0."""
    if pos_z:
        xyz = xyz * torch.sign(xyz[..., -1:])
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp(d, min=1e-8) * torch.expm1(torch.clamp(d, max=60.0))


def reg_dense_conf(x: torch.Tensor, vmin: float = 1.0) -> torch.Tensor:
    return vmin + torch.exp(x)


def postprocess_pose(out: torch.Tensor) -> torch.Tensor:
    """t * expm1(|t|)/|t|; quat L2-normalized with w >= 0 (wxyz)."""
    trans, quats = out[..., 0:3], out[..., 3:7]
    d = torch.linalg.norm(trans, dim=-1, keepdim=True)
    trans = trans * (torch.expm1(torch.clamp(d, max=60.0))
                     / torch.clamp(d, min=1e-8))
    quats = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True),
                                min=1e-12)
    quats = torch.where(quats[..., 0:1] < 0, -quats, quats)
    return torch.cat([trans, quats], -1)


class DPTPts3dPose(nn.Module):
    """The live head of cut3r_512_dpt_4_64. Input: 4 hook token tensors
    (the last carries the pose token first) and the image tokens'
    positions. ``outputs`` picks the pyramids that run."""

    def __init__(self, enc_dim: int, dec_embed_dim: int, dec_num_heads: int,
                 has_rgb: bool = True, rope_base: float = 100.0):
        super().__init__()
        dims = (enc_dim, dec_embed_dim, dec_embed_dim, dec_embed_dim)
        self.has_rgb = has_rgb
        self.pose_head = PoseDecoder(dec_embed_dim)
        self.dpt_self = DPTAdapter(dims, 4)
        self.final_transform = nn.ModuleList([
            ConditionModulationBlock(dec_embed_dim, dec_num_heads,
                                     use_rope=True, rope_base=rope_base)
            for _ in range(2)])
        self.dpt_cross = DPTAdapter(dims, 4)
        if has_rgb:
            self.dpt_rgb = DPTAdapter(dims, 3)

    def forward(self, hook_tokens, img_h: int, img_w: int, pos,
                outputs=("self", "cross", "rgb", "pose")):
        pose_token = at_least_f32(hook_tokens[-1][:, 0])
        token = at_least_f32(hook_tokens[-1][:, 1:])
        x_self = [at_least_f32(t) for t in hook_tokens[:-1]] + [token]
        out = {}
        if "pose" in outputs:
            out["camera_pose"] = postprocess_pose(self.pose_head(pose_token))
        if "self" in outputs:
            so = self.dpt_self(x_self, img_h, img_w)
            out["pts3d_in_self_view"] = reg_dense_depth(so[..., :3])
            out["conf_self"] = reg_dense_conf(so[..., 3])
        if "cross" in outputs:
            tc = token
            for blk in self.final_transform:
                tc = blk(tc, pose_token, pos)
            co = self.dpt_cross(x_self[:-1] + [at_least_f32(tc)], img_h, img_w)
            out["pts3d_in_other_view"] = reg_dense_depth(co[..., :3])
            out["conf"] = reg_dense_conf(co[..., 3])
        if self.has_rgb and "rgb" in outputs:
            eps = 1e-6
            rgb = torch.sigmoid(self.dpt_rgb(x_self, img_h, img_w)) \
                * (1 - 2 * eps) + eps
            out["rgb"] = (rgb - 0.5) * 2
        return out


def _unpatch(x: torch.Tensor, c: int, ps: int, img_h: int, img_w: int):
    """(B, N, c*ps*ps) per-patch values -> (B, H, W, c), torch's
    ``pixel_shuffle`` layout: feature f = c*ps^2 + dy*ps + dx."""
    B = x.shape[0]
    x = x.reshape(B, img_h // ps, img_w // ps, c, ps, ps)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(B, img_h, img_w, c)


class LinearPts3dPose(nn.Module):
    """The linear head of the 224 checkpoints: MLP projections (hidden
    ``mlp_ratio`` x D) of the final decoder tokens to per-patch (3 + 1)
    channel values; the cross pointmap runs the tokens through two
    pose-conditioned ``final_transform`` blocks first, as the DPT head
    does; the self pointmap's z is made non-negative (``pos_z``)."""

    def __init__(self, dec_embed_dim: int, dec_num_heads: int = 12,
                 patch_size: int = 16, mlp_ratio: float = 4.0,
                 has_rgb: bool = False, rope_base: float = 100.0):
        super().__init__()
        ps, hidden = patch_size, int(mlp_ratio * dec_embed_dim)
        self.patch_size, self.has_rgb = ps, has_rgb
        self.pose_head = PoseDecoder(dec_embed_dim)
        self.proj = Mlp(dec_embed_dim, hidden, ps * ps * 4)
        self.final_transform = nn.ModuleList([
            ConditionModulationBlock(dec_embed_dim, dec_num_heads,
                                     use_rope=True, rope_base=rope_base)
            for _ in range(2)])
        self.cross_proj = Mlp(dec_embed_dim, hidden, ps * ps * 4)
        if has_rgb:
            self.rgb_proj = Mlp(dec_embed_dim, hidden, ps * ps * 3)

    def forward(self, hook_tokens, img_h: int, img_w: int, pos,
                outputs=("self", "cross", "rgb", "pose")):
        pose_token = at_least_f32(hook_tokens[-1][:, 0])
        token = at_least_f32(hook_tokens[-1][:, 1:])
        ps, N = self.patch_size, token.shape[1]
        out = {}
        if "pose" in outputs:
            out["camera_pose"] = postprocess_pose(self.pose_head(pose_token))
        if "self" in outputs:
            so = _unpatch(self.proj(token), 4, ps, img_h, img_w)
            out["pts3d_in_self_view"] = reg_dense_depth(so[..., :3],
                                                        pos_z=True)
            out["conf_self"] = reg_dense_conf(so[..., 3])
        if "cross" in outputs:
            tc = token
            pos_img = None if pos is None else pos[:, -N:]
            for blk in self.final_transform:
                tc = blk(tc, pose_token, pos_img)
            co = _unpatch(self.cross_proj(at_least_f32(tc)), 4, ps, img_h,
                          img_w)
            out["pts3d_in_other_view"] = reg_dense_depth(co[..., :3])
            out["conf"] = reg_dense_conf(co[..., 3])
        if self.has_rgb and "rgb" in outputs:
            eps = 1e-6
            rgb = _unpatch(self.rgb_proj(token), 3, ps, img_h, img_w)
            out["rgb"] = (torch.sigmoid(rgb) * (1 - 2 * eps) + eps - 0.5) * 2
        return out
