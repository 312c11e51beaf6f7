"""Omnidata DPT-hybrid prior network (port of
``cut3r_slam_tpu/models/omnidata.py``): a DPT depth / normal predictor on
timm's ``vit_base_resnet50_384`` hybrid, the reference's monocular prior
source. The backbone is a ResNetV2 stem (weight-standardized 7x7/2 conv
with TF-"SAME" padding, GroupNorm(32), ReLU, a 3x3/2 "SAME" max-pool) and
stages of (3, 4, 9) bottlenecks, whose 1/16 map is projected to ViT-B
tokens; two ResNet taps and ViT blocks 8 and 11 feed the midas DPT
decoder through the "project" readout.

Module names are the midas / timm state-dict names, so a public
``omnidata_dpt_{depth,normal}_v2.ckpt`` loads strictly through
``load_omnidata_ckpt`` (``ckpt["state_dict"]`` with a ``model.`` prefix;
the keys in ``OMNIDATA_SKIP`` are dropped, each with its reason).

Numerics follow the JAX model: the conv weights are standardized with
the biased variance and eps 1e-8; "SAME" pads asymmetrically (the extra
row and column go after), the max-pool pads with -inf; GroupNorm eps
1e-5, LayerNorm eps 1e-6, exact GELU; the 24x24 ``pos_embed`` grid is
resized to (H/16, W/16) as ``jax.image.resize(..., "bilinear")`` does
(``resize_bilinear``: a triangle filter that antialiases when it
shrinks); the decoder's upsampling is bilinear with aligned corners.

``random_omnidata`` draws a network from a seed (``init_random``'s
scheme, then gains and values by parameter name): the stand-in for the
public checkpoints where the repository has none.

Spans (``utils.profiling``): ``omni.backbone`` (the ResNet stem and
stages), ``omni.vit`` (the patch projection, the position grid and the
blocks), ``omni.decoder`` (the readouts, the fusion blocks and the head).
"""
from __future__ import annotations

import fnmatch
import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..utils.profiling import span
from .blocks import init_random

__all__ = ["OmnidataDPT", "load_omnidata_ckpt", "random_omnidata",
           "resize_bilinear", "same_pad", "OMNIDATA_SKIP"]

# keys of the public checkpoints that the model never reads
OMNIDATA_SKIP = {
    "pretrained.model.norm.": "timm's final ViT norm: DPT taps the blocks",
    "pretrained.model.head.": "timm's classifier",
    "scratch.refinenet4.resConfUnit1.":
        "unused by midas: refinenet4 fuses one input",
}


# --------------------------------------------------------------------- #
# resampling
# --------------------------------------------------------------------- #
@lru_cache(maxsize=64)
def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s "bilinear" along one
    axis (``scale_and_translate`` with the triangle kernel, antialiased:
    the kernel widens by n_in / n_out when shrinking)."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, out_h, out_w, C), "bilinear")`` for a
    channels-last (B, H, W, C) or (B, H, W) tensor."""
    H, W = x.shape[1:3]
    if (H, W) == (out_h, out_w):
        return x
    wy = torch.as_tensor(_triangle_weights(H, out_h), dtype=x.dtype,
                         device=x.device)
    wx = torch.as_tensor(_triangle_weights(W, out_w), dtype=x.dtype,
                         device=x.device)
    if x.dim() == 3:
        return torch.einsum("bhw,hy,wx->byx", x, wy, wx)
    return torch.einsum("bhwc,hy,wx->byxc", x, wy, wx)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with aligned corners (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def same_pad(size: int, k: int, s: int):
    """TF-"SAME" padding of one axis: (before, after), the odd one after."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    top, bottom = same_pad(x.shape[-2], k, s)
    left, right = same_pad(x.shape[-1], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


# --------------------------------------------------------------------- #
# ResNetV2 stem (timm names)
# --------------------------------------------------------------------- #
class StdConv2dSame(nn.Conv2d):
    """Weight-standardized conv with TF-"SAME" padding (timm
    ``StdConv2dSame``, eps 1e-8, biased variance over (in, kh, kw))."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x):
        w = self.weight
        mu = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mu) / torch.sqrt(var + 1e-8)
        return F.conv2d(_pad_same(x, self.kernel_size[0], self.stride[0]),
                        w, stride=self.stride)


class GroupNormAct(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) and an optional ReLU (timm
    ``GroupNormAct``)."""

    def __init__(self, ch, act=True):
        super().__init__(32, ch, eps=1e-5)
        self.act = act

    def forward(self, x):
        y = F.group_norm(x, self.num_groups, self.weight, self.bias,
                         self.eps)
        return F.relu(y) if self.act else y


class _Downsample(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv2dSame(cin, cout, 1, stride)
        self.norm = GroupNormAct(cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2 non-preact bottleneck: conv-norm x 3, ReLU(add)."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        mid = cout // 4
        if cin != cout or stride != 1:
            self.downsample = _Downsample(cin, cout, stride)
        else:
            self.downsample = None
        self.conv1 = StdConv2dSame(cin, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv2dSame(mid, cout, 1)
        self.norm3 = GroupNormAct(cout, act=False)

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return F.relu(y + short)


class _Stage(nn.Module):
    def __init__(self, cin, cout, n, stride):
        super().__init__()
        self.blocks = nn.ModuleList([
            Bottleneck(cin if b == 0 else cout, cout, stride if b == 0 else 1)
            for b in range(n)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv2dSame(3, 64, 7, 2)
        self.norm = GroupNormAct(64)

    def forward(self, x):
        y = self.norm(self.conv(x))
        return F.max_pool2d(_pad_same(y, 3, 2, float("-inf")), 3, 2)


class ResNetV2(nn.Module):
    """The hybrid ViT's conv stem; returns the three stages' outputs."""

    def __init__(self, layers=(3, 4, 9), widths=(256, 512, 1024)):
        super().__init__()
        self.stem = _Stem()
        cins = (64,) + tuple(widths[:-1])
        self.stages = nn.ModuleList([
            _Stage(ci, co, n, 1 if s == 0 else 2)
            for s, (ci, co, n) in enumerate(zip(cins, widths, layers))])

    def forward(self, x):
        y, taps = self.stem(x), []
        for stage in self.stages:
            y = stage(y)
            taps.append(y)
        return taps


# --------------------------------------------------------------------- #
# ViT-B (timm names)
# --------------------------------------------------------------------- #
class _Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-2, -1)
                          / math.sqrt(D // self.heads), -1)
        return self.proj((a @ v).transpose(1, 2).reshape(B, N, D))


class _Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """timm ViT-B block: pre-LN attention and pre-LN MLP (4x, exact
    GELU), LayerNorm eps 1e-6."""

    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _HybridEmbed(nn.Module):
    def __init__(self, layers, dim):
        super().__init__()
        self.backbone = ResNetV2(layers)
        self.proj = nn.Conv2d(1024, dim, 1)


class _ViT(nn.Module):
    def __init__(self, dim, depth, heads, layers):
        super().__init__()
        self.patch_embed = _HybridEmbed(layers, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 577, dim))
        self.blocks = nn.ModuleList([ViTBlock(dim, heads)
                                     for _ in range(depth)])


class _ProjectReadout(nn.Module):
    """midas "project" readout: [tokens ; cls] -> Linear -> GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tok):
        cls = tok[:, :1].expand_as(tok[:, 1:])
        return self.project(torch.cat([tok[:, 1:], cls], -1))


class _Pretrained(nn.Module):
    def __init__(self, dim, depth, heads, layers):
        super().__init__()
        self.model = _ViT(dim, depth, heads, layers)
        # act_postprocess{3,4}: [0] readout, [3] 1x1 conv, [4] 3x3/2 conv
        self.act_postprocess3 = nn.Sequential(
            _ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1))
        self.act_postprocess4 = nn.Sequential(
            _ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1), nn.Conv2d(dim, dim, 3, 2, 1))


# --------------------------------------------------------------------- #
# midas DPT decoder (midas names)
# --------------------------------------------------------------------- #
class ResidualConvUnit(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusion(nn.Module):
    """midas ``FeatureFusionBlock_custom``: the skip through unit 1, unit
    2, bilinear 2x (aligned corners), a 1x1 out conv."""

    def __init__(self, f, with_skip=True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_upsample2(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    def __init__(self, dims, f, n_out):
        super().__init__()
        for k, c in enumerate(dims, start=1):
            setattr(self, f"layer{k}_rn", nn.Conv2d(c, f, 3, padding=1,
                                                    bias=False))
            setattr(self, f"refinenet{k}", FeatureFusion(f, k < 4))
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, n_out, 1), nn.ReLU())


class OmnidataDPT(nn.Module):
    """DPT on the ViT-hybrid backbone; ``task`` picks the output channels
    and the input normalization (depth: (x - 0.5) / 0.5, normal: raw)."""

    def __init__(self, task: str = "depth", vit_dim: int = 768,
                 vit_depth: int = 12, vit_heads: int = 12,
                 hook_blocks: Sequence[int] = (8, 11), features: int = 256,
                 resnet_layers: Sequence[int] = (3, 4, 9), device="cuda"):
        super().__init__()
        if task not in ("depth", "normal"):
            raise ValueError(f"unknown task {task!r}")
        self.task, self.vit_dim = task, vit_dim
        self.hook_blocks = tuple(hook_blocks)
        dev = resolve_device(device)
        with dev:   # initialised on the device, not copied there
            self.pretrained = _Pretrained(vit_dim, vit_depth, vit_heads,
                                          tuple(resnet_layers))
            self.scratch = _Scratch((256, 512, vit_dim, vit_dim), features,
                                    1 if task == "depth" else 3)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.pretrained.model.cls_token.device

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) in [0, 1], H and W multiples of 32 -> depth
        (B, H, W) or normals (B, H, W, 3)."""
        B, H, W, _ = img.shape
        if H % 32 or W % 32:
            raise ValueError("H, W must be multiples of 32")
        x = img.float().permute(0, 3, 1, 2)
        if self.task == "depth":
            x = (x - 0.5) / 0.5
        vit, post, D = self.pretrained.model, self.pretrained, self.vit_dim
        with span("omni.backbone"):
            layer1, layer2, feat = vit.patch_embed.backbone(x)
        gh, gw = H // 16, W // 16
        with span("omni.vit"):
            t = vit.patch_embed.proj(feat).flatten(2).transpose(1, 2)
            pos = vit.pos_embed
            grid = resize_bilinear(pos[:, 1:].reshape(1, 24, 24, D), gh, gw)
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, D)], 1)
            t = torch.cat([vit.cls_token.expand(B, 1, D), t], 1) + pos
            hooked = {}
            for i, blk in enumerate(vit.blocks):
                t = blk(t)
                if i in self.hook_blocks:
                    hooked[i] = t

        def grid_of(readout, tok):
            return readout(tok).transpose(1, 2).reshape(B, D, gh, gw)

        with span("omni.decoder"):
            a3, a4 = post.act_postprocess3, post.act_postprocess4
            layer3 = a3[3](grid_of(a3[0], hooked[self.hook_blocks[0]]))
            layer4 = a4[4](a4[3](grid_of(a4[0],
                                         hooked[self.hook_blocks[1]])))
            s = self.scratch
            rn = [getattr(s, f"layer{k}_rn")(v) for k, v in
                  enumerate((layer1, layer2, layer3, layer4), start=1)]
            p = s.refinenet4(rn[3])
            p = s.refinenet3(p, rn[2])
            p = s.refinenet2(p, rn[1])
            p = s.refinenet1(p, rn[0])
            oc = s.output_conv
            y = _upsample2(oc[0](p))
            y = oc[5](oc[4](oc[3](oc[2](y))))
            y = y.permute(0, 2, 3, 1)
        return y[..., 0] if self.task == "depth" else y


@torch.no_grad()
def random_omnidata(task: str, seed: int, device, scale=None, assign=None,
                    **widths) -> OmnidataDPT:
    """An ``OmnidataDPT`` of ``task`` (``widths``: its keyword sizes, the
    published ones by default) with random weights from ``seed``:
    ``init_random``'s scheme (fan-in-scaled convolutions, normal(0.02)
    linear weights, tokens and position grid, zero biases, unit norms),
    then ``scale`` (a gain by parameter name) and ``assign`` (a value by
    parameter name, a number filling the tensor); a name may be an
    ``fnmatch`` pattern, which must match some parameter."""
    net = OmnidataDPT(task=task, device=device, **widths)
    init_random(net, torch.Generator(device=net.device).manual_seed(
        int(seed)))
    params = dict(net.named_parameters())

    def named(pattern):
        hits = fnmatch.filter(params, pattern)
        if not hits:
            raise KeyError(f"no parameter of OmnidataDPT matches {pattern!r}")
        return [params[n] for n in hits]
    for pattern, gain in (scale or {}).items():
        for p in named(pattern):
            p.mul_(gain)
    for pattern, value in (assign or {}).items():
        for p in named(pattern):
            p.copy_(torch.as_tensor(value, dtype=torch.float32))
    return net.eval()


def load_omnidata_ckpt(path: str, task: str = "depth",
                       device="cuda") -> OmnidataDPT:
    """An ``omnidata_dpt_{task}_v2.ckpt`` (``ckpt["state_dict"]``, keys
    prefixed ``model.``) loaded strictly into a full-size ``OmnidataDPT``:
    every key but those under ``OMNIDATA_SKIP`` must be a tensor of the
    model and every tensor of the model must be in the file."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("model."):] if k.startswith("model.") else k):
          torch.as_tensor(v).float() for k, v in sd.items()}
    sd = {k: v for k, v in sd.items()
          if not any(k.startswith(p) for p in OMNIDATA_SKIP)}
    model = OmnidataDPT(task=task, device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()
