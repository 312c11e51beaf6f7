"""Omnidata DPT-Hybrid of the benchmark's reference (Eftekhar et al.,
"Omnidata: A Scalable Pipeline for Making Multi-Task Mid-Level Vision
Datasets from 3D Scans", ICCV 2021, arXiv:2110.04994; the checkpoints
``omnidata_dpt_{depth,normal}_v2.ckpt`` of EPFL-VILAB/omnidata): DPT
(Ranftl et al., arXiv:2103.13413) on timm's ``vit_base_resnet50_384``.

- The hybrid stem: ResNetV2 with weight-standardized convolutions (each
  filter less its mean over its biased standard deviation, eps 1e-8),
  TF-"SAME" padding (the odd pixel after), GroupNorm(32, eps 1e-5), a
  7x7/2 stem convolution, a 3x3/2 max-pool and stages of (3, 4, 9)
  non-preactivation bottlenecks (256, 512, 1024 wide, a strided 3x3 in
  the first block of the later two).
- The 1/16 map projected to ViT-B/16 tokens (768 wide, 12 blocks of 12
  heads, MLP 3072, pre-LayerNorm with eps 1e-6, exact GELU), a class
  token, the 24x24 position grid resized bilinearly to the image's grid.
- The "project" readout (each token beside the class token, a linear
  layer, GELU) of blocks 8 and 11; the midas decoder: the two stem taps
  and the two readouts reassembled (1x1 convolutions, a 3x3/2 one for the
  last), 3x3 convolutions to 256 features, four fusion blocks (residual
  convolution units, a 2x bilinear upsampling with aligned corners, a 1x1
  convolution), the head (3x3 to 128, 2x upsampling, 3x3 to 32, ReLU, 1x1
  to the task's channels, ReLU).
- Depth takes the image as (x - 0.5) / 0.5, normal takes it as it is.

Parameter names are the midas / timm state-dict names, so one state dict
loads into this module and the port's. Plain PyTorch in float32 with TF32
off for convolutions and products (``full_f32`` in ``droid.py``); it
imports nothing of the program. ``low=True`` in ``forward`` is the
control's knob: the whole forward under bfloat16 autocast.
``draw_state_dict`` draws the benchmark's weights, which the cell loads
into the program's networks and into this module alike.

Departures from the published description:
- the position grid is resized by ``F.interpolate``'s antialiased
  bilinear filter (a triangle widened when it shrinks, as
  ``jax.image.resize``'s "bilinear"), where timm's hybrid resizes with
  ``F.interpolate(mode="bilinear", align_corners=False)`` without
  antialiasing: the two agree when the grid grows, which is the case at
  384x512 (24x24 -> 24x32);
- timm's final norm and classifier are not part of the network (DPT taps
  the blocks), nor is refinenet4's first residual unit, which midas never
  calls.
"""
from __future__ import annotations

import fnmatch
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .droid import full_f32, low_precision

__all__ = ["OmnidataDPT", "PUBLISHED", "draw_state_dict"]

# the published widths (the configuration's ``prior.widths``)
PUBLISHED = dict(vit_dim=768, vit_depth=12, vit_heads=12,
                 hook_blocks=[8, 11], features=256, resnet_layers=[3, 4, 9])


def _same(x, k, s, value=0.0):
    """TF-"SAME" padding of both spatial axes for a k x k window at stride
    s: the total (ceil(n / s) - 1) s + k - n, its odd pixel after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class StdConv(nn.Module):
    """A weight-standardized convolution without bias, "SAME" padded."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        w = self.weight.flatten(1)
        w = (w - w.mean(1, keepdim=True)) * torch.rsqrt(
            ((w - w.mean(1, keepdim=True)) ** 2).mean(1, keepdim=True)
            + 1e-8)
        return F.conv2d(_same(x, self.k, self.stride),
                        w.view_as(self.weight), stride=self.stride)


class GN(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x, 32, self.weight, self.bias, 1e-5)


class ConvGN(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride)
        self.norm = GN(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        mid = cout // 4
        self.downsample = ConvGN(cin, cout, stride) \
            if (cin, stride) != (cout, 1) else None
        self.conv1, self.norm1 = StdConv(cin, mid, 1), GN(mid)
        self.conv2, self.norm2 = StdConv(mid, mid, 3, stride), GN(mid)
        self.conv3, self.norm3 = StdConv(mid, cout, 1), GN(cout)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample.norm(self.downsample.conv(x))
        return F.relu(x + y)


class Stage(nn.Module):
    def __init__(self, cin, cout, n, stride):
        super().__init__()
        self.blocks = nn.ModuleList(
            [Bottleneck(cin, cout, stride)]
            + [Bottleneck(cout, cout, 1) for _ in range(n - 1)])


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv, self.norm = StdConv(3, 64, 7, 2), GN(64)


class ResNetV2(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.stem = Stem()
        self.stages = nn.ModuleList([
            Stage(cin, cout, n, 1 if i == 0 else 2) for i, (cin, cout, n)
            in enumerate(zip((64, 256, 512), (256, 512, 1024), layers))])

    def forward(self, x):
        x = F.relu(self.stem.norm(self.stem.conv(x)))
        x = F.max_pool2d(_same(x, 3, 2, -math.inf), 3, 2)
        taps = []
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x)
            taps.append(x)
        return taps


class HybridEmbed(nn.Module):
    def __init__(self, layers, dim):
        super().__init__()
        self.backbone = ResNetV2(layers)
        self.proj = nn.Conv2d(1024, dim, 1)


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, t):
        B, N, D = t.shape
        dh = D // self.heads
        q, k, v = self.attn.qkv(self.norm1(t)).view(
            B, N, 3, self.heads, dh).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
        t = t + self.attn.proj(o.reshape(B, N, D))
        return t + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(t))))


class ViT(nn.Module):
    def __init__(self, dim, depth, heads, layers):
        super().__init__()
        self.patch_embed = HybridEmbed(layers, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 24 * 24 + 1, dim))
        self.blocks = nn.ModuleList([Block(dim, heads)
                                     for _ in range(depth)])


class Readout(nn.Module):
    """midas "project": [token ; class token] -> Linear -> GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t):
        body = t[:, 1:]
        return self.project(torch.cat(
            [body, t[:, :1].expand(-1, body.shape[1], -1)], -1))


class Pretrained(nn.Module):
    def __init__(self, dim, depth, heads, layers):
        super().__init__()
        self.model = ViT(dim, depth, heads, layers)
        # midas's act_postprocess{3,4}: [0] readout, [1] transpose, [2]
        # unflatten (no parameters), [3] 1x1, [4] 3x3/2 (4 only)
        self.act_postprocess3 = nn.Sequential(
            Readout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1))
        self.act_postprocess4 = nn.Sequential(
            Readout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1), nn.Conv2d(dim, dim, 3, 2, 1))


class Unit(nn.Module):
    """midas ``ResidualConvUnit_custom`` (no batch norm): x + conv(relu(
    conv(relu(x))))."""

    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Fusion(nn.Module):
    def __init__(self, f, skip):
        super().__init__()
        if skip:
            self.resConfUnit1 = Unit(f)
        self.resConfUnit2 = Unit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = F.interpolate(self.resConfUnit2(x), scale_factor=2,
                          mode="bilinear", align_corners=True)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, dims, f, n_out):
        super().__init__()
        for i, c in enumerate(dims, 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i}", Fusion(f, i < 4))
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, n_out, 1), nn.ReLU())


class OmnidataDPT(nn.Module):
    """The network of one task ("depth": one channel, "normal": three) at
    the given widths (``PUBLISHED`` by default)."""

    def __init__(self, task="depth", vit_dim=768, vit_depth=12,
                 vit_heads=12, hook_blocks=(8, 11), features=256,
                 resnet_layers=(3, 4, 9)):
        super().__init__()
        assert task in ("depth", "normal")
        self.task, self.hooks = task, tuple(hook_blocks)
        self.pretrained = Pretrained(vit_dim, vit_depth, vit_heads,
                                     tuple(resnet_layers))
        self.scratch = Scratch((256, 512, vit_dim, vit_dim), features,
                               1 if task == "depth" else 3)

    def forward(self, img, low=False):
        """img (B, H, W, 3) in [0, 1], H and W multiples of 32 -> (the map:
        depth (B, H, W) or normals (B, H, W, 3), {hook block: its tokens
        (B, 1 + H W / 256, D)}); in float32 with TF32 off, or under
        bfloat16 autocast where ``low``."""
        with full_f32(), low_precision(img.device, low):
            return self._forward(img)

    def _forward(self, img):
        B, H, W, _ = img.shape
        x = img.float().permute(0, 3, 1, 2)
        if self.task == "depth":
            x = 2.0 * x - 1.0
        vit, pre = self.pretrained.model, self.pretrained
        c1, c2, c3 = vit.patch_embed.backbone(x)
        gh, gw = H // 16, W // 16
        D = vit.cls_token.shape[-1]
        t = vit.patch_embed.proj(c3).flatten(2).transpose(1, 2)
        grid = vit.pos_embed[:, 1:].reshape(1, 24, 24, D).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                             align_corners=False, antialias=True)
        pos = torch.cat([vit.pos_embed[:, :1],
                         grid.flatten(2).transpose(1, 2)], 1)
        t = torch.cat([vit.cls_token.expand(B, -1, -1), t], 1) + pos
        tokens = {}
        for i, blk in enumerate(vit.blocks):
            t = blk(t)
            if i in self.hooks:
                tokens[i] = t

        def reassemble(post, tok):
            g = post[0](tok).transpose(1, 2).reshape(B, D, gh, gw)
            for m in list(post)[3:]:
                g = m(g)
            return g
        c4 = reassemble(pre.act_postprocess3, tokens[self.hooks[0]])
        c5 = reassemble(pre.act_postprocess4, tokens[self.hooks[1]])
        s = self.scratch
        r1, r2, r3, r4 = (getattr(s, f"layer{i}_rn")(c) for i, c in
                          enumerate((c1, c2, c4, c5), 1))
        p = s.refinenet1(s.refinenet2(s.refinenet3(s.refinenet4(r4), r3),
                                      r2), r1)
        head = s.output_conv
        y = F.interpolate(head[0](p), scale_factor=2, mode="bilinear",
                          align_corners=True)
        y = F.relu(head[4](F.relu(head[2](y)))).float().permute(0, 2, 3, 1)
        tokens = {i: v.float() for i, v in tokens.items()}
        return (y[..., 0] if self.task == "depth" else y), tokens


def draw_state_dict(task, seed: int, device, scale=None, assign=None,
                    **widths):
    """{name: float32 tensor} of every parameter of ``task``'s network at
    ``widths``, from ``seed``: convolution weights normal with standard
    deviation fan_in^-1/2, linear weights, the class token and the
    position grid normal(0.02), biases zero, GroupNorm and LayerNorm gains
    one, all from ONE ``torch.randn`` sliced in the order of the names;
    then ``scale`` (a gain by name) and ``assign`` (a value by name), the
    configuration's ``prior.init``. A name may be an ``fnmatch`` pattern,
    which must match some parameter."""
    with torch.device("meta"):
        model = OmnidataDPT(task, **widths)
    named = sorted(model.named_parameters())

    def kind(name, p):
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if name.endswith(".bias"):
            return "zero"
        if isinstance(owner, (GN, nn.LayerNorm)):
            return "one"
        return "conv" if p.dim() == 4 else "normal"
    kinds = {n: kind(n, p) for n, p in named}
    total = sum(p.numel() for n, p in named
                if kinds[n] in ("conv", "normal"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, p in named:
        if kinds[name] in ("zero", "one"):
            out[name] = torch.full(p.shape, float(kinds[name] == "one"),
                                   device=device)
            continue
        n = p.numel()
        std = p[0].numel() ** -0.5 if kinds[name] == "conv" else 0.02
        out[name] = flat[off:off + n].view(p.shape).mul_(std)
        off += n

    def matching(pattern):
        hits = fnmatch.filter(out, pattern)
        if not hits:
            raise KeyError(f"no parameter matches {pattern!r}")
        return hits
    for pattern, gain in (scale or {}).items():
        for name in matching(pattern):
            out[name].mul_(gain)
    for pattern, value in (assign or {}).items():
        for name in matching(pattern):
            out[name].fill_(value)
    return out
