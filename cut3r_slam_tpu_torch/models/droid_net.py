"""DROID-SLAM network stack (port of ``cut3r_slam_tpu/models/droid_net.py``):
the feature and context encoders, the ConvGRU update operator, convex
upsampling, and the BA-in-the-loop forward (12 GRU steps x 2 BA
iterations by default).

Modules run on NCHW tensors; module names are the flax names, so
``models/convert.droid_params_from_jax`` carries the JAX params. The
inputs and outputs of ``DroidNet.forward`` keep the JAX layouts (images
(P, H, W, 3), targets and residuals (E, h, w, 2)). The BA solver is
``ops/ba.py``, the correlation lookups ``ops/corr.py``.
``grad_clip`` is an identity whose backward zeroes NaNs and clamps to
+-0.01.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..geometry.projective import coords_grid, projective_transform
from ..ops.ba import bundle_adjust
from ..ops.corr import build_corr_pyramid, corr_lookup

__all__ = ["BasicEncoder", "ConvGRU", "GraphAgg", "UpdateModule",
           "DroidNet", "cvx_upsample", "grad_clip", "instance_norm"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return g.clamp(-0.01, 0.01)


def grad_clip(x: torch.Tensor) -> torch.Tensor:
    return _GradClip.apply(x)


def instance_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax ``GroupNorm(group_size=1)`` without scale or bias: per-channel
    statistics over (H, W), the fast variance E[x^2] - E[x]^2 clipped at
    0, eps 1e-6."""
    mu = x.mean((2, 3), keepdim=True)
    var = torch.clamp((x * x).mean((2, 3), keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps)


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


class ResBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.conv1 = _conv(cin, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        # a 1x1 stride-s "SAME" convolution pads nothing
        self.downsample = nn.Conv2d(cin, planes, 1, stride=stride) \
            if stride > 1 or cin != planes else None

    def _n(self, x):
        return instance_norm(x) if self.norm == "instance" else x

    def forward(self, x):
        y = F.relu(self._n(self.conv1(x)))
        y = F.relu(self._n(self.conv2(y)))
        if self.downsample is not None:
            x = self._n(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT feature encoder at 1/8 resolution."""

    def __init__(self, output_dim: int = 128, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.conv1 = _conv(3, 64, 7, 2)
        self.layer1_0 = ResBlock(64, 64, 1, norm)
        self.layer1_1 = ResBlock(64, 64, 1, norm)
        self.layer2_0 = ResBlock(64, 96, 2, norm)
        self.layer2_1 = ResBlock(96, 96, 1, norm)
        self.layer3_0 = ResBlock(96, 128, 2, norm)
        self.layer3_1 = ResBlock(128, 128, 1, norm)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, img):
        x = self.conv1(img)
        if self.norm == "instance":
            x = instance_norm(x)
        x = F.relu(x)
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1",
                     "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        return self.conv2(x)


class ConvGRU(nn.Module):
    """ConvGRU with the global context gate."""

    def __init__(self, h_planes: int = 128, i_planes: int = 320):
        super().__init__()
        cin = h_planes + i_planes
        self.w = nn.Conv2d(h_planes, h_planes, 1)
        self.convz = _conv(cin, h_planes, 3)
        self.convz_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convr = _conv(cin, h_planes, 3)
        self.convr_glo = nn.Conv2d(h_planes, h_planes, 1)
        self.convq = _conv(cin, h_planes, 3)
        self.convq_glo = nn.Conv2d(h_planes, h_planes, 1)

    def forward(self, net, inp):
        net_inp = torch.cat([net, inp], 1)
        glo = (torch.sigmoid(self.w(net)) * net).mean((2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], 1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor,
                 factor: int = 8) -> torch.Tensor:
    """Convex upsampling. data (N, C, h, w); mask (N, 9 * factor^2, h, w),
    channel k * factor^2 + f (the JAX mask (N, h, w, 9, factor^2) moved
    to channels). Returns (N, C, h * factor, w * factor)."""
    N, C, h, w = data.shape
    m = torch.softmax(mask.reshape(N, 9, factor * factor, h, w), dim=1)
    pad = F.pad(data, (1, 1, 1, 1))
    patches = torch.stack([pad[:, :, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)], 1)
    up = torch.einsum("nkfhw,nkchw->ncfhw", m, patches)
    up = up.reshape(N, C, factor, factor, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, C, h * factor, w * factor)


class GraphAgg(nn.Module):
    """Per-frame aggregation of the edge states -> eta damping and the
    upsampling mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 128, 3)
        self.conv2 = _conv(128, 128, 3)
        self.eta_conv = _conv(128, 1, 3)
        self.upmask_conv = nn.Conv2d(128, 8 * 8 * 9, 1)

    def forward(self, net, ii, n_frames: int):
        x = F.relu(self.conv1(net))
        # mean over the edges that share a source frame
        seg = x.new_zeros((n_frames,) + x.shape[1:]).index_add(0, ii, x)
        cnt = x.new_zeros(n_frames).index_add(0, ii, x.new_ones(len(ii)))
        x = seg / torch.clamp(cnt, min=1.0)[:, None, None, None]
        x = F.relu(self.conv2(x))
        eta = F.softplus(grad_clip(self.eta_conv(x)))[:, 0]
        return 0.01 * eta, self.upmask_conv(x)


class UpdateModule(nn.Module):
    """Correlation and flow encoders, the GRU, the delta / weight heads."""

    def __init__(self, corr_planes: int = 4 * 49):
        super().__init__()
        self.corr_enc1 = nn.Conv2d(corr_planes, 128, 1)
        self.corr_enc2 = _conv(128, 128, 3)
        self.flow_enc1 = _conv(4, 128, 7)
        self.flow_enc2 = _conv(128, 64, 3)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta1 = _conv(128, 128, 3)
        self.delta2 = _conv(128, 2, 3)
        self.weight1 = _conv(128, 128, 3)
        self.weight2 = _conv(128, 2, 3)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow, ii, n_frames: int):
        c = F.relu(self.corr_enc2(F.relu(self.corr_enc1(corr))))
        f = F.relu(self.flow_enc2(F.relu(self.flow_enc1(flow))))
        net = self.gru(net, torch.cat([inp, c, f], 1))
        delta = grad_clip(self.delta2(F.relu(self.delta1(net))))
        weight = torch.sigmoid(grad_clip(self.weight2(
            F.relu(self.weight1(net)))))
        eta, upmask = self.agg(net, ii, n_frames)
        return net, delta, weight, eta, upmask


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DroidNet(nn.Module):
    """The full update network: fnet (128 channels, instance norm), cnet
    (256, no norm), the update operator; forward = ``num_steps`` GRU steps
    of 2 BA iterations each. Random weights: ``models.blocks.init_random``
    (fan-in-scaled convolutions, zero biases)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.fnet.conv1.weight.device

    def extract_features(self, images):
        """images (N, H, W, 3) in [0, 255] -> fmaps (N, 128, h, w), net
        (N, 128, h, w), inp (N, 128, h, w) at 1/8."""
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        x = _nchw((images / 255.0 - mean) / std)
        fmaps = self.fnet(x)
        net, inp = self.cnet(x).split(128, 1)
        return fmaps, torch.tanh(net), F.relu(inp)

    def forward(self, poses, images, disps, intrinsics, ii, jj, edge_valid,
                num_steps: int = 12, fixedp: int = 2):
        """poses (P, 7) w2c; images (P, H, W, 3); disps (P, h, w) and
        intrinsics (P, 4) at 1/8 resolution; ii / jj (E,) with the
        validity mask ``edge_valid``. Returns (poses, disps, residual
        (E, h, w, 2)) after the GRU / BA loop; the loop carry is detached
        between steps."""
        fmaps, net0, inp0 = self.extract_features(images)
        net = net0[ii]
        inp = inp0[ii]
        fm = _nhwc(fmaps)
        pyramid = build_corr_pyramid(fm[ii], fm[jj])
        ht, wd = disps.shape[-2:]
        coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
        n_frames = poses.shape[0]
        ev = edge_valid.to(disps.dtype)

        coords1, _ = projective_transform(poses, disps, intrinsics, ii, jj)
        target = coords1
        residual = None
        for _ in range(num_steps):
            poses, disps, net, target, coords1 = (
                t.detach() for t in (poses, disps, net, target, coords1))
            corr = corr_lookup(pyramid, coords1)
            resd = target - coords1
            flow = coords1 - coords0
            motion = torch.clamp(torch.cat([flow, resd], -1), -64.0, 64.0)
            net, delta, weight, eta, _ = self.update(
                net, inp, _nchw(corr), _nchw(motion), ii, n_frames)
            target = coords1 + _nhwc(delta)
            poses, disps, _ = bundle_adjust(
                target, _nhwc(weight), eta, poses, disps, intrinsics, ii, jj,
                ev, fixedp=fixedp, n_frames=n_frames, steps=2)
            coords1, vmask = projective_transform(poses, disps, intrinsics,
                                                  ii, jj)
            residual = vmask * (target - coords1)
        return poses, disps, residual
