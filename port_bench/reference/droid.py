"""DROID-SLAM of the benchmark's reference (Teed & Deng, "DROID-SLAM: Deep
Visual SLAM for Monocular, Stereo, and RGB-D Cameras", NeurIPS 2021,
arXiv:2108.10869): the feature and context encoders, the all-pairs
correlation volume with its 4-level pyramid and windowed lookup, the
update operator (correlation and flow encoders, the ConvGRU with its
global gate, the delta and weight heads, the graph aggregation of eta and
the upsampling mask) and the dense bundle adjustment (per-pixel
Jacobians, the Schur complement on the depths, a Cholesky solve).
Parameter names are the port's, so one state_dict loads into both.

Plain PyTorch in float32 with TF32 off (``full_f32``); it imports nothing
of the program. ``dense_ba`` also runs in float64 (``dtype``): the check
measures the BA's float32 step against that. ``low=True`` is the
control's knob: the encoders and the update operator under bfloat16
autocast, the pyramid stored in bfloat16, the BA's per-pixel Jacobians,
residuals and weights and its assembled normal equations (the pose
Hessian and gradient, the pose-depth blocks, the depth diagonal and
gradient) rounded to bfloat16 around its float32 products and float32
solve: the precision below the configuration's float16 for the network
and below float32 for the BA.

Departures from the published description, each the program's own:
- instance norm with eps 1e-6 (the JAX package's flax ``GroupNorm``; the
  public code's ``nn.InstanceNorm2d`` uses 1e-5);
- the BA damps the pose Hessian before the Schur complement (``ep`` +
  ``lm`` x its diagonal) where the public code's sparse solver damps the
  reduced system, and solves in float32 with a dense Cholesky where the
  public code uses float64 (Eigen); a failed factorization gives a zero
  pose step; disparities above 10 after a step are set to 0, then all
  are clamped at 0.001;
- the lookup's window is dy-major (taps (dy, dx) with dy outer), levels
  concatenated, as the JAX package lays it out.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["DroidNet", "draw_state_dict", "full_f32", "pyramid", "lookup",
           "dense_ba", "reproject", "coords_grid", "low_precision",
           "quat_to_rot"]

MIN_DEPTH = 0.2


@contextlib.contextmanager
def full_f32():
    """Float32 products and convolutions at float32 accuracy (no TF32)
    inside the block; the caller's settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def low_precision(device, low: bool):
    """bfloat16 autocast on ``device`` where ``low``, else nothing."""
    if not low:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16)


def _bf16(x, low):
    return x.to(torch.bfloat16).float() if low else x


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def instance_norm(x, eps=1e-6):
    x = x.float()
    mu = x.mean((2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean((2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


class ResBlock(nn.Module):
    def __init__(self, cin, planes, stride, norm):
        super().__init__()
        self.norm = norm
        self.conv1 = _conv(cin, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
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


class Encoder(nn.Module):
    """RAFT's encoder: a 7x7 stride-2 stem, three stages of two residual
    blocks (64, 96 stride 2, 128 stride 2), a 1x1 projection: 1/8 of the
    image."""

    def __init__(self, out_dim, norm):
        super().__init__()
        self.norm = norm
        self.conv1 = _conv(3, 64, 7, 2)
        for name, (cin, c, s) in {
                "layer1_0": (64, 64, 1), "layer1_1": (64, 64, 1),
                "layer2_0": (64, 96, 2), "layer2_1": (96, 96, 1),
                "layer3_0": (96, 128, 2), "layer3_1": (128, 128, 1)}.items():
            setattr(self, name, ResBlock(cin, c, s, norm))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = self.conv1(x)
        if self.norm == "instance":
            x = instance_norm(x)
        x = F.relu(x)
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1",
                     "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        return self.conv2(x)


class ConvGRU(nn.Module):
    def __init__(self, h=128, i=320):
        super().__init__()
        self.w = nn.Conv2d(h, h, 1)
        self.convz = _conv(h + i, h, 3)
        self.convz_glo = nn.Conv2d(h, h, 1)
        self.convr = _conv(h + i, h, 3)
        self.convr_glo = nn.Conv2d(h, h, 1)
        self.convq = _conv(h + i, h, 3)
        self.convq_glo = nn.Conv2d(h, h, 1)

    def forward(self, h, x):
        glo = (torch.sigmoid(self.w(h)) * h).mean((2, 3), keepdim=True)
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(hx) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1))
                       + self.convq_glo(glo))
        return (1 - z) * h + z * q


class GraphAgg(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 128, 3)
        self.conv2 = _conv(128, 128, 3)
        self.eta_conv = _conv(128, 1, 3)
        self.upmask_conv = nn.Conv2d(128, 8 * 8 * 9, 1)

    def forward(self, net, ii, n_frames):
        x = F.relu(self.conv1(net))
        frames = []
        for f in range(n_frames):     # the mean over a frame's edges
            sel = (ii == f).nonzero()[:, 0]
            frames.append(x[sel].mean(0) if len(sel) else
                          torch.zeros_like(x[0]))
        x = F.relu(self.conv2(torch.stack(frames)))
        eta = 0.01 * F.softplus(self.eta_conv(x).float())[:, 0]
        return eta, self.upmask_conv(x)


class Update(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_enc1 = nn.Conv2d(4 * 49, 128, 1)
        self.corr_enc2 = _conv(128, 128, 3)
        self.flow_enc1 = _conv(4, 128, 7)
        self.flow_enc2 = _conv(128, 64, 3)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta1 = _conv(128, 128, 3)
        self.delta2 = _conv(128, 2, 3)
        self.weight1 = _conv(128, 128, 3)
        self.weight2 = _conv(128, 2, 3)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow, ii, n_frames):
        """net, inp (E, 128, h, w); corr (E, 196, h, w); flow (E, 4, h, w);
        ii (E,) source frames in [0, n_frames). Returns (net, delta (E, 2,
        h, w), weight, eta (n_frames, h, w), upmask)."""
        c = F.relu(self.corr_enc2(F.relu(self.corr_enc1(corr))))
        f = F.relu(self.flow_enc2(F.relu(self.flow_enc1(flow))))
        net = self.gru(net, torch.cat([inp, c, f], 1))
        delta = self.delta2(F.relu(self.delta1(net)))
        weight = torch.sigmoid(self.weight2(F.relu(self.weight1(net))))
        eta, up = self.agg(net, ii, n_frames)
        return net, delta, weight, eta, up


class DroidNet(nn.Module):
    """fnet (128, instance norm), cnet (256, no norm), the update
    operator."""

    def __init__(self):
        super().__init__()
        self.fnet = Encoder(128, "instance")
        self.cnet = Encoder(256, "none")
        self.update = Update()

    def encode(self, images):
        """(N, H, W, 3) uint8 or [0, 255] -> fmap, net (tanh), inp (relu),
        each (N, 128, H / 8, W / 8)."""
        mean = torch.tensor((0.485, 0.456, 0.406), device=images.device)
        std = torch.tensor((0.229, 0.224, 0.225), device=images.device)
        x = ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        fmap = self.fnet(x)
        net, inp = self.cnet(x).split(128, 1)
        return fmap, torch.tanh(net), F.relu(inp)


@torch.no_grad()
def draw_state_dict(seed: int, device, scale=None, assign=None):
    """{name: float32 tensor} of every parameter, from ``seed``: each
    convolution's weight normal with standard deviation fan_in^-1/2,
    biases zero (the port's ``init_random`` scheme), all from ONE
    ``torch.randn`` sliced in the order of the names; then ``scale`` (a
    gain by name) and ``assign`` (values by name)."""
    with torch.device("meta"):
        model = DroidNet()
    named = sorted(model.named_parameters())
    total = sum(p.numel() for n, p in named if not n.endswith("bias"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, p in named:
        if name.endswith("bias"):
            out[name] = torch.zeros(p.shape, device=device)
            continue
        n = p.numel()
        out[name] = flat[off:off + n].view(p.shape).mul_(p[0].numel()
                                                         ** -0.5)
        off += n
    for name, gain in (scale or {}).items():
        out[name].mul_(gain)
    for name, value in (assign or {}).items():
        out[name].copy_(torch.as_tensor(value, device=device))
    return out


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------
def pyramid(fmap1, fmap2, levels=4, low=False):
    """fmap1, fmap2 (E, C, h, w) -> [(E, h w, h / 2^l, w / 2^l)]: the dot
    products of every pixel pair over 16 (each map / 4), average-pooled
    2x2 level by level (floor sizes); bfloat16-rounded where ``low``."""
    E, C, h, w = fmap1.shape
    a = fmap1.float().reshape(E, C, h * w).transpose(1, 2)
    b = fmap2.float().reshape(E, C, h * w)
    if low:
        a, b = _bf16(a, True), _bf16(b, True)
    vol = torch.bmm(a / 4.0, b / 4.0).reshape(E * h * w, 1, h, w)
    out = []
    for lvl in range(levels):
        if lvl:
            vol = F.avg_pool2d(vol, 2, stride=2)
        out.append(_bf16(vol, low).reshape(E, h * w, vol.shape[-2],
                                           vol.shape[-1]))
    return out


def lookup(pyr, coords, radius=3):
    """coords (E, h, w, 2) pixels (x, y) -> (E, h, w, levels x (2r+1)^2):
    at level l the window around coords / 2^l, each tap bilinear from its
    four neighbouring cells (cells outside the volume read 0)."""
    E, h, w, _ = coords.shape
    offs = torch.arange(-radius, radius + 1, device=coords.device,
                        dtype=torch.float32)
    out = []
    for lvl, vol in enumerate(pyr):
        hl, wl = vol.shape[-2:]
        flat = vol.reshape(E, h * w, hl * wl)
        c = coords.float().reshape(E, h * w, 1, 2) / 2 ** lvl
        taps = []
        for dy in offs:
            for dx in offs:
                x, y = c[..., 0] + dx, c[..., 1] + dy
                x0, y0 = torch.floor(x), torch.floor(y)
                acc = torch.zeros_like(x)
                for cy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
                    for cx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
                        inside = (cx >= 0) & (cx <= wl - 1) & (cy >= 0) \
                            & (cy <= hl - 1)
                        k = (cy.clamp(0, hl - 1) * wl
                             + cx.clamp(0, wl - 1)).long()
                        v = torch.gather(flat, 2, k).float()
                        acc = acc + torch.where(inside, v * wx * wy,
                                                torch.zeros_like(v))
                taps.append(acc[..., 0])
        out.append(torch.stack(taps, -1))
    return torch.cat(out, -1).reshape(E, h, w, -1)


# ---------------------------------------------------------------------------
# geometry and the dense BA (rotation matrices throughout)
# ---------------------------------------------------------------------------
def coords_grid(h, w, device, dtype=torch.float32):
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=dtype),
                          torch.arange(w, device=device, dtype=dtype),
                          indexing="ij")
    return torch.stack([x, y], -1)


def quat_to_rot(q):
    """(..., 4) quaternions [x, y, z, w] (normalized here) -> (..., 3, 3)."""
    q = q / q.norm(dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def pose_mats(poses, dtype=torch.float32):
    """(P, 7) [t, q xyzw] -> (P, 4, 4) in ``dtype``."""
    M = torch.zeros(poses.shape[0], 4, 4, device=poses.device, dtype=dtype)
    M[:, :3, :3] = quat_to_rot(poses[:, 3:7].to(dtype))
    M[:, :3, 3] = poses[:, :3].to(dtype)
    M[:, 3, 3] = 1.0
    return M


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1).reshape(
                            v.shape[:-1] + (3, 3))


def _exp(xi):
    """se(3) [tau, phi] (P, 6) -> (P, 4, 4): Rodrigues' rotation and the
    left Jacobian on the translation."""
    tau, phi = xi[:, :3].double(), xi[:, 3:].double()
    th = phi.norm(dim=-1)[:, None, None]
    K = _skew(phi)
    small = th < 1e-8
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(th_s) / th_s)
    b = torch.where(small, torch.full_like(th, 0.5),
                    (1 - torch.cos(th_s)) / th_s ** 2)
    c = torch.where(small, torch.full_like(th, 1 / 6),
                    (th_s - torch.sin(th_s)) / th_s ** 3)
    eye = torch.eye(3, dtype=torch.float64, device=xi.device)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    G = torch.zeros(xi.shape[0], 4, 4, dtype=torch.float64, device=xi.device)
    G[:, :3, :3] = R
    G[:, :3, 3] = (V @ tau[..., None])[..., 0]
    G[:, 3, 3] = 1.0
    return G.to(xi.dtype)


def reproject(G, disps, intr, ii, jj, jacobians=False):
    """G (P, 4, 4) world-to-camera; disps (P, h, w); intr (P, 4); edges
    (ii, jj). Returns coords (E, h, w, 2), valid (E, h, w) and with
    ``jacobians`` (Ji, Jj (E, h w, 2, 6), Jz (E, h w, 2))."""
    E = ii.shape[0]
    h, w = disps.shape[-2:]
    dt = disps.dtype
    grid = coords_grid(h, w, disps.device, dt).reshape(1, h * w, 2)
    Gij = G[jj] @ torch.linalg.inv(G[ii])
    R, t = Gij[:, :3, :3], Gij[:, :3, 3]
    fi, fj = intr[ii].to(dt), intr[jj].to(dt)
    p = torch.stack([(grid[..., 0] - fi[:, 2:3]) / fi[:, 0:1],
                     (grid[..., 1] - fi[:, 3:4]) / fi[:, 1:2],
                     torch.ones(E, h * w, device=disps.device, dtype=dt)], -1)
    d = disps[ii].reshape(E, h * w)
    X = p @ R.transpose(1, 2) + d[..., None] * t[:, None]
    Z = X[..., 2]
    valid = (Z > MIN_DEPTH).to(dt)
    Zs = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    u = fj[:, 0:1] * X[..., 0] / Zs + fj[:, 2:3]
    v = fj[:, 1:2] * X[..., 1] / Zs + fj[:, 3:4]
    coords = torch.stack([u, v], -1).reshape(E, h, w, 2)
    if not jacobians:
        return coords, valid.reshape(E, h, w)
    fx, fy = fj[:, 0:1], fj[:, 1:2]
    zero = torch.zeros_like(Z)
    # d(u, v) / d(X, Y, Z)
    Jp = torch.stack([torch.stack([fx / Zs, zero, -fx * X[..., 0] / Zs ** 2],
                                  -1),
                      torch.stack([zero, fy / Zs, -fy * X[..., 1] / Zs ** 2],
                                  -1)], -2)               # (E, n, 2, 3)
    # d(X, Y, Z) / d(tau, phi) of exp(xi) applied to the point (p, d)
    Ja = torch.cat([d[..., None, None] * torch.eye(3, device=d.device,
                                                   dtype=dt),
                    -_skew(X)], -1)                       # (E, n, 3, 6)
    Jj = Jp @ Ja
    Ad = torch.zeros(E, 6, 6, device=d.device, dtype=dt)
    Ad[:, :3, :3] = R
    Ad[:, :3, 3:] = _skew(t) @ R
    Ad[:, 3:, 3:] = R
    Ji = -Jj @ Ad[:, None]
    Jz = (Jp @ t[:, None, :, None])[..., 0]
    return coords, valid.reshape(E, h, w), (Ji, Jj, Jz)


@torch.no_grad()
def dense_ba(target, weight, eta, poses, disps, intr, ii, jj, fixedp,
             iters=2, lm=1e-4, ep=0.1, low=False, dtype=torch.float32):
    """Dense BA over P frames (the first ``fixedp`` poses fixed; every
    frame's disparities variables): residual target - coords on the valid
    pixels, weight 0.001 x the confidence; a damped Gauss-Newton step by
    the Schur complement on the (diagonal) disparity block; ``iters``
    steps, in ``dtype``. Returns (P, 4, 4) world-to-camera poses and (P, h,
    w) disparities."""
    G = pose_mats(poses, dtype)
    disps = disps.to(dtype).clone()
    target, weight, eta, intr = (x.to(dtype) for x in (target, weight, eta,
                                                        intr))
    P, h, w = disps.shape
    n = h * w
    E = ii.shape[0]
    V = P - fixedp
    for _ in range(iters):
        coords, valid, (Ji, Jj, Jz) = reproject(G, disps, intr, ii, jj, True)
        r = ((target - coords) * valid[..., None]).reshape(E, n, 2)
        wt = (0.001 * weight * valid[..., None]).reshape(E, n, 2)
        Ji, Jj, Jz, r, wt = (_bf16(x, low) for x in (Ji, Jj, Jz, r, wt))
        z = dict(device=disps.device, dtype=dtype)
        H = torch.zeros(V * 6, V * 6, **z)
        g = torch.zeros(V * 6, **z)
        Em = torch.zeros(V * 6, P * n, **z)
        C = eta.reshape(P * n) + 1e-7
        wz = torch.zeros(P * n, **z)
        for e in range(E):
            i, j = int(ii[e]), int(jj[e])
            blocks = {i: Ji[e], j: Jj[e]}
            WJz = wt[e] * Jz[e]                              # (n, 2)
            C[i * n:(i + 1) * n] += (WJz * Jz[e]).sum(-1)
            wz[i * n:(i + 1) * n] += (WJz * r[e]).sum(-1)
            for a, Ja_ in blocks.items():
                if a < fixedp:
                    continue
                ra = slice((a - fixedp) * 6, (a - fixedp + 1) * 6)
                WJa = wt[e][..., None] * Ja_                 # (n, 2, 6)
                g[ra] += torch.einsum("nkc,nk->c", WJa, r[e])
                Em[ra, i * n:(i + 1) * n] += torch.einsum(
                    "nkc,nk->cn", WJa, Jz[e])
                for b, Jb in blocks.items():
                    if b < fixedp:
                        continue
                    rb = slice((b - fixedp) * 6, (b - fixedp + 1) * 6)
                    H[ra, rb] += torch.einsum("nkc,nkd->cd", WJa, Jb)
        H, g, Em, C, wz = (_bf16(x, low) for x in (H, g, Em, C, wz))
        H = H + torch.diag(ep + lm * torch.diagonal(H))
        Q = 1.0 / C
        EQ = Em * Q
        S = H - EQ @ Em.T
        L, info = torch.linalg.cholesky_ex(S)
        dx = torch.cholesky_solve((g - EQ @ wz)[:, None], L)[:, 0]
        if int(info) != 0 or not bool(torch.isfinite(dx).all()):
            dx = torch.zeros_like(dx)
        dz = Q * (wz - Em.T @ dx)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        if V:
            G = torch.cat([G[:fixedp], _exp(dx.reshape(V, 6)) @ G[fixedp:]])
        disps = disps + dz.reshape(P, h, w)
        disps = torch.where(disps > 10, torch.zeros_like(disps), disps)
        disps = torch.clamp(disps, min=0.001)
    return G, disps
