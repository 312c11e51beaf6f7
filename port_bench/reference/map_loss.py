"""The mapper's losses, plain: a frozen float32 copy of the window loss
and the global-BA loss of the port's Gaussian mapper (``slam/mapping.py``
``_window_loss`` and ``_gba_batch``), over the plain rasterizer of
``raster.py``, differentiated by autograd. It imports nothing of the
program.

Per view, on the rendered colour (after the view's exposure affine
``a``, ``b``), depth, normal and visibility against the keyframe's image
and depth:

- RGB: 0.8 L1 + 0.2 (1 - SSIM, 11-tap Gaussian window, sigma 1.5);
- depth: the inverse-depth L1 over pixels where both depths exceed 1e-3;
- normal: 1 - <normal of the rendered depth, normal of the keyframe's
  depth> over those pixels; the global BA adds the same term for the
  rendered normal;
- iso: each visible Gaussian's mean absolute departure of its three
  scales from their mean, averaged over the visible.

Window: sum of (rgb + 0.5 depth + 0.05 normal + 10 iso) x the view's
weight, over the weights' sum (at least 1). Global BA: per view rgb +
0.05 depth + 0.05 (normal + rendered normal) + 10 iso, differentiated
summed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import raster

__all__ = ["LAMBDA_DEPTH", "LAMBDA_NORMAL", "LAMBDA_ISO", "ssim",
           "depth_to_normal", "view_terms", "window_loss_grads",
           "gba_loss_grads"]

LAMBDA_DEPTH, LAMBDA_NORMAL, LAMBDA_ISO = 0.5, 0.05, 10.0


def _gauss(size, sigma, device, dtype):
    x = torch.arange(size, device=device, dtype=torch.float64) - size // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).to(dtype)


def ssim(a, b, window=11, sigma=1.5, c1=0.01 ** 2, c2=0.03 ** 2):
    """Mean SSIM of (H, W, C) images, same padding, per channel."""
    C = a.shape[-1]
    g = _gauss(window, sigma, a.device, a.dtype)
    k2 = (g[:, None] * g[None, :]).expand(C, 1, window, window)

    def blur(x):
        return F.conv2d(x.permute(2, 0, 1)[None], k2, padding=window // 2,
                        groups=C)[0].permute(1, 2, 0)

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) \
        / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def _unproject(depth, K4):
    H, W = depth.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, device=depth.device, dtype=depth.dtype),
        torch.arange(W, device=depth.device, dtype=depth.dtype),
        indexing="ij")
    return torch.stack([(gx - K4[2]) / K4[0] * depth,
                        (gy - K4[3]) / K4[1] * depth, depth], -1)


def depth_to_normal(depth, K4):
    """(H, W) depth -> (H, W, 3) normals from central differences of the
    camera-frame points; zero on the one-pixel border."""
    p = _unproject(depth, K4)
    dx = p[2:, 1:-1] - p[:-2, 1:-1]
    dy = p[1:-1, 2:] - p[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def view_terms(out, image, depth_gt, K4, log_scales, a, b):
    """One view's loss terms from its render ``out`` (colour, depth,
    normal, visibility of shape (H, W, ...) and (P,)): (rgb, depth,
    normal of the rendered depth, rendered normal, iso)."""
    img = out["color"] @ a + b
    rgb = 0.8 * torch.abs(image - img).mean() + 0.2 * (1 - ssim(img, image))
    d = out["depth"]
    gdn = depth_to_normal(depth_gt, K4)
    m = ((depth_gt > 1e-3) & (d > 1e-3)).detach()
    cnt = torch.clamp(m.sum().float(), min=1.0)
    inv = torch.where(m, 1 / torch.clamp(d, min=1e-6)
                      - 1 / torch.clamp(depth_gt, min=1e-6),
                      torch.zeros_like(d))
    depth_l = torch.abs(inv).sum() / cnt
    norm_l = ((1 - (depth_to_normal(d, K4) * gdn).sum(-1)) * m).sum() / cnt
    rn_l = ((1 - (out["normal"] * gdn).sum(-1)) * m).sum() / cnt
    s = torch.exp(log_scales)
    dev = torch.abs(s - s.mean(1, keepdim=True)).mean(1)
    vis = out["visibility"]
    iso = (dev * vis).sum() / torch.clamp(vis.sum().float(), min=1.0)
    return rgb, depth_l, norm_l, rn_l, iso


def _render(params, alive, w2c, K4, cfg, t, r, dtype, bins_from):
    return raster.render_views(
        params, alive, w2c[None], K4, cfg,
        None if t is None else t[None], None if r is None else r[None],
        dtype=dtype, bins_from=None if bins_from is None else [bins_from])


def _leaves(params, extra):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    e = {k: None if v is None else v.detach().clone().requires_grad_(True)
         for k, v in extra.items()}
    return p, e


def _accumulate(total, loss, leaves):
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    for acc, gi in zip(total, g):
        if gi is not None:
            acc += gi


def window_loss_grads(params, alive, w2cs, K4, cfg, images, depths,
                      weights, exposure, t=None, r=None, binned_at=None,
                      dtype=torch.float32):
    """The window loss of V views and its gradients by leaf: (loss,
    {name: gradient}) over the parameters, the exposure (``a`` (V, 3, 3),
    ``b`` (V, 3)) and, where given, the pose deltas ``t``, ``r`` (V, 3).
    ``binned_at``: per view the ``raster.camera_frame`` the program binned
    at, or None. One view at a time (the plain blend keeps every
    (tile, pixel, entry) intermediate for its backward)."""
    p, e = _leaves(params, {"t": t, "r": r, **exposure})
    names = list(p) + [k for k in ("t", "r", "a", "b") if e[k] is not None]
    leaves = list(p.values()) + [e[k] for k in names[len(p):]]
    grads = [torch.zeros_like(x) for x in leaves]
    norm = torch.clamp(weights.sum(), min=1.0)
    loss = 0.0
    for v in range(w2cs.shape[0]):
        with torch.enable_grad():
            out = {k: x[0] for k, x in _render(
                p, alive, w2cs[v], K4, cfg,
                None if e["t"] is None else e["t"][v],
                None if e["r"] is None else e["r"][v], dtype,
                None if binned_at is None else binned_at[v]).items()}
            rgb, dl, nl, _, iso = view_terms(out, images[v], depths[v], K4,
                                             p["log_scales"], e["a"][v],
                                             e["b"][v])
            lv = (rgb + LAMBDA_DEPTH * dl + LAMBDA_NORMAL * nl
                  + LAMBDA_ISO * iso) * weights[v] / norm
            _accumulate(grads, lv, leaves)
        loss = loss + float(lv.detach())
    return loss, dict(zip(names, grads))


def gba_loss_grads(params, alive, w2cs, K4, cfg, images, depths, exposure,
                   dtype=torch.float32):
    """The global-BA batch's per-view losses (V,) and the gradients of
    their sum by leaf: the parameters, the pose deltas ``t``, ``r`` (at
    zero) and the exposure ``a``, ``b``. Each view binned afresh."""
    V = w2cs.shape[0]
    zeros = torch.zeros(V, 3, device=w2cs.device)
    p, e = _leaves(params, {"t": zeros, "r": zeros, **exposure})
    names = list(p) + ["t", "r", "a", "b"]
    leaves = list(p.values()) + [e[k] for k in names[len(p):]]
    grads = [torch.zeros_like(x) for x in leaves]
    losses = []
    for v in range(V):
        with torch.enable_grad():
            out = {k: x[0] for k, x in _render(
                p, alive, w2cs[v], K4, cfg, e["t"][v], e["r"][v], dtype,
                None).items()}
            rgb, dl, nl, rn, iso = view_terms(out, images[v], depths[v], K4,
                                              p["log_scales"], e["a"][v],
                                              e["b"][v])
            lv = (rgb + LAMBDA_DEPTH / 10 * dl + LAMBDA_NORMAL * (nl + rn)
                  + LAMBDA_ISO * iso)
            _accumulate(grads, lv, leaves)
        losses.append(float(lv.detach()))
    return torch.tensor(losses, dtype=torch.float64), dict(zip(names, grads))
