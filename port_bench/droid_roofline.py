"""Operations and bytes of the DROID tracker's work, counted from shapes:
the encoders and the update operator by ``FlopCounterMode`` on the
reference network on the ``meta`` device (2 FLOPs a multiply-add), the
correlation pyramid's matrix product and the dense BA's matrix products
by formula; the lookup's least bytes. The peaks are ``peaks.py``'s."""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.droid import DroidNet

__all__ = ["encoder_flops", "update_flops", "pyramid_flops", "ba_flops",
           "lookup_bytes", "CORR_PLANES"]

CORR_PLANES = 4 * 49


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _meta():
    with torch.device("meta"):
        return DroidNet().requires_grad_(False)


@functools.lru_cache(maxsize=None)
def encoder_flops(H: int, W: int) -> tuple:
    """(fnet, cnet) operations on one (H, W) image."""
    net = _meta()
    x = torch.zeros(1, 3, H, W, device="meta")
    return _count(lambda: net.fnet(x)), _count(lambda: net.cnet(x))


@functools.lru_cache(maxsize=None)
def update_flops(h: int, w: int) -> tuple:
    """(per edge, per frame) operations of the update operator at an
    (h, w) grid: the correlation and flow encoders, the GRU, the delta and
    weight heads and the aggregation's first convolution run per edge; the
    aggregation's second convolution, eta and the upsampling mask per
    frame of the window."""
    u = _meta().update
    z = torch.zeros
    corr = z(1, CORR_PLANES, h, w, device="meta")
    flow = z(1, 4, h, w, device="meta")
    net = z(1, 128, h, w, device="meta")

    def edge():
        c = u.corr_enc2(u.corr_enc1(corr))
        f = u.flow_enc2(u.flow_enc1(flow))
        n = u.gru(net, torch.cat([net, c, f], 1))
        u.delta2(u.delta1(n))
        u.weight2(u.weight1(n))
        u.agg.conv1(n)

    def frame():
        x = u.agg.conv2(net)
        u.agg.eta_conv(x)
        u.agg.upmask_conv(x)
    return _count(edge), _count(frame)


def pyramid_flops(h: int, w: int, dim: int = 128) -> int:
    """One edge's all-pairs product (h w x dim x h w)."""
    return 2 * (h * w) ** 2 * dim


def ba_flops(edges: int, frames: int, fixed: int, hw: int,
             iters: int) -> int:
    """The dense BA's matrix products over ``iters`` iterations: per edge
    and pixel the Jacobians (2x4 x 4x6, 2x6 x 6x6, 2x4 x 4) and their
    weighted products into the pose blocks, the gradient and the pose-depth
    blocks; per iteration the Schur complement (6V x frames hw x 6V), its
    right-hand side, the Cholesky factor and solve, and the depth step."""
    v6 = 6 * (frames - fixed)
    m = frames * hw
    per_pixel = 2 * (2 * 4 * 6 + 2 * 6 * 6 + 2 * 4) \
        + 2 * (4 * 6 * 6 * 2 + 2 * 6 * 2 + 2 * 6 * 2 + 2 * 2)
    per_iter = edges * hw * per_pixel + 2 * v6 * v6 * m + 4 * v6 * m \
        + v6 ** 3 // 3 + 2 * v6 * v6
    return iters * per_iter


def lookup_bytes(edges: int, h: int, w: int, levels: int = 4,
                 radius: int = 3, elem: int = 2, out_elem: int = 2) -> int:
    """The least bytes of one lookup of ``edges`` edges: per pixel the
    distinct cells that a (2r+1)^2 bilinear window touches at each level,
    (2r+2)^2 or the whole level where it is smaller, read once in the
    pyramid's dtype; the coordinates in (2 float32); the window
    correlations out."""
    cells = sum(min((2 * radius + 2) ** 2, (h >> lvl) * (w >> lvl))
                for lvl in range(levels))
    per_px = cells * elem + 2 * 4 + levels * (2 * radius + 1) ** 2 \
        * out_elem
    return edges * h * w * per_px
