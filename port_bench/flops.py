"""Operations of CUT3R's calls, counted from shapes: the benchmark's
reference model runs on the ``meta`` device (no data, no time) under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products, attention products and convolutions (2 FLOPs a
multiply-add) of the forward and, where asked, the backward."""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.cut3r import CUT3R
from .weights import reference_config

__all__ = ["encode_flops", "decode_flops", "train_step_flops"]


def _meta_model(widths, grad=False):
    with torch.device("meta"):
        model = CUT3R(reference_config(widths))
    return model.requires_grad_(grad)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _encode(widths_items, H, W):
    model = _meta_model(dict(widths_items))
    img = torch.zeros(1, H, W, 3, device="meta")
    return _count(lambda: model.encode_image(img))


@functools.lru_cache(maxsize=None)
def _decode(widths_items, H, W, V, heads):
    widths = dict(widths_items)
    model = _meta_model(widths)
    p = model.cfg.patch_size
    n = (H // p) * (W // p)
    feat = torch.zeros(V, 1, n, model.cfg.enc_embed_dim, device="meta")
    gy, gx = torch.meshgrid(torch.arange(H // p, device="meta"),
                            torch.arange(W // p, device="meta"),
                            indexing="ij")
    pos = torch.stack([gy, gx], -1).reshape(1, 1, n, 2).expand(V, 1, n, 2)
    return _count(lambda: model.decode_views(feat, pos, H, W, heads))


@functools.lru_cache(maxsize=None)
def _train(widths_items, H, W, V, B):
    model = _meta_model(dict(widths_items), grad=True)
    imgs = torch.zeros(V, B, H, W, 3, device="meta")

    def step():
        out = model(imgs)
        sum(o.sum() for o in out.values()).backward()
    return _count(step)


def encode_flops(widths: dict, H: int, W: int) -> int:
    """One image through the ViT encoder."""
    return _encode(tuple(sorted(widths.items())), H, W)


def decode_flops(widths: dict, H: int, W: int, V: int,
                 heads=("self", "pose")) -> int:
    """V views' tokens through the recurrent decoder and ``heads``."""
    return _decode(tuple(sorted(widths.items())), H, W, V, tuple(heads))


def train_step_flops(widths: dict, H: int, W: int, V: int, B: int) -> int:
    """A training step's forward (every head) and backward, V views of B
    sequences (the loss and the optimizer are elementwise: not counted)."""
    return _train(tuple(sorted(widths.items())), H, W, V, B)
