"""Transformer building blocks (port of ``cut3r_slam_tpu/models/blocks.py``):
Mlp, Attention / CrossAttention (optional RoPE2D on q/k), Block,
DecoderBlock, and ModLN / ConditionModulationBlock (adaLN conditioning on
the pose token, used by the DPT cross head). Module and parameter names
follow the upstream torch state_dict (``attn.qkv``, ``cross_attn.projq``,
``norm_y``, ``mlp.fc1``...).

Numerics follow the JAX model's flax dtypes: weights are stored f32 and
each Linear casts its input and weights to ``dtype`` (bf16 on the card at
inference, f32 in the CPU parity tests); LayerNorm computes and returns
f32; RoPE runs in f32. A model with f64 weights computes in f64 throughout
(``rope.promoted_dtype`` / ``at_least_f32``: the float64 oracle of
tests/test_torch_f64_oracle.py). Attention is
``F.scaled_dot_product_attention`` at inference and the explicit softmax
where a backward runs or a read has one query, on both devices
(``_sdpa``; the JAX package uses ``jax.nn.dot_product_attention``, not a
Pallas kernel).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .rope import apply_rope2d, at_least_f32, promoted_dtype

__all__ = ["Linear", "LayerNorm", "Mlp", "Attention", "CrossAttention",
           "Block", "DecoderBlock", "ModLN", "ConditionModulationBlock",
           "init_random"]


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator,
                std: float = 0.02, late=()):
    """Random weights for ``model`` from ``generator``: normal(std) linear
    and embedding weights and tokens, zero biases, unit norms, fan-in-
    scaled convolutions. Drawn in ``named_parameters`` order, the
    parameters whose names start with a ``late`` prefix last (so that a
    seed gives the other parameters the same tensors as before those
    existed). Returns ``model``."""
    named = list(model.named_parameters())
    is_late = [n.startswith(tuple(late)) for n, _ in named]
    for _, (name, p) in sorted(zip(is_late, named), key=lambda t: t[0]):
        leaf = name.rsplit(".", 1)[-1]
        mod = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = p[0].numel() if isinstance(mod, nn.Conv2d) \
                else p.shape[0] * p.shape[2] * p.shape[3]
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
        else:
            p.normal_(0.0, std, generator=generator)
    return model


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (inputs and weights cast)."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = promoted_dtype(self.compute_dtype, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm(eps=1e-6) computed and returned in f32 (f64 for f64
    inputs)."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(at_least_f32(x), self.normalized_shape,
                            self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, in_dim, hidden_dim, out_dim=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim or in_dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _softmax_read(q, k, v, scale):
    """The explicit softmax(q k^T scale) v of the JAX model, the softmax in
    f32 (f64 for f64 inputs)."""
    s = (q @ k.transpose(-2, -1)) * scale
    return torch.softmax(s, -1, dtype=at_least_f32(s).dtype).to(v.dtype) @ v


class _OneQueryRead(torch.autograd.Function):
    """``_softmax_read`` for one query, its backward recomputed in float64.
    The q / k gradient of a one-query read (the pose retriever's) is a
    difference of nearly equal terms: in f32 it lay 3.07x further from a
    float64 oracle than the JAX package's (tests/test_torch_f64_oracle.py),
    the largest ratio of any tensor; in float64 it costs next to nothing.
    The forward is the f32 read's, so inference is unchanged."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _softmax_read(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
        p = torch.softmax((qd @ kd.transpose(-2, -1)) * ctx.scale, -1)
        dp = gd @ vd.transpose(-2, -1)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * ctx.scale
        return ((ds @ kd).to(q.dtype), (ds.transpose(-2, -1) @ qd).to(k.dtype),
                (p.transpose(-2, -1) @ gd).to(v.dtype), None)


def _sdpa(q, k, v, scale):
    """Softmax attention, keyed to the read, the same on both devices. A
    read with one query (the pose retriever's) is ``_OneQueryRead``; a
    read that a backward will run through computes the explicit softmax of
    the JAX model; any other read (inference) takes the fused kernel.
    Against a float64 oracle (tests/test_torch_f64_oracle.py,
    scripts/f64_oracle_card.py): on the card the fused backward left the
    pose retriever's one-query q / k weight gradients up to 8.35x further
    off than the JAX package's."""
    if q.shape[-2] == 1:
        return _OneQueryRead.apply(q, k, v, scale)
    if not (q.requires_grad or k.requires_grad or v.requires_grad):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)
    return _softmax_read(q, k, v, scale)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, use_rope=False, rope_base=100.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.rope_base = rope_base
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, xpos):
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.use_rope and xpos is not None:
            q = apply_rope2d(q, xpos, self.rope_base)
            k = apply_rope2d(k, xpos, self.rope_base)
        out = _sdpa(q, k, v, D ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, use_rope=False, rope_base=100.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.rope_base = rope_base
        self.projq = Linear(dim, dim, dtype=dtype)
        self.projk = Linear(dim, dim, dtype=dtype)
        self.projv = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, query, key, value, qpos, kpos):
        B, Nq, C = query.shape
        Nk = key.shape[1]
        H = self.num_heads
        D = C // H
        if Nk == 1:
            # one key: the softmax is exactly 1, every query reads the one
            # value, and q / k get exactly zero gradient (as in the JAX
            # model's softmax; a fused attention's backward leaves
            # rounding noise there, which Adam would turn into steps)
            v = self.projv(value)
            return self.proj(v.expand(B, Nq, C))
        q = self.projq(query).reshape(B, Nq, H, D).transpose(1, 2)
        k = self.projk(key).reshape(B, Nk, H, D).transpose(1, 2)
        v = self.projv(value).reshape(B, Nk, H, D).transpose(1, 2)
        if self.use_rope:
            if qpos is not None:
                q = apply_rope2d(q, qpos, self.rope_base)
            if kpos is not None:
                k = apply_rope2d(k, kpos, self.rope_base)
        out = _sdpa(q, k, v, D ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, Nq, C))


class Block(nn.Module):
    """Pre-norm self-attention block (encoder)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_rope, rope_base, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attn + cross-attn + MLP; returns (x, y) like the reference."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_rope, rope_base, dtype)
        self.norm_y = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, use_rope, rope_base,
                                         dtype)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, y, xpos: Optional[torch.Tensor],
                ypos: Optional[torch.Tensor]):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        x = x + self.mlp(self.norm3(x))
        return x, y


class ModLN(nn.Module):
    """adaLN modulation: LayerNorm(x) * (1 + scale) + shift, with
    (shift, scale) = Linear(SiLU(mod)) split in two. ``mod`` is (B, C)."""

    def __init__(self, dim, mod_dim=None, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.mlp = nn.Sequential(nn.SiLU(), Linear(mod_dim or dim, 2 * dim,
                                                   dtype=dtype))

    def forward(self, x, mod):
        shift, scale = self.mlp(mod).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class ConditionModulationBlock(nn.Module):
    """Self-attention block whose two norms are ``ModLN`` conditioned on a
    pose token."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = ModLN(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, use_rope, rope_base, dtype)
        self.norm2 = ModLN(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x, mod, xpos):
        x = x + self.attn(self.norm1(x, mod), xpos)
        return x + self.mlp(self.norm2(x, mod))
