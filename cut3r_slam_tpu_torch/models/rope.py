"""2D rotary position embedding (RoPE2D), plain PyTorch (port of
``cut3r_slam_tpu/models/rope.py``).

The head dim D splits in two halves: the first rotates by the token's
**y** position, the second by its **x** position; within a half of size
Dh the frequencies are ``1 / base**(2i/Dh)`` in the "rotate_half" layout.
Angles come straight from the position value (the pose token's -1
included), computed in float32 whatever the token dtype.
"""
from __future__ import annotations

import torch

__all__ = ["rope_cos_sin", "apply_rope2d"]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 if it is float64 already (the f32
    islands of the model stay f32 but keep a float64 model float64)."""
    return x if x.dtype == torch.float64 else x.float()


def promoted_dtype(dtype: torch.dtype, weight: torch.Tensor) -> torch.dtype:
    """A module's compute dtype: its own, or float64 for float64 weights
    (a float64 model computes in float64 throughout)."""
    return torch.float64 if weight.dtype == torch.float64 else dtype


def rope_cos_sin(positions: torch.Tensor, half_dim: int, base: float = 100.0,
                 dtype: torch.dtype = torch.float32):
    """positions (..., N, 2) -> (cos, sin) of shape (..., N, 2, half_dim),
    in ``dtype``."""
    assert half_dim % 2 == 0, "half of head_dim must be even"
    quarter = half_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, quarter, dtype=dtype,
                                            device=positions.device)
                                * 2.0 / half_dim))
    ang = positions.to(dtype)[..., None] * inv_freq
    ang = torch.cat([ang, ang], -1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def apply_rope2d(tokens: torch.Tensor, positions: torch.Tensor,
                 base: float = 100.0) -> torch.Tensor:
    """tokens (B, H, N, D); positions (B, N, 2) int. Computed in f32 (f64
    for f64 tokens), cast back to the token dtype."""
    dtype = tokens.dtype
    half = tokens.shape[-1] // 2
    t = at_least_f32(tokens)
    cos, sin = rope_cos_sin(positions, half, base, t.dtype)  # (B, N, 2, half)
    ty, tx = t[..., :half], t[..., half:]
    cy, sy = cos[..., 0, :][:, None], sin[..., 0, :][:, None]
    cx, sx = cos[..., 1, :][:, None], sin[..., 1, :][:, None]
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], -1).to(dtype)
