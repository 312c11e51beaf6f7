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


def rope_cos_sin(positions: torch.Tensor, half_dim: int, base: float = 100.0):
    """positions (..., N, 2) -> (cos, sin) of shape (..., N, 2, half_dim)."""
    assert half_dim % 2 == 0, "half of head_dim must be even"
    quarter = half_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, quarter, dtype=torch.float32,
                                            device=positions.device)
                                * 2.0 / half_dim))
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], -1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def apply_rope2d(tokens: torch.Tensor, positions: torch.Tensor,
                 base: float = 100.0) -> torch.Tensor:
    """tokens (B, H, N, D); positions (B, N, 2) int. Computed in f32, cast
    back to the token dtype."""
    dtype = tokens.dtype
    half = tokens.shape[-1] // 2
    cos, sin = rope_cos_sin(positions, half, base)      # (B, N, 2, half)
    t = tokens.float()
    ty, tx = t[..., :half], t[..., half:]
    cy, sy = cos[..., 0, :][:, None], sin[..., 0, :][:, None]
    cx, sx = cos[..., 1, :][:, None], sin[..., 1, :][:, None]
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], -1).to(dtype)
