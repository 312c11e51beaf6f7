"""The mapper's Adam, plain: moments updated in place, float32 bias
corrections, parameters moved by lr * m_hat / (sqrt(v_hat) + eps)."""
from __future__ import annotations

import torch

__all__ = ["adam_step"]


@torch.no_grad()
def adam_step(params, grads, m, v, t, lrs, b1=0.9, b2=0.999, eps=1e-8):
    """One step from step count ``t`` (the count before it) on dicts of
    tensors; returns the new parameters (new tensors; inputs unchanged)."""
    c = torch.tensor(float(t + 1), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
    out = {}
    for k, p in params.items():
        g = grads[k]
        mk = m[k] * b1 + (1 - b1) * g
        vk = v[k] * b2 + (1 - b2) * g * g
        out[k] = p - lrs[k] * (mk / bc1) / (torch.sqrt(vk / bc2) + eps)
    return out
