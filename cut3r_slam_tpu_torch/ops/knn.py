"""Mean squared distance to the 3 nearest neighbors (port of
``cut3r_slam_tpu/ops/knn.py``): chunked pairwise distances + top-3, the
scale initialization of seeded Gaussians."""
from __future__ import annotations

import torch

__all__ = ["dist_to_3nn_sq"]


@torch.no_grad()
def dist_to_3nn_sq(points: torch.Tensor, valid: torch.Tensor = None,
                   chunk: int = 2048) -> torch.Tensor:
    """points (N, 3) -> (N,) mean squared distance to the 3 nearest valid
    neighbors; invalid points are excluded as neighbors and get 0."""
    N = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=dev)
    sq = (points * points).sum(-1)
    out = torch.zeros(N, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for s in range(0, N, chunk):
        q = points[s:s + chunk]
        d2 = sq[s:s + chunk, None] + sq[None, :] - 2.0 * (q @ points.T)
        d2 = torch.where(valid[None, :], d2, inf)
        idx = torch.arange(s, s + q.shape[0], device=dev)
        d2[torch.arange(q.shape[0], device=dev), idx] = inf   # self
        k = min(3, N)
        nn = -torch.topk(-d2, k, dim=1).values
        nn = torch.where(torch.isfinite(nn), torch.clamp(nn, min=0.0),
                         torch.zeros_like(nn))
        out[s:s + q.shape[0]] = nn.sum(1) / 3.0
    return torch.where(valid, out, torch.zeros_like(out))
