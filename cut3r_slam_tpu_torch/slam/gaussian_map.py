"""Gaussian map: fixed-capacity arena with masked densify/split/clone/prune
(port of ``cut3r_slam_tpu/slam/gaussian_map.py``).

The arena keeps the JAX package's design: fixed capacity with an alive
mask, children written into the LOWEST free slots (so the alive set stays
a prefix, with holes from pruning), Adam moments zeroed at reallocated
slots by the caller. Parameterization: log-scales, inverse-sigmoid
opacity, wxyz quaternions, SH degree 0. Functions here update the arena
in place (the JAX versions donate it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.knn import dist_to_3nn_sq
from ..ops.gs_raster import quat_wxyz_to_matrix

__all__ = ["GaussianArena", "seed_from_pointmap", "densify_and_prune",
           "RGB2SH", "SH2RGB", "last_alive_bound"]

SH_C0 = 0.28209479177387814
# seeded colors are inset by half a u8 step from [0, 1] so no Gaussian
# starts exactly on the renderer's clip(SH2RGB, 0) boundary
_COLOR_INSET = 1.0 / 510.0


def RGB2SH(rgb):
    return (torch.clamp(rgb, _COLOR_INSET, 1.0 - _COLOR_INSET) - 0.5) / SH_C0


def SH2RGB(sh):
    return sh * SH_C0 + 0.5


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


PARAM_KEYS = ("xyz", "f_dc", "opacity_logit", "log_scales", "quat")


@dataclasses.dataclass
class GaussianArena:
    """All fields (capacity, ...); ``alive`` masks real Gaussians."""
    xyz: torch.Tensor            # (N, 3) world
    f_dc: torch.Tensor           # (N, 3) SH degree-0 coeffs
    opacity_logit: torch.Tensor  # (N,)
    log_scales: torch.Tensor     # (N, 3)
    quat: torch.Tensor           # (N, 4) wxyz
    alive: torch.Tensor          # (N,) bool
    kf_id: torch.Tensor          # (N,) int32 submap id
    n_obs: torch.Tensor          # (N,) int32
    grad_accum: torch.Tensor     # (N,) densification statistics
    grad_accum_abs: torch.Tensor
    denom: torch.Tensor
    max_radii: torch.Tensor

    @staticmethod
    def empty(capacity: int, device) -> "GaussianArena":
        def z(*s, dtype=torch.float32):
            return torch.zeros(*s, dtype=dtype, device=device)
        return GaussianArena(
            xyz=z(capacity, 3), f_dc=z(capacity, 3),
            opacity_logit=torch.full((capacity,), -10.0, device=device),
            log_scales=torch.full((capacity, 3), -10.0, device=device),
            quat=torch.tensor([[1.0, 0, 0, 0]], device=device).repeat(
                capacity, 1),
            alive=z(capacity, dtype=torch.bool),
            kf_id=z(capacity, dtype=torch.int32),
            n_obs=z(capacity, dtype=torch.int32),
            grad_accum=z(capacity), grad_accum_abs=z(capacity),
            denom=z(capacity), max_radii=z(capacity))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def params(self) -> Dict[str, torch.Tensor]:
        """The optimizable tensors (shared storage, not copies)."""
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def slice_prefix(self, n: int) -> "GaussianArena":
        """A view of the first ``n`` slots: writes go to the full arena."""
        return GaussianArena(**{f.name: getattr(self, f.name)[:n]
                                for f in dataclasses.fields(self)})


def last_alive_bound(alive: torch.Tensor) -> int:
    """1 + highest alive slot index (0 when empty)."""
    idx = torch.nonzero(alive)
    return int(idx[-1, 0]) + 1 if idx.numel() else 0


@torch.no_grad()
def seed_from_pointmap(arena: GaussianArena, points: torch.Tensor,
                       colors: torch.Tensor, conf_mask: torch.Tensor,
                       kf_id: int) -> Tuple[int, torch.Tensor]:
    """Insert Gaussians for one keyframe's confident pixels, in place.

    points (M, 3) world; colors (M, 3) in [0, 1]; conf_mask (M,) bool.
    Candidates fill the lowest free slots in order; overflow is dropped.
    Returns (n_inserted, slot_used (N,) bool).
    """
    free = ~arena.alive
    free_rank = torch.cumsum(free.long(), 0) - 1
    cand_rank = torch.cumsum(conf_mask.long(), 0) - 1
    n_ins = int(min(int(free.sum()), int(conf_mask.sum())))

    d2 = dist_to_3nn_sq(points, conf_mask)
    scale = torch.log(torch.sqrt(torch.clamp(d2, min=1e-7)))

    slot_used = free & (free_rank < n_ins)
    cand = conf_mask & (cand_rank < n_ins)
    slots = torch.nonzero(slot_used)[:, 0]       # ascending = free-rank order
    src = torch.nonzero(cand)[:, 0]              # ascending = cand-rank order
    arena.xyz[slots] = points[src]
    arena.f_dc[slots] = RGB2SH(colors[src])
    arena.log_scales[slots] = scale[src, None].expand(-1, 3)
    arena.opacity_logit[slots] = float(inverse_sigmoid(torch.tensor(0.1)))
    arena.quat[slots] = torch.tensor([1.0, 0, 0, 0], device=points.device)
    arena.alive[slots] = True
    arena.kf_id[slots] = int(kf_id)
    for f in ("n_obs", "grad_accum", "grad_accum_abs", "denom", "max_radii"):
        getattr(arena, f)[slots] = 0
    return n_ins, slot_used


@torch.no_grad()
def densify_and_prune(arena: GaussianArena, noise: torch.Tensor,
                      max_grad: float = 0.0002, min_opacity: float = 0.005,
                      extent: float = 4.0, max_new: int = 8192):
    """Clone / split / prune in place (gaussian_model.py:748-777 semantics,
    shape-static). ``noise``: (N, 3) standard-normal draws for the split
    children, injected by the caller (a ``torch.Generator`` draw, or the
    JAX package's draw in parity tests)."""
    g = arena.grad_accum / torch.clamp(arena.denom, min=1.0)
    g_abs = arena.grad_accum_abs / torch.clamp(arena.denom, min=1.0)
    ratio = ((g >= max_grad) & arena.alive).float().mean()
    q = torch.quantile(torch.where(arena.alive, g_abs, torch.zeros_like(g_abs)),
                       float(1.0 - ratio))
    over = ((g >= max_grad) | (g_abs >= q)) & arena.alive & (arena.denom > 0)

    scales = torch.exp(arena.log_scales)
    max_scale = scales.max(-1).values
    small = max_scale <= 0.01 * extent
    clone = over & small
    split = over & ~small
    prune = ((torch.sigmoid(arena.opacity_logit) < min_opacity)
             | (max_scale > 0.1 * extent) | (max_scale < 5e-4)) & arena.alive

    sel = clone | split
    sel_rank = torch.cumsum(sel.long(), 0) - 1
    keep_child = sel & (sel_rank < max_new)

    offset = torch.einsum("pij,pj->pi", quat_wxyz_to_matrix(arena.quat),
                          noise * scales)
    child_xyz = torch.where(split[:, None], arena.xyz + offset, arena.xyz)
    child_ls = torch.where(split[:, None], torch.log(scales / 1.6),
                           arena.log_scales)

    alive_after_prune = arena.alive & ~prune
    free = ~alive_after_prune
    free_rank = torch.cumsum(free.long(), 0) - 1
    n_children = int(min(int(keep_child.sum()), int(free.sum())))
    slot_used = free & (free_rank < n_children)
    slots = torch.nonzero(slot_used)[:, 0]
    src = torch.nonzero(keep_child & (sel_rank < n_children))[:, 0]

    new_ls = arena.log_scales.clone()
    new_ls[slots] = child_ls[src]
    arena.xyz[slots] = child_xyz[src]
    arena.f_dc[slots] = arena.f_dc[src]
    arena.opacity_logit[slots] = arena.opacity_logit[src]
    arena.quat[slots] = arena.quat[src]
    arena.kf_id[slots] = arena.kf_id[src]
    arena.alive.copy_(alive_after_prune | slot_used)
    arena.n_obs[slots] = 0
    # split parents also shrink in place (the reference splits into N=2)
    parent = split & arena.alive
    new_ls[parent] = torch.log(scales / 1.6)[parent]
    arena.log_scales.copy_(new_ls)
    arena.grad_accum.zero_()
    arena.grad_accum_abs.zero_()
    arena.denom.zero_()
    arena.max_radii.copy_(torch.where(arena.alive, arena.max_radii,
                                      torch.zeros_like(arena.max_radii)))
