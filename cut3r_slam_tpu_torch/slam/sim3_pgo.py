"""Sim(3) pose-graph bundle adjustment (port of
``cut3r_slam_tpu/slam/sim3_pgo.py``).

Relative SE(3) constraints between keyframes (odometry edges and loop
edges) refine the absolute Sim(3) keyframe poses by Gauss-Newton. Each
edge's residual is log(meas^-1 * g_i^-1 * g_j) in sim(3); its (7, 14)
Jacobian with respect to the two endpoints' local perturbations comes
from ``torch.func.vmap(torch.func.jacfwd(...))`` at zero perturbation,
exactly as the JAX package takes it, so every step evaluates the
small-angle, small-sigma series branches of the Sim(3) exp. The normal
equations are assembled per edge by an accumulating scatter (edge lists
repeat keyframe pairs), and the (N*7)^2 system is solved densely on the
keyframe store's device, in full f32.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import full_f32
from ..geometry.lie import (sim3_exp, sim3_log, sim3_mul, sim3_inv, se3_mul,
                            se3_inv)
from .keyframe import SUBMAP_SIZE

__all__ = ["Sim3PGO", "sim3_pgo_solve", "sim3_pgo_solve_dense", "PGBABuffer"]

D = 7  # sim(3) tangent size


def _residual(g_all, ii, jj, rel_meas):
    """Per-edge residual log(meas^-1 * g_i^-1 * g_j) in sim(3)."""
    pred = sim3_mul(sim3_inv(g_all[ii]), g_all[jj])
    return sim3_log(sim3_mul(sim3_inv(rel_meas), pred))


def _r_local(xi2, gi, gj, meas):
    gi2 = sim3_mul(sim3_exp(xi2[:D]), gi)
    gj2 = sim3_mul(sim3_exp(xi2[D:]), gj)
    return sim3_log(sim3_mul(sim3_inv(meas), sim3_mul(sim3_inv(gi2), gj2)))


def _edge_jacobians(g_all, ii, jj, rel_meas):
    """Per-edge residual (E, 7) and (E, 7, 14) Jacobian with respect to the
    edge's two local sim(3) perturbations, at zero."""
    z14 = torch.zeros(2 * D, dtype=g_all.dtype, device=g_all.device)

    def one(gi, gj, meas):
        return _r_local(z14, gi, gj, meas), \
            jacfwd(_r_local)(z14, gi, gj, meas)
    return vmap(one)(g_all[ii], g_all[jj], rel_meas)


def _gn_update(g_all, H, b, fixed, damping):
    """Solve the damped normal equations and retract; the first ``fixed``
    poses stay put."""
    n = g_all.shape[0]
    H = H + damping * torch.eye(n * D, dtype=H.dtype, device=H.device)
    dx = torch.linalg.solve(H, b.reshape(-1)).reshape(n, D)
    dx[:fixed] = 0.0
    return sim3_mul(sim3_exp(dx), g_all)


@torch.no_grad()
@full_f32()
def sim3_pgo_solve(poses_sim3: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor, rel_meas: torch.Tensor,
                   weights: torch.Tensor, iters: int = 10, fixed: int = 1,
                   damping: float = 1e-4) -> torch.Tensor:
    """Gauss-Newton Sim(3) PGO with block-sparse normal equations.

    poses_sim3 (N, 8) absolute Sim3 [t, q xyzw, s]; ii / jj (E,) edges,
    repeats allowed; rel_meas (E, 8) measured relative Sim3 (i -> j);
    weights (E,). The first ``fixed`` poses are pinned. Each edge's 7x7
    blocks are scatter-added into the (N, N, 7, 7) Hessian (cost linear in
    E); only the solve touches the (N*7)^2 system. Returns refined (N, 8).
    """
    N = poses_sim3.shape[0]
    g = poses_sim3
    for _ in range(iters):
        r, J = _edge_jacobians(g, ii, jj, rel_meas)
        # fixed poses: their perturbation columns are identically zero
        Ji = J[..., :D] * (ii >= fixed)[:, None, None]
        Jj = J[..., D:] * (jj >= fixed)[:, None, None]
        w = weights[:, None, None]
        Hb = torch.zeros(N, N, D, D, dtype=g.dtype, device=g.device)
        for a, ja, bb, jb in ((ii, Ji, ii, Ji), (ii, Ji, jj, Jj),
                              (jj, Jj, ii, Ji), (jj, Jj, jj, Jj)):
            Hb.index_put_((a, bb), w * torch.einsum("eri,erj->eij", ja, jb),
                          accumulate=True)
        wr = weights[:, None] * r
        b = torch.zeros(N, D, dtype=g.dtype, device=g.device)
        b.index_add_(0, ii, -torch.einsum("erd,er->ed", Ji, wr))
        b.index_add_(0, jj, -torch.einsum("erd,er->ed", Jj, wr))
        H = Hb.permute(0, 2, 1, 3).reshape(N * D, N * D)
        g = _gn_update(g, H, b, fixed, damping)
    return g


@torch.no_grad()
@full_f32()
def sim3_pgo_solve_dense(poses_sim3: torch.Tensor, ii: torch.Tensor,
                         jj: torch.Tensor, rel_meas: torch.Tensor,
                         weights: torch.Tensor, iters: int = 10,
                         fixed: int = 1,
                         damping: float = 1e-4) -> torch.Tensor:
    """The dense formulation: ``jacfwd`` over all N*7 variables at once
    (the parity oracle of ``sim3_pgo_solve``; O(N^2) memory, small N)."""
    N = poses_sim3.shape[0]
    g = poses_sim3
    w = torch.repeat_interleave(weights, D)
    keep = (torch.arange(N, device=g.device) >= fixed)[:, None].to(g.dtype)
    for _ in range(iters):
        def r_of_xi(xi_flat, g_all=g):
            xi = xi_flat.reshape(N, D) * keep
            return _residual(sim3_mul(sim3_exp(xi), g_all), ii, jj,
                             rel_meas).reshape(-1)
        z = torch.zeros(N * D, dtype=g.dtype, device=g.device)
        r0 = r_of_xi(z)
        J = jacfwd(r_of_xi)(z)
        JtW = J.T * w[None, :]
        g = _gn_update(g, JtW @ J, -JtW @ r0, fixed, damping)
    return g


class Sim3PGO:
    """Constraint accumulator + solver. Edges live in host lists."""

    def __init__(self):
        self.ii: List[int] = []
        self.jj: List[int] = []
        self.rel: List[np.ndarray] = []
        self.w: List[float] = []

    def add_relative_se3(self, i: int, j: int, rel_se3: np.ndarray,
                         weight: float = 1.0):
        """Store an SE(3) constraint as Sim3 with unit scale."""
        self.ii.append(i)
        self.jj.append(j)
        self.rel.append(np.concatenate([np.asarray(rel_se3, np.float32),
                                        np.ones(1, np.float32)]))
        self.w.append(weight)

    def add_sequential_constraints(self, poses_se3: np.ndarray,
                                   weight: float = 1.0):
        """Odometry edges between consecutive poses."""
        poses = np.asarray(poses_se3, np.float32)
        for i, rel in enumerate(_relative(poses[:-1], poses[1:])):
            self.add_relative_se3(i, i + 1, rel, weight)

    def loop_candidates(self, positions: np.ndarray, z_axes: np.ndarray,
                        current: int, dist_thresh: float = 0.5,
                        angle_thresh: float = 0.7,
                        temporal_gap: int = 20) -> np.ndarray:
        """Indices of the poses within ``dist_thresh`` of ``current``,
        whose viewing axis is within ``angle_thresh`` (cosine) of its, and
        more than ``temporal_gap`` indices away."""
        d = np.linalg.norm(positions - positions[current], axis=1)
        cos = (z_axes @ z_axes[current]) / np.maximum(
            np.linalg.norm(z_axes, axis=1)
            * np.linalg.norm(z_axes[current]), 1e-8)
        idx = np.arange(len(positions))
        m = (d < dist_thresh) & (cos > angle_thresh) \
            & (np.abs(idx - current) > temporal_gap)
        return idx[m]

    def solve(self, poses_se3: np.ndarray, iters: int = 10, fixed: int = 1,
              *, device) -> np.ndarray:
        """Refine absolute SE(3) poses (N, 7) on ``device``; returns (N, 8)
        Sim3."""
        n = len(poses_se3)
        g0 = np.concatenate([np.asarray(poses_se3, np.float32),
                             np.ones((n, 1), np.float32)], axis=1)
        if not self.ii:
            return g0

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        return sim3_pgo_solve(
            t(g0), t(self.ii, torch.long), t(self.jj, torch.long),
            t(np.stack(self.rel)), t(self.w), iters=iters,
            fixed=fixed).cpu().numpy()


def _relative(pose_i: np.ndarray, pose_j: np.ndarray) -> np.ndarray:
    """pose_i^-1 * pose_j of SE(3) [t, q xyzw] vectors (..., 7), in f32."""
    a, b = torch.as_tensor(pose_i), torch.as_tensor(pose_j)
    return se3_mul(se3_inv(a), b).numpy()


class PGBABuffer:
    """Live-path Sim(3) PGBA: accumulate odometry constraints as the
    frontend tracks keyframes, add a loop constraint when the loop backend
    fires, and refine every keyframe pose (and rescale its depth) with
    ``sim3_pgo_solve``. Edge weights: odometry 1, loop ``loop_weight``;
    with ``conf_weighting`` each edge is also scaled by the mean stored
    submap confidence of its two keyframes. The JAX package pads poses to
    a multiple of 32 and edges to a multiple of 64 (identity poses,
    zero-weight self-loops) to bound recompiles; those rows change nothing
    in the solve, so the port solves the real ones."""

    def __init__(self, loop_weight: float = 2.0, iters: int = 6,
                 conf_weighting: bool = False):
        self.pgo = Sim3PGO()
        self.loop_weight = loop_weight
        self.iters = iters
        self.conf_weighting = conf_weighting
        self._odo_upto = 0  # sequential edges exist for [0, _odo_upto)

    def _kf_conf(self, kf, i: int) -> float:
        return float(kf.submap_conf[i // SUBMAP_SIZE, i % SUBMAP_SIZE]
                     .mean())

    def _edge_weight(self, kf, i: int, j: int, base: float) -> float:
        if not self.conf_weighting:
            return base
        c = 0.5 * (self._kf_conf(kf, i) + self._kf_conf(kf, j))
        # conf in [0, 1) -> a [0.25, 1.75) multiplier
        return base * (0.25 + 1.5 * max(min(c, 1.0), 0.0))

    def on_new_keyframes(self, kf, upto: int):
        """Add odometry edges i -> i+1 for newly tracked keyframes."""
        lo = max(self._odo_upto - 1, 0)
        if upto - 1 > lo:
            rel = _relative(kf.pose[lo:upto - 1], kf.pose[lo + 1:upto])
            for k, i in enumerate(range(lo, upto - 1)):
                self.pgo.add_relative_se3(
                    i, i + 1, rel[k], self._edge_weight(kf, i, i + 1, 1.0))
        self._odo_upto = max(self._odo_upto, upto)

    def on_loop(self, matched: int, current: int, kf):
        """Add a loop-closure edge from the (LC-corrected) poses."""
        self.pgo.add_relative_se3(
            matched, current, _relative(kf.pose[matched], kf.pose[current]),
            self._edge_weight(kf, matched, current, self.loop_weight))

    def solve_and_writeback(self, kf) -> np.ndarray:
        """Refine kf.pose[:count] in place; depths scale by each pose's
        Sim3 scale. Returns the (n, 8) refined Sim3 poses."""
        n = kf.count
        if n < 2 or not self.pgo.ii:
            return np.zeros((0, 8), np.float32)
        g = self.pgo.solve(kf.pose[:n], iters=self.iters, fixed=1,
                           device=kf.device)
        kf.pose[:n] = g[:, :7]
        kf.depth[:n] *= g[:, 7, None, None]
        return g
