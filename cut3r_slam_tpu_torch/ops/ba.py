"""Dense bundle adjustment with a Schur-complement Cholesky solve,
DROID-style (port of ``cut3r_slam_tpu/ops/ba.py``).

Projective residuals and analytic Jacobians (``geometry/projective.py``)
are scattered into the block Hessian (pose-pose H, pose-depth E, diagonal
depth-depth C) with ``index_add`` in place of ``segment_sum``, solved by
a damped Schur complement and a dense Cholesky, then retracted (SE(3) on
the poses, the reference's clamp on the disparities). The depth
covariance comes from the same factorization.

A failed factorization gives the JAX package's result without a host
sync: ``cholesky_ex``'s ``info`` selects, on the device, what JAX's NaN
factor leads to through each guard (``block_solve``: zero; ``schur_solve``:
a zero pose update, dz = Q w, a NaN covariance). Edge lists are
fixed-capacity with a validity mask; cells out of range (the fixed
frames) go to a sentinel segment that is dropped. Every solve runs under
``full_f32``: a Schur complement in TF32 is useless.
"""
from __future__ import annotations

import torch

from .. import full_f32
from ..geometry.lie import se3_retr
from ..geometry.projective import projective_transform

__all__ = ["bundle_adjust", "moba", "jdsa", "schur_solve", "block_solve"]


def _damp(H, ep=0.1, lm=1e-4):
    return H + torch.diag_embed(ep + lm * H.diagonal(dim1=-2, dim2=-1))


def _ok(info, like):
    """info == 0 per batch, broadcast against ``like`` (B, ...)."""
    return (info == 0).reshape((-1,) + (1,) * (like.dim() - 1))


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


@full_f32()
def block_solve(H: torch.Tensor, b: torch.Tensor, ep=0.1,
                lm=1e-4) -> torch.Tensor:
    """(B, N, N, D, D), (B, N, D) -> (B, N, D) by a damped Cholesky; a
    non-finite entry (a whole batch where the factorization fails) is 0."""
    B, N, _, D, _ = H.shape
    Hf = _damp(H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D), ep, lm)
    L, info = torch.linalg.cholesky_ex(Hf)
    x = torch.cholesky_solve(b.reshape(B, N * D, 1), L)
    x = torch.where(_ok(info, x), x, torch.zeros_like(x))
    return _finite_or_zero(x).reshape(B, N, D)


@full_f32()
def schur_solve(H, E, C, v, w, ep=0.1, lm=1e-4, with_cov: bool = True):
    """Damped Schur-complement solve. H (B, P, P, D, D), E (B, P, M, D, HW),
    C (B, M, HW), v (B, P, D), w (B, M, HW). Returns (dx (B, P, D),
    dz (B, M, HW)[, dzcov (M, HW) of batch 0])."""
    B, P, M, D, HW = E.shape
    Hf = _damp(H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D), ep, lm)
    Ef = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW)
    vf = v.reshape(B, P * D)
    wf = w.reshape(B, M * HW)

    EQ = Ef * Q[:, None, :]
    S = Hf - EQ @ Ef.transpose(1, 2)
    rhs = vf - (EQ @ wf[..., None])[..., 0]

    L, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    # a failed factorization, or any non-finite entry: zero pose update
    ok = _ok(info, dx) & torch.isfinite(dx).all(-1, keepdim=True)
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    dz = Q * (wf - (Ef.transpose(1, 2) @ dx[..., None])[..., 0])
    dz = _finite_or_zero(dz)
    dxr, dzr = dx.reshape(B, P, D), dz.reshape(B, M, HW)
    if not with_cov:
        return dxr, dzr
    # depth covariance: diag(Q) + ||L^{-1} E Q||^2 by column; JAX's NaN
    # factor makes it NaN where the factorization failed
    Linv_EQ = torch.linalg.solve_triangular(L, EQ, upper=False)
    Linv_EQ = torch.where(_ok(info, Linv_EQ), Linv_EQ,
                          torch.full_like(Linv_EQ, float("nan")))
    dzcov = (Linv_EQ * Linv_EQ).sum(1) + Q
    return dxr, dzr, dzcov.reshape(B, M, HW)[0]


def _scatter_mat(A, ii, jj, n, m):
    """(B, E, D1, D2) edge blocks -> (B, n*m, D1, D2) by (ii, jj) cell."""
    ok = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    idx = torch.where(ok, ii * m + jj, torch.full_like(ii, n * m))
    A = torch.where(ok[None, :, None, None], A, torch.zeros_like(A))
    out = A.new_zeros((A.shape[0], n * m + 1) + A.shape[2:])
    return out.index_add(1, idx, A)[:, :-1]


def _scatter_vec(b, ii, n):
    """(B, E, ...) -> (B, n, ...) by ii; cells out of range dropped."""
    ok = (ii >= 0) & (ii < n)
    idx = torch.where(ok, ii, torch.full_like(ii, n))
    b = torch.where(ok.reshape((1, -1) + (1,) * (b.dim() - 2)), b,
                    torch.zeros_like(b))
    out = b.new_zeros((b.shape[0], n + 1) + b.shape[2:])
    return out.index_add(1, idx, b)[:, :-1]


def _edge_terms(target, weight, poses, disps, intrinsics, ii, jj,
                edge_valid):
    """Residuals, weights and Jacobians of every edge, flattened per
    pixel: (Jif, Jjf (1, E, 2HW, 6), rf, wf (1, E, 2HW, 1), Jz)."""
    E_n = ii.shape[0]
    coords, valid, (Ji, Jj, Jz) = projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)
    ev = edge_valid[:, None, None, None]
    r = (target - coords) * valid * ev
    w = 0.001 * (valid * weight) * ev
    return (Ji.reshape(1, E_n, -1, 6), Jj.reshape(1, E_n, -1, 6),
            r.reshape(1, E_n, -1, 1), w.reshape(1, E_n, -1, 1), Jz)


def _pose_system(Jif, Jjf, rf, wf, iis, jjs, P):
    """The pose-pose Hessian (1, P, P, 6, 6) and gradient (1, P, 6), with
    the edge products wJ^T (1, E, 6, 2HW) of frames i and j."""
    wJiT = (wf * Jif).transpose(2, 3)
    wJjT = (wf * Jjf).transpose(2, 3)
    H = (_scatter_mat(wJiT @ Jif, iis, iis, P, P)
         + _scatter_mat(wJiT @ Jjf, iis, jjs, P, P)
         + _scatter_mat(wJjT @ Jif, jjs, iis, P, P)
         + _scatter_mat(wJjT @ Jjf, jjs, jjs, P, P)).reshape(1, P, P, 6, 6)
    v = _scatter_vec((wJiT @ rf)[..., 0], iis, P) \
        + _scatter_vec((wJjT @ rf)[..., 0], jjs, P)
    return H, v, wJiT, wJjT


def _retract_disps(disps, dz):
    d = disps + dz
    d = torch.where(d > 10, torch.zeros_like(d), d)
    return torch.clamp(d, min=0.001)


@full_f32()
def bundle_adjust(target: torch.Tensor, weight: torch.Tensor,
                  eta: torch.Tensor, poses: torch.Tensor,
                  disps: torch.Tensor, intrinsics: torch.Tensor,
                  ii: torch.Tensor, jj: torch.Tensor,
                  edge_valid: torch.Tensor, fixedp: int = 1,
                  n_frames: int = None, steps: int = 1):
    """Full BA. poses (P0, 7) w2c; disps (P0, H, W); target / weight
    (E, H, W, 2); ii / jj (E,) with the ``edge_valid`` mask; eta
    (P0, H, W) damping. Every frame's depth is a variable. Returns
    (poses, disps, dzcov of the last step)."""
    P0 = poses.shape[0] if n_frames is None else n_frames
    ht, wd = disps.shape[-2:]
    HW = ht * wd
    E_n = ii.shape[0]
    P = P0 - fixedp
    iis, jjs, kk = ii - fixedp, jj - fixedp, ii  # depth of an edge: frame i
    dzcov = None
    for _ in range(steps):
        Jif, Jjf, rf, wf, Jz = _edge_terms(target, weight, poses, disps,
                                           intrinsics, ii, jj, edge_valid)
        H, v, wJiT, wJjT = _pose_system(Jif, Jjf, rf, wf, iis, jjs, P)
        Jzf = Jz.reshape(1, E_n, HW, 2)
        Ei = (wJiT.reshape(1, E_n, 6, HW, 2) * Jzf[:, :, None]).sum(-1)
        Ej = (wJjT.reshape(1, E_n, 6, HW, 2) * Jzf[:, :, None]).sum(-1)
        w2 = wf.reshape(1, E_n, HW, 2)
        r2 = rf.reshape(1, E_n, HW, 2)
        wk = (w2 * r2 * Jzf).sum(-1)
        Ck = (w2 * Jzf * Jzf).sum(-1)

        Em = (_scatter_mat(Ei.transpose(2, 3), iis, kk, P, P0)
              + _scatter_mat(Ej.transpose(2, 3), jjs, kk, P, P0))
        Em = Em.transpose(2, 3).reshape(1, P, P0, 6, HW)
        C = _scatter_vec(Ck, kk, P0) + eta.reshape(1, P0, HW) + 1e-7
        wv = _scatter_vec(wk, kk, P0)

        dx, dz, dzcov = schur_solve(H, Em, C, v, wv)
        poses = torch.cat([poses[:fixedp], se3_retr(poses[fixedp:], dx[0])])
        disps = _retract_disps(disps, dz[0].reshape(P0, ht, wd))
    return poses, disps, dzcov


def _bilinear_upsample_with_jacobian(scales: torch.Tensor, ht: int,
                                     wd: int):
    """Per-frame low-resolution scale grids (M, hs, ws) -> the full-
    resolution multiplier (M, ht, wd) and the bilinear weights
    J (ht*wd, hs*ws), shared across frames (accumulated where two taps
    meet one cell)."""
    M, hs, ws = scales.shape
    dev, dt = scales.device, scales.dtype
    gy = torch.linspace(0, hs - 1 - 1e-6, ht, dtype=dt, device=dev)
    gx = torch.linspace(0, ws - 1 - 1e-6, wd, dtype=dt, device=dev)
    y0 = torch.floor(gy).long()
    x0 = torch.floor(gx).long()
    fy = (gy - y0)[:, None]
    fx = (gx - x0)[None, :]
    y1 = torch.clamp(y0 + 1, 0, hs - 1)
    x1 = torch.clamp(x0 + 1, 0, ws - 1)

    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx
    Y0, Y1, X0, X1 = y0[:, None], y1[:, None], x0[None, :], x1[None, :]
    vals = (scales[:, Y0, X0] * w00 + scales[:, Y0, X1] * w01
            + scales[:, Y1, X0] * w10 + scales[:, Y1, X1] * w11)

    rows = torch.arange(ht * wd, device=dev)
    yy0, yy1 = y0.repeat_interleave(wd), y1.repeat_interleave(wd)
    xx0, xx1 = x0.repeat(ht), x1.repeat(ht)
    J = torch.zeros(ht * wd, hs * ws, dtype=dt, device=dev)
    for yy, xx, wgt in ((yy0, xx0, w00), (yy0, xx1, w01), (yy1, xx0, w10),
                        (yy1, xx1, w11)):
        J.index_put_((rows, yy * ws + xx), wgt.reshape(-1), accumulate=True)
    return vals, J


@full_f32()
def jdsa(target: torch.Tensor, weight: torch.Tensor, eta: torch.Tensor,
         poses: torch.Tensor, disps: torch.Tensor, intrinsics: torch.Tensor,
         disps_prior: torch.Tensor, dscales: torch.Tensor, ii: torch.Tensor,
         jj: torch.Tensor, edge_valid: torch.Tensor, alpha: float = 0.01):
    """Joint depth and scale adjustment: mono-prior disparities, scaled by
    per-frame low-resolution grids ``dscales`` (P, hs, ws) upsampled
    bilinearly, fused with the depth-only BA system, one Schur solve with
    a block-diagonal prior Hessian. Returns (disps, dscales, dzcov)."""
    P0, ht, wd = disps.shape
    HW = ht * wd
    hs, ws = dscales.shape[-2:]
    Dg = hs * ws
    E_n = ii.shape[0]

    # depth-only BA coefficients
    _, _, rf, wf, Jz = _edge_terms(target, weight, poses, disps, intrinsics,
                                   ii, jj, edge_valid)
    Jz2 = Jz.reshape(1, E_n, HW, 2)
    w2 = wf.reshape(1, E_n, HW, 2)
    r2 = rf.reshape(1, E_n, HW, 2)
    C = _scatter_vec((w2 * Jz2 * Jz2).sum(-1), ii, P0)[0]
    wv = _scatter_vec((w2 * r2 * Jz2).sum(-1), ii, P0)[0]

    # prior residuals
    m = (disps_prior > 0).to(disps.dtype).reshape(P0, HW)
    vals, Jbi = _bilinear_upsample_with_jacobian(dscales, ht, wd)
    rd = (disps - disps_prior * vals).reshape(P0, HW)
    Jso = -(m * disps_prior.reshape(P0, HW))[:, :, None] * Jbi[None]

    aw = alpha
    Hs = (Jso * aw).transpose(1, 2) @ Jso             # (P0, Dg, Dg)
    Es = (Jso * aw).transpose(1, 2)                   # (P0, Dg, HW)
    vs = -((Jso * aw).transpose(1, 2) @ rd[..., None])[..., 0]

    C = C + m * aw + (1 - m) * eta.reshape(P0, HW) + 1e-7
    wv = wv - m * aw * rd

    ar = torch.arange(P0, device=disps.device)
    Hd = Hs.new_zeros(1, P0, P0, Dg, Dg)
    Hd[:, ar, ar] = Hs[None]
    Ed = Es.new_zeros(1, P0, P0, Dg, HW)
    Ed[:, ar, ar] = Es[None]
    dso, dz, dzcov = schur_solve(Hd, Ed, C[None], vs[None], wv[None])

    new_disps = _retract_disps(disps, dz[0].reshape(P0, ht, wd))
    return new_disps, dscales + dso[0].reshape(P0, hs, ws), dzcov


@full_f32()
def moba(target: torch.Tensor, weight: torch.Tensor, poses: torch.Tensor,
         disps: torch.Tensor, intrinsics: torch.Tensor, ii: torch.Tensor,
         jj: torch.Tensor, edge_valid: torch.Tensor, fixedp: int = 1,
         steps: int = 1) -> torch.Tensor:
    """Motion-only BA: depths fixed, a pose-only solve per step."""
    P = poses.shape[0] - fixedp
    iis, jjs = ii - fixedp, jj - fixedp
    for _ in range(steps):
        Jif, Jjf, rf, wf, _ = _edge_terms(target, weight, poses, disps,
                                          intrinsics, ii, jj, edge_valid)
        H, v, _, _ = _pose_system(Jif, Jjf, rf, wf, iis, jjs, P)
        dx = block_solve(H, v)
        poses = torch.cat([poses[:fixedp], se3_retr(poses[fixedp:], dx[0])])
    return poses
