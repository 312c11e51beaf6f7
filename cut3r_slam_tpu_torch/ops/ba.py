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

On the card, ``bundle_adjust`` with no input that requires a gradient
(every call of the DROID tracker, which runs under ``no_grad``) takes each
step as the hand-written kernels of ``csrc/droid_ba.cu``, the same
mathematics in float32 (``_bundle_adjust_cuda``); otherwise, and always on
the CPU, the plain steps, which are also the kernels' plain version. The
kernels gather the per-edge terms into the dense blocks by a plan that
they build on the device from ``ii`` / ``jj``; ``ba_plan`` and
``plan_gather`` are the plan's and the gather's plain versions.
``LAUNCHES`` counts the kernels launched; the counters ``ba.steps.kernel``
/ ``ba.steps.plain`` count the steps by path.
"""
from __future__ import annotations

import torch

from .. import full_f32
from ..geometry.lie import se3_retr
from ..geometry.projective import projective_transform
from ..utils.profiling import count

__all__ = ["bundle_adjust", "moba", "jdsa", "schur_solve", "block_solve",
           "ba_plan", "plan_gather", "LAUNCHES"]

# kernels of csrc/droid_ba.cu launched, by name: those of every step, the
# plan on a call's first step, the covariance on its last
_STEP_KERNELS = ("ba_edge", "ba_gather", "ba_schur", "ba_solve", "ba_update")
LAUNCHES = dict.fromkeys(("ba_plan",) + _STEP_KERNELS + ("ba_cov",), 0)


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
    (poses, disps, dzcov of the last step). On the card with no input that
    requires a gradient, the kernels of ``csrc/droid_ba.cu``."""
    P0 = poses.shape[0] if n_frames is None else n_frames
    if poses.is_cuda and not any(t.requires_grad for t in (
            target, weight, eta, poses, disps, intrinsics, edge_valid)):
        count("ba.steps.kernel", steps)
        return _bundle_adjust_cuda(target, weight, eta, poses, disps,
                                   intrinsics, ii, jj, edge_valid, fixedp,
                                   P0, steps)
    count("ba.steps.plain", steps)
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


def ba_plan(ii: torch.Tensor, jj: torch.Tensor, fixedp: int,
            n_frames: int) -> torch.Tensor:
    """The kernels' gather plan (the plain version of ``ba_plan_kernel``,
    which builds it on the card from ``ii`` / ``jj``, with no host read):
    the output cell of each of the 9E per-edge contributions, -1 where it
    is dropped (a fixed frame's pose), int32 (9E,), contribution c = t E + e
    of edge e:

    - t 0-3: the 6x6 blocks Hii, Hij, Hji, Hjj at H cell row * P + col,
      (row, col) = (a_i, a_i), (a_i, a_j), (a_j, a_i), (a_j, a_j);
    - t 4-5: vi, vj at v cell a_i, a_j;
    - t 6-7: Ei, Ej at E cell a_i * P0 + i, a_j * P0 + i (the depth of an
      edge is frame i's);
    - t 8: Ck and wk at C / w cell i,

    with a_f = f - fixedp the free-frame row and P = n_frames - fixedp.
    Each cell sums its contributions in ascending c."""
    P0 = n_frames
    P = P0 - fixedp
    f = torch.stack([ii, jj]).long() - fixedp
    free = (f >= 0) & (f < P)
    ki = ii.long()
    kin = (ki >= 0) & (ki < P0)
    ai, aj, fi, fj = f[0], f[1], free[0], free[1]
    h = torch.where(torch.stack([fi, fi & fj, fj & fi, fj]),
                    torch.stack([ai, ai, aj, aj]) * P
                    + torch.stack([ai, aj, ai, aj]), -1)
    v = torch.where(free, f, -1)
    e = torch.where(free & kin, f * P0 + ki, -1)
    c = torch.where(kin, ki, -1)
    return torch.cat([h, v, e, c[None]]).reshape(-1).int()


def plan_gather(cells, HB, VB, EB, CW, eta, P: int, P0: int):
    """Plain version of ``ba_gather_kernel``: the per-edge terms HB (4, E,
    36), VB (2, E, 6), EB (2, E, 6, HW), CW (E, 2, HW) summed by the plan
    ``cells`` into H (P, P, 6, 6), v (P, 6), E (P, P0, 6, HW), the
    contributions counted into each E block (P, P0), Q = 1 / C (P0, HW)
    with C = (sum Ck + eta) + 1e-7, and w (P0, HW)."""
    E = HB.shape[1]
    HW = EB.shape[-1]
    groups = ((HB, 0, P * P), (VB, 4, P), (EB, 6, P * P0), (CW[None], 8, P0))
    out = []
    for rows, t0, n in groups:
        cl = cells[t0 * E:(t0 + rows.shape[0]) * E].long()
        flat = rows.reshape((-1,) + rows.shape[2:])
        out.append(_scatter_vec(flat[None], cl, n)[0])
        if t0 == 6:
            ok = (cl >= 0) & (cl < n)
            out.append(torch.zeros(n + 1, dtype=torch.int32,
                                   device=cl.device).index_add_(
                0, torch.where(ok, cl, n), ok.int())[:-1].reshape(P, P0))
    H, v, Ed, nz, Cw = out
    Q = 1.0 / (Cw[:, 0] + eta.reshape(P0, HW) + 1e-7)
    return (H.reshape(P, P, 6, 6), v, Ed.reshape(P, P0, 6, HW), nz, Q,
            Cw[:, 1])


def _stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def _step_work(E: int, P: int, P0: int, HW: int, device) -> dict:
    """The buffers of ``droid_ba_step`` (csrc/droid_ba.cu): the plan cells
    (9E, as ``ba_plan``'s), the per-edge terms HB (4, E, 36), VB (2, E, 6),
    EB (2, E, 6, HW), CW (E, 2, HW); the gathered H (P, P, 36), v (P, 6),
    Ed (P, P0, 6, HW), nzE (P, P0), Q and w (P0, HW); the Schur system S
    (n, n), rhs (n); the factor Lp (the packed rows of L, then y = L^-1
    rhs), dx (n), status (1) and dzcov (P0, HW), n = 6 P."""
    n = 6 * P
    shapes = {"HB": (4, E, 36), "VB": (2, E, 6), "EB": (2, E, 6, HW),
              "CW": (E, 2, HW), "H": (P, P, 36), "v": (P, 6),
              "Ed": (P, P0, 6, HW), "Q": (P0, HW), "w": (P0, HW),
              "S": (n, n), "rhs": (n,), "Lp": ((n + 1) * (n + 2) // 2,),
              "dx": (n,), "dzcov": (P0, HW)}
    work = {k: torch.empty(v, dtype=torch.float32, device=device)
            for k, v in shapes.items()}
    work["cells"] = torch.empty(9 * E, dtype=torch.int32, device=device)
    work["nzE"] = torch.empty(P, P0, dtype=torch.int32, device=device)
    work["status"] = torch.empty(1, dtype=torch.int32, device=device)
    return work


# droid_ba_step's buffer arguments, in order
_WORK_ARGS = ("HB", "VB", "EB", "CW", "H", "v", "Ed", "nzE", "Q", "w", "S",
              "rhs", "Lp", "dx", "status", "dzcov")


def _bundle_adjust_cuda(target, weight, eta, poses, disps, intrinsics, ii,
                        jj, edge_valid, fixedp: int, P0: int, steps: int,
                        work: dict = None):
    """``bundle_adjust``'s steps as ``csrc/droid_ba.cu``'s kernels, damped
    as ``schur_solve`` damps the plain step (ep 0.1, lm 1e-4). Every input
    on one CUDA device, float32 (``ii`` / ``jj`` any integer type);
    malformed inputs raise. One call of ``droid_ba_step`` a step, reading
    the last step's poses and disparities and writing fresh ones: five
    launches, and the plan's on the first step, the depth covariance's on
    the last. ``work`` (``_step_work``'s buffers, made here when None)
    holds the last step's intermediates afterwards."""
    dev = poses.device
    ht, wd = disps.shape[-2:]
    HW, E, P = ht * wd, ii.shape[0], P0 - fixedp
    intr = intrinsics.expand(P0, 4) if intrinsics.dim() == 1 else intrinsics
    ins = {"target": (target, (E, ht, wd, 2)),
           "weight": (weight, (E, ht, wd, 2)),
           "eta": (eta.reshape(P0, ht, wd), (P0, ht, wd)),
           "poses": (poses, (P0, 7)), "disps": (disps, (P0, ht, wd)),
           "intrinsics": (intr, (P0, 4)),
           "edge_valid": (edge_valid.to(torch.float32), (E,))}
    for name, (t, shape) in ins.items():
        if t.dtype != torch.float32 or t.device != dev \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= fixedp <= P0 or jj.shape != ii.shape or ii.device != dev:
        raise ValueError(f"fixedp {fixedp} of {P0} frames, ii "
                         f"{tuple(ii.shape)} / jj {tuple(jj.shape)}")
    if steps < 1:
        return poses, disps, None
    (target, weight, eta, poses_in, disps_in, intr, ev) = (
        t.contiguous() for t, _ in ins.values())
    ii, jj = ii.long().contiguous(), jj.long().contiguous()
    from ..kernels import load
    lib = load("droid_ba")
    if work is None:
        work = _step_work(E, P, P0, HW, dev)
    bufs = [work[k].data_ptr() for k in _WORK_ARGS]
    outs = [(torch.empty_like(poses_in), torch.empty_like(disps_in))
            for _ in range(min(steps, 2))]
    p_in, d_in = poses_in, disps_in
    for s in range(steps):
        p_out, d_out = outs[s % 2]
        last = s == steps - 1
        rc = lib.droid_ba_step(
            p_in.data_ptr(), p_out.data_ptr(), d_in.data_ptr(),
            d_out.data_ptr(), intr.data_ptr(), target.data_ptr(),
            weight.data_ptr(), ev.data_ptr(), eta.data_ptr(), ii.data_ptr(),
            jj.data_ptr(), work["cells"].data_ptr(), E, P0, fixedp, ht, wd,
            0.1, 1e-4, int(s == 0), int(last), *bufs, _stream_ptr(dev))
        for k in ((("ba_plan",) if s == 0 else ()) + _STEP_KERNELS
                  + (("ba_cov",) if last else ())):
            LAUNCHES[k] += 1
        if rc != 0:
            raise RuntimeError(f"droid_ba_step launch failed: cudaError {rc}")
        p_in, d_in = p_out, d_out
    return p_in, d_in, work["dzcov"]


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
