"""The port's dense bundle adjustment (``ops/ba.py``) against the JAX
package on the CPU, the same seeded numpy inputs through both.

Tolerances (f32 on both sides; the solves differ in summation order
only): the linear solves and the bilinear Jacobian 1e-5 relative + 1e-6;
``bundle_adjust`` / ``moba`` / ``jdsa`` after their steps 1e-4 relative
+ 1e-5 on poses, disparities, scale grids and covariances (what f32
reaches here: worst 1.1e-6 of the largest pose entry, 8.0e-7 on the
disparities and 5.9e-6 on the covariance after two steps, printed under
``pytest -s``). A failed Cholesky factorization (an indefinite
system) must give the JAX package's guarded result: a zero update from
``block_solve``; from ``schur_solve`` a zero pose update, dz = Q w and a
NaN covariance.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.geometry import lie as jlie, projective as jproj
from cut3r_slam_tpu.ops import ba as jba
from cut3r_slam_tpu_torch.geometry import lie, projective
from cut3r_slam_tpu_torch.ops import ba

from test_torch_cut3r_train import few_threads  # noqa: F401

SOLVE = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(np.asarray(x)) for x in xs]


def _spd(rng, B, n, shift):
    A = rng.normal(size=(B, n, n))
    return (A @ A.transpose(0, 2, 1) + shift * np.eye(n)).astype(np.float32)


def _blocks(Hf, N, D):
    B = Hf.shape[0]
    return np.ascontiguousarray(
        Hf.reshape(B, N, D, N, D).transpose(0, 1, 3, 2, 4))


def test_block_solve_matches_jax_and_direct():
    rng = np.random.default_rng(0)
    N, D = 3, 6
    Hf = _spd(rng, 2, N * D, 10.0)
    b = rng.normal(size=(2, N, D)).astype(np.float32)
    H5 = _blocks(Hf, N, D)
    got = ba.block_solve(*_t(H5, b))
    want = np.asarray(jba.block_solve(*_j(H5, b)))
    np.testing.assert_allclose(got.numpy(), want, **SOLVE)
    undamped = ba.block_solve(*_t(H5, b), ep=0.0, lm=0.0).numpy()
    ref = np.linalg.solve(Hf.astype(np.float64),
                          b.reshape(2, -1, 1)).reshape(2, N, D)
    np.testing.assert_allclose(undamped, ref, rtol=1e-3, atol=1e-4)


def _schur_inputs(rng, B=2, P=2, M=3, D=6, HW=5):
    E = (rng.normal(size=(B, P, M, D, HW)) * 0.1).astype(np.float32)
    H = _blocks(_spd(rng, B, P * D, 5.0), P, D)
    C = rng.uniform(1.0, 2.0, size=(B, M, HW)).astype(np.float32)
    v = rng.normal(size=(B, P, D)).astype(np.float32)
    w = rng.normal(size=(B, M, HW)).astype(np.float32)
    return H, E, C, v, w


def test_schur_solve_with_covariance_matches_jax():
    H, E, C, v, w = _schur_inputs(np.random.default_rng(1))
    got = ba.schur_solve(*_t(H, E, C, v, w))
    want = jba.schur_solve(*_j(H, E, C, v, w))
    for g, wv, what in zip(got, want, ("dx", "dz", "dzcov")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), err_msg=what,
                                   **SOLVE)
    dx, dz = ba.schur_solve(*_t(H, E, C, v, w), with_cov=False)
    np.testing.assert_allclose(dx.numpy(), got[0].numpy(), rtol=0, atol=0)


def test_failed_cholesky_gives_the_jax_guarded_update():
    """An indefinite system in batch 0 (a positive definite one in batch
    1): both packages return the same zero update there, the other batch
    solved as usual."""
    rng = np.random.default_rng(2)
    H, E, C, v, w = _schur_inputs(rng)
    P, D = H.shape[1], H.shape[3]
    bad = -_spd(rng, 1, P * D, 5.0)[0]          # negative definite
    H[0] = _blocks(bad[None], P, D)[0]
    got = ba.schur_solve(*_t(H, E, C, v, w))
    want = jba.schur_solve(*_j(H, E, C, v, w))
    assert not got[0][0].any() and not np.asarray(want[0][0]).any()
    np.testing.assert_allclose(got[1][0].numpy(), (w[0] / C[0]), rtol=1e-6)
    for g, wv, what in zip(got[:2], want[:2], ("dx", "dz")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), err_msg=what,
                                   **SOLVE)
    # the covariance of batch 0 is NaN in both (JAX's NaN factor)
    assert np.isnan(got[2].numpy()).all()
    assert np.isnan(np.asarray(want[2])).all()

    b = rng.normal(size=(2, P, D)).astype(np.float32)
    bx = ba.block_solve(*_t(H, b))
    jx = np.asarray(jba.block_solve(*_j(H, b)))
    assert not bx[0].any() and not jx[0].any()
    np.testing.assert_allclose(bx.numpy(), jx, **SOLVE)


def test_scatter_drops_cells_out_of_range():
    """Edges of fixed frames (index < 0 after the shift) and past the end
    go to the dropped sentinel segment, as ``segment_sum`` there."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(1, 5, 2, 3)).astype(np.float32)
    ii = np.asarray([-1, 0, 1, 2, 1])
    jj = np.asarray([0, 1, -2, 1, 1])
    got = ba._scatter_mat(*_t(A), *_t(ii, jj), 2, 2)
    want = jba._scatter_mat(*_j(A), *_j(ii, jj), 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE)
    b = rng.normal(size=(1, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(ba._scatter_vec(*_t(b, ii), 2).numpy(),
                               np.asarray(jba._scatter_vec(*_j(b, ii), 2)),
                               **SOLVE)


def _problem(seed, n=4, h=12, w=16):
    """Frames over a fronto-parallel-ish scene: ground-truth poses and
    disparities, the |i - j| = 1 edges plus one invalid edge, perturbed
    starting poses (frame 0 kept) and disparities."""
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(n, 6)) * 0.03).astype(np.float32)
    disps_gt = rng.uniform(0.45, 0.55, size=(n, h, w)).astype(np.float32)
    intr = np.tile([20.0, 20.0, w / 2, h / 2], (n, 1)).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = np.abs(ii - jj) == 1
    ii = np.concatenate([ii[m], [0]])
    jj = np.concatenate([jj[m], [3]])
    ev = np.ones(len(ii), np.float32)
    ev[-1] = 0.0
    poses_gt = jlie.se3_exp(jnp.asarray(xi))
    target = np.asarray(jproj.projective_transform(
        poses_gt, jnp.asarray(disps_gt), jnp.asarray(intr), jnp.asarray(ii),
        jnp.asarray(jj))[0])
    noise = (rng.normal(size=(n, 6)) * 0.01).astype(np.float32)
    noise[0] = 0.0
    poses0 = np.asarray(jlie.se3_retr(poses_gt, jnp.asarray(noise)))
    disps0 = (disps_gt + rng.normal(size=disps_gt.shape) * 0.02).astype(
        np.float32)
    weight = rng.uniform(0.2, 1.0, target.shape).astype(np.float32)
    eta = np.full((n, h, w), 1e-2, np.float32)
    return dict(target=target, weight=weight, eta=eta, poses=poses0,
                disps=disps0, intrinsics=intr, ii=ii, jj=jj, edge_valid=ev)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("fixedp", [1, 2])
def test_bundle_adjust_matches_jax(fixedp):
    pr = _problem(4)
    keys = ("target", "weight", "eta", "poses", "disps", "intrinsics", "ii",
            "jj", "edge_valid")
    got = ba.bundle_adjust(*_t(*(pr[k] for k in keys)), fixedp=fixedp,
                           steps=2)
    want = jba.bundle_adjust(*_j(*(pr[k] for k in keys)), fixedp=fixedp,
                             steps=2)
    for g, w, what in zip(got, want, ("poses", "disps", "dzcov")):
        print(f"bundle_adjust fixedp={fixedp} {what}: rel "
              f"{_rel(g.numpy(), w):.2e}")
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **STEP)
    np.testing.assert_array_equal(got[0][:fixedp].numpy(),
                                  pr["poses"][:fixedp])
    # the BA moved the free poses toward the targets
    c0 = projective.projective_transform(*_t(pr["poses"], pr["disps"],
                                             pr["intrinsics"], pr["ii"],
                                             pr["jj"]))[0]
    c1 = projective.projective_transform(got[0], got[1],
                                         *_t(pr["intrinsics"], pr["ii"],
                                             pr["jj"]))[0]
    tgt = torch.tensor(pr["target"])[:-1]
    assert (c1[:-1] - tgt).abs().mean() < 0.5 * (c0[:-1] - tgt).abs().mean()


def test_moba_matches_jax():
    pr = _problem(5)
    keys = ("target", "weight", "poses", "disps", "intrinsics", "ii", "jj",
            "edge_valid")
    got = ba.moba(*_t(*(pr[k] for k in keys)), fixedp=1, steps=3)
    want = jba.moba(*_j(*(pr[k] for k in keys)), fixedp=1, steps=3)
    print(f"moba poses: rel {_rel(got.numpy(), want):.2e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)


@pytest.mark.parametrize("hw", [(3, 4), (1, 4)], ids=["grid", "one_row"])
def test_bilinear_upsample_with_jacobian(hw):
    """Values and the dense Jacobian; with one grid row both row taps meet
    one cell, and their weights accumulate (``index_put_`` with
    ``accumulate``)."""
    rng = np.random.default_rng(6)
    scales = rng.normal(size=(2,) + hw).astype(np.float32)
    vals, J = ba._bilinear_upsample_with_jacobian(*_t(scales), 12, 16)
    jv, jJ = jba._bilinear_upsample_with_jacobian(*_j(scales), 12, 16)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), **SOLVE)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), **SOLVE)
    np.testing.assert_allclose(J.sum(1).numpy(), 1.0, atol=1e-5)
    v2 = (J @ torch.tensor(scales).reshape(2, -1).T).T.reshape(2, 12, 16)
    np.testing.assert_allclose(v2.numpy(), vals.numpy(), atol=1e-5)


def test_jdsa_matches_jax():
    pr = _problem(7, n=3)
    rng = np.random.default_rng(8)
    n, h, w = pr["disps"].shape
    prior = (pr["disps"] / 1.25).astype(np.float32)
    prior[0, :2] = 0.0              # pixels without a prior
    dscales = (1 + 0.1 * rng.normal(size=(n, 3, 4))).astype(np.float32)
    ii, jj = np.asarray([0, 1, 1, 2]), np.asarray([1, 0, 2, 1])
    tgt = pr["target"][:4]
    ins = (tgt, pr["weight"][:4], pr["eta"], pr["poses"], pr["disps"],
           pr["intrinsics"], prior, dscales, ii, jj, np.ones(4, np.float32))
    got = ba.jdsa(*_t(*ins), alpha=0.05)
    want = jba.jdsa(*_j(*ins), alpha=0.05)
    for g, wv, what in zip(got, want, ("disps", "dscales", "dzcov")):
        print(f"jdsa {what}: rel {_rel(g.numpy(), wv):.2e}")
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), err_msg=what,
                                   **STEP)


def test_oracle_ba_recovers_pose_10x():
    """As tests/test_droid_convergence.py: fed the targets of the true
    geometry, 8 x 2 BA steps drive a perturbed pose back, >= 10x."""
    HT, WD = 12, 16
    rng = np.random.default_rng(0)
    d = 0.6 + 0.2 * np.sin(np.arange(WD) / 3.0)[None, :] \
        + 0.05 * rng.standard_normal((HT, WD))
    disps = torch.tensor(np.stack([d, d]), dtype=torch.float32)
    intr = torch.tensor([WD * 1.2, WD * 1.2, WD / 2, HT / 2]).expand(2, 4)
    xi = torch.tensor([0.04, -0.02, 0.03, 0.02, -0.015, 0.01])
    gt = torch.stack([lie.se3_identity(), lie.se3_exp(xi)])
    ii, jj = torch.tensor([0, 1]), torch.tensor([1, 0])
    target, _ = projective.projective_transform(gt, disps, intr, ii, jj)
    bad = torch.tensor([0.03, 0.025, -0.02, -0.015, 0.02, 0.012])
    poses = torch.stack([gt[0], lie.se3_mul(lie.se3_exp(bad), gt[1])])

    def err(p):
        return float((p[1] - gt[1]).norm())

    e0 = err(poses)
    weight = torch.ones(2, HT, WD, 2)
    eta = torch.full((2, HT, WD), 1e-4)
    cur = disps
    for _ in range(8):
        poses, cur, _ = ba.bundle_adjust(target, weight, eta, poses, cur,
                                         intr, ii, jj, torch.ones(2),
                                         fixedp=1, n_frames=2, steps=2)
    assert np.isfinite(err(poses)) and err(poses) < e0 / 10.0, (e0,
                                                                err(poses))
