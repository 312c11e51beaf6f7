"""The port's projective ops (``geometry/projective.py``) and the SE(3)
retraction / identity of ``geometry/lie.py`` against the JAX package on
the CPU: the same seeded numpy inputs through both.

Tolerance: 1e-5 absolute + 1e-5 relative, f32 on both sides, per element
for coordinates and the three Jacobians; the validity mask must be equal,
including pixels whose transformed depth lies on either side of
``MIN_DEPTH`` and below the projection's 0.5 ``MIN_DEPTH`` clamp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.geometry import lie as jlie, projective as jproj
from cut3r_slam_tpu_torch.geometry import lie, projective

from test_torch_cut3r_train import few_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def _problem(seed, n=3, h=12, w=16, near=False):
    """Poses, disparities, intrinsics and 4 edges; ``near`` pushes frame
    1 forward along z so that its pixels land around MIN_DEPTH."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)) * 0.2
    if near:
        xi[1, :3] = [0.0, 0.0, -0.55]
        xi[1, 3:] *= 0.1
    disps = rng.uniform(0.3, 2.2 if near else 1.5, size=(n, h, w))
    intr = np.tile([20.0, 22.0, w / 2, h / 2], (n, 1))
    ii = np.asarray([0, 1, 1, 2])
    jj = np.asarray([1, 0, 2, 1])
    f32 = np.float32
    return (xi.astype(f32), disps.astype(f32), intr.astype(f32), ii, jj)


def _poses(xi):
    return lie.se3_exp(torch.tensor(xi)), jlie.se3_exp(jnp.asarray(xi))


def test_se3_retr_and_identity():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(5, 6)).astype(np.float32) * 0.5
    d = rng.normal(size=(5, 6)).astype(np.float32) * 0.3
    pt, pj = _poses(g)
    _close(lie.se3_retr(pt, torch.tensor(d)),
           jlie.se3_retr(pj, jnp.asarray(d)))
    _close(lie.se3_identity((2, 3)), jlie.se3_identity((2, 3)))


def test_coords_iproj_proj_actp():
    xi, disps, intr, ii, jj = _problem(1)
    _close(projective.coords_grid(5, 7), jproj.coords_grid(5, 7))
    X, Jz = projective.iproj(torch.tensor(disps), torch.tensor(intr),
                             jacobian=True)
    Xj, Jzj = jproj.iproj(jnp.asarray(disps), jnp.asarray(intr),
                          jacobian=True)
    _close(X, Xj, "iproj")
    _close(Jz, Jzj, "iproj J")
    pt, pj = _poses(xi)
    X1, Ja = projective.actp(pt, X, jacobian=True)
    X1j, Jaj = jproj.actp(pj, Xj, jacobian=True)
    _close(X1, X1j, "actp")
    _close(Ja, Jaj, "actp J")
    for rd in (False, True):
        c, Jp = projective.proj(X1, torch.tensor(intr), jacobian=True,
                                return_depth=rd)
        cj, Jpj = jproj.proj(X1j, jnp.asarray(intr), jacobian=True,
                             return_depth=rd)
        _close(c, cj, f"proj rd={rd}")
        _close(Jp, Jpj, f"proj J rd={rd}")


@pytest.mark.parametrize("near", [False, True], ids=["generic",
                                                     "min_depth_edge"])
@pytest.mark.parametrize("return_depth", [False, True])
def test_projective_transform_matches_jax(near, return_depth):
    xi, disps, intr, ii, jj = _problem(2, near=near)
    pt, pj = _poses(xi)
    out = projective.projective_transform(
        pt, torch.tensor(disps), torch.tensor(intr), torch.tensor(ii),
        torch.tensor(jj), jacobian=True, return_depth=return_depth)
    ref = jproj.projective_transform(
        pj, jnp.asarray(disps), jnp.asarray(intr), jnp.asarray(ii),
        jnp.asarray(jj), jacobian=True, return_depth=return_depth)
    coords, valid, (Ji, Jj, Jz) = out
    assert coords.shape == (4, 12, 16, 3 if return_depth else 2)
    assert Ji.shape == (4, 12, 16, 3 if return_depth else 2, 6)
    assert Jz.shape[-1] == 1
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[1]))
    _close(coords, ref[0], "coords")
    for got, want, what in zip((Ji, Jj, Jz), ref[2], ("Ji", "Jj", "Jz")):
        _close(got, want, what)
    if near:
        # the edge cases are present: invalid pixels on both sides of the
        # 0.5 MIN_DEPTH clamp, valid ones too
        z = np.asarray(jproj.actp(
            jlie.se3_mul(pj[jj], jlie.se3_inv(pj[ii])),
            jproj.iproj(jnp.asarray(disps)[ii], jnp.asarray(intr)[ii])))[
            ..., 2]
        mdep = projective.MIN_DEPTH
        assert (z < 0.5 * mdep).any() and ((z > 0.5 * mdep)
                                           & (z < mdep)).any()
        assert (z > mdep).any()
    # without jacobians: the same coordinates and mask, broadcast (4,)
    # intrinsics
    c2, v2 = projective.projective_transform(
        pt, torch.tensor(disps), torch.tensor(intr[0]), torch.tensor(ii),
        torch.tensor(jj), return_depth=return_depth)
    _close(c2, ref[0], "coords, shared intrinsics")
    np.testing.assert_array_equal(v2.numpy(), np.asarray(ref[1]))


def test_pose_jacobians_match_autograd():
    """The analytic Jj / Ji equal torch's forward-mode derivative of the
    retraction-perturbed map (1e-3 relative, 1e-4 absolute: the JAX
    suite's tolerance for the same check)."""
    xi, disps, intr, ii, jj = _problem(3)
    pt, _ = _poses(xi)
    d, K = torch.tensor(disps), torch.tensor(intr)
    e_i, e_j = torch.tensor([0]), torch.tensor([1])
    _, valid, (Ji, Jj, _) = projective.projective_transform(
        pt, d, K, e_i, e_j, jacobian=True)
    mask = valid[0, ..., 0].numpy() > 0

    def f(x, frame):
        p = torch.cat([pt[:frame], lie.se3_retr(pt[frame:frame + 1], x[None]),
                       pt[frame + 1:]])
        return projective.projective_transform(p, d, K, e_i, e_j)[0][0]

    for frame, J in ((1, Jj), (0, Ji)):
        J_ad = torch.func.jacfwd(lambda x: f(x, frame))(torch.zeros(6))
        np.testing.assert_allclose(J[0].numpy()[mask], J_ad.numpy()[mask],
                                   rtol=1e-3, atol=1e-4)
