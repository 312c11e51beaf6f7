"""Sim(3) port vs the JAX package on the CPU: the group functions of
``geometry/lie.py``, the PGBA edge Jacobians at zero perturbation, the
block-sparse Gauss-Newton solve (against JAX and against the port's own
dense oracle) and the live-path ``PGBABuffer``.

Tolerances: group functions 1e-5 absolute + 1e-4 relative (f32, the same
formulas in another summation order; ``sim3_log`` solves its 3x3 system by
Cramer's rule where JAX factorizes it); Jacobians 1e-5 + 1e-4 relative;
four Gauss-Newton steps 1e-5 + 1e-4 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.geometry import lie as JL
from cut3r_slam_tpu.slam import sim3_pgo as JS
from cut3r_slam_tpu.slam.keyframe import KeyframeStore as JKeyframes
from cut3r_slam_tpu_torch.geometry import lie as TL
from cut3r_slam_tpu_torch.slam import sim3_pgo as TS
from cut3r_slam_tpu_torch.slam.keyframe import KeyframeStore

from test_torch_cut3r_train import few_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-4)


def _tangents(n=64, seed=0):
    """sim(3) tangents covering every branch of ``_sim3_W``: zero, small
    angles, small and negative scales, large angles, and mixes."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 7)).astype(np.float32)
    xi[0] = 0.0
    xi[1:8, 3:6] *= 1e-3                                # |phi| < 1e-2
    xi[8:16, 6] *= 0.01                                 # |sigma| < 0.05
    xi[16:24, 6] = -np.abs(xi[16:24, 6])                # negative sigma
    xi[24:28, 3:6] *= 2.0                               # large angles
    xi[28:32, 3:6] *= 1e-3
    xi[28:32, 6] = -np.abs(xi[28:32, 6]) * 0.01         # both small, sigma<0
    xi[32:36, 6] = 0.0
    xi[36:40, 3:6] = 0.0                                # phi = 0 exactly
    return xi


def _groups(seed=0):
    return np.asarray(JL.sim3_exp(jnp.asarray(_tangents(seed=seed))))


def _pair(name):
    return getattr(JL, name), getattr(TL, name)


@pytest.mark.parametrize("name", ["sim3_exp"])
def test_sim3_exp(name):
    jf, tf = _pair(name)
    xi = _tangents()
    np.testing.assert_allclose(tf(torch.tensor(xi)).numpy(),
                               np.asarray(jf(jnp.asarray(xi))), **TOL)


@pytest.mark.parametrize("name", ["sim3_log", "sim3_inv", "sim3_matrix"])
def test_sim3_unary(name):
    jf, tf = _pair(name)
    g = _groups()
    np.testing.assert_allclose(tf(torch.tensor(g)).numpy(),
                               np.asarray(jf(jnp.asarray(g))), **TOL)


def test_sim3_log_inverts_exp():
    xi = _tangents()
    back = TL.sim3_log(TL.sim3_exp(torch.tensor(xi))).numpy()
    np.testing.assert_allclose(back[:24], xi[:24], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["sim3_mul", "sim3_retr", "sim3_act"])
def test_sim3_binary(name):
    jf, tf = _pair(name)
    g = _groups(0)
    other = {"sim3_mul": _groups(1), "sim3_retr": _tangents(seed=1) * 0.3,
             "sim3_act": np.random.default_rng(2).normal(
                 size=(g.shape[0], 3)).astype(np.float32)}[name]
    np.testing.assert_allclose(
        tf(torch.tensor(g), torch.tensor(other)).numpy(),
        np.asarray(jf(jnp.asarray(g), jnp.asarray(other))), **TOL)


def test_sim3_from_matrix_and_identity():
    m = np.asarray(JL.sim3_matrix(jnp.asarray(_groups())))
    a = TL.sim3_from_matrix(torch.tensor(m)).numpy()
    b = np.asarray(JL.sim3_from_matrix(jnp.asarray(m)))
    flip = np.sign(np.sum(a[:, 3:7] * b[:, 3:7], -1, keepdims=True))
    a[:, 3:7] *= flip                     # quaternions are sign-ambiguous
    np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(TL.sim3_identity((2,)).numpy(),
                                  np.asarray(JL.sim3_identity((2,))))


@pytest.mark.parametrize("name", ["so3_inv", "so3_matrix", "so3_mul",
                                  "so3_act"])
def test_so3_helpers(name):
    jf, tf = _pair(name)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    args = [q]
    if name == "so3_mul":
        args.append(q[::-1].copy())
    elif name == "so3_act":
        args.append(rng.normal(size=(16, 3)).astype(np.float32))
    np.testing.assert_allclose(
        tf(*[torch.tensor(a) for a in args]).numpy(),
        np.asarray(jf(*[jnp.asarray(a) for a in args])), **TOL)


def _graph(N=6, seed=0):
    """Poses, an edge list with repeated (i, j) pairs and zero-weight
    (0, 0) self-loops at the identity (the JAX package's padding rows),
    measurements from a perturbed ground truth, and weights."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(N, 7)).astype(np.float32) * 0.3
    xi[:, 6] *= 0.2
    xi[0] = 0.0
    g = np.array(JL.sim3_exp(jnp.asarray(xi)))
    gt = np.array(JL.sim3_exp(jnp.asarray(xi * 0.9)))
    ii = np.array([0, 1, 2, 3, 4, 0, 1, 1, 1, 0, 0, 2], np.int32)
    jj = np.array([1, 2, 3, 4, 5, 5, 2, 3, 3, 0, 0, 4], np.int32)
    rel = np.array(JL.sim3_mul(JL.sim3_inv(jnp.asarray(gt[ii])),
                               jnp.asarray(gt[jj])))
    rel[9:11] = [0, 0, 0, 0, 0, 0, 1, 1]
    w = np.array([1, 1, 1, 1, 1, 2, .5, .5, .7, 0, 0, 1], np.float32)
    return g, ii, jj, rel, w


def _t(*arrs):
    return [torch.tensor(a).long() if a.dtype == np.int32 else torch.tensor(a)
            for a in arrs]


def test_edge_jacobians_at_zero():
    """``vmap(jacfwd)`` at zero perturbation, on a batch that mixes general
    edges with identity self-loops (``sim3_log`` through
    ``torch.linalg.solve`` gave wrong Jacobians here under vmap)."""
    g, ii, jj, rel, _ = _graph()
    r_j, J_j = JS._edge_jacobians(*map(jnp.asarray, (g, ii, jj, rel)))
    r_t, J_t = TS._edge_jacobians(*_t(g, ii, jj, rel))
    assert torch.isfinite(J_t).all()
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), **TOL)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)


def test_sim3_pgo_solve_matches_jax_and_dense():
    g, ii, jj, rel, w = _graph()
    ref = np.asarray(JS.sim3_pgo_solve(*map(jnp.asarray, (g, ii, jj, rel, w)),
                                       iters=4))
    out = TS.sim3_pgo_solve(*_t(g, ii, jj, rel, w), iters=4).numpy()
    dense = TS.sim3_pgo_solve_dense(*_t(g, ii, jj, rel, w), iters=4).numpy()
    assert np.abs(out - g).max() > 0.02      # the solve moved the poses
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, dense, **TOL)
    np.testing.assert_allclose(out[0], g[0], atol=1e-6)   # pinned


def test_duplicate_edges_accumulate():
    """A repeated edge counts twice: the same graph with the duplicate's
    weight folded into one edge solves to the same poses."""
    g, ii, jj, rel, w = _graph()
    keep = np.ones(len(ii), bool)
    keep[8] = False                         # (1, 3) repeats edge 7
    w2 = w.copy()
    w2[7] += w[8]
    a = TS.sim3_pgo_solve(*_t(g, ii, jj, rel, w), iters=3).numpy()
    b = TS.sim3_pgo_solve(*_t(g, ii[keep], jj[keep], rel[keep], w2[keep]),
                          iters=3).numpy()
    np.testing.assert_allclose(a, b, **TOL)


def _stores(n=10, seed=5):
    """Keyframe stores of both packages holding the same drifted poses,
    unit depths and a seeded confidence map."""
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.normal(size=(n, 6)).astype(np.float32) * 0.1, 0)
    xi[0] = 0.0
    poses = np.asarray(JL.se3_exp(jnp.asarray(xi)))
    conf = rng.uniform(0.2, 0.9, (n // 5 + 1, 6, 8, 12)).astype(np.float32)
    jk = JKeyframes(16, (16, 24), feat_tokens=1, feat_dim=4)
    tk = KeyframeStore(16, (16, 24), feat_tokens=1, feat_dim=4)
    for k in (jk, tk):
        for i in range(n):
            k.append(i, np.zeros((16, 24, 3), np.uint8), pose=poses[i])
        k.depth[:n] = 1.0 + 0.1 * np.arange(n)[:, None, None]
    jk.submap_conf = jk.submap_conf.at[:conf.shape[0]].set(jnp.asarray(conf))
    tk.submap_conf[:conf.shape[0]] = torch.tensor(conf)
    return jk, tk


@pytest.mark.parametrize("conf_weighting", [False, True])
def test_pgba_buffer_matches_jax(conf_weighting):
    """Odometry edges, a loop edge with a drifted measurement, the solve
    and the pose / depth writeback. The JAX buffer pads poses to 32 and
    edges to 64; the port solves the real rows only."""
    jk, tk = _stores()
    n = jk.count
    jb = JS.PGBABuffer(iters=4, conf_weighting=conf_weighting)
    tb = TS.PGBABuffer(iters=4, conf_weighting=conf_weighting)
    for b, k in ((jb, jk), (tb, tk)):
        b.on_new_keyframes(k, 6)
        b.on_new_keyframes(k, n)
        k.pose[n - 1, :3] += np.float32([0.05, -0.03, 0.02])
        b.on_loop(0, n - 1, k)
    assert tb.pgo.ii == jb.pgo.ii and tb.pgo.jj == jb.pgo.jj
    np.testing.assert_allclose(tb.pgo.w, jb.pgo.w, rtol=1e-6)
    np.testing.assert_allclose(np.stack(tb.pgo.rel), np.stack(jb.pgo.rel),
                               **TOL)
    gj = jb.solve_and_writeback(jk)
    gt = tb.solve_and_writeback(tk)
    assert np.abs(gt[:, 7] - 1.0).max() > 1e-4       # scales were solved
    np.testing.assert_allclose(gt, gj, **TOL)
    np.testing.assert_allclose(tk.pose[:n], jk.pose[:n], **TOL)
    np.testing.assert_allclose(tk.depth[:n], jk.depth[:n], **TOL)


def test_sim3pgo_solve_recovers_drift():
    """The JAX suite's drift case (tests/test_sim3_pgo.py) through both
    ``Sim3PGO.solve``s: sequential edges plus one loop edge."""
    rng = np.random.default_rng(2)
    xi = rng.normal(size=(8, 6)).astype(np.float32) * 0.2
    xi[0] = 0
    gt = np.asarray(JL.se3_exp(jnp.asarray(np.cumsum(xi, 0))))
    drift = rng.normal(size=(8, 6)).astype(np.float32) * 0.05
    drift[0] = 0
    init = np.asarray(JL.se3_retr(jnp.asarray(gt), jnp.asarray(drift)))
    loop = np.asarray(JL.se3_mul(JL.se3_inv(jnp.asarray(gt[0])),
                                 jnp.asarray(gt[7])))
    outs = []
    for mod in (JS, TS):
        pgo = mod.Sim3PGO()
        pgo.add_sequential_constraints(gt, weight=1.0)
        pgo.add_relative_se3(0, 7, loop, weight=5.0)
        kw = {"device": "cpu"} if mod is TS else {}
        outs.append(np.asarray(pgo.solve(init, iters=8, **kw)))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    with pytest.raises(TypeError):      # the device is the caller's choice
        pgo.solve(init, iters=8)
    err = np.abs(TL.se3_log(TL.se3_mul(
        torch.tensor(outs[1][:, :7]), TL.se3_inv(torch.tensor(gt))))).mean()
    err0 = np.abs(drift).mean()
    assert float(err) < 0.3 * err0
