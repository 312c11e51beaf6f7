"""The plan that the dense BA's card kernels (``csrc/droid_ba.cu``) gather
by, run on CPU tensors: ``ops/ba.ba_plan`` (built from ``ii`` / ``jj`` on
their device) and its plain gather ``plan_gather`` must reproduce the
dense layout that the plain step builds with ``_scatter_mat`` /
``_scatter_vec``, on random graphs with edges into fixed frames and
repeated (i, j) pairs: the pose blocks H and v, the pose-depth blocks E by
(row, depth frame k), C and w. Integer-valued terms make every sum exact,
so the layouts must be equal, not close. The nonzero E blocks the plan
counts, and the (a, b, k) Schur list they give, must be exactly the
blocks and products that are nonzero in the dense E Q E^T.

The counters: ``bundle_adjust`` counts its steps by path
(``ba.steps.plain`` here), and the DROID tracker counts the BA's edges
of each update (``droid.ba.edges``).
"""
import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.ops import ba
from cut3r_slam_tpu_torch.ops.ba import _scatter_mat, _scatter_vec
from cut3r_slam_tpu_torch.utils import profiling

SEEDS = [0, 1, 2, 3]


def _graph(seed):
    """(ii, jj, fixedp, P0, HW): random edges i != j, a third of them
    repeated, some into or out of the fixed frames."""
    rng = np.random.default_rng(seed)
    P0 = int(rng.integers(4, 9))
    fixedp = int(rng.integers(0, 4))
    n = int(rng.integers(10, 30))
    ii = rng.integers(0, P0, n)
    jj = (ii + rng.integers(1, P0, n)) % P0
    rep = rng.choice(n, n // 3)
    ii = np.concatenate([ii, ii[rep]])
    jj = np.concatenate([jj, jj[rep]])
    perm = rng.permutation(len(ii))
    return (torch.tensor(ii[perm]), torch.tensor(jj[perm]), fixedp, P0,
            int(rng.integers(3, 7)))


def _terms(rng, E, HW):
    """Per-edge terms as the edge kernel lays them out, strictly positive
    integers (every landed sum nonzero and exact)."""
    def ints(*shape):
        return torch.tensor(rng.integers(1, 9, shape), dtype=torch.float32)
    HB = ints(4, E, 36)
    HB[2] = HB[1].reshape(E, 6, 6).transpose(1, 2).reshape(E, 36)
    return HB, ints(2, E, 6), ints(2, E, 6, HW), ints(E, 2, HW)


def _dense(ii, jj, fixedp, P0, HB, VB, EB, CW, eta):
    """The plain step's layout (``bundle_adjust`` / ``_pose_system``)."""
    P = P0 - fixedp
    E, HW = EB.shape[1], EB.shape[-1]
    iis, jjs, kk = ii - fixedp, jj - fixedp, ii
    Hb = HB.reshape(4, 1, E, 6, 6)
    H = (_scatter_mat(Hb[0], iis, iis, P, P)
         + _scatter_mat(Hb[1], iis, jjs, P, P)
         + _scatter_mat(Hb[2], jjs, iis, P, P)
         + _scatter_mat(Hb[3], jjs, jjs, P, P)).reshape(P, P, 6, 6)
    v = _scatter_vec(VB[0][None], iis, P) + _scatter_vec(VB[1][None], jjs, P)
    Em = (_scatter_mat(EB[0].transpose(1, 2)[None], iis, kk, P, P0)
          + _scatter_mat(EB[1].transpose(1, 2)[None], jjs, kk, P, P0))
    Em = Em.transpose(2, 3).reshape(P, P0, 6, HW)
    C = _scatter_vec(CW[None, :, 0], kk, P0) + eta.reshape(1, P0, HW) + 1e-7
    w = _scatter_vec(CW[None, :, 1], kk, P0)
    return H, v[0], Em, 1.0 / C[0], w[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_gather_reproduces_the_dense_layout(seed):
    ii, jj, fixedp, P0, HW = _graph(seed)
    rng = np.random.default_rng(100 + seed)
    HB, VB, EB, CW = _terms(rng, len(ii), HW)
    eta = torch.tensor(rng.uniform(0.5, 2.0, (P0, HW)), dtype=torch.float32)
    cells = ba.ba_plan(ii, jj, fixedp, P0)
    assert cells.dtype == torch.int32 and cells.shape == (9 * len(ii),)
    H, v, Ed, nz, Q, w = ba.plan_gather(cells, HB, VB, EB, CW, eta,
                                        P0 - fixedp, P0)
    want = _dense(ii, jj, fixedp, P0, HB, VB, EB, CW, eta)
    for name, got, ref in zip(("H", "v", "E", "Q", "w"), (H, v, Ed, Q, w),
                              want):
        assert torch.equal(got, ref), name
    # an E block counts Ei of each edge whose frame i is free and Ej of
    # each whose frame j is
    assert int(nz.sum()) == int((ii >= fixedp).sum() + (jj >= fixedp).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_blocks_and_schur_list_are_the_nonzero_products(seed):
    ii, jj, fixedp, P0, HW = _graph(seed)
    P = P0 - fixedp
    rng = np.random.default_rng(200 + seed)
    HB, VB, EB, CW = _terms(rng, len(ii), HW)
    eta = torch.ones(P0, HW)
    cells = ba.ba_plan(ii, jj, fixedp, P0)
    _, _, Ed, nz, Q, _ = ba.plan_gather(cells, HB, VB, EB, CW, eta, P, P0)
    # the nonzero (row, k) E blocks
    assert torch.equal(nz > 0, Ed.abs().sum((2, 3)) > 0)
    # each (row, k) block: the edges (i = k, row a_i) and (i = k, row a_j)
    for a in range(P):
        for k in range(P0):
            want = int(((ii == k) & (ii - fixedp == a)).sum()
                       + ((ii == k) & (jj - fixedp == a)).sum())
            assert int(nz[a, k]) == want
    # the Schur list: (a, b, k) with both blocks nonzero, exactly the
    # nonzero products E_ak Q_k E_bk^T
    listed = (nz[:, None, :] > 0) & (nz[None, :, :] > 0)
    EQ = Ed.double() * Q.double()[None, :, None, :]
    prod = torch.einsum("akdp,bkep->abkde", EQ, Ed.double())
    assert torch.equal(listed, prod.abs().sum((3, 4)) > 0)
    # and the Schur term summed over the list is the dense one
    Ef = Ed.permute(0, 2, 1, 3).reshape(6 * P, P0 * HW).double()
    dense = (Ef * Q.reshape(-1).double()) @ Ef.T
    sparse = (prod * listed[..., None, None]).sum(2)
    assert torch.allclose(sparse.permute(0, 2, 1, 3).reshape(6 * P, 6 * P),
                          dense, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_cells_by_group(seed):
    """Each contribution's cell from its edge alone: the pose blocks and
    rows drop a fixed frame, the depth terms go to frame i."""
    ii, jj, fixedp, P0, _ = _graph(seed)
    P, E = P0 - fixedp, len(ii)
    cells = ba.ba_plan(ii, jj, fixedp, P0).reshape(9, E).long()
    a = torch.stack([ii, jj]) - fixedp
    free = a >= 0
    pairs = ((0, 0), (0, 1), (1, 0), (1, 1))
    for t, (r, c) in enumerate(pairs):
        ok = free[r] & free[c]
        assert torch.equal(cells[t], torch.where(ok, a[r] * P + a[c], -1))
    for t in (0, 1):
        assert torch.equal(cells[4 + t], torch.where(free[t], a[t], -1))
        assert torch.equal(cells[6 + t],
                           torch.where(free[t], a[t] * P0 + ii, -1))
    assert torch.equal(cells[8], ii)


class _Counts:
    def __init__(self):
        self.counters = {}

    def __call__(self, name):
        return profiling._NOOP

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


def test_bundle_adjust_counts_its_steps_by_path():
    ii, jj, fixedp, P0, _ = _graph(5)
    rng = np.random.default_rng(5)
    h, w, E = 3, 4, len(ii)
    poses = torch.zeros(P0, 7)
    poses[:, 6] = 1
    poses[:, 2] = torch.linspace(0, 0.1, P0)
    args = [torch.tensor(rng.uniform(0, 4, (E, h, w, 2)),
                         dtype=torch.float32),
            torch.tensor(rng.uniform(0, 1, (E, h, w, 2)),
                         dtype=torch.float32),
            torch.full((P0, h, w), 1e-2), poses, torch.full((P0, h, w), 0.5),
            torch.tensor([3.0, 3.0, 2.0, 1.5]), ii, jj, torch.ones(E)]
    timer = _Counts()
    prev = profiling.attach(timer)
    try:
        ba.bundle_adjust(*args, fixedp=fixedp, steps=3)
    finally:
        profiling.attach(prev)
    assert timer.counters == {"ba.steps.plain": 3}
