"""The dense BA's kernel path (``csrc/droid_ba.cu`` through
``ops/ba.bundle_adjust``) on the card. Every test needs a GPU (marker
``cuda``) and skips without one. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_ba_cuda.py -q

Inputs (``chip_smoke.droid_ba_case``): ``droid_track``'s shapes (290 edges
over 21 frames, 4 fixed, the 48x64 grid, repeated pairs, edges into fixed
frames) and a small case (5 frames, 2 fixed, 12x16, 18 edges). The plain
path is the same function on the CPU, in float32 and float64.

- Two steps' poses, disparities and depth covariance within 1e-4 of the
  plain float32 path's on the CPU, relative to the largest entry (the two
  sum in other orders: the kernels read up to 1.2e-5 at ``droid_track``'s
  shape; the card's own plain path reads up to 1.5e-4 from the CPU's on
  the covariance, 7.5e-5 on the disparities).
- The steps' distance from the float64 steps at most 3x the plain float32
  path's (the Schur complement's Cholesky amplifies any float32 rounding
  by the system's conditioning; the kernels read 0.45-0.54x).
- The plan and the gather: the kernels' plan equal to ``ba_plan``'s; their
  H, v, E blocks, block counts, Q and w bitwise the plain gather's
  (``plan_gather`` on the CPU: both add each cell's contributions in
  ascending order) from the kernels' own per-edge terms, and those H
  blocks within 1e-4 of the plain step's.
- The guards: a failed factorization (negative confidences) leaves the
  poses as they were, gives dz = Q w and a NaN covariance; non-finite
  targets give finite poses and disparities, as the plain path; the
  disparity clamp (beyond 10 -> 0, then at least 0.001).
- A rerun is bitwise; no host wait (``set_sync_debug_mode("error")``);
  five kernels a step, the plan's on the first and the covariance's on the
  last (``ops/ba.LAUNCHES``); every call that needs a gradient (a leaf that
  requires one, ``DroidNet``'s forward under autograd) takes the plain
  path and launches none.
"""
import pytest
import torch

from chip_smoke import droid_ba_case
from cut3r_slam_tpu_torch import full_f32
from cut3r_slam_tpu_torch.ops import ba
from cut3r_slam_tpu_torch.ops.ba import bundle_adjust

pytestmark = pytest.mark.cuda

CASES = {"droid_track": dict(seed=3),
         "small": dict(n=5, fixedp=2, h8=12, w8=16, n_edges=18, seed=4)}
STEP_KERNELS = ("ba_edge", "ba_gather", "ba_schur", "ba_solve", "ba_update")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BA kernels run only on the "
                    "card")
    with full_f32():
        yield torch.device("cuda")


def _case(name):
    return droid_ba_case(**CASES[name]), CASES[name].get("fixedp", 4)


def _rel_max(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_steps_match_the_plain_steps(cuda, name):
    args, fixedp = _case(name)
    cpu = [a.cpu() for a in args]
    with torch.no_grad():
        got = bundle_adjust(*args, fixedp=fixedp, steps=2)
        want = bundle_adjust(*cpu, fixedp=fixedp, steps=2)
        f64 = bundle_adjust(*[a.double() if a.is_floating_point() else a
                              for a in cpu], fixedp=fixedp, steps=2)
    for what, g, r in zip(("poses", "disps", "dzcov"), got, want):
        assert torch.isfinite(g).all(), what
        assert _rel_max(g, r) <= 1e-4, (what, _rel_max(g, r))
    for k, what in ((0, "poses"), (1, "disps")):
        x0 = cpu[3 + k].double()
        truth = f64[k] - x0
        dk = float(((got[k].cpu().double() - x0) - truth).norm())
        dp = float(((want[k].double() - x0) - truth).norm())
        assert dk <= 3.0 * dp, (what, dk, dp)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_gather_is_the_plain_gather(cuda, name):
    """One step with the kernels' buffers kept: the gathered system against
    ``plan_gather`` on the kernels' own per-edge terms, and H against the
    plain step's ``_pose_system``."""
    args, fixedp = _case(name)
    target, weight, eta, poses, disps, intr, ii, jj, ev = args
    P0, HW = poses.shape[0], disps.shape[1] * disps.shape[2]
    P, E = P0 - fixedp, len(ii)
    work = ba._step_work(E, P, P0, HW, cuda)
    with torch.no_grad():
        ba._bundle_adjust_cuda(*args, fixedp, P0, 1, work=work)
    torch.cuda.synchronize()
    w = {k: t.cpu() for k, t in work.items()}
    cells = w["cells"]
    assert torch.equal(cells, ba.ba_plan(ii.cpu(), jj.cpu(), fixedp, P0))
    H, v, Ed, nz, Q, wv = ba.plan_gather(cells, w["HB"], w["VB"], w["EB"],
                                         w["CW"], eta.cpu(), P, P0)
    assert torch.equal(w["H"].reshape(P, P, 6, 6), H)
    assert torch.equal(w["v"], v)
    assert torch.equal(w["Ed"], Ed)
    assert torch.equal(w["nzE"], nz)
    assert torch.equal(w["Q"], Q)
    assert torch.equal(w["w"], wv)
    cpu = [a.cpu() for a in args]
    Jif, Jjf, rf, wf, _ = ba._edge_terms(*cpu[:2], cpu[3], cpu[4], cpu[5],
                                         cpu[6], cpu[7], cpu[8])
    Hp, vp, _, _ = ba._pose_system(Jif, Jjf, rf, wf, cpu[6] - fixedp,
                                   cpu[7] - fixedp, P)
    assert _rel_max(H, Hp[0]) <= 1e-4
    assert _rel_max(v, vp[0]) <= 1e-4


def test_failure_guards(cuda):
    args, fixedp = _case("small")
    # negative confidences: an indefinite system, the factorization fails
    bad = list(args)
    bad[1] = -args[1]
    with torch.no_grad():
        p, d, cov = bundle_adjust(*bad, fixedp=fixedp, steps=1)
        pp, pd, pc = bundle_adjust(*[a.cpu() for a in bad], fixedp=fixedp,
                                   steps=1)
    # a zero pose update: exp(0) * g, the quaternion renormalised
    assert _rel_max(p, pp) <= 1e-6 and _rel_max(p, args[3]) <= 1e-6
    assert torch.isnan(cov).all() and torch.isnan(pc).all()
    assert _rel_max(d, pd) <= 1e-5
    # non-finite targets: zeroed steps, finite results as the plain path's
    bad = list(args)
    bad[0] = args[0].clone()
    bad[0][3, 2, 4, 0] = float("nan")
    bad[0][5, 1, 1, 1] = float("inf")
    with torch.no_grad():
        got = bundle_adjust(*bad, fixedp=fixedp, steps=2)
        want = bundle_adjust(*[a.cpu() for a in bad], fixedp=fixedp,
                             steps=2)
    for g, r in zip(got[:2], want[:2]):
        assert torch.isfinite(g).all()
        assert _rel_max(g, r) <= 1e-4
    # the disparity clamp: beyond 10 -> 0, then at least 0.001
    bad = list(args)
    bad[4] = args[4].clone()
    bad[4][1, :2, :3] = 20.0
    bad[4][2, 3, :4] = -1.0
    with torch.no_grad():
        got = bundle_adjust(*bad, fixedp=fixedp, steps=1)
        want = bundle_adjust(*[a.cpu() for a in bad], fixedp=fixedp,
                             steps=1)
    assert _rel_max(got[1], want[1]) <= 1e-4
    assert (got[1][1, :2, :3] == 0.001).all()


def test_rerun_bitwise_without_host_wait(cuda):
    args, fixedp = _case("droid_track")
    with torch.no_grad():
        first = bundle_adjust(*args, fixedp=fixedp, steps=2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = bundle_adjust(*args, fixedp=fixedp, steps=2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_launches_per_step(cuda):
    args, fixedp = _case("small")
    before = dict(ba.LAUNCHES)
    with torch.no_grad():
        bundle_adjust(*args, fixedp=fixedp, steps=3)
    torch.cuda.synchronize()
    got = {k: ba.LAUNCHES[k] - before[k] for k in ba.LAUNCHES}
    assert got == {**{k: 3 for k in STEP_KERNELS}, "ba_plan": 1,
                   "ba_cov": 1}


def test_gradient_calls_take_the_plain_path(cuda):
    from chip_smoke import droid_clip
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    args, fixedp = _case("small")
    before = dict(ba.LAUNCHES)
    p = args[3].clone().requires_grad_()
    poses, _, _ = bundle_adjust(*args[:3], p, *args[4:], fixedp=fixedp,
                                steps=2)
    poses.sum().backward()
    assert p.grad is not None and torch.isfinite(p.grad).all()
    # DroidNet's forward under autograd: the plain BA inside it
    net = init_random(DroidNet(device="cuda"),
                      torch.Generator(device="cuda").manual_seed(1))
    imgs = torch.rand(3, 64, 64, 3, device=cuda) * 255
    p3, d3, k3 = (torch.tensor(a, device=cuda)
                  for a in droid_clip(3, 8, 8, 9.6, 14))
    e3 = (torch.tensor([0, 1, 1, 2], device=cuda),
          torch.tensor([1, 0, 2, 1], device=cuda))
    ev = torch.ones(4, device=cuda)
    out = net(p3, imgs, d3, k3, *e3, ev, num_steps=2, fixedp=1)
    out[2].abs().mean().backward()
    assert ba.LAUNCHES == before
    # the same forward without a gradient takes the kernels
    with torch.no_grad():
        net(p3, imgs, d3, k3, *e3, ev, num_steps=2, fixedp=1)
    assert ba.LAUNCHES["ba_edge"] == before["ba_edge"] + 4
