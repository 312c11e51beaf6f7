"""The rasterizer's cached bin plan against the JAX package on the CPU.

``compute_bin_plan`` (``cut3r_slam_tpu/ops/gs_raster.py:419-455``) is held
bitwise; a render and its gradients through a plan are held against
``rasterize_pallas(interpret=True, bins=plan)`` and against the port's own
fresh-bin render; the inverse Gaussian -> entry map of
``_bin_gaussians(return_inverse=True)`` is held bitwise; a malformed
``bins`` raises. Scenes and loss are those of
tests/test_gs_raster_pallas.py (32x32, max_per_tile 64).

Tolerances: plan against fresh bins, within the port, are those of
``test_planned_bins_grads_match_fresh`` (maps 1e-5, gradient error /
max|grad| 1e-5); the port against JAX are those of
tests/test_torch_gs_raster.py (color / alpha 1e-4, depths / normal 1e-3,
gradients 5e-4), because the two packages' blends round differently.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.ops import gs_raster as JR
from cut3r_slam_tpu.ops.gs_raster_pallas import (rasterize_pallas,
                                                 rasterize_pallas_multi)
from cut3r_slam_tpu_torch.ops import gs_raster as TR
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_gs_raster import (CFG, JCFG, K4, MAPS, _close, _j, _loss,
                                  _random_scene, _t, _views)

NAMES = ("means", "quats", "scales", "opac", "colors")


def _grid_scene():
    """One identical (anisotropic, so that the rotation has a gradient)
    Gaussian at the centre of each 16x16 tile: every tile holds the same
    count, so the occupancy sort is all ties."""
    ty, tx = np.meshgrid(np.arange(2), np.arange(2), indexing="ij")
    u = tx.reshape(-1) * 16 + 8.0
    v = ty.reshape(-1) * 16 + 8.0
    z = np.full(u.shape, 2.0)
    means = np.stack([(u - K4[2]) / K4[0] * z, (v - K4[3]) / K4[1] * z, z],
                     -1)
    n = len(z)
    rng = np.random.default_rng(6)
    return [np.asarray(a, np.float32) for a in (
        means, np.tile(np.asarray([0.9, 0.3, 0.2, 0.1]) / np.sqrt(0.95), (n, 1)),
        np.tile([0.012, 0.007, 0.01], (n, 1)),
        np.full((n,), 0.7), rng.uniform(0, 1, (n, 3)))]


SCENES = {"random": lambda: _random_scene(60), "tied": _grid_scene}


def _jax_plan(arrs):
    m, q, s, o, _ = _j(arrs)
    eg, em = JR.compute_bins(m, q, s, o, jnp.asarray(K4), JCFG)
    return (eg, em) + tuple(JR.compute_bin_plan(eg, em, m.shape[0], JCFG))


def _torch_plan(arrs):
    m, q, s, o, _ = _t(arrs)
    eg, em = TR.compute_bins(m, q, s, o, torch.tensor(K4), CFG)
    return (eg, em) + tuple(TR.compute_bin_plan(eg, em, m.shape[0], CFG))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compute_bin_plan_bitwise(scene):
    arrs = SCENES[scene]()
    jp = _jax_plan(arrs)
    tp = _torch_plan(arrs)
    if scene == "tied":                 # the occupancy sort is all ties
        counts = np.asarray(jp[1]).sum(1)
        assert (counts == counts[0]).all() and counts[0] > 0
    for name, a, b in zip(("entry_gauss", "entry_mask", "order",
                           "inv_order", "perm", "bounds"), jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    # the plan alone, from JAX's bins
    tp2 = TR.compute_bin_plan(torch.tensor(np.asarray(jp[0])),
                              torch.tensor(np.asarray(jp[1])),
                              arrs[0].shape[0], CFG)
    for a, b in zip(jp[2:], tp2):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tp[4].dtype == tp[5].dtype == torch.int32


def _torch_bins(plan):
    return tuple(torch.tensor(np.asarray(x)) for x in plan)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_planned_render_and_gradients_match_pallas(scene):
    arrs = SCENES[scene]()
    jp = _jax_plan(arrs)

    def jloss(*a):
        out = rasterize_pallas(*a, jnp.asarray(K4), JCFG, interpret=True,
                               bins=jp)
        return _loss(out), out
    (_, ref), g_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(*_j(arrs))
    ts = _t(arrs, grad=True)
    out = G.rasterize_cuda(*ts, torch.tensor(K4), CFG, bins=_torch_bins(jp))
    _close(out, ref)
    _loss(out).backward()
    for name, a, b in zip(NAMES, g_ref, ts):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b.grad.numpy() / scale, a / scale,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_planned_render_matches_fresh_bins(scene):
    """Within the port: a plan changes the row order, not the render or
    its gradients."""
    arrs = SCENES[scene]()
    bins = _torch_plan(arrs)
    outs, grads = [], []
    for b in (None, bins):
        ts = _t(arrs, grad=True)
        out = G.rasterize_cuda(*ts, torch.tensor(K4), CFG, bins=b)
        _loss(out).backward()
        outs.append(out)
        grads.append([t.grad.numpy() for t in ts])
    for k in MAPS:
        np.testing.assert_allclose(outs[1][k].detach().numpy(),
                                   outs[0][k].detach().numpy(), atol=1e-5,
                                   err_msg=k)
    fwd = G.rasterize_cuda_forward(*_t(arrs), torch.tensor(K4), CFG,
                                   bins=bins)
    for k in MAPS:
        np.testing.assert_allclose(fwd[k].numpy(),
                                   outs[0][k].detach().numpy(), atol=1e-5,
                                   err_msg=k)
    for name, a, b in zip(NAMES, *grads):
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-5,
                                   err_msg=name)
    # the plain oracle takes a plan and needs only its bins
    p_fresh = TR.rasterize(*_t(arrs), torch.tensor(K4), CFG, bins=bins[:2])
    p_plan = TR.rasterize(*_t(arrs), torch.tensor(K4), CFG, bins=bins)
    for k in p_fresh:
        assert torch.equal(p_plan[k], p_fresh[k]), k


def test_multi_view_plan_matches_pallas_and_fresh():
    """Stacked per-view plans in the fused V-view render, as
    ``test_multi_view_planned_bins_parity`` drives the JAX path."""
    arrs = _views()
    mc, qc = arrs[0], arrs[1]
    per = [_jax_plan([mc[v], qc[v]] + list(arrs[2:]))
           for v in range(mc.shape[0])]
    jbins = tuple(jnp.stack([p[i] for p in per]) for i in range(6))
    wts = np.asarray([1.0, 0.7, 0.3], np.float32)

    def weighted(out, xp):
        return ((out["color"].mean((1, 2, 3)) + out["depth"].mean((1, 2)))
                * xp.asarray(wts)).sum()

    def jloss(m, q, s, o, c):
        out = rasterize_pallas_multi(m, q, s, o, c, jnp.asarray(K4), JCFG,
                                     interpret=True, bins=jbins)
        return weighted(out, jnp), out
    (_, ref), g_ref = jax.value_and_grad(jloss, argnums=(0, 2, 3, 4),
                                         has_aux=True)(*_j(arrs))
    outs, grads = [], []
    for b in (_torch_bins(jbins), None):
        ts = _t(arrs, grad=True)
        out = G.rasterize_cuda_multi(*ts, torch.tensor(K4), CFG, bins=b)
        weighted(out, torch).backward()
        outs.append(out)
        grads.append([ts[i].grad.numpy() for i in (0, 2, 3, 4)])
    _close(outs[0], ref)
    for k in MAPS:
        np.testing.assert_allclose(outs[0][k].detach().numpy(),
                                   outs[1][k].detach().numpy(), atol=1e-5,
                                   err_msg=k)
    for name, a, b, c in zip(("means", "scales", "opac", "colors"), g_ref,
                             *grads):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4,
                                   err_msg=name)
        scale = np.abs(c).max() + 1e-6
        np.testing.assert_allclose(b / scale, c / scale, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bin_inverse_map_matches_jax(scene):
    """The same preprocess (JAX's, handed to both) bins to the same
    entries and the same inverse map."""
    arrs = SCENES[scene]()
    pre = JR._preprocess(*_j(arrs[:4]), jnp.asarray(K4), JCFG)
    jout = JR._bin_gaussians(pre, JCFG, return_inverse=True)
    tpre = {k: torch.tensor(np.asarray(v)) for k, v in pre.items()}
    tout = TR._bin_gaussians(tpre, CFG, return_inverse=True)
    for name, a, b in zip(("entry_gauss", "entry_mask", "inverse"), jout,
                          tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    inv = tout[2]
    assert inv.dtype == torch.int32 and (inv >= 0).any() and (inv < 0).any()
    eg = tout[0].reshape(-1)
    hit = inv >= 0
    g = torch.arange(inv.shape[0])[:, None].expand_as(inv)[hit]
    np.testing.assert_array_equal(eg[inv[hit].long()].numpy(), g.numpy())
    plain = TR._bin_gaussians(tpre, CFG)
    for a, b in zip(plain, tout[:2]):
        assert torch.equal(a, b)


ENTRIES = {
    "rasterize": lambda a, b: TR.rasterize(*a, torch.tensor(K4), CFG,
                                           bins=b),
    "rasterize_cuda": lambda a, b: G.rasterize_cuda(*a, torch.tensor(K4),
                                                    CFG, bins=b),
    "rasterize_cuda_forward": lambda a, b: G.rasterize_cuda_forward(
        *a, torch.tensor(K4), CFG, bins=b),
    "rasterize_cuda_multi": lambda a, b: G.rasterize_cuda_multi(
        torch.stack([a[0]]), torch.stack([a[1]]), *a[2:], torch.tensor(K4),
        CFG, bins=tuple(x[None] for x in b)),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("n", [1, 3, 7])
def test_malformed_bins_raise(entry, n):
    arrs = _random_scene(20)
    plan = _torch_plan(arrs)
    bins = (plan + plan)[:n]
    with pytest.raises(ValueError, match="bins"):
        ENTRIES[entry](_t(arrs), bins)
