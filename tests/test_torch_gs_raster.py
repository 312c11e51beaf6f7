"""Rasterizer port vs the JAX package on the CPU, on the scenes of
tests/test_gs_raster_pallas.py (random scene :16-43, exact-0.5 mdepth tie
:46-67, background :70-82):

* plain ``rasterize`` vs JAX ``rasterize`` (XLA);
* ``rasterize_cuda_forward`` (CPU tensors -> plain blend) vs JAX
  ``rasterize_pallas_forward(interpret=True)``;
* gradients of the same ``_loss_fn`` vs JAX ``rasterize_pallas``;
* ``rasterize_cuda_multi`` vs ``rasterize_pallas_multi``.

Tolerances are that file's: color and alpha 1e-4; depth, mdepth and
normal 1e-3; gradient error / max|grad| within 5e-4. The CUDA kernels
themselves are held against their plain versions by
tests/test_torch_kernels_cuda.py (skipped without a card) and by
chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.ops.gs_raster import RasterizeConfig as JConfig, \
    rasterize as j_rasterize
from cut3r_slam_tpu.ops.gs_raster_pallas import (
    rasterize_pallas, rasterize_pallas_forward, rasterize_pallas_multi)
from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig, rasterize
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G

H, W = 32, 32
K4 = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
JCFG = JConfig(height=H, width=W, max_dup=16, max_per_tile=64, chunk=32,
               kernel_size=0.1)
CFG = RasterizeConfig(height=H, width=W, max_dup=16, max_per_tile=64,
                      chunk=32, kernel_size=0.1)
MAPS = ("color", "alpha", "depth", "mdepth", "normal")
ATOL = {"color": 1e-4, "alpha": 1e-4, "depth": 1e-3, "mdepth": 1e-3,
        "normal": 1e-3, "coord": 1e-3, "mcoord": 1e-3}


def _random_scene(n, seed=3):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1)
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return [np.asarray(a, np.float32) for a in (
        means, q, rng.uniform(0.02, 0.1, (n, 3)), rng.uniform(0.2, 0.9, n),
        rng.uniform(0, 1, (n, 3)))]


def _tie_scene():
    """Identical stacked Gaussians with exact-0.5 opacities."""
    n = 12
    rng = np.random.default_rng(4)
    means = np.stack([np.zeros(n), np.zeros(n), np.linspace(1.0, 2.0, n)], -1)
    return [np.asarray(a, np.float32) for a in (
        means, np.tile([1.0, 0, 0, 0], (n, 1)), np.full((n, 3), 0.8),
        np.full((n,), 0.5), rng.uniform(0, 1, (n, 3)))]


SCENES = {"random": lambda: _random_scene(50), "tie": _tie_scene,
          "sparse": lambda: _random_scene(5, seed=5)}


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


def _close(out_t, out_j, keys=MAPS):
    for k in keys:
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), atol=ATOL[k],
                                   err_msg=k)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_rasterize_matches_jax(scene):
    arrs = SCENES[scene]()
    ref = j_rasterize(*_j(arrs), jnp.asarray(K4), JCFG)
    out = rasterize(*_t(arrs), torch.tensor(K4), CFG)
    _close(out, ref, MAPS + ("coord", "mcoord"))
    np.testing.assert_array_equal(out["visibility"].numpy(),
                                  np.asarray(ref["visibility"]))
    np.testing.assert_allclose(out["radii"].numpy(), np.asarray(ref["radii"]))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_path_forward_matches_pallas(scene):
    arrs = SCENES[scene]()
    ref = rasterize_pallas_forward(*_j(arrs), jnp.asarray(K4), JCFG,
                                   interpret=True)
    out = G.rasterize_cuda_forward(*_t(arrs), torch.tensor(K4), CFG)
    _close(out, ref)
    if scene == "tie":
        assert (out["mdepth"].numpy() > 0).any()


def test_cuda_path_background():
    arrs = _random_scene(5)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    ref = rasterize_pallas_forward(*_j(arrs), jnp.asarray(K4), JCFG,
                                   bg=jnp.asarray(bg), interpret=True)
    out = G.rasterize_cuda_forward(*_t(arrs), torch.tensor(K4), CFG,
                                   bg=torch.tensor(bg))
    _close(out, ref)
    empty = out["alpha"].numpy() < 1e-6
    assert empty.any()
    np.testing.assert_allclose(out["color"].numpy()[empty],
                               np.tile(bg, (empty.sum(), 1)), atol=1e-3)


def _loss(out):
    return (out["color"].sum() + 0.5 * out["alpha"].sum()
            + 0.3 * out["depth"].sum() + 0.2 * out["mdepth"].sum()
            + 0.1 * out["normal"].sum())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_path_gradients_match_pallas(scene):
    arrs = SCENES[scene]()
    g_ref = jax.grad(lambda *a: _loss(rasterize_pallas(
        *a, jnp.asarray(K4), JCFG, interpret=True)),
        argnums=(0, 1, 2, 3, 4))(*_j(arrs))
    ts = _t(arrs, grad=True)
    _loss(G.rasterize_cuda(*ts, torch.tensor(K4), CFG)).backward()
    for name, a, b in zip(("means", "quats", "scales", "opac", "colors"),
                          g_ref, ts):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b.grad.numpy() / scale, a / scale,
                                   atol=5e-4, err_msg=name)


def test_cuda_path_probe_gradient_matches_pallas():
    arrs = _random_scene(30)
    probe = np.zeros((30, 2), np.float32)

    def jf(p):
        out = rasterize_pallas(*_j(arrs), jnp.asarray(K4), JCFG,
                               means2d_probe=p, interpret=True)
        return out["color"].sum() + out["depth"].sum()
    g_ref = np.asarray(jax.grad(jf)(jnp.asarray(probe)))
    p = torch.tensor(probe, requires_grad=True)
    out = G.rasterize_cuda(*_t(arrs), torch.tensor(K4), CFG, means2d_probe=p)
    (out["color"].sum() + out["depth"].sum()).backward()
    scale = np.abs(g_ref).max() + 1e-6
    np.testing.assert_allclose(p.grad.numpy() / scale, g_ref / scale,
                               atol=5e-4)


def _views(V=3):
    """Three nearby camera-frame copies of the random scene."""
    from cut3r_slam_tpu_torch.geometry.quaternion import (matrix_to_quat,
                                                          xyzw_to_wxyz)
    from cut3r_slam_tpu_torch.slam.renderer import quat_mult_wxyz
    means, quats, scales, opac, colors = _random_scene(60)
    mc, qc = [], []
    for i in range(V):
        th = 0.05 * i
        R = np.asarray([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]], np.float32)
        t = np.asarray([0.02 * i, -0.01 * i, 0.03 * i], np.float32)
        mc.append(means @ R.T + t)
        qr = xyzw_to_wxyz(matrix_to_quat(torch.tensor(R)))
        qc.append(quat_mult_wxyz(qr[None], torch.tensor(quats)).numpy())
    return np.stack(mc), np.stack(qc), scales, opac, colors


def test_cuda_path_multi_view_matches_pallas():
    arrs = _views()
    wts = np.asarray([1.0, 0.7, 0.3], np.float32)

    def jloss(m, q, s, o, c):
        out = rasterize_pallas_multi(m, q, s, o, c, jnp.asarray(K4), JCFG,
                                     interpret=True)
        return ((out["color"].mean((1, 2, 3)) + out["depth"].mean((1, 2)))
                * wts).sum(), out
    (_, ref), g_ref = jax.value_and_grad(jloss, argnums=(0, 2, 3, 4),
                                         has_aux=True)(*_j(arrs))
    ts = _t(arrs, grad=True)
    out = G.rasterize_cuda_multi(*ts, torch.tensor(K4), CFG)
    _close(out, ref)
    np.testing.assert_array_equal(out["visibility"].numpy(),
                                  np.asarray(ref["visibility"]))
    ((out["color"].mean((1, 2, 3)) + out["depth"].mean((1, 2)))
     * torch.tensor(wts)).sum().backward()
    for name, a, b in zip(("means", "scales", "opac", "colors"), g_ref,
                          [ts[0], ts[2], ts[3], ts[4]]):
        a = np.asarray(a)
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b.grad.numpy() / scale, a / scale,
                                   atol=5e-4, err_msg=name)


def test_plain_blend_backward_is_vjp_of_forward():
    """Plain K2 = autograd VJP of plain K1; the CPU path launches nothing."""
    arrs = _views(2)
    A, ext = G.packed_entries(*[torch.tensor(a) for a in arrs],
                              torch.tensor(K4), CFG)
    before = dict(G.LAUNCHES)
    (O, d, md, T), tchk = G.blend_forward(A, ext, with_residuals=True)
    assert tchk.shape == (A.shape[0], -(-A.shape[1] // G.CHUNK), 256)
    assert (tchk[:, 0] == 1.0).all()          # every row starts at T = 1
    rng = np.random.default_rng(0)
    cots = [torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)
            for x in (O, d, md, T)]
    dA = G.blend_backward(A, ext, tchk, T, *cots)
    Ad = A.clone().requires_grad_(True)
    outs = G.blend_forward_plain(Ad, ext)
    (ref,) = torch.autograd.grad(outs, (Ad,), cots)
    np.testing.assert_allclose(dA.numpy(), ref.numpy(), atol=1e-6)
    assert G.LAUNCHES == before
