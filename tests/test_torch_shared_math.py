"""The port's shared math (``ops/imageproc.py``, ``geometry/sim3_align.py``)
against the JAX package and the literal oracles of
tests/test_shared_math.py on the CPU, the same seeded numpy inputs
through each.

Tolerances, f32: the TV loss, its weights, Sobel and the blur 1e-6
absolute against JAX (the same shifted sums in the same order) and 1e-5
against the grouped ``conv2d`` oracles; the Sim(3) estimates 1e-5 on the
scale and 1e-4 on R and t against JAX (a 3x3 SVD), 1e-4 / 1e-3 against
the float64 numpy oracle, as the JAX suite.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from cut3r_slam_tpu.geometry import sim3_align as jsim
from cut3r_slam_tpu.ops import imageproc as jimg
from cut3r_slam_tpu_torch.geometry import sim3_align as sim
from cut3r_slam_tpu_torch.ops import imageproc as img

from test_shared_math import _np_weighted_sim3, _rand_sim3
from test_torch_cut3r_train import few_threads  # noqa: F401

EXACT = dict(atol=1e-6, rtol=0)


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("shape", [(9, 11), (2, 9, 11), (9, 11, 3),
                                   (2, 9, 11, 1), (4, 5, 6, 7)],
                         ids=["hw", "bhw", "hwc", "bhw1", "bhwc7"])
def test_total_variance(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for got, want in zip(img.total_variance(*_t(x)),
                         jimg.total_variance(*_j(x))):
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


@pytest.mark.parametrize("parts", ["depth", "image", "all"])
def test_tv_loss(parts):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 3.0, (2, 12, 16)).astype(np.float32)
    image = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    normal = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, 12, 16)).astype(np.float32)
    kw = {"depth": {}, "image": {"image": image},
          "all": {"image": image, "normal": normal, "conf_masks": conf}}[parts]
    loss, w = img.tv_loss(torch.tensor(depth),
                          **{k: torch.tensor(v) for k, v in kw.items()})
    jl, jw = jimg.tv_loss(jnp.asarray(depth),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **EXACT)
    assert abs(float(loss) - float(jl)) < 1e-6
    if parts == "all":
        # the literal oracle of tests/test_shared_math.py (utils.py:240-268)
        d = torch.tensor(depth)

        def tv(a, hd, wd):
            gx = a.narrow(wd, 0, a.shape[wd] - 1) - a.narrow(wd, 1,
                                                             a.shape[wd] - 1)
            gy = a.narrow(hd, 0, a.shape[hd] - 1) - a.narrow(hd, 1,
                                                             a.shape[hd] - 1)
            return (torch.cat((gx, gx.narrow(wd, -1, 1)), wd),
                    torch.cat((gy, gy.narrow(hd, -1, 1)), hd))
        t = torch.tensor(image)
        gray = 0.2989 * t[..., 0] + 0.5870 * t[..., 1] + 0.1140 * t[..., 2]
        igx, igy = tv(gray, 1, 2)
        wts = torch.exp(-torch.sqrt(igx ** 2 + igy ** 2) * 5)
        cm = torch.tensor(conf)
        gx, gy = tv(d, 1, 2)
        ngx, ngy = tv(torch.tensor(normal), 1, 2)
        ref = (gx.abs() * wts * cm).mean() + (gy.abs() * wts * cm).mean() \
            + 0.05 * ((ngx.abs().mean(-1) * wts * cm).mean()
                      + (ngy.abs().mean(-1) * wts * cm).mean())
        np.testing.assert_allclose(w.numpy(), wts.numpy(), atol=1e-6)
        assert abs(float(loss) - float(ref)) < 1e-6


@pytest.mark.parametrize("shape", [(10, 14, 3), (10, 14)], ids=["hwc", "hw"])
def test_sobel_edges(shape):
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    got = img.sobel_edges(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jimg.sobel_edges(jnp.asarray(x))),
                               **EXACT)
    x3 = x if x.ndim == 3 else x[..., None]
    C = x3.shape[-1]
    xt = torch.tensor(x3).permute(2, 0, 1)[None]
    kx = torch.tensor([[1., 0, -1], [2, 0, -2], [1, 0, -1]]).view(1, 1, 3, 3)
    ky = torch.tensor([[1., 2, 1], [0, 0, 0], [-1, -2, -1]]).view(1, 1, 3, 3)
    gx = F.conv2d(xt, kx.expand(C, -1, -1, -1), padding=1, groups=C)
    gy = F.conv2d(xt, ky.expand(C, -1, -1, -1), padding=1, groups=C)
    ref = torch.sqrt(gx ** 2 + gy ** 2 + 1e-6)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("k, sigma, shape", [(5, 1.0, (12, 9, 3)),
                                             (7, 2.0, (8, 10))],
                         ids=["k5_hwc", "k7_hw"])
def test_gaussian_blur(k, sigma, shape):
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    got = img.gaussian_blur(torch.tensor(x), kernel_size=k, sigma=sigma)
    want = jimg.gaussian_blur(jnp.asarray(x), kernel_size=k, sigma=sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    x3 = x if x.ndim == 3 else x[..., None]
    C = x3.shape[-1]
    c = torch.arange(k, dtype=torch.float32) - k // 2
    g = torch.exp(-(c ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    kern = (g[:, None] * g[None, :]).expand(C, 1, -1, -1)
    ref = F.conv2d(torch.tensor(x3).permute(2, 0, 1)[None], kern,
                   padding=k // 2, groups=C)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref.numpy(),
                               atol=1e-5)


def _close_sim3(got, want, s_tol, rt_tol):
    s, R, t = got
    assert abs(float(s) - float(want[0])) < s_tol
    np.testing.assert_allclose(R.numpy(), np.asarray(want[1]), atol=rt_tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(want[2]), atol=rt_tol)


def test_weighted_sim3():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(200, 3)).astype(np.float32)
    s, R, t = _rand_sim3(rng)
    tgt = (s * src @ R.T + t).astype(np.float32)
    tgt += rng.normal(scale=0.01, size=tgt.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 200).astype(np.float32)
    got = sim.weighted_estimate_sim3(*_t(src, tgt, w))
    _close_sim3(got, jsim.weighted_estimate_sim3(*_j(src, tgt, w)), 1e-5,
                1e-4)
    oracle = _np_weighted_sim3(src.astype(np.float64),
                               tgt.astype(np.float64), w.astype(np.float64))
    _close_sim3(got, oracle, 1e-4, 1e-3)


def test_weighted_sim3_reflection_fix():
    """Coplanar points mirrored through their plane: the unconstrained fit
    is a reflection; det(R) = +1 after the fix, as JAX."""
    rng = np.random.default_rng(5)
    src = np.concatenate([rng.normal(size=(50, 2)), np.zeros((50, 1))], 1)
    tgt = src * np.asarray([1.0, 1.0, -1.0]) + rng.normal(
        scale=1e-3, size=src.shape)
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    w = np.ones(50, np.float32)
    got = sim.weighted_estimate_sim3(*_t(src, tgt, w))
    assert abs(float(torch.linalg.det(got[1])) - 1.0) < 1e-5
    _close_sim3(got, jsim.weighted_estimate_sim3(*_j(src, tgt, w)), 1e-5,
                1e-4)


def test_robust_sim3_and_point_maps():
    rng = np.random.default_rng(6)
    src = rng.normal(size=(300, 3)).astype(np.float32)
    s, R, t = _rand_sim3(rng)
    tgt = (s * src @ R.T + t).astype(np.float32)
    tgt[:45] += rng.normal(scale=3.0, size=(45, 3)).astype(np.float32)
    w = np.ones(300, np.float32)
    got = sim.robust_weighted_estimate_sim3(*_t(src, tgt, w), delta=0.1,
                                            max_iters=20)
    want = jsim.robust_weighted_estimate_sim3(*_j(src, tgt, w), delta=0.1,
                                              max_iters=20)
    _close_sim3(got, want, 1e-5, 1e-4)
    assert abs(float(got[0]) - s) + np.abs(got[1].numpy() - R).max() < 0.02

    pm2 = rng.normal(size=(1, 8, 10, 3)).astype(np.float32)
    s, R, t = _rand_sim3(rng)
    pm1 = (s * pm2.reshape(-1, 3) @ R.T + t).reshape(pm2.shape)
    conf = rng.uniform(0, 2, (1, 8, 10)).astype(np.float32)
    pm1 = np.where((conf < 1.0)[..., None], 99.0, pm1).astype(np.float32)
    got = sim.weighted_align_point_maps(*_t(pm1, conf, pm2, conf), 1.0)
    want = jsim.weighted_align_point_maps(pm1, conf, pm2, conf, 1.0)
    _close_sim3(got, want, 1e-5, 1e-4)
    _close_sim3(got, (s, R, t), 1e-3, 1e-3)


def test_huber_loss():
    r = np.asarray([-0.5, -0.05, 0.0, 0.05, 0.1, 0.5], np.float32)
    got = sim.huber_loss(torch.tensor(r), 0.1).numpy()
    np.testing.assert_allclose(got, np.asarray(jsim.huber_loss(
        jnp.asarray(r), 0.1)), **EXACT)
    np.testing.assert_allclose(
        got, [0.1 * 0.45, 0.5 * 0.05 ** 2, 0.0, 0.5 * 0.05 ** 2,
              0.5 * 0.01, 0.1 * 0.45], atol=1e-7)
