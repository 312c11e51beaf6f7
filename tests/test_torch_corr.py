"""The port's correlation pyramid (``ops/corr.py``) against the JAX
package on the CPU: the volume, the pyramid at odd sizes (VALID 2x2
pools floor) and the radius lookup with coordinates off the volume
(zeros outside), in the JAX layout (window channels dy-major, levels
level-major, channels last).

Tolerance: 1e-5 absolute + 1e-5 relative per element, f32 on both sides;
shapes must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.ops import corr as jcorr
from cut3r_slam_tpu_torch.ops import corr

from test_torch_cut3r_train import few_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _fmaps(seed, N=2, H=7, W=9, C=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, H, W, C)).astype(np.float32),
            rng.normal(size=(N, H, W, C)).astype(np.float32))


@pytest.mark.parametrize("hw", [(7, 9), (8, 12)], ids=["odd", "even"])
def test_volume_and_pyramid(hw):
    f1, f2 = _fmaps(0, H=hw[0], W=hw[1])
    got = corr.build_corr_pyramid(torch.tensor(f1), torch.tensor(f2))
    want = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert len(got) == len(want) == 4
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (lvl, g.shape, w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=lvl,
                                   **TOL)
    # definition at one pixel pair
    v = float(got[0][1, 2, 3, 4, 5])
    assert abs(v - float(f1[1, 2, 3] @ f2[1, 4, 5]) / 16) < 1e-5


@pytest.mark.parametrize("radius", [1, 3])
def test_lookup_matches_jax_off_the_volume(radius):
    f1, f2 = _fmaps(1, H=8, W=10)
    rng = np.random.default_rng(2)
    N, H, W = f1.shape[:3]
    # targets spread well beyond the volume on every side
    coords = np.stack([rng.uniform(-6, W + 6, (N, H, W)),
                       rng.uniform(-6, H + 6, (N, H, W))], -1).astype(
        np.float32)
    pyr = corr.build_corr_pyramid(torch.tensor(f1), torch.tensor(f2))
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got = corr.corr_lookup(pyr, torch.tensor(coords), radius=radius)
    want = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords),
                                        radius=radius))
    D = (2 * radius + 1) ** 2
    assert got.shape == want.shape == (N, H, W, 4 * D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # far outside every level: all zeros
    far = np.full((N, H, W, 2), -100.0, np.float32)
    assert not corr.corr_lookup(pyr, torch.tensor(far), radius).any()


def test_pooled_lookup_reads_each_pixels_row():
    """A pool of volumes read by row (the DROID tracker's per-edge cache)
    gives the lookup of each edge's own volumes, bitwise: two edges'
    pyramids stored in a pool of three slots in swapped order, targets off
    the volume."""
    f1, f2 = _fmaps(6, N=2, H=8, W=10)
    N, H, W = f1.shape[:3]
    rng = np.random.default_rng(7)
    coords = torch.tensor(np.stack([rng.uniform(-4, W + 4, (N, H, W)),
                                    rng.uniform(-4, H + 4, (N, H, W))], -1),
                          dtype=torch.float32)
    pyr = corr.build_corr_pyramid(torch.tensor(f1), torch.tensor(f2))
    slot = torch.tensor([2, 0])
    pool = []
    for p in pyr:
        buf = torch.zeros(3 * H * W, *p.shape[-2:])
        buf.view(3, H * W, -1)[slot] = p.reshape(N, H * W, -1)
        pool.append(buf)
    rows = (slot[:, None] * (H * W) + torch.arange(H * W)).reshape(N, H, W)
    assert torch.equal(corr.corr_lookup(pool, coords, 3, rows),
                       corr.corr_lookup(pyr, coords, 3))


def test_lookup_window_layout():
    """Integer targets read the volume: window channel k of level 0 is
    (dy, dx) = divmod(k, 2r + 1) - r, dy-major."""
    f1, f2 = _fmaps(3, N=1, H=8, W=8)
    pyr = corr.build_corr_pyramid(torch.tensor(f1), torch.tensor(f2), 2)
    gy, gx = np.meshgrid(np.arange(8.0), np.arange(8.0), indexing="ij")
    grid = torch.tensor(np.stack([gx, gy], -1)[None], dtype=torch.float32)
    out = corr.corr_lookup(pyr, grid, radius=1)
    vol = pyr[0][0]
    y, x = 3, 4
    for k in range(9):
        dy, dx = divmod(k, 3)
        assert abs(float(out[0, y, x, k])
                   - float(vol[y, x, y + dy - 1, x + dx - 1])) < 1e-6


def test_lookup_gradient_matches_jax():
    """The lookup's gradient with respect to the feature maps (DroidNet
    trains through it), 1e-5 + 1e-5 relative."""
    import jax
    f1, f2 = _fmaps(4, N=1, H=6, W=8, C=8)
    rng = np.random.default_rng(5)
    coords = np.stack([rng.uniform(-2, 10, (1, 6, 8)),
                       rng.uniform(-2, 8, (1, 6, 8))], -1).astype(np.float32)
    wts = rng.normal(size=(1, 6, 8, 4 * 9)).astype(np.float32)

    def jloss(a, b):
        pyr = jcorr.build_corr_pyramid(a, b)
        return (jcorr.corr_lookup(pyr, jnp.asarray(coords), radius=1)
                * wts).sum()

    ja, jb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    a = torch.tensor(f1, requires_grad=True)
    b = torch.tensor(f2, requires_grad=True)
    pyr = corr.build_corr_pyramid(a, b)
    (corr.corr_lookup(pyr, torch.tensor(coords), radius=1)
     * torch.tensor(wts)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), **TOL)
