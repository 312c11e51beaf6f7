"""``integrate_points`` and ``mark_visible`` of the port against
``cut3r_slam_tpu/ops/gs_integrate.py`` on the CPU, on the scenes of
tests/test_gs_integrate.py (max_per_tile 64): alpha, colour, SDF and the
projected coordinates within 1e-5, ``visible`` equal (f32 in another
order of operations: XLA fuses the 5-tap arithmetic, the port does not)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.ops import gs_integrate as J
from cut3r_slam_tpu.ops.gs_raster import RasterizeConfig as JConfig
from cut3r_slam_tpu_torch.ops import gs_integrate as T
from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig
from test_gs_integrate import H, K4, W, make_scene
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)

TOL = 1e-5
KEYS = ("alpha_integrated", "color_integrated", "point_coordinate",
        "point_sdf")


def query_points(means, seed=7, n=40):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.5, 0.5, n),
                    rng.uniform(1.2, 4.5, n)], -1)
    # points at Gaussian centres, behind the camera and near the plane
    return np.concatenate([pts, means[:4], [[0, 0, -1.0], [0.1, 0, 0.15]]]
                          ).astype(np.float32)


def both(pts, scene, bg, max_per_tile, chunk):
    means, quats, scales, opac, colors = scene
    jc = JConfig(height=H, width=W, max_dup=16, max_per_tile=max_per_tile)
    tc = RasterizeConfig(height=H, width=W, max_dup=16,
                         max_per_tile=max_per_tile)
    args = (pts, means, quats, scales, opac, colors)
    oj = J.integrate_points(*(jnp.asarray(a) for a in args),
                            jnp.asarray(K4), jc, bg=jnp.asarray(bg),
                            point_chunk=chunk)
    ot = T.integrate_points(*(torch.tensor(a) for a in args),
                            torch.tensor(K4), tc, bg=torch.tensor(bg),
                            point_chunk=chunk)
    return ({k: np.asarray(v) for k, v in oj.items()},
            {k: v.numpy() for k, v in ot.items()})


@pytest.mark.parametrize("seed,n,max_per_tile,chunk", [
    (0, 24, 64, 16), (3, 60, 32, 64), (5, 120, 64, 7)])
def test_integrate_points_matches_jax(seed, n, max_per_tile, chunk):
    """Random scenes; the densest one overflows max_per_tile, so the
    capped binning is in play; chunks that do not divide the point count."""
    scene = make_scene(seed=seed, n=n)
    pts = query_points(scene[0], seed=seed + 7)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    oj, ot = both(pts, scene, bg, max_per_tile, chunk)
    assert np.array_equal(ot["visible"], oj["visible"])
    assert oj["visible"].sum() > 20
    assert (oj["alpha_integrated"] > 0.1).sum() > 5
    assert (oj["point_sdf"] != 0).sum() > 5
    for k in KEYS:
        assert ot[k].shape == oj[k].shape, k
        np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_integrate_opaque_wall_matches_jax():
    """tests/test_gs_integrate.py's wall: a point behind an opaque layer
    of Gaussians and one in front of it, with ill-conditioned scales on
    two Gaussians (the behind-test branch of the per-point alpha)."""
    means, quats, scales, opac, colors = make_scene(seed=3, n=10)
    means[:, 2] = 2.0
    opac[:] = 0.95
    scales[:2, 0] = 1e-5
    pts = np.array([[0.0, 0.0, 3.0], [0.0, 0.0, 0.5], [0.05, 0.02, 2.0]],
                   np.float32)
    oj, ot = both(pts, (means, quats, scales, opac, colors),
                  np.zeros(3, np.float32), 64, 2)
    for k in KEYS:
        np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=TOL,
                                   err_msg=k)
    assert ot["alpha_integrated"][0] > 0.5 and ot["point_sdf"][0] < 0
    assert ot["point_sdf"][1] > 0


def test_inv_ray_cov_matches_jax():
    means, quats, scales, _, _ = make_scene(seed=1, n=16)
    scales[0] = 1e-6    # the ridge clamp
    t_norm = np.linalg.norm(means, axis=-1)
    args = (quats, scales, means[:, 0] / means[:, 2],
            means[:, 1] / means[:, 2], t_norm, means[:, 2])
    want = np.asarray(J._inv_ray_cov(*(jnp.asarray(a) for a in args),
                                     K4[0], K4[1]))
    got = T._inv_ray_cov(*(torch.tensor(a) for a in args),
                         torch.tensor(K4[0]), torch.tensor(K4[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_mark_visible_matches_jax():
    pts = np.array([[0, 0, 1.0], [0, 0, 0.1], [0, 0, -2.0], [5, 5, 3.0],
                    [0, 0, 0.2]], np.float32)
    want = np.asarray(J.mark_visible(jnp.asarray(pts)))
    got = T.mark_visible(torch.tensor(pts)).numpy()
    assert got.tolist() == want.tolist() == [True, False, False, True, False]
