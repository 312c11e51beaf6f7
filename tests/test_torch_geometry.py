"""Geometry port (quaternion, SO3/SE3, pointmap) vs the JAX package on the
inputs of tests/test_lie.py. Both sides are f32 elementwise math; the
tolerance is the JAX suite's 1e-5 (1e-4 for log/exp round trips)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from cut3r_slam_tpu.geometry import lie as jlie, quaternion as jq, \
    pointmap as jpm
from cut3r_slam_tpu_torch.geometry import lie, quaternion as q_, pointmap

from test_torch_cut3r_train import few_threads  # noqa: F401

RNG = np.random.default_rng(0)


def rand_quat(n):
    return Rotation.random(n, random_state=42).as_quat().astype(np.float32)


def rand_se3(n):
    t = RNG.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([t, rand_quat(n)], -1)


def _cmp(torch_fn, jax_fn, *args, atol=1e-5):
    out_t = torch_fn(*[torch.tensor(a) for a in args])
    out_j = jax_fn(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=atol)


CASES = {
    "quat_to_matrix": (q_.quat_to_matrix, jq.quat_to_matrix,
                       lambda: [rand_quat(16)]),
    "matrix_to_quat": (q_.matrix_to_quat, jq.matrix_to_quat,
                       lambda: [Rotation.random(64, random_state=1)
                                .as_matrix().astype(np.float32)]),
    "quat_multiply": (q_.quat_multiply, jq.quat_multiply,
                      lambda: [rand_quat(8), rand_quat(8)[::-1].copy()]),
    "quat_rotate": (q_.quat_rotate, jq.quat_rotate,
                    lambda: [rand_quat(8),
                             RNG.normal(size=(8, 3)).astype(np.float32)]),
    "wxyz_to_xyzw": (q_.wxyz_to_xyzw, jq.wxyz_to_xyzw,
                     lambda: [rand_quat(4)]),
    "xyzw_to_wxyz": (q_.xyzw_to_wxyz, jq.xyzw_to_wxyz,
                     lambda: [rand_quat(4)]),
    "so3_exp": (lie.so3_exp, jlie.so3_exp,
                lambda: [np.concatenate([RNG.normal(size=(16, 3)),
                                         [[1e-9, 0, 0], [0, 0, 0]]])
                         .astype(np.float32)]),
    "so3_log": (lie.so3_log, jlie.so3_log, lambda: [rand_quat(16)]),
    "se3_exp": (lie.se3_exp, jlie.se3_exp,
                lambda: [(RNG.normal(size=(32, 6)) * 0.8).astype(np.float32)]),
    "se3_log": (lie.se3_log, jlie.se3_log, lambda: [rand_se3(16)]),
    "se3_inv": (lie.se3_inv, jlie.se3_inv, lambda: [rand_se3(16)]),
    "se3_mul": (lie.se3_mul, jlie.se3_mul,
                lambda: [rand_se3(8), rand_se3(8)]),
    "se3_act": (lie.se3_act, jlie.se3_act,
                lambda: [rand_se3(8),
                         RNG.normal(size=(8, 3)).astype(np.float32)]),
    "se3_matrix": (lie.se3_matrix, jlie.se3_matrix, lambda: [rand_se3(8)]),
    "se3_from_matrix": (lie.se3_from_matrix, jlie.se3_from_matrix,
                        lambda: [np.asarray(jlie.se3_matrix(
                            jnp.asarray(rand_se3(16))))]),
    "pose_vec_to_matrix": (pointmap.pose_vec_to_matrix,
                           jpm.pose_vec_to_matrix, lambda: [rand_se3(8)]),
    "geotrf": (pointmap.geotrf, jpm.geotrf,
               lambda: [np.asarray(jlie.se3_matrix(jnp.asarray(
                   rand_se3(1))))[0],
                   RNG.normal(size=(5, 7, 3)).astype(np.float32)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    tf, jf, make = CASES[name]
    _cmp(tf, jf, *make(), atol=1e-4 if name.endswith("log") else 1e-5)


def _depth_k():
    yy, xx = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    depth = (2.0 + 0.3 * np.sin(xx / 5.0) + 0.1 * yy / 24).astype(np.float32)
    return depth, np.asarray([30.0, 31.0, 16.0, 12.0], np.float32)


def test_depth_to_pointmap_matches_jax():
    depth, K = _depth_k()
    c2w = np.asarray(jlie.se3_matrix(jnp.asarray(rand_se3(1))))[0]
    _cmp(pointmap.depth_to_pointmap, jpm.depth_to_pointmap, depth, K)
    _cmp(lambda d, k, c: pointmap.depth_to_pointmap(d, k, c2w=c),
         lambda d, k, c: jpm.depth_to_pointmap(d, k, c2w=c), depth, K, c2w)


def test_depth_to_normal_matches_jax():
    depth, K = _depth_k()
    _cmp(pointmap.depth_to_normal, jpm.depth_to_normal, depth, K)
    # batched over views, as the mapping losses call it
    batch = np.stack([depth, depth * 1.1])
    out = pointmap.depth_to_normal(torch.tensor(batch), torch.tensor(K))
    for v in range(2):
        np.testing.assert_allclose(
            out[v].numpy(), np.asarray(jpm.depth_to_normal(
                jnp.asarray(batch[v]), jnp.asarray(K))), atol=1e-5)


def test_se3_exp_gradient_finite_at_zero():
    xi = torch.zeros(6, requires_grad=True)
    jac = torch.autograd.functional.jacobian(lie.se3_exp, xi)
    assert torch.isfinite(jac).all()
    np.testing.assert_allclose(jac[:3, :3].numpy(), np.eye(3), atol=1e-5)
