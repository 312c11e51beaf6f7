"""The last four JAX-package functions that had no counterpart in the port,
each held against JAX on the inputs of the JAX test that covers it, plus a
seeded random input:

* ``Sim3PGO.loop_candidates`` (tests/test_sim3_pgo.py::test_loop_candidate_gate);
* ``KeyframeStore.normalize_scale`` (tests/test_slam_frontend.py::
  test_keyframe_store_basics);
* ``geometry.pointmap.log_depth_scale_align`` (tests/test_projective.py::
  test_log_depth_scale_align, with its fewer-than-50-pixels guard);
* ``models.convert.cast_params_bf16``: JAX casts the flax tree, the port a
  state_dict; the same leaves are cast to the same bf16 values, and the
  port's CUT3R loads the cast dict and agrees with the JAX model run on
  the cast tree.

Tolerances: the index sets and the cast values are exact; the scale
factor 1e-5 relative, the JAX test's own (f32 sums of 1024 logs round
differently in the two packages: 2.000014 against 2.0 on the JAX test's
input); the CUT3R outputs those of
tests/test_torch_cut3r.py (1e-4 abs + 1e-4 rel).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_cut3r_train import few_threads  # noqa: F401

H, W = 32, 48
TOKENS = (H // 16) * (W // 16)


def loop_candidates():
    from cut3r_slam_tpu.slam.sim3_pgo import Sim3PGO as JPGO
    from cut3r_slam_tpu_torch.slam.sim3_pgo import Sim3PGO
    pos = np.zeros((50, 3))
    pos[40:] += 10.0
    z = np.tile([0, 0, 1.0], (50, 1))
    rng = np.random.default_rng(0)
    cases = [(pos, z, 30, {"dist_thresh": 0.5, "temporal_gap": 20}),
             (rng.normal(0, 0.4, (60, 3)), rng.normal(size=(60, 3)), 45, {}),
             (rng.normal(0, 0.4, (60, 3)), rng.normal(size=(60, 3)), 3,
              {"angle_thresh": 0.2, "temporal_gap": 5})]
    n_hit = 0
    for p, za, cur, kw in cases:
        a = JPGO().loop_candidates(p, za, current=cur, **kw)
        b = Sim3PGO().loop_candidates(p, za, current=cur, **kw)
        np.testing.assert_array_equal(b, a)
        n_hit += len(b)
    assert n_hit > 10


def normalize_scale():
    from cut3r_slam_tpu.slam.keyframe import KeyframeStore as JStore
    from cut3r_slam_tpu_torch.slam.keyframe import KeyframeStore
    rng = np.random.default_rng(1)
    stores = (JStore(16, (H, W), feat_tokens=TOKENS, feat_dim=8),
              KeyframeStore(16, (H, W), feat_tokens=TOKENS, feat_dim=8,
                            device="cpu"))
    pts = rng.normal(size=stores[1].submap_pts.shape).astype(np.float32)
    depth = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    poses = [np.array([1, 2, 3, 0, 0, 0, 1], np.float32),
             np.r_[rng.normal(size=3), 0.1, 0.2, 0.3, 0.9].astype(np.float32)]
    for kf in stores:
        for i, p in enumerate(poses):
            kf.append(i, np.zeros((H, W, 3), np.uint8), pose=p, depth=depth)
        kf.submap_pts = jnp.asarray(pts) if kf is stores[0] \
            else torch.tensor(pts)
        kf.normalize_scale(2.0)
        kf.normalize_scale(0.37)
    jk, tk = stores
    np.testing.assert_allclose(tk.pose[0, :3], [0.74, 1.48, 2.22], rtol=1e-6)
    np.testing.assert_array_equal(tk.pose, jk.pose)
    np.testing.assert_array_equal(tk.depth, jk.depth)
    np.testing.assert_array_equal(tk.submap_pts.numpy(),
                                  np.asarray(jk.submap_pts))


def log_depth_scale_align():
    from cut3r_slam_tpu.geometry import pointmap as JP
    from cut3r_slam_tpu_torch.geometry import pointmap as TP
    rng = np.random.default_rng(2)
    ref = rng.uniform(0.5, 4, (32, 32)).astype(np.float32)
    new = (ref * rng.uniform(0.4, 0.6, (32, 32))).astype(np.float32)
    new[0, :5] = -1.0                                   # the 1e-6 clamp
    cases = [(np.full((32, 32), 2.0, np.float32),
              np.full((32, 32), 1.0, np.float32), np.ones((32, 32)), 2.0),
             (np.full((32, 32), 2.0, np.float32),
              np.full((32, 32), 1.0, np.float32), np.zeros((32, 32)), 1.0),
             (ref, new, rng.uniform(size=(32, 32)) > 0.3, None),
             (ref, new, np.arange(1024).reshape(32, 32) < 49, 1.0),
             (ref, new, np.arange(1024).reshape(32, 32) < 50, None)]
    for d_ref, d_new, mask, want in cases:
        a = float(JP.log_depth_scale_align(jnp.asarray(d_ref),
                                           jnp.asarray(d_new),
                                           jnp.asarray(mask)))
        b = float(TP.log_depth_scale_align(torch.tensor(d_ref),
                                           torch.tensor(d_new),
                                           torch.tensor(mask)))
        np.testing.assert_allclose(b, a, rtol=1e-5)
        if want is not None:
            np.testing.assert_allclose(b, want, rtol=1e-5)


def cast_params_bf16():
    from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
    from cut3r_slam_tpu.models.convert import cast_params_bf16 as j_cast
    from cut3r_slam_tpu.models.cut3r import normalize_images as j_normalize
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.models.convert import (cast_params_bf16,
                                                     params_from_jax)
    from cut3r_slam_tpu_torch.models.cut3r import normalize_images
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    jcast = j_cast(params)
    flat = flatten_dict(params["params"], sep="/")
    flat_cast = flatten_dict(jcast["params"], sep="/")
    sd = params_from_jax(flat)
    sd_cast = cast_params_bf16(sd)
    # the same leaves are cast, to the same values
    n_cast = sum(v.dtype == jnp.bfloat16 for v in flat_cast.values())
    assert n_cast == sum(v.dtype == torch.bfloat16 for v in sd_cast.values())
    assert 0 < n_cast < len(sd)
    want = params_from_jax({k: np.asarray(v, np.float32)
                            for k, v in flat_cast.items()})
    for k, v in sd_cast.items():
        assert v.dtype == (torch.bfloat16 if sd[k].dim() >= 2
                           else torch.float32), k
        assert torch.equal(v.float(), want[k]), k
    # the port's model loads the cast dict and agrees with JAX's on the
    # cast tree
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(sd_cast, strict=True)
    tm.eval()
    frames = np.random.default_rng(3).uniform(0, 255, (2, H, W, 3)
                                              ).astype(np.uint8)
    tok_j, _ = jm.apply(jcast, j_normalize(jnp.asarray(frames)),
                        method=JCUT3R.encode_image)
    with torch.no_grad():
        tok_t, _ = tm.encode_image(normalize_images(torch.as_tensor(frames)))
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), atol=1e-4,
                               rtol=1e-4)


CASES = {f.__name__: f for f in (loop_candidates, normalize_scale,
                                 log_depth_scale_align, cast_params_bf16)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    CASES[case]()
