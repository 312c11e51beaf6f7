"""CUT3R port vs the JAX model at the tiny config in f32 (CPU): the same
random flax params go through ``models/convert.params_from_jax``; encoder
tokens, then decode_views self-pointmaps, confidences and poses must
agree.

Tolerances: f32 on both sides, differing only in summation order and the
JAX model's fused decoder restructuring — 1e-4 abs + 1e-4 rel on tokens,
pointmaps and confidences, 1e-4 on poses (the JAX suite's own
stored-token vs full-forward tolerance, tests/test_slam_frontend.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.models.cut3r import normalize_images as j_normalize
from cut3r_slam_tpu.models.patch_embed import patch_positions as j_positions
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.models.cut3r import normalize_images

from test_torch_cut3r_train import few_threads  # noqa: F401

H, W = 32, 48
V = 3


@pytest.fixture(scope="module")
def models():
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    sd = params_from_jax(flatten_dict(params["params"], sep="/"))
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    return jm, params, tm


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(H, W + V, 3)).astype(np.uint8)
    return np.stack([base[:, i:i + W] for i in range(V)])


def test_params_from_jax_covers_state_dict(models):
    _, params, tm = models
    sd = params_from_jax(flatten_dict(params["params"], sep="/"))
    assert set(sd) == set(tm.state_dict())
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(tm.state_dict()[k].shape), k


def test_encode_image_matches_jax(models):
    jm, params, tm = models
    frames = _frames()
    x = j_normalize(jnp.asarray(frames))
    tok_j, pos_j = jm.apply(params, x, method=JCUT3R.encode_image)
    with torch.no_grad():
        tok_t, pos_t = tm.encode_image(normalize_images(torch.as_tensor(frames)))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j),
                               atol=1e-4, rtol=1e-4)


def test_decode_views_matches_jax(models):
    jm, params, tm = models
    frames = _frames(1)
    x = j_normalize(jnp.asarray(frames))
    feat_j, _ = jm.apply(params, x, method=JCUT3R.encode_image)
    pos = j_positions(V, H // 16, W // 16)
    out_j, _ = jm.apply(params, feat_j[:, None], pos[:, None], H, W, None,
                        jnp.int32(0), method=JCUT3R.decode_views,
                        head_outputs=("self", "pose"))
    with torch.no_grad():
        feat_t = torch.as_tensor(np.asarray(feat_j))[:, None]
        pos_t = torch.as_tensor(np.asarray(pos))[:, None]
        out_t, _ = tm.decode_views(feat_t, pos_t, H, W,
                                   head_outputs=("self", "pose"))
    for k in ("pts3d_in_self_view", "conf_self"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(out_t["camera_pose"].numpy(),
                               np.asarray(out_j["camera_pose"]), atol=1e-4,
                               err_msg="camera_pose")
