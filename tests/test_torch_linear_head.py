"""CUT3R with the linear head of the 224 checkpoints (``LinearPts3dPose``)
vs the JAX model at ``CUT3RConfig.tiny()`` with ``head_type="linear"``
(f32, CPU): the same seeded params through ``params_from_jax``; every
head of the full forward (self pointmap with z >= 0, the cross pointmap
behind the two ``final_transform`` blocks, confidences, poses, rgb) and
the tracking path's ``("self", "pose")`` decode. Then a state dict in the
upstream ``downstream_head`` names, saved as an upstream checkpoint, goes
through ``load_cut3r_checkpoint`` and the JAX converter alike.

Tolerance: tests/test_torch_cut3r_train.py's, 1e-4 absolute + 1e-4
relative, per pixel on the Euclidean norm for pointmaps and colours.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.models.convert import convert_state_dict
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import (load_cut3r_checkpoint,
                                                 params_from_jax)
from cut3r_slam_tpu_torch.models.heads import LinearPts3dPose

from test_torch_cut3r_train import _close, _imgs, few_threads  # noqa: F401
from test_torch_prior import as_jax, jax_random_params

V, B, H, W = 2, 2, 32, 48
JCFG = dataclasses.replace(JConfig.tiny(), head_type="linear")
TCFG = dataclasses.replace(CUT3RConfig.tiny(), head_type="linear")


@pytest.fixture(scope="module")
def models():
    jm = JCUT3R(JCFG)
    flat = jax_random_params(jm, jnp.zeros((1, 1, H, W, 3)), seed=5)
    tm = CUT3R(TCFG, device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return jm, as_jax(flat), tm, flat


def test_linear_model_holds_the_linear_head(models):
    _, _, tm, flat = models
    head = tm.downstream_head
    assert isinstance(head, LinearPts3dPose)
    names = set(tm.state_dict())
    for prefix in ("downstream_head.proj.fc2.", "downstream_head.cross_proj.",
                   "downstream_head.rgb_proj.", "downstream_head.pose_head.",
                   "downstream_head.final_transform.1.norm2.mlp.1."):
        assert any(k.startswith(prefix) for k in names), prefix
    assert not any(".dpt_" in k for k in names)
    assert head.proj.fc2.out_features == 16 * 16 * 4


@pytest.mark.parametrize("outputs", ["all", "tracking"])
def test_forward_matches_jax(outputs, models):
    jm, params, tm, _ = models
    imgs = _imgs(7, (V, B, H, W, 3))
    heads = ("self", "cross", "rgb", "pose") if outputs == "all" \
        else ("self", "pose")
    out_j = jax.jit(lambda p, x: jm.apply(p, x, head_outputs=heads))(
        params, jnp.asarray(imgs))
    with torch.no_grad():
        out_t = tm(torch.from_numpy(imgs), head_outputs=heads)
    want = {"pts3d_in_self_view", "conf_self", "camera_pose"}
    if outputs == "all":
        want |= {"pts3d_in_other_view", "conf", "rgb"}
    assert set(out_j) == want
    _close(out_t, out_j)
    assert (out_t["pts3d_in_self_view"][..., 2] >= 0).all()


def test_upstream_checkpoint_loads_like_the_jax_converter(models, tmp_path):
    """The port's names are the upstream ones: a checkpoint of them (under
    ``model`` with a ``module.`` prefix and a training-only key) loads
    strictly, and the JAX converter reads the same file to the same
    tensors."""
    _, _, tm, _ = models
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g)
          for k, v in tm.state_dict().items()}
    path = str(tmp_path / "cut3r_224_linear.pth")
    torch.save({"model": {"module." + k: v for k, v in
                          {**sd, "mask_token": torch.zeros(1, 1, 48)}.items()
                          }}, path)
    got = load_cut3r_checkpoint(path)
    assert set(got) == set(sd)
    m = CUT3R(TCFG, device="cpu")
    m.load_state_dict(got, strict=True)
    jflat = flatten_dict(unfreeze(convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})["params"]), sep="/")
    back = params_from_jax(jflat)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]) and torch.equal(got[k], sd[k]), k
