"""The whole CUT3R model of the port vs the JAX model at the tiny config in
f32 (CPU): the ray-map encoder, the cross and rgb heads behind the
pose-conditioned ``final_transform`` blocks, the update / reset gating,
ManyAR ``true_shape``, ``forward_chunk`` with a carry and the ray-map
``inference_step``. The same seeded params go through
``models/convert.params_from_jax``.

Tolerance: 1e-4 absolute + 1e-4 relative (f32 on both sides, differing
in summation order and the JAX model's fused decoder; the tolerance of
tests/test_torch_cut3r.py), per element for tokens, states, poses and
confidences, per pixel on the Euclidean norm for pointmaps and colours:
a coordinate near 0 of a far point carries that point's error (a
pointmap reaches |p| ~ 900 at these random weights).

Also pinned here: ``init_random`` draws the tracking slice's parameters
exactly as before the training modules existed (a checksum of the 394
tensors of the tiny model at seed 0, taken before they were added).
"""
import dataclasses
import hashlib
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.models.cut3r import _LATE_PARAMS

V, B, H, W = 3, 2, 32, 48
TOL = dict(atol=1e-4, rtol=1e-4)
# sha256 over the sorted (name, f32 bytes) of the tiny model's 394
# tracking-slice tensors after init_random(Generator().manual_seed(0)),
# recorded before the ray-map encoder and the cross / rgb heads existed
TRACKING_TENSORS = 394
TRACKING_SHA256 = ("13dbd0ba593af30c6726b81f2030a784"
                   "43aaaad19406feba6027496112b79eb1")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU work (under ``pytest -n``
    every worker's default pool spans all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tiny_params(seed=0, hw=(H, W)):
    """Seeded params of the tiny JAX CUT3R: the tree of ``model.init``
    (``jax.eval_shape``: nothing compiled or run) filled from numpy with
    the scale of flax's default init — N(0, 1 / fan_in) kernels — and
    small random biases (N(0, 0.02)), norms (1 + N(0, 0.02)) and tokens
    (N(0, 0.02)) where flax starts from 0, 1 or small normals."""
    shapes = jax.eval_shape(JCUT3R(JConfig.tiny()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 1) + tuple(hw) + (3,)))
    flat = flatten_dict(unfreeze(shapes["params"]), sep="/")
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        shp, leaf = flat[k].shape, k.rsplit("/", 1)[-1]
        z = rng.standard_normal(shp)
        if leaf == "kernel":
            v = z / math.sqrt(math.prod(shp[:-1]))
        else:
            v = (leaf == "scale") + 0.02 * z
        out[k] = v.astype(np.float32)
    return out


def torch_from_flat(flat, device="cpu"):
    tm = CUT3R(CUT3RConfig.tiny(), device=device)
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return tm


def jax_params(flat):
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


@pytest.fixture(scope="module")
def models():
    flat = jax_tiny_params()
    return JCUT3R(JConfig.tiny()), jax_params(flat), torch_from_flat(flat)


def _imgs(seed, shape=(V, B, H, W, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _close(out_t, out_j):
    assert set(out_t) == set(out_j)
    for k in sorted(out_j):
        got, want = out_t[k].detach().numpy(), np.asarray(out_j[k])
        if got.shape[-1] == 3:      # pointmaps and colours: per pixel
            err = np.linalg.norm(got - want, axis=-1)
            bound = TOL["atol"] + TOL["rtol"] * np.linalg.norm(want, axis=-1)
            assert (err <= bound).all(), (k, float((err - bound).max()))
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)


def test_params_from_jax_holds_every_module(models):
    _, params, tm = models
    sd = params_from_jax(flatten_dict(unfreeze(params["params"]), sep="/"))
    assert set(sd) == set(tm.state_dict())
    for prefix in ("patch_embed_ray_map.", "enc_blocks_ray_map.1.",
                   "enc_norm_ray_map.", "masked_img_token",
                   "masked_ray_map_token", "downstream_head.dpt_cross.",
                   "downstream_head.dpt_rgb.",
                   "downstream_head.final_transform.1.norm2.mlp.1."):
        assert any(k.startswith(prefix) for k in sd), prefix


@pytest.mark.parametrize("case", ["plain", "masks_manyar"])
def test_forward_all_heads_matches_jax(case, models):
    """The full forward with every head; with per-sample update / reset
    masks (B = 2 rows that differ) and a mixed portrait / landscape
    ``true_shape``, and the final state."""
    jm, params, tm = models
    imgs = _imgs(1)
    kw = {}
    if case == "masks_manyar":
        kw = {"update": np.array([[1, 1], [0, 1], [1, 0]], bool),
              "reset": np.array([[0, 0], [0, 0], [1, 0]], bool),
              "true_shape": np.broadcast_to(np.int32([[H, W], [W, H]]),
                                            (V, B, 2)).copy()}
    fn = jax.jit(lambda p, x, kw: jm.apply(p, x, ret_state=True, **kw))
    out_j = fn(params, jnp.asarray(imgs),
               {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out_t = tm(torch.from_numpy(imgs), ret_state=True,
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    state_j, state_t = out_j.pop("state"), out_t.pop("state")
    assert set(out_j) == {"pts3d_in_self_view", "conf_self",
                          "pts3d_in_other_view", "conf", "camera_pose", "rgb"}
    _close(out_t, out_j)
    for a, b in zip(state_t, state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_forward_chunk_with_carry_matches_jax(models):
    """A second chunk of views from the carry of a first forward, the
    chunk starting at global view 3 (memory reads, no pose token)."""
    jm, params, tm = models
    first, second = _imgs(2), _imgs(3, (2, B, H, W, 3))
    carry_j = jax.jit(lambda p, x: jm.apply(p, x, ret_state=True)["state"])(
        params, jnp.asarray(first))
    out_j, (sf_j, mem_j) = jax.jit(lambda p, x, c: jm.apply(
        p, x, c, jnp.int32(3), method=JCUT3R.forward_chunk))(
        params, jnp.asarray(second), carry_j)
    with torch.no_grad():
        carry_t = tm(torch.from_numpy(first), ret_state=True)["state"]
        out_t, (sf_t, mem_t) = tm.forward_chunk(torch.from_numpy(second),
                                                carry_t, 3)
    _close(out_t, out_j)
    np.testing.assert_allclose(sf_t.numpy(), np.asarray(sf_j), **TOL)
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j), **TOL)


def test_encode_ray_map_and_inference_step_match_jax(models):
    """The ray-map encoder's tokens, then a ray-map query of a state
    carried from a forward (every head; the state is not updated)."""
    jm, params, tm = models
    rng = np.random.default_rng(4)
    ray = rng.standard_normal((B, H, W, 6)).astype(np.float32)
    imgs = _imgs(5, (2, B, H, W, 3))
    tok_j, pos_j = jax.jit(lambda p, r: jm.apply(
        p, r, method=JCUT3R.encode_ray_map))(params, jnp.asarray(ray))

    def jax_query(p, x, r):
        sf, mem = jm.apply(p, x, ret_state=True)["state"]
        return jm.apply(p, r, sf, mem, method=JCUT3R.inference_step)

    out_j = jax.jit(jax_query)(params, jnp.asarray(imgs), jnp.asarray(ray))
    with torch.no_grad():
        tok_t, pos_t = tm.encode_ray_map(torch.from_numpy(ray))
        sf, mem = tm(torch.from_numpy(imgs), ret_state=True)["state"]
        out_t = tm.inference_step(torch.from_numpy(ray), sf, mem)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), **TOL)
    _close(out_t, out_j)


def test_manyar_portrait_is_the_transposed_native_run(models):
    """A portrait sample in the landscape container gives the transposed
    outputs of a run at its native (W, H) resolution (port only, the
    equivariance the JAX suite checks in tests/test_manyar.py)."""
    _, _, tm = models
    native = _imgs(6, (2, 1, W, H, 3))
    with torch.no_grad():
        out_n = tm(torch.from_numpy(native))
        out_m = tm(torch.from_numpy(native).transpose(2, 3),
                   true_shape=torch.tensor([W, H]).expand(2, 1, 2))
    for k, v in out_n.items():
        want = v.transpose(2, 3) if v.dim() >= 4 else v
        np.testing.assert_allclose(out_m[k].numpy(), want.numpy(),
                                   atol=1e-5, err_msg=k)


def test_init_random_keeps_the_tracking_tensors():
    """The parameters added for training draw after all others, so a seed
    gives every tracking-slice parameter the tensor it had before."""
    m = CUT3R(CUT3RConfig.tiny(), device="cpu")
    m.init_random(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    old = sorted(k for k in sd if not k.startswith(_LATE_PARAMS))
    assert len(old) == TRACKING_TENSORS and len(sd) == 576
    h = hashlib.sha256()
    for k in old:
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().astype("<f4").tobytes())
    assert h.hexdigest() == TRACKING_SHA256


def test_linear_head_and_fsdp_raise():
    """``fsdp > 1`` is refused; ``head_type="linear"`` builds the linear
    head (held against JAX in tests/test_torch_linear_head.py) and an
    unknown head type raises."""
    from cut3r_slam_tpu_torch.models.heads import LinearPts3dPose
    from cut3r_slam_tpu_torch.train.trainer import TrainerConfig, train
    m = CUT3R(dataclasses.replace(CUT3RConfig.tiny(), head_type="linear"),
              device="cpu")
    assert isinstance(m.downstream_head, LinearPts3dPose)
    with pytest.raises(ValueError, match="head_type"):
        CUT3RConfig(head_type="conv")
    with pytest.raises(NotImplementedError, match="fsdp"):
        train(None, iter(()), TrainerConfig(fsdp=2), device="cpu")
