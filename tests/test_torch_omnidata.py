"""Omnidata DPT-hybrid of the port vs the JAX package on the CPU, piece by
piece where the two frameworks differ by default, then whole:

* the weight-standardized conv (biased variance, eps 1e-8; ``torch.var``
  is unbiased by default) with TF-"SAME" padding, asymmetric at stride 2
  on even sizes (``nn.Conv2d(padding=...)`` is symmetric);
* the stem's 3x3/2 "SAME" max-pool, padded with -inf;
* the ``pos_embed`` resize, shrinking and growing, against
  ``jax.image.resize(..., "bilinear")``, which antialiases when it
  shrinks (``F.interpolate(antialias=False)`` does not);
* ``OmnidataDPT`` at a small config (64 wide, 4 blocks, hooks (2, 3), 32
  features, one bottleneck a stage) at 64x64, depth and normal, from the
  same seeded params through ``omnidata_params_from_jax``, and the
  system's Omnidata prior function (resize to multiples of 32 and back)
  at 40x56;
* the checkpoint path on a made-up full-size state dict with the public
  ``omnidata_dpt_*_v2`` names and shapes: ``load_omnidata_ckpt`` loads it
  strictly and every tensor equals the JAX converter's param in the
  port's layout (no full-size JAX forward: the JAX suite marks it slow);
  a task without a checkpoint gives zeros in both packages.

Tolerance: 1e-4 absolute + 1e-4 relative (f32 both sides).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import omnidata as JO
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.models import omnidata as TO
from cut3r_slam_tpu_torch.models.convert import omnidata_params_from_jax
from cut3r_slam_tpu_torch.slam.system import (build_prior_fns,
                                              omnidata_prior_fn)

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_prior import as_jax, jax_random_params

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(vit_dim=64, vit_depth=4, vit_heads=4, hook_blocks=(2, 3),
             features=32, resnet_layers=(1, 1, 1))


@pytest.mark.parametrize("k,s,size", [(7, 2, 10), (7, 2, 9), (3, 2, 8),
                                      (3, 1, 7), (1, 2, 8)])
def test_stdconv_same_padding(k, s, size):
    rng = np.random.default_rng(k * 10 + size)
    x = rng.normal(size=(1, size, size + 1, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 8)).astype(np.float32)  # HWIO
    want = np.asarray(JO.StdConv(8, k, s).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x)))
    conv = TO.StdConv2dSame(4, 8, k, s)
    conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    if k > 1 and s == 2 and size % 2 == 0:
        # the odd pad row / column goes after: not nn.Conv2d's symmetric
        # padding, and not torch's unbiased variance
        assert TO.same_pad(size, k, s)[0] != TO.same_pad(size, k, s)[1]


def test_maxpool_same_pads_with_minus_inf():
    """All-negative maps: a zero pad would win at the borders."""
    rng = np.random.default_rng(0)
    y = -np.abs(rng.normal(size=(1, 10, 13, 3))).astype(np.float32) - 1
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(y), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    t = torch.from_numpy(y).permute(0, 3, 1, 2)
    got = F.max_pool2d(TO._pad_same(t, 3, 2, float("-inf")), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want < -1).all()


@pytest.mark.parametrize("hw", [(4, 6), (2, 3), (30, 40), (24, 37)],
                         ids=["shrink", "shrink_far", "grow", "grow_mixed"])
def test_pos_embed_resize(hw):
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(1, 24, 24, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1,) + hw + (16,),
                                       "bilinear"))
    got = TO.resize_bilinear(torch.from_numpy(grid), *hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    plain = F.interpolate(torch.from_numpy(grid).permute(0, 3, 1, 2),
                          size=hw, mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).numpy()
    if hw[0] < 24:      # shrinking: the antialiased filter is another one
        assert np.abs(plain - want).max() > 1e-2


@pytest.fixture(scope="module", params=["depth", "normal"])
def small(request):
    task = request.param
    jm = JO.OmnidataDPT(task=task, **SMALL)
    flat = jax_random_params(jm, jnp.zeros((1, 64, 64, 3)),
                             seed=len(task))
    tm = TO.OmnidataDPT(task=task, device="cpu", **SMALL)
    tm.load_state_dict(omnidata_params_from_jax(flat), strict=True)
    return task, jm, as_jax(flat), tm.eval()


def test_small_model_matches_jax(small):
    task, jm, params, tm = small
    x = np.random.default_rng(2).uniform(size=(1, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((1, 64, 64) if task == "depth"
                                       else (1, 64, 64, 3))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got >= 0).all() and np.abs(want).max() > 0


def test_prior_function_matches_jax(small):
    """The system's Omnidata prior at 40x56: in resized to 32x64 (one
    axis shrinks, one grows), out resized back."""
    task, jm, params, tm = small
    H, W = 40, 56
    img = np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8)
    out = (1, H, W) if task == "depth" else (1, H, W, 3)
    want = np.asarray(jax.jit(lambda p, im: jax.image.resize(
        jm.apply(p, jax.image.resize(im[None].astype(jnp.float32) / 255.0,
                                     (1, 32, 64, 3), "bilinear")),
        out, "bilinear")[0])(params, jnp.asarray(img)))
    with torch.no_grad():
        got = omnidata_prior_fn(tm, (H, W))(img).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _fabricated(rng, n_out=1):
    """A random state dict with the public omnidata_dpt_*_v2 names and
    shapes (the JAX suite's fabrication; ``n_out`` 1 = depth, 3 =
    normal), plus keys the model never reads."""
    sd = {}

    def add(name, *shape):
        sd[name] = (rng.standard_normal(shape, np.float32) * 0.05)

    pm = "pretrained.model."
    add(pm + "patch_embed.backbone.stem.conv.weight", 64, 3, 7, 7)
    add(pm + "patch_embed.backbone.stem.norm.weight", 64)
    add(pm + "patch_embed.backbone.stem.norm.bias", 64)
    for s, (n, (out_c, in_c)) in enumerate(zip(
            (3, 4, 9), [(256, 64), (512, 256), (1024, 512)])):
        mid = out_c // 4
        for b in range(n):
            src = pm + f"patch_embed.backbone.stages.{s}.blocks.{b}."
            ic = in_c if b == 0 else out_c
            if b == 0:
                add(src + "downsample.conv.weight", out_c, ic, 1, 1)
                add(src + "downsample.norm.weight", out_c)
                add(src + "downsample.norm.bias", out_c)
            for c, (co, ci, k) in enumerate(((mid, ic, 1), (mid, mid, 3),
                                             (out_c, mid, 1)), start=1):
                add(src + f"conv{c}.weight", co, ci, k, k)
                add(src + f"norm{c}.weight", co)
                add(src + f"norm{c}.bias", co)
    add(pm + "cls_token", 1, 1, 768)
    add(pm + "pos_embed", 1, 577, 768)
    add(pm + "patch_embed.proj.weight", 768, 1024, 1, 1)
    add(pm + "patch_embed.proj.bias", 768)
    for i in range(12):
        src = pm + f"blocks.{i}."
        for name, shape in (("norm1.weight", (768,)), ("norm1.bias", (768,)),
                            ("attn.qkv.weight", (2304, 768)),
                            ("attn.qkv.bias", (2304,)),
                            ("attn.proj.weight", (768, 768)),
                            ("attn.proj.bias", (768,)),
                            ("norm2.weight", (768,)), ("norm2.bias", (768,)),
                            ("mlp.fc1.weight", (3072, 768)),
                            ("mlp.fc1.bias", (3072,)),
                            ("mlp.fc2.weight", (768, 3072)),
                            ("mlp.fc2.bias", (768,))):
            add(src + name, *shape)
    for idx in (3, 4):
        src = f"pretrained.act_postprocess{idx}."
        add(src + "0.project.0.weight", 768, 1536)
        add(src + "0.project.0.bias", 768)
        add(src + "3.weight", 768, 768, 1, 1)
        add(src + "3.bias", 768)
    add("pretrained.act_postprocess4.4.weight", 768, 768, 3, 3)
    add("pretrained.act_postprocess4.4.bias", 768)
    for k, c in ((1, 256), (2, 512), (3, 768), (4, 768)):
        add(f"scratch.layer{k}_rn.weight", 256, c, 3, 3)
        src = f"scratch.refinenet{k}."
        for r in (1, 2):
            for cv in (1, 2):
                add(src + f"resConfUnit{r}.conv{cv}.weight", 256, 256, 3, 3)
                add(src + f"resConfUnit{r}.conv{cv}.bias", 256)
        add(src + "out_conv.weight", 256, 256, 1, 1)
        add(src + "out_conv.bias", 256)
    add("scratch.output_conv.0.weight", 128, 256, 3, 3)
    add("scratch.output_conv.0.bias", 128)
    add("scratch.output_conv.2.weight", 32, 128, 3, 3)
    add("scratch.output_conv.2.bias", 32)
    add("scratch.output_conv.4.weight", n_out, 32, 1, 1)
    add("scratch.output_conv.4.bias", n_out)
    # timm's final norm and classifier, never read by the DPT
    add(pm + "norm.weight", 768)
    add(pm + "norm.bias", 768)
    add(pm + "head.weight", 1000, 768)
    add(pm + "head.bias", 1000)
    return sd


@pytest.fixture(scope="module", params=["depth", "normal"])
def full_ckpt(request, tmp_path_factory):
    task = request.param
    sd = _fabricated(np.random.default_rng(3), 1 if task == "depth" else 3)
    path = str(tmp_path_factory.mktemp("omnidata")
               / f"omnidata_dpt_{task}_v2.ckpt")
    torch.save({"state_dict": {"model." + k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return task, sd, path


def test_full_size_checkpoint_loads_strictly(full_ckpt):
    task, sd, path = full_ckpt
    tm = TO.load_omnidata_ckpt(path, task, device="cpu")
    got = tm.state_dict()
    flat = flatten_dict(unfreeze(JO.convert_omnidata_state_dict(
        sd, task)["params"]), sep="/")
    want = omnidata_params_from_jax({k: np.asarray(v)
                                     for k, v in flat.items()})
    assert set(got) == set(want) and len(got) == len(flat)
    skipped = [k for k in sd if k not in got]
    assert sorted(skipped) == sorted(
        k for k in sd if k.startswith(tuple(TO.OMNIDATA_SKIP)))
    assert len(skipped) == 8
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], torch.from_numpy(sd[k])), k


def test_task_without_checkpoint_gives_zeros(full_ckpt):
    """Omnidata for one task only: the other task's prior is zeros in both
    packages; the loaded one is a finite map of the image's size."""
    task, _, path = full_ckpt
    H, W = 32, 48
    cfg = {f"omnidata_ckpt_{task}": path}
    img = np.random.default_rng(4).integers(0, 256, (H, W, 3), np.uint8)
    fns_t = build_prior_fns(cfg, (H, W), "cpu")
    fns_j = JSLAM._build_prior_fns(cfg, (H, W))
    live = 0 if task == "depth" else 1
    zero_t, zero_j = fns_t[1 - live](img), fns_j[1 - live](img)
    shape = (H, W, 3) if task == "depth" else (H, W)
    assert zero_t.shape == np.asarray(zero_j).shape == shape
    assert not zero_t.any() and not np.asarray(zero_j).any()
    with torch.no_grad():
        out = fns_t[live](img)
    assert out.shape == ((H, W) if task == "depth" else (H, W, 3))
    assert torch.isfinite(out).all()
