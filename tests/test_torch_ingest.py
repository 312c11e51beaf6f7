"""The demo driver's inputs in the port vs the JAX package on the CPU:
the image stream (``list_images``, ``mono_stream``, ``prefetch_stream``)
on a folder of PNGs, exactly equal arrays and intrinsics; and the CUT3R
checkpoint loader on a state_dict the test writes itself, exactly equal
tensors."""
import os

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models.convert import load_cut3r_params
from cut3r_slam_tpu.utils import image as JI
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import CKPT_SKIP, \
    load_cut3r_checkpoint, params_from_jax
from cut3r_slam_tpu_torch.utils import image as TI

from test_torch_cut3r_train import few_threads  # noqa: F401


def _write(folder, names, hw=(30, 50), seed=0):
    import cv2
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for n in names:
        cv2.imwrite(os.path.join(folder, n),
                    rng.integers(0, 255, hw + (3,), dtype=np.uint8))
    return str(folder)


@pytest.mark.parametrize("kw", [
    {}, {"stride": 2, "start": 1, "length": 3},
    {"crop_border": 3, "target_w": 32}], ids=["plain", "stride", "crop"])
def test_mono_stream_matches_jax(kw, tmp_path):
    folder = _write(tmp_path / "seq", [f"frame{i:04d}.png" for i in range(7)]
                    + ["depth0000.png"])
    calib = np.asarray([40.0, 42.0, 25.0, 15.0])
    kw = dict({"target_w": 48}, **kw)
    a = list(TI.prefetch_stream(TI.mono_stream(folder, calib, **kw), 2))
    b = list(JI.mono_stream(folder, calib, **kw))
    assert len(a) == len(b) > 0 and a[-1][-1] and not a[0][-1]
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[5] == y[5]
        for u, v in zip(x[1:5], y[1:5]):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    assert a[0][1].shape[0] % 16 == 0 and a[0][3].shape[0] % 2 == 0


def test_prefetch_stream_raises_in_consumer():
    def bad():
        yield 1
        raise ValueError("decode failed")
    it = TI.prefetch_stream(bad(), 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_list_images_keeps_mixed_names(tmp_path):
    """Deliberate divergence (ROADMAP §3): colour-frame names beside an
    auxiliary stream (depth*) select the colour frames in both packages;
    beside other images (img_*) the JAX ``list_images`` still drops those,
    the port keeps every image."""
    aux = _write(tmp_path / "aux", ["frame0.png", "frame1.png",
                                    "depth0.png"])
    assert TI.list_images(aux) == JI.list_images(aux) == [
        os.path.join(aux, f) for f in ("frame0.png", "frame1.png")]
    mixed = _write(tmp_path / "mixed", ["rgb_0.png", "img_1.png",
                                        "img_2.png"])
    assert len(JI.list_images(mixed)) == 1
    assert TI.list_images(mixed) == [os.path.join(mixed, f) for f in (
        "img_1.png", "img_2.png", "rgb_0.png")]


# upstream-only keys, one per skipped prefix family: the JAX converter's
# training-only skips and the never-run first residual unit of every DPT's
# refinenet4
_EXTRA = ("mask_token", "mask_generator.weight", "enc_pos_embed",
          "dec_pos_embed") + tuple(
    f"downstream_head.{h}.scratch.refinenet4.resConfUnit1.conv1.weight"
    for h in ("dpt_self", "dpt_cross", "dpt_rgb"))


@pytest.fixture(scope="module")
def model():
    m = CUT3R(CUT3RConfig.tiny(), device="cpu")
    m.init_random(torch.Generator().manual_seed(3))
    return m


def _ckpt(model, path, drop_state=False, extra=_EXTRA, alias=True):
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()
          if not (drop_state and k.startswith("dec_blocks_state."))}
    for k in extra:
        sd[f"module.{k}"] = torch.ones(4, 4, 1, 1)
    if alias:   # the upstream DPT's ModuleList alias of layer{1..4}_rn
        for h in ("dpt_self", "dpt_cross", "dpt_rgb"):
            for i in range(4):
                k = f"downstream_head.{h}.scratch.layer{i + 1}_rn.weight"
                sd[f"module.downstream_head.{h}.scratch.layer_rn.{i}."
                   "weight"] = model.state_dict()[k].clone()
    torch.save({"model": sd, "epoch": 7}, path)
    return path


def test_checkpoint_round_trip(model, tmp_path):
    """A checkpoint with every upstream key (the ray-map encoder, the
    masked tokens, the cross / rgb heads and their final_transform blocks
    included) loads strictly; only the skipped families are dropped."""
    sd = load_cut3r_checkpoint(_ckpt(model, str(tmp_path / "c.pth")))
    assert set(sd) == set(model.state_dict())
    for prefix in ("patch_embed_ray_map.", "enc_blocks_ray_map.",
                   "enc_norm_ray_map.", "masked_img_token",
                   "masked_ray_map_token", "downstream_head.dpt_cross.",
                   "downstream_head.dpt_rgb.",
                   "downstream_head.final_transform."):
        assert any(k.startswith(prefix) for k in sd), prefix
    other = CUT3R(CUT3RConfig.tiny(), device="cpu")
    other.load_state_dict(sd)   # strict
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert all(any(k.startswith(p) for p in CKPT_SKIP) for k in _EXTRA)
    assert not any(any(k.startswith(p) for p in CKPT_SKIP)
                   for k in model.state_dict())


def test_checkpoint_matches_jax_converter(model, tmp_path):
    """The JAX package's loader of the same file, mapped through
    ``params_from_jax``, gives the same tensors."""
    path = _ckpt(model, str(tmp_path / "c.pth"),
                 extra=[k for k in _EXTRA if "refinenet4" not in k])
    ours = load_cut3r_checkpoint(path)
    theirs = params_from_jax(flatten_dict(load_cut3r_params(path)["params"],
                                          sep="/"))
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        assert torch.equal(v, theirs[k]), k


def test_checkpoint_aliases_the_state_decoder(model, tmp_path):
    """A checkpoint without ``dec_blocks_state`` uses ``dec_blocks`` for
    it (the upstream aliasing rule)."""
    sd = load_cut3r_checkpoint(_ckpt(model, str(tmp_path / "c.pth"),
                                     drop_state=True))
    for k, v in sd.items():
        if k.startswith("dec_blocks_state."):
            assert torch.equal(v, sd["dec_blocks." + k[17:]]), k


@pytest.mark.parametrize("bad", ["unknown", "missing", "alias"])
def test_checkpoint_rejects_unknown_or_missing_keys(bad, model, tmp_path):
    path = str(tmp_path / "c.pth")
    _ckpt(model, path, alias=bad != "alias")
    raw = torch.load(path, weights_only=False)
    if bad == "unknown":
        raw["model"]["module.downstream_head.dpt_rgb_typo.weight"] = \
            torch.ones(1)
    elif bad == "missing":
        del raw["model"]["module.enc_norm.weight"]
    else:   # an alias that is not the same tensor
        raw["model"]["module.downstream_head.dpt_self.scratch.layer_rn.0."
                     "weight"] = torch.zeros(1)
    torch.save(raw, path)
    other = CUT3R(CUT3RConfig.tiny(), device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        other.load_state_dict(load_cut3r_checkpoint(path))
