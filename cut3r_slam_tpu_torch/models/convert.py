"""CUT3R weights into the port's ``state_dict``: from an upstream
``ARCroco3DStereo`` checkpoint (``load_cut3r_checkpoint``) or from the JAX
model's flax params (``params_from_jax``).

``load_cut3r_checkpoint(path)`` follows the JAX converter's rules
(``cut3r_slam_tpu/models/convert.py``): unwrap ``ckpt["model"]``, strip
``module.``, alias ``dec_blocks`` as ``dec_blocks_state`` when the latter
is absent, and skip the training-only ``mask_generator`` /
``enc_pos_embed`` / ``dec_pos_embed`` / ``mask_token``. Keys of modules
the port does not hold (``CKPT_SKIP``) are dropped by name; every other
key goes into the state_dict as it is, so ``model.load_state_dict``
(strict) raises on any key that is unexpected or missing.

``params_from_jax(flat)`` takes the JAX model's params flattened to numpy
with ``/``-joined paths (``flax.traverse_util.flatten_dict(params["params"],
sep="/")``) and returns the port's state_dict, whose names are the
upstream ``ARCroco3DStereo`` ones. Layout transforms (the inverse of the
JAX package's torch -> flax converter):

* Dense kernel (in, out) -> Linear weight (out, in)
* Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
* ConvTranspose kernel (kh, kw, out, in) (``transpose_kernel=True``) ->
  ConvTranspose2d weight (in, out, kh, kw)
* LayerNorm scale -> weight; Embed embedding -> weight

Params of modules the port does not build yet (the ray-map encoder, the
masked tokens, the cross / rgb heads) are skipped.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "load_torch_checkpoint",
           "load_cut3r_checkpoint", "CKPT_SKIP"]

# upstream checkpoint keys the port drops, each with its reason
CKPT_SKIP = {
    # training-only (the JAX converter's skip list)
    "mask_generator": "training-time masking",
    "enc_pos_embed": "unused: positions are RoPE",
    "dec_pos_embed": "unused: positions are RoPE",
    "mask_token": "training-time masking",
    # modules the port does not build yet (ROADMAP §1 item 7)
    "patch_embed_ray_map.": "ray-map encoder",
    "enc_blocks_ray_map.": "ray-map encoder",
    "enc_norm_ray_map.": "ray-map encoder",
    "masked_img_token": "ray-map / image token masking",
    "masked_ray_map_token": "ray-map / image token masking",
    "downstream_head.dpt_cross.": "cross-view pointmap head",
    "downstream_head.dpt_rgb.": "rgb head",
    "downstream_head.final_transform.": "rgb / cross heads' transforms",
    # dead in the upstream module too: refinenet4 fuses one input, so it
    # never runs its first residual unit
    "downstream_head.dpt_self.scratch.refinenet4.resConfUnit1.":
        "unused by the upstream DPT",
}
# ModuleList alias of the same tensors (upstream dpt_block registers
# scratch.layer_rn = [layer1_rn, ..., layer4_rn])
_RN_ALIAS = re.compile(r"^(downstream_head\.dpt_self\.scratch\.)layer_rn\."
                       r"(\d)\.(.*)$")


def _skipped(key: str) -> bool:
    """Whether a state_dict key lies under a ``CKPT_SKIP`` prefix."""
    return any(key.startswith(p) for p in CKPT_SKIP)


_ACT = {"act_1_conv": "act_postprocess.0.0", "act_1_deconv": "act_postprocess.0.1",
        "act_2_conv": "act_postprocess.1.0", "act_2_deconv": "act_postprocess.1.1",
        "act_3_conv": "act_postprocess.2.0", "act_4_conv": "act_postprocess.3.0",
        "act_4_downconv": "act_postprocess.3.1"}
_HEAD = {"head_0": "head.0", "head_2": "head.2", "head_4": "head.4"}
_LIST = re.compile(r"^(enc_blocks|dec_blocks|dec_blocks_state|write_blocks|"
                   r"read_blocks)_(\d+)$")


def _segment(seg: str) -> str:
    m = _LIST.match(seg)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    if seg in _ACT:
        return _ACT[seg]
    if seg in _HEAD:
        return _HEAD[seg]
    if re.fullmatch(r"layer\d_rn|refinenet\d", seg):
        return f"scratch.{seg}"
    return seg


def _leaf(name: str, w: np.ndarray):
    if name == "kernel":
        if w.ndim == 2:
            return "weight", w.T
        return "weight", w.transpose(3, 2, 0, 1)   # conv and deconv alike
    if name in ("scale", "embedding"):
        return "weight", w
    return name, w


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, w in flat.items():
        # JAX names a ModuleList entry <list>_<i>: held against CKPT_SKIP
        # as <list>.<i>
        if _skipped(".".join(re.sub(r"_(\d+)$", r".\1", p)
                             for p in path.split("/"))):
            continue
        parts = path.split("/")
        leaf, val = _leaf(parts[-1], np.asarray(w, np.float32))
        key = ".".join([_segment(p) for p in parts[:-1]] + [leaf])
        sd[key] = torch.tensor(np.ascontiguousarray(val))
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The raw state_dict of a torch checkpoint (``ckpt["model"]`` when
    present), with any ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k[7:] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_cut3r_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An upstream CUT3R checkpoint as the port's state_dict (f32). Load
    it with ``model.load_state_dict`` (strict)."""
    sd = load_torch_checkpoint(path)
    if not any(k.startswith("dec_blocks_state.") for k in sd):
        sd.update({"dec_blocks_state." + k[len("dec_blocks."):]: v
                   for k, v in list(sd.items())
                   if k.startswith("dec_blocks.")})
    out = {}
    for k, v in sd.items():
        if _skipped(k):
            continue
        m = _RN_ALIAS.match(k)
        if m:
            canon = f"{m.group(1)}layer{int(m.group(2)) + 1}_rn.{m.group(3)}"
            if canon in sd and not torch.equal(sd[canon], v):
                raise ValueError(f"{k} differs from its alias {canon}")
            k = canon
        out[k] = v.detach().float().clone()
    return out
