"""JAX (flax) CUT3R params -> the port's ``state_dict``.

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

__all__ = ["params_from_jax"]

_SKIP = re.compile(r"^(patch_embed_ray_map|enc_blocks_ray_map_\d+|"
                   r"enc_norm_ray_map|masked_img_token|masked_ray_map_token|"
                   r"downstream_head/(dpt_cross|dpt_rgb|final_transform_\d+))"
                   r"(/|$)")
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
        if _SKIP.match(path):
            continue
        parts = path.split("/")
        leaf, val = _leaf(parts[-1], np.asarray(w, np.float32))
        key = ".".join([_segment(p) for p in parts[:-1]] + [leaf])
        sd[key] = torch.tensor(np.ascontiguousarray(val))
    return sd
