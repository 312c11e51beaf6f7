"""Weights into the port's ``state_dict``s: from upstream torch
checkpoints (CUT3R ``load_cut3r_checkpoint``, Spann3R
``load_spann3r_checkpoint``; Omnidata's loader is
``models/omnidata.load_omnidata_ckpt``) or from the JAX models' flax
params (``params_from_jax``, ``omnidata_params_from_jax``).

``load_cut3r_checkpoint(path)`` follows the JAX converter's rules
(``cut3r_slam_tpu/models/convert.py``): unwrap ``ckpt["model"]``, strip
``module.``, alias ``dec_blocks`` as ``dec_blocks_state`` when the latter
is absent, and skip the training-only ``mask_generator`` /
``enc_pos_embed`` / ``dec_pos_embed`` / ``mask_token``. Those and the
never-run first residual unit of each DPT's ``refinenet4`` are the only
keys dropped (``CKPT_SKIP``); every other key goes into the state_dict as
it is, so ``model.load_state_dict`` (strict) raises on any key that is
unexpected or missing. ``load_spann3r_checkpoint`` does the same for the
upstream ``hislam2/modules/spann3r.py`` layout (``SPANN3R_SKIP``).

``params_from_jax(flat)`` takes a JAX model's params flattened to numpy
with ``/``-joined paths (``flax.traverse_util.flatten_dict(params["params"],
sep="/")``) and returns the port's state_dict, whose names are the
upstream torch ones. It serves every family whose flax names follow the
torch ones: CUT3R (either head), ``PriorNet``, ``CroCoPretrain``,
``CroCoDownstreamBinocular``, ``AsymmetricCroCo3DStereo`` and ``Spann3R``.
Layout transforms (the inverse of the JAX package's torch -> flax
converter):

* Dense kernel (in, out) -> Linear weight (out, in)
* Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
* ConvTranspose kernel (kh, kw, out, in) (``transpose_kernel=True``) ->
  ConvTranspose2d weight (in, out, kh, kw)
* LayerNorm / GroupNorm scale -> weight; Embed embedding -> weight
* a flax list entry ``<list>_<i>`` -> ``<list>.<i>``
* ModLN's ``mlp_1`` (the Linear after the SiLU) -> ``mlp.1``; a Spann3R
  key head's ``fc1`` / ``fc2`` -> ``0`` / ``2`` (Linear, GELU, Linear)

``omnidata_params_from_jax`` maps ``OmnidataDPT``'s flax names, which are
the JAX package's own, onto the midas / timm names of the port's model.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "omnidata_params_from_jax",
           "load_torch_checkpoint", "load_cut3r_checkpoint",
           "load_spann3r_checkpoint", "CKPT_SKIP", "SPANN3R_SKIP"]

# upstream checkpoint keys the port drops, each with its reason
CKPT_SKIP = {
    # training-only (the JAX converter's skip list)
    "mask_generator": "training-time masking",
    "enc_pos_embed": "unused: positions are RoPE",
    "dec_pos_embed": "unused: positions are RoPE",
    "mask_token": "training-time masking",
}
# dead in the upstream module too: refinenet4 fuses one input, so it never
# runs its first residual unit
CKPT_SKIP.update({
    f"downstream_head.{h}.scratch.refinenet4.resConfUnit1.":
        "unused by the upstream DPT" for h in ("dpt_self", "dpt_cross",
                                               "dpt_rgb")})
# upstream Spann3R checkpoint keys the port drops (the JAX converter's
# skip list, and the dead refinenet4 unit of the DUSt3R DPT heads)
SPANN3R_SKIP = {
    "mem_dropout": "dropout, no tensors at inference",
    "dust3r.mask_token": "training-time masking",
    "dust3r.prediction_head": "CroCo pretraining head",
    "dust3r.enc_pos_embed": "unused: positions are RoPE",
    "dust3r.dec_pos_embed": "unused: positions are RoPE",
    "dust3r.mask_generator": "training-time masking",
}
SPANN3R_SKIP.update({
    f"dust3r.downstream_head{n}.dpt.scratch.refinenet4.resConfUnit1.":
        "unused by the upstream DPT" for n in (1, 2)})
# ModuleList alias of the same tensors (upstream dpt_block registers
# scratch.layer_rn = [layer1_rn, ..., layer4_rn])
_RN_ALIAS = re.compile(r"^(.*\.(?:dpt|dpt_self|dpt_cross|dpt_rgb)\."
                       r"scratch\.)layer_rn\.(\d)\.(.*)$")


_ACT = {"act_1_conv": "act_postprocess.0.0", "act_1_deconv": "act_postprocess.0.1",
        "act_2_conv": "act_postprocess.1.0", "act_2_deconv": "act_postprocess.1.1",
        "act_3_conv": "act_postprocess.2.0", "act_4_conv": "act_postprocess.3.0",
        "act_4_downconv": "act_postprocess.3.1"}
_HEAD = {"head_0": "head.0", "head_2": "head.2", "head_4": "head.4"}
_LIST = re.compile(r"^(blocks|enc_blocks|enc_blocks_ray_map|dec_blocks|"
                   r"dec_blocks2|dec_blocks_state|write_blocks|read_blocks|"
                   r"final_transform|value_encoder)_(\d+)$")


def _segment(seg: str, parent: str = "") -> str:
    m = _LIST.match(seg)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    if parent.startswith("attn_head_") and seg in ("fc1", "fc2"):
        return "0" if seg == "fc1" else "2"
    if seg in _ACT:
        return _ACT[seg]
    if seg in _HEAD:
        return _HEAD[seg]
    if seg == "mlp_1":      # ModLN's Sequential(SiLU, Linear)
        return "mlp.1"
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
        parts = path.split("/")
        leaf, val = _leaf(parts[-1], np.asarray(w, np.float32))
        segs = [_segment(p, parts[i - 1] if i else "")
                for i, p in enumerate(parts[:-1])]
        sd[".".join(segs + [leaf])] = torch.tensor(np.ascontiguousarray(val))
    return sd


# OmnidataDPT: the JAX package's flax names -> the midas / timm names
_PM = "pretrained.model."
_OMNI = [
    (r"backbone/stem_conv", _PM + "patch_embed.backbone.stem.conv"),
    (r"backbone/stem_norm/gn", _PM + "patch_embed.backbone.stem.norm"),
    (r"backbone/stage(\d+)_block(\d+)/(conv\d)",
     _PM + r"patch_embed.backbone.stages.\1.blocks.\2.\3"),
    (r"backbone/stage(\d+)_block(\d+)/(norm\d)/gn",
     _PM + r"patch_embed.backbone.stages.\1.blocks.\2.\3"),
    (r"backbone/stage(\d+)_block(\d+)/downsample_conv",
     _PM + r"patch_embed.backbone.stages.\1.blocks.\2.downsample.conv"),
    (r"backbone/stage(\d+)_block(\d+)/downsample_norm/gn",
     _PM + r"patch_embed.backbone.stages.\1.blocks.\2.downsample.norm"),
    (r"(cls_token|pos_embed)", _PM + r"\1"),
    (r"embed_proj", _PM + "patch_embed.proj"),
    (r"block(\d+)/(norm\d)", _PM + r"blocks.\1.\2"),
    (r"block(\d+)/qkv", _PM + r"blocks.\1.attn.qkv"),
    (r"block(\d+)/attn_proj", _PM + r"blocks.\1.attn.proj"),
    (r"block(\d+)/(fc\d)", _PM + r"blocks.\1.mlp.\2"),
    (r"readout(\d)_proj", r"pretrained.act_postprocess\1.0.project.0"),
    (r"post(\d)_conv", r"pretrained.act_postprocess\1.3"),
    (r"post4_conv2", "pretrained.act_postprocess4.4"),
    (r"(layer\d_rn)", r"scratch.\1"),
    (r"refinenet(\d)/rcu(\d)/(conv\d)",
     r"scratch.refinenet\1.resConfUnit\2.\3"),
    (r"refinenet(\d)/out_conv", r"scratch.refinenet\1.out_conv"),
    (r"head_conv1", "scratch.output_conv.0"),
    (r"head_conv2", "scratch.output_conv.2"),
    (r"head_conv3", "scratch.output_conv.4"),
]


def omnidata_params_from_jax(flat: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """``OmnidataDPT``'s flax params (flattened, ``/``-joined) as the
    port's state_dict (midas / timm names, the layout of the public
    ``omnidata_dpt_*_v2.ckpt`` with its ``model.`` prefix stripped)."""
    sd = {}
    for path, w in flat.items():
        head, leaf = (path.rsplit("/", 1) if "/" in path else ("", path))
        if leaf in ("cls_token", "pos_embed"):
            head, leaf = path, ""
        for pat, rep in _OMNI:
            if re.fullmatch(pat, head):
                name = re.sub(pat, rep, head)
                break
        else:
            raise KeyError(f"unmapped OmnidataDPT param {path}")
        if not leaf:
            sd[name] = torch.tensor(np.asarray(w, np.float32))
            continue
        leaf, val = _leaf(leaf, np.asarray(w, np.float32))
        sd[f"{name}.{leaf}"] = torch.tensor(np.ascontiguousarray(val))
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The raw state_dict of a torch checkpoint (``ckpt["model"]`` when
    present), with any ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k[7:] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _canonical(sd, skip) -> Dict[str, torch.Tensor]:
    """``sd`` without the keys under a ``skip`` prefix, the DPT
    ``layer_rn`` aliases folded into ``layer{k}_rn`` (they must hold the
    same tensors), as f32."""
    out = {}
    for k, v in sd.items():
        if any(k.startswith(p) for p in skip):
            continue
        m = _RN_ALIAS.match(k)
        if m:
            canon = f"{m.group(1)}layer{int(m.group(2)) + 1}_rn.{m.group(3)}"
            if canon in sd and not torch.equal(sd[canon], v):
                raise ValueError(f"{k} differs from its alias {canon}")
            k = canon
        out[k] = v.detach().float().clone()
    return out


def load_cut3r_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An upstream CUT3R checkpoint (either head) as the port's
    state_dict (f32). Load it with ``model.load_state_dict`` (strict)."""
    sd = load_torch_checkpoint(path)
    if not any(k.startswith("dec_blocks_state.") for k in sd):
        sd.update({"dec_blocks_state." + k[len("dec_blocks."):]: v
                   for k, v in list(sd.items())
                   if k.startswith("dec_blocks.")})
    return _canonical(sd, CKPT_SKIP)


def load_spann3r_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An upstream Spann3R checkpoint (``hislam2/modules/spann3r.py``
    names: ``dust3r.*``, ``value_encoder.*``, ``norm_q/k/v``,
    ``attn_head_1/2``...) as the port's ``Spann3R`` state_dict (f32).
    Load it with ``model.load_state_dict`` (strict)."""
    return _canonical(load_torch_checkpoint(path), SPANN3R_SKIP)
