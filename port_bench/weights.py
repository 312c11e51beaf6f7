"""CUT3R's weights drawn from the seed on the device, in the port's
initialization scheme: normal(0, 0.02) linear and embedding weights and
tokens, zero biases, unit norms, convolutions normal with standard
deviation fan_in^-1/2; then the configuration's named tensors scaled or
set (the port's ``init_trainable`` scales the pointmap heads' last
convolutions; its plausible random SLAM model also biases the self
pointmap to a plane in front of the camera and the pose head to the
identity). All normal
draws come from ONE ``torch.randn`` on the device; the state_dict's
tensors are scaled views of it, keyed by the reference model's parameter
names (the port's)."""
from __future__ import annotations

import functools

import torch
import torch.nn as nn

from .reference.cut3r import CUT3R, CUT3RConfig

__all__ = ["draw_state_dict", "model_weights", "reference_config"]


def reference_config(widths: dict) -> CUT3RConfig:
    """The reference's ``CUT3RConfig`` from a configuration's widths."""
    keys = CUT3RConfig.__dataclass_fields__
    return CUT3RConfig(**{k: v for k, v in widths.items() if k in keys})


def _kind(model, name):
    leaf = name.rsplit(".", 1)[-1]
    mod = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else model
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return "one" if leaf == "weight" else "zero"
    if leaf == "bias":
        return "zero"
    if isinstance(mod, nn.Conv2d):
        return "conv", mod.weight[0].numel()
    if isinstance(mod, nn.ConvTranspose2d):
        w = mod.weight
        return "conv", w.shape[0] * w.shape[2] * w.shape[3]
    return "normal"


@functools.lru_cache(maxsize=4)
def _layout(widths_items):
    """(name, shape, kind) of every parameter, by name."""
    with torch.device("meta"):
        model = CUT3R(reference_config(dict(widths_items)))
    return tuple((n, tuple(p.shape), _kind(model, n))
                 for n, p in sorted(model.named_parameters()))


@torch.no_grad()
def draw_state_dict(widths: dict, seed: int, device, std=0.02,
                    scale=None, assign=None):
    """{name: float32 tensor on ``device``} for every parameter of CUT3R
    at ``widths``, from ``seed`` (the normal draws sliced in the order of
    the names)."""
    named = _layout(tuple(sorted(widths.items())))
    total = sum(int(torch.Size(shape).numel()) for _, shape, k in named
                if k not in ("one", "zero"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in named:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = int(torch.Size(shape).numel())
            sd = std if kind == "normal" else kind[1] ** -0.5
            out[name] = flat[off:off + n].view(shape).mul_(sd)
            off += n
    for name, gain in (scale or {}).items():
        out[name].mul_(gain)
    for name, value in (assign or {}).items():
        out[name].copy_(torch.tensor(value, device=device))
    return out


def model_weights(model_cfg: dict, seed: int, device):
    """The state_dict of a configuration's ``model`` for run ``seed``: its
    ``widths`` and its ``init``: ``std``, and optionally ``scale`` (a gain
    by parameter name) and ``assign`` (values by parameter name), applied
    after the draw."""
    init = model_cfg["init"]
    return draw_state_dict(model_cfg["widths"], seed, device, init["std"],
                           init.get("scale"), init.get("assign"))
