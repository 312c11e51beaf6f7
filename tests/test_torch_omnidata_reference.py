"""The port's Omnidata DPT-Hybrid (``models/omnidata.py``) against the
benchmark's plain reference (``port_bench/reference/omnidata.py``, written
anew in plain torch, float32) on the CPU, from one seeded random state
dict (``random_omnidata``, the draw ``prior_model: omnidata`` builds):
the depth and normal maps and the tapped ViT blocks' tokens, at a reduced
width on 64x96 images and at the published widths on 64x64 ones.

Tolerance: the maps within 1e-4 of the reference map's spread about its
mean (the maps sit on the head's bias of 1, so a norm relative to the
map would hide a gap in what varies), the tokens within 1e-4 relative.
Both sides compute in float32 on the CPU; their convolutions, attention
and the position grid's resize (the port's triangle-filter einsum, the
reference's antialiased ``F.interpolate``) sum in other orders, which
reads ~2e-6 at the reduced width and ~2e-5 at the published one (16
bottlenecks, 12 blocks, the decoder); the same forward under bfloat16
autocast reads 5e-2 to 2e-1.
"""
import pytest
import torch

from cut3r_slam_tpu_torch.models.omnidata import random_omnidata
from port_bench.reference import omnidata as ref

REDUCED = dict(vit_dim=64, vit_depth=4, vit_heads=4, hook_blocks=(2, 3),
               features=32, resnet_layers=(1, 1, 1))
INIT = dict(scale={"scratch.output_conv.4.weight": 0.05,
                   "pretrained.model.pos_embed": 25.0},
            assign={"scratch.output_conv.4.bias": 1.0})
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spread_gap(got, want):
    return float((got - want).norm() / (want - want.mean((1, 2),
                                                         keepdim=True)).norm())


@pytest.mark.parametrize("task", ["depth", "normal"])
@pytest.mark.parametrize("widths,hw", [(REDUCED, (64, 96)), ({}, (64, 64))],
                         ids=["reduced_64x96", "published_64x64"])
def test_port_matches_the_reference(task, widths, hw):
    port = random_omnidata(task, 11, "cpu", **INIT, **widths)
    plain = ref.OmnidataDPT(task, **widths)
    plain.load_state_dict(port.state_dict(), strict=True)
    taps = {}
    for b in port.hook_blocks:
        port.pretrained.model.blocks[b].register_forward_hook(
            lambda m, a, out, b=b: taps.__setitem__(b, out))
    img = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = port(img)
        want, tokens = plain(img)
    assert got.shape == want.shape == ((2, *hw) if task == "depth"
                                       else (2, *hw, 3))
    assert (want > 0).all()                  # above the head's final ReLU
    assert _spread_gap(got, want) < TOL
    assert sorted(tokens) == sorted(taps) == sorted(port.hook_blocks)
    for b, t in tokens.items():
        assert float((taps[b] - t).norm() / t.norm()) < TOL


@pytest.mark.parametrize("task", ["depth", "normal"])
def test_the_benchmarks_draw_runs_the_port_as_the_reference(task):
    """The state dict the benchmark draws (``draw_state_dict``, its own
    scheme) loads strictly into the port, which then gives the
    reference's maps."""
    sd = ref.draw_state_dict(task, 12, "cpu", **INIT, **REDUCED)
    port = random_omnidata(task, 0, "cpu", **REDUCED)
    port.load_state_dict(sd, strict=True)
    plain = ref.OmnidataDPT(task, **REDUCED)
    plain.load_state_dict(sd, strict=True)
    img = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got, (want, _) = port(img), plain(img)
    assert (want > 0).all() and _spread_gap(got, want) < TOL


def test_the_draw_is_the_seeds_and_the_published_size():
    a = random_omnidata("depth", 4, "cpu", **INIT, **REDUCED)
    b = random_omnidata("depth", 4, "cpu", **INIT, **REDUCED)
    c = random_omnidata("depth", 5, "cpu", **INIT, **REDUCED)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["pretrained.model.pos_embed"],
                           sc["pretrained.model.pos_embed"])
    assert (sa["scratch.output_conv.4.bias"] == 1.0).all()
    with torch.device("meta"):
        full = ref.OmnidataDPT("depth")
    assert sum(p.numel() for p in full.parameters()) == 121_196_289
