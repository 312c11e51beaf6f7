"""The mapper's gradient renders replayed as CUDA graphs
(``slam/render_graph.py``), on the card. Every test needs a GPU (marker
``cuda``) and skips without one. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_render_graph_cuda.py -q

At the mapping's shape (384x512, an arena of 2^18 slots with ~95k alive,
512 entries a tile) the three calls the mapper makes run several
iterations each, with the parameters, the pose deltas and the bins
changed between them: the batched refine (pose deltas only, cached bins),
the window (parameters and deltas, cached bins) and the global-BA batch
(parameters, deltas and the screen-space probe, fresh binning). Every map
and every leaf's gradient must be ``torch.equal`` to the eager body's on
the same inputs; the counters are exact; a new arena prefix recaptures
and frees the old graph; a forward whose backward is pending sends the
next render down the eager path; maps and gradients handed out are never
changed by a later replay.
"""
import gc
import weakref

import pytest
import torch

from cut3r_slam_tpu_torch import full_f32
from cut3r_slam_tpu_torch.bench import micro_scene
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
from cut3r_slam_tpu_torch.slam import render_graph, renderer
from cut3r_slam_tpu_torch.slam.renderer import bin_window, render_window
from cut3r_slam_tpu_torch.utils.profiling import StageTimer, attach

pytestmark = pytest.mark.cuda

H, W = 384, 512
ARENA = 2 ** 18
ALIVE = 95_000
KERNELS = ("gs_blend_fwd", "gs_blend_bwd", "gs_pack_bwd")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    with full_f32():
        yield torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_graphs():
    """Each test starts with no graph and no warm-up, and leaves none."""
    render_graph.clear()
    yield
    render_graph.clear()


@pytest.fixture(scope="module")
def scene(cuda):
    """The mapping's shape: 2^18 slots, ~95k alive."""
    params, _, w2c, K4, cfg = micro_scene(H, W, ARENA, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    alive = torch.rand(ARENA, generator=g, device=cuda) < ALIVE / ARENA
    return params, alive, w2c, K4, cfg


@pytest.fixture
def timer():
    t = StageTimer()
    prev = attach(t)
    yield t
    attach(prev)


# the mapper's three gradient renders: (V, parameters are leaves, pose
# deltas, cached bins, probe, the maps the loss reads)
SHAPES = {
    "refine": (3, False, True, True, False, ("color", "depth", "alpha")),
    "window": (6, True, True, True, False, ("color", "depth")),
    "gba": (4, True, True, False, True, ("color", "depth", "normal")),
}


def _state(scene, V, i, P=ARENA):
    """Iteration ``i``'s inputs: parameters moved, poses and deltas drawn,
    all from seed ``i``."""
    params, alive, w2c, K4, cfg = scene
    g = torch.Generator(device=w2c.device).manual_seed(100 + i)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=w2c.device)
    p = {"xyz": params["xyz"] + 0.01 * rnd(ARENA, 3),
         "f_dc": params["f_dc"] + 0.05 * rnd(ARENA, 3),
         "opacity_logit": params["opacity_logit"] + 0.2 * rnd(ARENA),
         "log_scales": params["log_scales"] + 0.1 * rnd(ARENA, 3),
         "quat": params["quat"] + 0.05 * rnd(ARENA, 4)}
    p = {k: v[:P].contiguous() for k, v in p.items()}
    w2cs = w2c.repeat(V, 1, 1)
    w2cs[:, 0, 3] = 0.05 * torch.arange(V, device=w2c.device) + 0.01 * i
    t, r = 1e-3 * rnd(V, 3), 1e-3 * rnd(V, 3)
    cot = {k: rnd(V, H, W, 3 if k in ("color", "normal") else 1)
           .squeeze(-1) for k in ("color", "depth", "alpha", "normal")}
    return p, alive[:P], w2cs, K4, cfg, t, r, cot


def _render(shape, state, body):
    """One gradient render of ``shape`` through ``body`` (the public entry
    or the eager body): (maps, {leaf: gradient}) from fresh leaves."""
    V, p_leaf, _, binned, probe, reads = SHAPES[shape]
    p, alive, w2cs, K4, cfg, t, r, cot = state
    leaves = {}
    if p_leaf:
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        leaves.update(p)
    leaves["t"] = t.clone().requires_grad_(True)
    leaves["r"] = r.clone().requires_grad_(True)
    bins = bin_window(p, alive, w2cs, K4, cfg, trans_deltas=t,
                      rot_deltas=r) if binned else None
    kw = {}
    if probe:
        leaves["probe"] = torch.zeros(V, p["xyz"].shape[0], 2,
                                      device=w2cs.device, requires_grad=True)
        kw["means2d_probe"] = leaves["probe"]
    maps = body(p, alive, w2cs, K4, cfg, trans_deltas=leaves["t"],
                rot_deltas=leaves["r"], bins=bins, **kw)
    loss = sum((maps[k] * cot[k]).sum() for k in reads)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return maps, dict(zip(leaves, grads))


def _eager(params, alive, w2c_base, K4, cfg, trans_deltas=None,
           rot_deltas=None, bins=None, means2d_probe=None):
    """``render_window``'s body called directly: the eager path."""
    x = {f"p.{k}": v for k, v in params.items()}
    x.update(alive=alive, w2c=w2c_base, K4=K4, t=trans_deltas,
             r=rot_deltas, probe=means2d_probe)
    x.update((f"bins.{i}", b) for i, b in enumerate(bins or ()))
    return renderer._window(cfg, {k: v for k, v in x.items()
                                  if v is not None})


def _assert_equal(got, ref, what):
    for k in ref:
        assert torch.equal(got[k], ref[k]), \
            f"{what} {k}: max |diff| {(got[k] - ref[k]).abs().max()}"


@pytest.mark.parametrize("shape", list(SHAPES))
def test_call_shape_equals_eager(cuda, scene, timer, shape):
    """Four iterations of one of the mapper's calls, inputs changed every
    time: the first runs eagerly (the warm-up), the second captures, the
    rest replay; maps and gradients equal to the eager body's bit for bit;
    the counters and kernel launches count every call."""
    V = SHAPES[shape][0]
    states = [_state(scene, V, i) for i in range(4)]
    attach(None)
    refs = [_render(shape, s, _eager) for s in states]
    attach(timer)
    before = {k: G.LAUNCHES[k] for k in KERNELS}
    for i, s in enumerate(states):
        maps, grads = _render(shape, s, render_window)
        _assert_equal(maps, refs[i][0], f"{shape} iteration {i} map")
        _assert_equal(grads, refs[i][1], f"{shape} iteration {i} gradient")
    c = timer.counters
    assert (c["render.graph.eager"], c["render.graph.eager.warmup"],
            c["render.graph.capture"], c["render.graph.replay"]) \
        == (1, 1, 1, 2), dict(c)
    assert "render.graph.eager.pending" not in c
    assert c["render.views.grad"] == 4 * V, dict(c)
    assert {k: G.LAUNCHES[k] - before[k] for k in KERNELS} \
        == dict.fromkeys(KERNELS, 4)
    assert timer.counts["render.graph_fwd"] == 3
    assert timer.counts["render.graph_bwd"] == 3


def test_new_prefix_recaptures_and_frees(cuda, scene, timer):
    """The window's graph at one arena prefix, then a shorter one: a
    second capture of the structure, the first graph freed, no more memory
    held, and the maps and gradients still the eager body's."""
    P1, P2 = ARENA, ARENA - 4096
    for i in range(3):
        out = _render("window", _state(scene, 6, i, P1), render_window)
    (key, g1), = render_graph._graphs.items()
    gone = weakref.ref(g1)
    del g1
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()      # the graph and one result
    s2 = _state(scene, 6, 3, P2)
    s2_bytes = torch.cuda.memory_allocated() - held
    out = _render("window", s2, render_window)
    gc.collect()
    assert gone() is None, "the superseded graph is still alive"
    (key2, g2), = render_graph._graphs.items()
    assert key2 == key and g2.layout[0][0] == (P2, 3)
    assert torch.cuda.memory_allocated() <= held + s2_bytes
    attach(None)
    ref_maps, ref_grads = _render("window", s2, _eager)
    _assert_equal(out[0], ref_maps, "prefix P2 map")
    _assert_equal(out[1], ref_grads, "prefix P2 gradient")
    assert timer.counters["render.graph.capture"] == 2


def _forward(state, body):
    """The window without pose deltas: (leaves, maps)."""
    p, alive, w2cs, K4, cfg = state[:5]
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    bins = bin_window(p, alive, w2cs, K4, cfg)
    return leaves, body(leaves, alive, w2cs, K4, cfg, bins=bins)


def _backward(leaves, maps):
    return torch.autograd.grad(maps["color"].sum(), list(leaves.values()))


def test_pending_backward_goes_eager(cuda, scene, timer):
    """A replay whose backward has not run yet: the next gradient render
    runs eagerly and is counted; both backwards then give the eager
    gradients. A replay whose graph node is dropped without a backward no
    longer blocks."""
    states = [_state(scene, 6, i) for i in range(4)]
    for s in states[:2]:                       # warm-up, capture
        _backward(*_forward(s, render_window))
    la, ma = _forward(states[2], render_window)    # replay, backward due
    lb, mb = _forward(states[3], render_window)    # eager
    assert timer.counters["render.graph.eager.pending"] == 1
    assert timer.counters["render.graph.replay"] == 1
    ga, gb = _backward(la, ma), _backward(lb, mb)
    attach(None)
    for state, maps, grads in ((states[2], ma, ga), (states[3], mb, gb)):
        leaves, ref = _forward(state, _eager)
        _assert_equal(maps, ref, "pending-guard map")
        for g, rg in zip(grads, _backward(leaves, ref)):
            assert torch.equal(g, rg)
    attach(timer)
    la, ma = _forward(states[2], render_window)    # replay, never backward
    assert render_graph._pending[0] is not None
    del la, ma
    gc.collect()
    assert render_graph._pending[0] is None
    _backward(*_forward(states[3], render_window))
    assert timer.counters["render.graph.replay"] == 3
    assert timer.counters["render.graph.eager.pending"] == 1


def test_held_outputs_survive_later_replays(cuda, scene, timer):
    """Maps and gradients of one replay are copies: the next replays of
    the same graph, on other inputs, leave them as they were."""
    states = [_state(scene, 4, i) for i in range(5)]
    for s in states[:2]:                       # warm-up, capture
        _render("gba", s, render_window)
    maps, grads = _render("gba", states[2], render_window)
    kept_maps = {k: v.clone() for k, v in maps.items()}
    kept_grads = {k: v.clone() for k, v in grads.items()}
    for s in states[3:]:
        _render("gba", s, render_window)
    assert timer.counters["render.graph.replay"] == 3
    _assert_equal(maps, kept_maps, "held map")
    _assert_equal(grads, kept_grads, "held gradient")


def test_leaf_hooks_fire(cuda, scene, timer):
    """A hook on a caller's leaf sees the graphed render's gradient, as
    the benchmark's loss listener and autograd's accumulation need."""
    seen = []
    for i in range(3):
        p, alive, w2cs, K4, cfg, t, r, cot = _state(scene, 6, i)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        leaves["xyz"].register_hook(lambda g: seen.append(g.clone()))
        maps = render_window(leaves, alive, w2cs, K4, cfg)
        loss = (maps["color"] * cot["color"]).sum()
        (g,) = torch.autograd.grad(loss, [leaves["xyz"]])
        assert torch.equal(seen[-1], g)
    assert len(seen) == 3 and timer.counters["render.graph.replay"] == 1
