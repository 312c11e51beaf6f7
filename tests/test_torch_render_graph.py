"""The CUDA-graph render's CPU side (``slam/render_graph.py``) and the
host-copy-free homogeneous row of ``geometry/lie``. No JAX.

On the CPU ``render_window`` never takes the graph path: a CPU gradient
render, a ``no_grad`` render and ``render_view`` keep the eager body's
outputs and gradients, which are those of the body as it was before the
graph path existed, and ``render.views.*`` counts every call. The graph
cache's policy (a structure's first call eager, then capture, replay, a
recapture at new shapes, the least recently used structure dropped, the
pending-backward guard) runs here against a stand-in for
``torch.cuda.CUDAGraph`` that captures nothing: its counters and
bookkeeping are checked, not its maps (the card's test,
tests/test_torch_render_graph_cuda.py, holds those to the eager path).
"""
import contextlib

import pytest
import torch

from cut3r_slam_tpu_torch.bench import micro_scene
from cut3r_slam_tpu_torch.geometry import lie
from cut3r_slam_tpu_torch.geometry.quaternion import (quat_normalize,
                                                      quat_to_matrix)
from cut3r_slam_tpu_torch.ops.gs_raster_cuda import rasterize_cuda_multi
from cut3r_slam_tpu_torch.slam import render_graph, renderer
from cut3r_slam_tpu_torch.slam.renderer import (bin_window, render_view,
                                                render_window)
from cut3r_slam_tpu_torch.utils import profiling
from cut3r_slam_tpu_torch.utils.profiling import (StageTimer, attach, count,
                                                  held_counts, span)

H, W, N = 32, 48, 600


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def timer():
    t = StageTimer()
    prev = attach(t)
    yield t
    attach(prev)


# ---------------------------------------------------------------------------
# geometry/lie: the [0, 0, 0, 1] row
# ---------------------------------------------------------------------------

def _old_homogeneous(R, t):
    """The construction before: a host tensor copied to t's device."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=t.dtype,
                          device=t.device).expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_homogeneous_row_is_the_old_one(batch, dtype):
    g = torch.Generator().manual_seed(len(batch))
    R = torch.randn(batch + (3, 3), generator=g, dtype=dtype)
    t = torch.randn(batch + (3,), generator=g, dtype=dtype)
    new, old = lie._homogeneous(R, t), _old_homogeneous(R, t)
    assert new.dtype == old.dtype == dtype and new.device == old.device
    assert new.shape == batch + (4, 4) and torch.equal(new, old)
    # se3_matrix / sim3_matrix, values and gradients
    for fn, n in ((lie.se3_matrix, 7), (lie.sim3_matrix, 8)):
        x = torch.randn(batch + (n,), generator=g, dtype=dtype)
        if n == 8:
            x[..., 7] = x[..., 7].abs() + 0.5
        w = torch.randn(batch + (4, 4), generator=g, dtype=dtype)
        a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        R = quat_to_matrix(quat_normalize(b[..., 3:7]))
        if n == 8:
            R = R * b[..., 7:8, None]
        ma, mb = fn(a), _old_homogeneous(R, b[..., :3])
        assert torch.equal(ma, mb)
        (ga,) = torch.autograd.grad((ma * w).sum(), a)
        (gb,) = torch.autograd.grad((mb * w).sum(), b)
        assert torch.equal(ga, gb)


def test_homogeneous_row_under_vmap_jacfwd():
    """The Sim(3) PGO's edge Jacobians take ``sim3_matrix`` through
    ``vmap(jacfwd(...))``: the same Jacobians as the old row's."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, generator=g, dtype=torch.float64)
    x[:, 7] = x[:, 7].abs() + 0.5

    def old(v):
        R = quat_to_matrix(quat_normalize(v[3:7])) * v[7]
        return _old_homogeneous(R, v[:3])
    jn = torch.func.vmap(torch.func.jacfwd(lie.sim3_matrix))(x)
    jo = torch.func.vmap(torch.func.jacfwd(old))(x)
    assert torch.equal(jn, jo)


# ---------------------------------------------------------------------------
# the CPU keeps the eager path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    params, alive, w2c, K4, cfg = micro_scene(H, W, N, "cpu")
    g = torch.Generator().manual_seed(0)
    alive = torch.rand(N, generator=g) < 0.7
    return params, alive, w2c, K4, cfg


def _inputs(scene, V, seed):
    params, alive, w2c, K4, cfg = scene
    g = torch.Generator().manual_seed(seed)
    p = {k: v + 0.01 * torch.randn(v.shape, generator=g)
         for k, v in params.items()}
    w2cs = w2c.repeat(V, 1, 1)
    w2cs[:, 0, 3] = 0.05 * torch.arange(V)
    return p, alive, w2cs, K4, cfg, 1e-3 * torch.randn(V, 3, generator=g)


def _old_render_window(params, alive, w2c_base, K4, cfg, trans_deltas=None,
                       rot_deltas=None, bins=None, means2d_probe=None):
    """``render_window``'s body before the graph path, verbatim."""
    means_cam, quats_cam = renderer.transform_to_frame(
        params, renderer._posed(w2c_base, trans_deltas, rot_deltas))
    scales, opac, colors = renderer._attrs(params, alive)
    return rasterize_cuda_multi(means_cam, quats_cam, scales, opac, colors,
                                K4, cfg, bins=bins,
                                means2d_probe=means2d_probe)


def _graph_refused(*a, **k):
    raise AssertionError("the CUDA-graph path was taken")


# the mapper's three gradient renders: (V, parameters are leaves, cached
# bins, probe)
CALLS = {"refine": (3, False, True, False), "window": (4, True, True, False),
         "gba": (2, True, False, True)}


@pytest.mark.parametrize("call", list(CALLS))
def test_cpu_gradient_render_stays_eager(scene, timer, monkeypatch, call):
    """Three gradient renders of one of the mapper's call shapes on the
    CPU: no graph, the old body's maps and gradients bit for bit, and the
    views counted on every call."""
    monkeypatch.setattr(render_graph, "run", _graph_refused)
    V, p_leaf, binned, probe = CALLS[call]
    for i in range(3):
        p, alive, w2cs, K4, cfg, d = _inputs(scene, V, i)
        bins = bin_window(p, alive, w2cs, K4, cfg) if binned else None
        outs = []
        for fn in (render_window, _old_render_window):
            pl = {k: v.clone().requires_grad_(p_leaf) for k, v in p.items()}
            t = d.clone().requires_grad_(True)
            r = d.flip(0).clone().requires_grad_(True)
            pr = torch.zeros(V, N, 2, requires_grad=True) if probe else None
            maps = fn(pl, alive, w2cs, K4, cfg, trans_deltas=t,
                      rot_deltas=r, bins=bins, means2d_probe=pr)
            leaves = [t, r] + (list(pl.values()) if p_leaf else []) \
                + ([pr] if probe else [])
            loss = maps["color"].sum() + 0.1 * maps["depth"].sum() \
                + 0.01 * maps["normal"].sum()
            outs.append((maps, torch.autograd.grad(loss, leaves)))
        (m_new, g_new), (m_old, g_old) = outs
        assert m_new.keys() == m_old.keys()
        for k in m_old:
            assert torch.equal(m_new[k], m_old[k]), k
        for a, b in zip(g_new, g_old):
            assert torch.equal(a, b)
    c = timer.counters
    assert c["render.views.grad"] == 2 * 3 * V      # both bodies, 3 calls
    assert not any(k.startswith("render.graph") for k in c), dict(c)


def test_no_grad_renders_stay_eager(scene, timer, monkeypatch):
    """Under ``no_grad`` (``data_update``, the batched tracker renders, the
    viewer) and through ``render_view`` nothing is graphed, whatever the
    inputs require."""
    monkeypatch.setattr(render_graph, "run", _graph_refused)
    p, alive, w2cs, K4, cfg, d = _inputs(scene, 3, 7)
    pl = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        a = render_window(pl, alive, w2cs, K4, cfg)
        b = _old_render_window(pl, alive, w2cs, K4, cfg)
    for k in b:
        assert torch.equal(a[k], b[k])
    one = render_view(pl, alive, w2cs[0], K4, cfg)
    (g,) = torch.autograd.grad(one["color"].sum(), [pl["xyz"]])
    assert torch.isfinite(g).all()
    c = timer.counters
    assert c["render.views.nograd"] == 2 * 3
    assert c["render.views.grad"] == 1


def test_held_counts_hold_counts_and_pass_spans(timer):
    with held_counts() as held:
        count("a", 2)
        with span("s"):
            count("a")
        assert profiling._timer is not timer
    count("b")
    assert dict(held) == {"a": 3}
    assert timer.counters == {"b": 1} and timer.counts["s"] == 1
    assert profiling._timer is timer


# ---------------------------------------------------------------------------
# the graph cache's policy, against a stand-in graph
# ---------------------------------------------------------------------------

class _StandIn:
    """``torch.cuda.CUDAGraph`` without a device: captures nothing (the
    body runs once, at the capture), replays nothing."""
    replays = 0

    def capture_begin(self, pool=None):
        self._pool = pool if pool is not None else object()

    def capture_end(self):
        pass

    def replay(self):
        _StandIn.replays += 1

    def pool(self):
        return self._pool


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandIn)
    monkeypatch.setattr(render_graph, "_streams", {})
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    render_graph.clear()
    _StandIn.replays = 0
    yield
    render_graph.clear()


def _call(scene, V, P=N, seed=0):
    """One window-shaped gradient render through ``render_graph.run`` on
    the CPU: (leaves, maps)."""
    p, alive, w2cs, K4, cfg, d = _inputs(scene, V, seed)
    leaves = {k: v[:P].clone().requires_grad_(True) for k, v in p.items()}
    x = {f"p.{k}": v for k, v in leaves.items()}
    x.update(alive=alive[:P], w2c=w2cs, K4=K4)
    return leaves, render_graph.run(renderer._window, cfg, x)


def _backward(leaves, maps):
    return torch.autograd.grad(maps["color"].sum(), list(leaves.values()))


def test_policy_warmup_capture_replay(scene, timer, stand_in):
    """First call eager, second captured, then replays; a new prefix P
    recaptures and drops the old graph; the views are counted on every
    call and the replays inside ``render.graph_fwd`` / ``_bwd``."""
    for i in range(4):
        _backward(*_call(scene, 3, seed=i))
    (key, first), = render_graph._graphs.items()
    _backward(*_call(scene, 3, P=N - 50))
    (key2, second), = render_graph._graphs.items()
    assert key2 == key and second is not first
    assert second.layout[0][0] == (N - 50, 3)
    c = timer.counters
    assert (c["render.graph.eager"], c["render.graph.eager.warmup"],
            c["render.graph.capture"], c["render.graph.replay"]) \
        == (1, 1, 2, 2), dict(c)
    assert c["render.views.grad"] == 5 * 3
    assert timer.counts["render.graph_fwd"] == 4 == \
        timer.counts["render.graph_bwd"]
    assert _StandIn.replays == 8


def test_policy_pending_backward_goes_eager(scene, timer, stand_in):
    """A replay whose backward has not run sends the next render, of any
    structure, down the eager path; a dropped node releases it; a
    backward after a later replay of its graph raises."""
    for V in (3, 2):
        for i in range(2):
            _backward(*_call(scene, V, seed=i))  # warm-up, capture
    la, ma = _call(scene, 3, seed=2)              # replay, backward due
    assert render_graph._pending[0] is not None
    _call(scene, 2)                               # another structure
    _backward(*_call(scene, 3, seed=3))
    assert timer.counters["render.graph.eager.pending"] == 2
    _backward(la, ma)
    assert render_graph._pending[0] is None
    la, ma = _call(scene, 3, seed=4)
    del la, ma                                    # never differentiated
    assert render_graph._pending[0] is None
    _backward(*_call(scene, 3, seed=5))
    assert timer.counters["render.graph.replay"] == 3
    la, ma = _call(scene, 3, seed=6)
    loss = ma["color"].sum()
    torch.autograd.grad(loss, list(la.values()), retain_graph=True)
    _backward(*_call(scene, 3, seed=7))
    with pytest.raises(RuntimeError, match="later replay"):
        torch.autograd.grad(loss, list(la.values()))


def test_policy_keeps_the_newest_structures(scene, timer, stand_in,
                                            monkeypatch):
    """Past ``MAX_GRAPHS`` structures the least recently used one goes."""
    monkeypatch.setattr(render_graph, "MAX_GRAPHS", 2)
    for V in (1, 2, 3):
        for i in range(2):
            _backward(*_call(scene, V, seed=i))
    assert [k[5] for k in render_graph._graphs] == [2, 3]
    _backward(*_call(scene, 1))                   # warmed: captures again
    assert [k[5] for k in render_graph._graphs] == [3, 1]
    assert timer.counters["render.graph.capture"] == 4
    assert timer.counters["render.graph.eager.warmup"] == 3
