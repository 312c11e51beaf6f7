"""CUDA graphs of the mapper's gradient renders (``renderer.render_window``).

A gradient render of V views is a chain of small launches: the pose and
camera transform, the preprocess (~100 elementwise operations on (V, P)
tensors), the binning or the cached bins' validity, the occupancy sort,
the pack gather, K1 and the image maps, then as many again in their
backward with K2 and K3. The device finishes each faster than the host
launches the next, so the host sets a mapping iteration's pace. Here the
render's forward and its backward are each captured once as a CUDA graph
and then replayed with one launch, as ``torch.cuda.make_graphed_callables``
does: an autograd Function copies the caller's tensors into the graphs'
static inputs and replays the forward graph; its backward copies the
maps' cotangents in, replays the backward graph and hands the static
gradients back to autograd, which reaches the caller's leaves (and their
hooks) as before. The maps and the gradients are returned as copies, so a
later replay never changes a tensor the caller holds.

What engages it is what the call shows: ``render_window`` hands a call
here when its tensors are on a CUDA device, grad mode is on and an input
requires a gradient. A graph is kept per structure (the body, the
rasterizer's config, the device, the float32-matmul and TF32 settings,
each input's name, dtype, rank and whether it requires a gradient, the
view count V) with the shapes and strides it was captured at: a call of
new shapes (the arena's live prefix P grows between mapping calls)
recaptures and drops the old graph. A structure's first call runs eagerly
and its result is used: it loads the kernels and creates the cuBLAS
handles that a capture must not create; every later call captures or
replays. Every graph of a device draws from one memory pool, so a new
capture reuses what a dropped graph held. That is safe because no graph's
tensors outlive a replay but the saved activations that its backward
reads; while a forward replay's backward is pending, a gradient render
on any structure runs eagerly (counted), and so never writes them.

Counters (``utils/profiling.count``): ``render.graph.capture``,
``render.graph.replay``, ``render.graph.eager`` with its reason in
``render.graph.eager.warmup`` / ``render.graph.eager.pending``; the
counts a capture's body makes (``render.views.*``) and the kernels it
launches (``gs_raster_cuda.LAUNCHES``) are held back at the capture and
given by every replay. Spans ``render.graph_fwd`` / ``render.graph_bwd``
cover the replays.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict

import torch
from torch.autograd.function import once_differentiable

from ..ops.gs_raster_cuda import LAUNCHES
from ..utils.profiling import count, held_counts, span

__all__ = ["run", "clear"]

MAX_GRAPHS = 8    # structures kept; the least recently used is dropped

_graphs: "collections.OrderedDict[tuple, _Graphed]" = \
    collections.OrderedDict()
_warmed = set()       # structures whose first call ran eagerly
_pending = [None]     # the graph whose forward replay awaits its backward
_streams: Dict[int, torch.cuda.Stream] = {}


def clear():
    """Drop every graph and forget the warm-ups."""
    _graphs.clear()
    _warmed.clear()
    _pending[0] = None


def _structure(body, cfg, x):
    dev = x["w2c"].device
    return (body, cfg, dev, torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32, x["w2c"].shape[0],
            tuple((k, v.dtype, v.dim(), v.requires_grad)
                  for k, v in x.items()))


@contextlib.contextmanager
def _capturing(graph, pool):
    graph.capture_begin(pool=pool)
    try:
        yield
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()
        raise
    graph.capture_end()


def _add(counts: Dict[str, int], launches: Dict[str, int]):
    for k, n in launches.items():
        LAUNCHES[k] += n
    for k, n in counts.items():
        count(k, n)


class _Graphed:
    """One render captured at one set of shapes: static inputs, the
    forward and backward graphs, static outputs and gradients."""

    def __init__(self, body, cfg, x: Dict[str, torch.Tensor], layout, pool):
        dev = x["w2c"].device
        self.layout = layout
        self.gen = 0
        with torch.no_grad():
            self.inputs = [torch.empty_like(v).copy_(v) for v in x.values()]
        for s, v in zip(self.inputs, x.values()):
            s.requires_grad_(v.requires_grad)
        if dev.index not in _streams:
            _streams[dev.index] = torch.cuda.Stream(dev)
        stream = _streams[dev.index]
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        # no synchronize: a capture runs nothing, and every replay of the
        # pool's graphs is ordered on the caller's stream
        try:
            self._capture(body, cfg, x, stream, pool, before)
        finally:
            LAUNCHES.update(before)

    def _capture(self, body, cfg, x, stream, pool, before):
        with held_counts() as counts:
            with torch.cuda.stream(stream), _capturing(self.fwd, pool), \
                    torch.enable_grad():
                maps = body(cfg, dict(zip(x, self.inputs)))
            self.fwd_counts = dict(counts)
            self.fwd_launches = {k: LAUNCHES[k] - before[k] for k in before}
            self.names = tuple(maps)
            outs = tuple(maps.values())
            self.diff = tuple(o.requires_grad for o in outs)
            self.grad_out = [torch.empty_like(o)
                             for o, d in zip(outs, self.diff) if d]
            wrt = [s for s in self.inputs if s.requires_grad]
            counts.clear()
            mid = dict(LAUNCHES)
            with torch.cuda.stream(stream), \
                    _capturing(self.bwd, self.fwd.pool()):
                grads = iter(torch.autograd.grad(
                    [o for o, d in zip(outs, self.diff) if d], wrt,
                    self.grad_out, allow_unused=True))
            self.bwd_counts = dict(counts)
            self.bwd_launches = {k: LAUNCHES[k] - mid[k] for k in mid}
        self.outs = tuple(o.detach() for o in outs)
        self.grads = [next(grads) if s.requires_grad else None
                      for s in self.inputs]


class _Pending:
    """Held by a replay's autograd node: when the node goes without its
    backward having run, the replay no longer awaits one."""

    def __init__(self, graph, gen):
        self.graph, self.gen = graph, gen

    def __del__(self):
        if _pending[0] is self.graph and self.graph.gen == self.gen:
            _pending[0] = None


class _Replay(torch.autograd.Function):
    """The caller's tensors -> the graphed render's maps (copies); the
    backward replays the backward graph."""

    @staticmethod
    def forward(ctx, graph, *tensors):
        ctx.set_materialize_grads(False)
        for s, v in zip(graph.inputs, tensors):
            s.copy_(v)
        with span("render.graph_fwd"):
            graph.fwd.replay()
        _add(graph.fwd_counts, graph.fwd_launches)
        graph.gen += 1
        ctx.graph, ctx.gen = graph, graph.gen
        if any(graph.diff):
            _pending[0] = graph
            ctx.pending = _Pending(graph, graph.gen)
        outs = tuple(o.clone() for o in graph.outs)
        ctx.mark_non_differentiable(
            *(o for o, d in zip(outs, graph.diff) if not d))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graph = ctx.graph
        if ctx.gen != graph.gen:
            raise RuntimeError("a graphed render's backward after a later "
                               "replay of its graph")
        for s, g in zip(graph.grad_out,
                        (g for g, d in zip(grads, graph.diff) if d)):
            if g is None:
                s.zero_()
            else:
                s.copy_(g)
        with span("render.graph_bwd"):
            graph.bwd.replay()
        _add(graph.bwd_counts, graph.bwd_launches)
        if _pending[0] is graph:
            _pending[0] = None
        return (None,) + tuple(None if g is None else g.clone()
                               for g in graph.grads)


def _eager(body, cfg, x, reason):
    count("render.graph.eager")
    count(f"render.graph.eager.{reason}")
    return body(cfg, x)


def run(body: Callable, cfg, x: Dict[str, torch.Tensor]):
    """``body(cfg, x)`` (a dict of maps) for the named CUDA tensors ``x``
    (``x["w2c"]`` the views' poses), replayed from this structure's
    graphs, captured first where the shapes are new, or run eagerly on a
    structure's first call and while a replay's backward is pending."""
    key = _structure(body, cfg, x)
    layout = tuple((v.shape, v.stride()) for v in x.values())
    if key not in _warmed:
        _warmed.add(key)
        return _eager(body, cfg, x, "warmup")
    if _pending[0] is not None:
        return _eager(body, cfg, x, "pending")
    graph = _graphs.get(key)
    if graph is not None and graph.layout == layout:
        _graphs.move_to_end(key)
        count("render.graph.replay")
    else:
        dev = x["w2c"].device
        pool = next((g.fwd.pool() for k, g in _graphs.items()
                     if k[2] == dev), None)
        graph = _Graphed(body, cfg, x, layout, pool)
        # the new graph first, then the old one goes: the pool stays in use
        _graphs[key] = graph
        _graphs.move_to_end(key)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
        count("render.graph.capture")
    return dict(zip(graph.names, _Replay.apply(graph, *x.values())))
