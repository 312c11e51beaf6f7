"""Sharded CUT3R inference over a process group (port of
``cut3r_slam_tpu/parallel/inference.py``).

* ``make_sharded_forward``: replicated parameters (a broadcast from rank
  0), the (V, B, ...) images sliced on B over the ``dp`` axis, each
  rank's forward on its slice, the outputs gathered on B on every rank.
* ``tp_param_specs`` / ``make_tp_sharded_forward``: Megatron tensor
  parallelism over the ``tp`` axis through ``parallelize_module``: the
  attention ``qkv`` / ``projq`` / ``projk`` / ``projv`` and MLP ``fc1``
  Linears split by output feature (weight dim 0 and bias), the attention
  ``proj`` and ``fc2`` by input feature (weight dim 1, bias replicated),
  so each block reduces once after its attention and once after its MLP.
  Only 2-D Linear weights split: the patch embedding's Conv2d ``proj``
  stays replicated, as the JAX layout's ``ndim == 2`` rule keeps it.

The fused ``attn.qkv`` output is (3, heads, head_dim)-major: a contiguous
split of its rows would hand the first rank all of q and part of k. So
its rows are regrouped first into (tp, 3, heads / tp, head_dim) order,
which puts each rank's q, k and v of its own heads in its contiguous
share, and every attention then runs ``num_heads / tp`` heads. Cross
attention's ``projq`` / ``projk`` / ``projv`` are head-major already.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.distributed as dist

from ..models.blocks import Attention, CrossAttention
from .mesh import mesh_size, replicate, shard_batch

__all__ = ["make_sharded_forward", "tp_param_specs",
           "make_tp_sharded_forward"]

COL_PARENTS = ("qkv", "projq", "projk", "projv", "fc1")
ROW_PARENTS = ("proj", "fc2")


def _gather_dim1(out, group, n: int):
    """Every tensor output of two or more dims concatenated on dim 1 (B)
    over ``group``."""
    def gather(x):
        if not torch.is_tensor(x) or x.dim() < 2:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)
    return {k: gather(v) for k, v in out.items()}


def _batch_sharded(model: nn.Module, mesh, batch_axis: str):
    group, n = mesh.get_group(batch_axis), mesh_size(mesh, batch_axis)

    def fn(imgs: torch.Tensor, **kw):
        local = shard_batch(mesh, imgs, axis=batch_axis, dim=1)
        return _gather_dim1(model(local, **kw), group, n)
    return fn


def make_sharded_forward(model: nn.Module, mesh, batch_axis: str = "dp"):
    """Returns ``fn(imgs, **kw)``: ``model``'s parameters made equal to
    rank 0's, then per call this rank's B slice of imgs (V, B, H, W, 3)
    over ``batch_axis`` (B must divide by its size) through ``model`` and
    every (V, B, ...) output gathered back to the whole batch."""
    replicate(mesh, list(model.parameters()) + list(model.buffers()))
    return _batch_sharded(model, mesh, batch_axis)


def tp_param_specs(model: nn.Module) -> Dict[str, str]:
    """The tensor-parallel role of every parameter of ``model``'s
    state_dict: ``"col"`` (split by output feature: the weight's dim 0 and
    the bias of a ``qkv`` / ``projq`` / ``projk`` / ``projv`` / ``fc1``
    Linear), ``"row"`` (split by input feature: the weight's dim 1 of a
    ``proj`` / ``fc2`` Linear) or ``"replicate"`` (everything else,
    the row-split biases included)."""
    specs = {}
    for name in model.state_dict():
        mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(mod_name)
        parent = mod_name.rsplit(".", 1)[-1]
        role = "replicate"
        if isinstance(mod, nn.Linear):
            if parent in COL_PARENTS:
                role = "col"
            elif parent in ROW_PARENTS and leaf == "weight":
                role = "row"
        specs[name] = role
    return specs


@torch.no_grad()
def _regroup_qkv(attn: Attention, tp: int):
    """Reorder the fused qkv rows from (3, H, D) to (tp, 3, H / tp, D)."""
    H, D = attn.num_heads, attn.head_dim
    for p in (attn.qkv.weight, attn.qkv.bias):
        x = p.reshape((3, tp, H // tp, D) + p.shape[1:])
        p.copy_(x.transpose(0, 1).reshape(p.shape))


def make_tp_sharded_forward(model: nn.Module, mesh, batch_axis: str = "dp",
                            tp_axis: str = "tp"):
    """dp x tp sharded forward over a (``batch_axis``, ``tp_axis``) mesh:
    images sliced on B over ``batch_axis``, the Linears Megatron-split
    over ``tp_axis`` (``tp_param_specs``) by ``parallelize_module``, in
    place on ``model`` (its parameters first made equal to rank 0's).
    Every attention's head count must divide by the ``tp`` size. Returns
    ``fn(imgs, **kw)`` with outputs gathered to the whole batch on every
    rank."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    tp = mesh_size(mesh, tp_axis)
    attns = [m for m in model.modules()
             if isinstance(m, (Attention, CrossAttention))]
    bad = sorted({m.num_heads for m in attns if m.num_heads % tp})
    if bad:
        raise ValueError(f"attention head counts {bad} do not divide over "
                         f"tp = {tp}")
    replicate(mesh, list(model.parameters()) + list(model.buffers()))
    for m in attns:
        if isinstance(m, Attention):
            _regroup_qkv(m, tp)
        m.num_heads //= tp
    roles = tp_param_specs(model)
    plan = {}
    for name, role in roles.items():
        mod_name = name.rsplit(".", 1)[0]
        if role == "col":
            plan[mod_name] = ColwiseParallel()
        elif role == "row":
            plan[mod_name] = RowwiseParallel()
    parallelize_module(model, mesh[tp_axis], plan)
    return _batch_sharded(model, mesh, batch_axis)
