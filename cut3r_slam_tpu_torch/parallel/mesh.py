"""Process group, device mesh and sharding helpers (port of
``cut3r_slam_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``; the
port runs one process per device (``torchrun``), every process the same
program, over ``torch.distributed``:

=====================  ==================================================
JAX                    port
=====================  ==================================================
``Mesh``               ``init_device_mesh`` over the initialized group
``P()`` (replicated)   the same tensor on every rank (``replicate``: a
                       broadcast from rank 0)
``P("dp")``            each rank's slice (``shard_batch``)
``psum`` / ``pmax``    ``all_reduce`` SUM / MAX
``out_specs=P(axis)``  ``all_gather``
FSDP layout            FSDP2 ``fully_shard`` over the (dp, fsdp) mesh
=====================  ==================================================

Held divergences: the mesh covers the whole process group (JAX takes the
first n devices; here the world size must equal the mesh's product), and
``fsdp_shard_params`` shards every parameter on dim 0 with padding (JAX
shards parameters of at least 2^16 elements on their largest divisible
dim and replicates the rest). The arithmetic is the same either way.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

__all__ = ["init_distributed", "make_mesh", "mesh_size", "shard_batch",
           "replicate", "fsdp_shard_params", "all_reduce"]

TORCHRUN_HINT = ("launch one process per device with torchrun "
                 "(torchrun --nproc_per_node=N ...)")


def init_distributed(backend: Optional[str] = None,
                     timeout_s: float = 600.0,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or
    the one given by the arguments; returns (rank, world size). With a GPU
    the rank's card becomes the current device (``LOCAL_RANK`` modulo the
    card count), so ``resolve_device("cuda")`` picks it. ``backend``
    defaults to NCCL with a GPU and gloo without. Collectives that wait
    longer than ``timeout_s`` raise instead of hanging. World size 1
    initializes nothing unless ``init_method`` is given."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if dist.is_initialized() or (world == 1 and init_method is None):
        return rank, world
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=init_method or "env://", rank=rank, world_size=world,
        timeout=timedelta(seconds=timeout_s))
    return rank, world


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("dp", "fsdp"),
              shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` named ``axes`` over the whole initialized process
    group. The default layout puts every rank on the first axis; ``shape``
    splits them, e.g. (2, 4) over 8 ranks. ``device_type`` defaults to
    ``cuda`` with a GPU, else ``cpu``. Raises without a process group or
    when the world size is not the mesh's product."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           + TORCHRUN_HINT)
    world = dist.get_world_size()
    n = n_devices or world
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n or n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} of {n} devices "
                         f"does not cover the world of {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """``x`` reduced over ``group``, as a new (detached) tensor."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def mesh_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (1 for a mesh without it)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def shard_batch(mesh, tree, axis: str = "dp", dim: int = 0):
    """This rank's contiguous slice of every leaf's ``dim`` over ``axis``
    (tensors or numpy arrays; other leaves pass through). The dim must
    divide by the axis size, as in JAX."""
    n = mesh_size(mesh, axis)
    r = mesh.get_local_rank(axis) if n > 1 else 0

    def _shard(x):
        if not hasattr(x, "shape") or len(x.shape) <= dim:
            return x
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide "
                             f"over {n} ranks of {axis!r}")
        k = size // n
        return x[(slice(None),) * dim + (slice(r * k, (r + 1) * k),)]
    return tree_map(_shard, tree)


@torch.no_grad()
def replicate(mesh, tree):
    """Every tensor leaf made equal to rank 0's, in place (a broadcast
    over the mesh's ranks); returns ``tree``."""
    del mesh  # the mesh covers the whole group (make_mesh)

    def _bcast(x):
        if torch.is_tensor(x):
            dist.broadcast(x.data if isinstance(x, torch.nn.Parameter)
                           else x, src=0)
        return x
    return tree_map(_bcast, tree)


def fsdp_shard_params(mesh, model: torch.nn.Module, axis: str = "fsdp",
                      forward_methods: Sequence[str] = ()):
    """Shard ``model``'s parameters over ``axis`` with FSDP2
    (``fully_shard``, in place): over a 2-D (dp, fsdp) mesh the parameters
    are replicated over dp and sharded over fsdp (HSDP). Each parameter is
    all-gathered for the forward and backward and its gradient
    reduce-scattered; ``forward_methods`` names methods other than
    ``forward`` that run the model (each unshards and reshards as
    ``forward`` does). Returns the model."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh {names} has no axis {axis!r}")
    if mesh.ndim == 2 and names[1] != axis:
        raise ValueError(f"the sharded axis {axis!r} must be the mesh's "
                         "second")
    fully_shard(model, mesh=mesh)
    for m in forward_methods:
        register_fsdp_forward_method(model, m)
    return model
