"""Which collectives the gloo backend takes on CUDA tensors, two ranks on
one card (NCCL refuses two ranks on one GPU), and NCCL at world size 1:
all_reduce (sum, max, f64), all_gather, all_gather_into_tensor,
reduce_scatter_tensor, broadcast, an FSDP2 forward / backward over a
(1, 2) mesh and a tensor-parallel (ColwiseParallel / RowwiseParallel)
forward; prints one OK / FAIL line each.

    python3 scripts/probe_gloo_cuda.py      # on a machine with a GPU
"""
import socket
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check(rank, name, fn):
    try:
        r = fn()
        if rank == 0:
            print(f"[probe] {name}: OK {r}", flush=True)
    except Exception as e:   # report and go on to the next collective
        if rank == 0:
            print(f"[probe] {name}: FAIL {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)


def _rank(rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)

    def full(v, n=2, dtype=torch.float32):
        return torch.full((n,), float(v), device=dev, dtype=dtype)

    def reduce(op=dist.ReduceOp.SUM, dtype=torch.float32):
        x = full(rank + 1, dtype=dtype)
        dist.all_reduce(x, op=op)
        return x.tolist()

    def gather():
        out = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(out, full(rank))
        return [o.tolist() for o in out]

    def gather_tensor():
        out = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(out, full(rank))
        return out.tolist()

    def reduce_scatter():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(
            2.0 * world, device=dev))
        return out.tolist()

    def broadcast():
        x = full(rank)
        dist.broadcast(x, 0)
        return x.tolist()

    def fsdp():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("dp", "fsdp"))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(5, 7),
                                torch.nn.Linear(7, 3)).to(dev)
        fully_shard(m, mesh=mesh)
        m(torch.randn(4, 5, device=dev)).sum().backward()
        return tuple(m[0].weight.grad.to_local().shape)

    def tensor_parallel():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.parallel import (
            ColwiseParallel, RowwiseParallel, parallelize_module)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("tp",))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                torch.nn.Linear(8, 4)).to(dev)
        x = torch.randn(3, 4, device=dev)
        with torch.no_grad():
            ref = m(x)
            parallelize_module(m, mesh, {"0": ColwiseParallel(),
                                         "1": RowwiseParallel()})
            return float((m(x) - ref).abs().max())

    for name, fn in (("all_reduce sum", reduce),
                     ("all_reduce max", lambda: reduce(dist.ReduceOp.MAX)),
                     ("all_reduce f64", lambda: reduce(dtype=torch.float64)),
                     ("all_gather", gather),
                     ("all_gather_into_tensor", gather_tensor),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("broadcast", broadcast), ("FSDP2 (1, 2)", fsdp),
                     ("tensor parallel", tensor_parallel)):
        _check(rank, f"gloo, CUDA tensors, {name}", fn)
    dist.barrier()
    dist.destroy_process_group()


def _nccl_world1():
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    dist.destroy_process_group()
    return x.tolist()


if __name__ == "__main__":
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    mp.spawn(_rank, args=(2, _free_port()), nprocs=2, join=True)
    _check(0, "nccl, world size 1, all_reduce", _nccl_world1)
