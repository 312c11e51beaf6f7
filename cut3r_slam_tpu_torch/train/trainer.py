"""CUT3R training loop on one device (port of
``cut3r_slam_tpu/train/trainer.py``): the train step of ``train_step.py``
(or its truncated-BPTT form), JSON log lines, an optional eval hook, and
full train-state checkpoints (parameters, optimizer state, step) written
with ``torch.save`` and an atomic rename.

A checkpoint ``step_<k>.pt`` holds the state after ``k`` steps, so a
resumed run starts at step ``k`` and repeats the uninterrupted run when it
is fed the batches from the ``k``-th on.

Several ranks (``torchrun``, one process per card; the process group
initialized by ``parallel.init_distributed``): the JAX trainer's (dp,
fsdp) mesh of (world / ``fsdp``, ``fsdp``) ranks. Every rank starts from
rank 0's weights; the parameters are FSDP2 shards over fsdp, replicated
over dp (``parallel.fsdp_shard_params``); every rank draws the same global
batches and takes its dp slice of dim 1 (B must divide by dp), so the
fsdp ranks of one dp slice hold the same data. The loss of each rank is
its part of the whole batch's (``losses.py``), so the gradient reduction
sums over dp and averages the fsdp copies (divide factor ``fsdp``).
Checkpoints stay one full-state file in the format above, gathered on
every rank and written by rank 0: a checkpoint resumes at any world size.
Rank 0 alone logs. ``fsdp`` must divide the world size, and ``fsdp > 1``
needs a process group (the JAX trainer drops to fsdp 1 instead).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .train_step import init_trainable, make_optimizer, \
    make_tbptt_train_step, make_train_step, _full

__all__ = ["TrainerConfig", "train", "distribute"]


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 1e-4
    weight_decay: float = 0.05
    warmup_steps: int = 1000
    total_steps: int = 100_000
    log_every: int = 50
    ckpt_every: int = 1000
    ckpt_dir: str = "outputs/ckpt"
    fsdp: int = 1
    seed: int = 0
    accum_steps: int = 1          # gradient accumulation
    resume: bool = False          # resume from the latest ckpt in ckpt_dir
    tbptt_chunk: int = 0          # > 0: TBPTT with a no-grad encoder pass
    tbptt_grad_chunks: int = 4
    eval_every: int = 0           # > 0: run eval_fn every N steps


def _save_ckpt(path: str, model, opt, step: int, rank: int = 0):
    """The full train state (parameters, optimizer state, step) as
    ``step_<step>.pt``, written to a temporary name and renamed. Sharded
    state is gathered whole on every rank; rank 0 writes."""
    params = {k: _full(v) for k, v in model.state_dict().items()}
    opt_state = opt.full_state_dict()
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"step_{step}.pt.tmp")
        torch.save({"params": params, "opt_state": opt_state, "step": step},
                   tmp)
        os.replace(tmp, os.path.join(path, f"step_{step}.pt"))
    if dist.is_initialized():
        dist.barrier()


def _load_latest_ckpt(path: str):
    """(params, opt_state, step) of the newest checkpoint, or None."""
    cands = glob.glob(os.path.join(path, "step_*.pt"))
    if not cands:
        return None
    latest = max(cands, key=lambda p: int(
        os.path.basename(p).split("_")[1].split(".")[0]))
    state = torch.load(latest, map_location="cpu", weights_only=False)
    return state["params"], state["opt_state"], int(state["step"])


def distribute(model, fsdp: int, device_type: str):
    """``model`` made rank 0's and sharded in place over the (dp = world /
    ``fsdp``, ``fsdp``) mesh of the whole process group; returns (mesh, the
    dp process group, or None when dp is 1). The ranks' losses are parts
    of the whole batch's (``losses.py``), so the gradient reduction sums
    over dp and averages the fsdp ranks' copies of one dp slice."""
    from ..parallel.mesh import fsdp_shard_params, make_mesh, replicate
    world = dist.get_world_size()
    mesh = make_mesh(world, axes=("dp", "fsdp"), shape=(world // fsdp, fsdp),
                     device_type=device_type)
    replicate(mesh, list(model.parameters()) + list(model.buffers()))
    fsdp_shard_params(mesh, model,
                      forward_methods=("encode_image", "decode_views"))
    model.set_gradient_divide_factor(float(fsdp))
    return mesh, (mesh.get_group("dp") if world // fsdp > 1 else None)


def train(model, data_iter: Iterator[Dict],
          tcfg: TrainerConfig = TrainerConfig(),
          init_params: Optional[Dict[str, torch.Tensor]] = None,
          log_fn: Callable[[Dict], None] = lambda m: print(json.dumps(m)),
          eval_fn: Optional[Callable] = None, device="cuda"):
    """Train ``model`` in place on ``device`` and return it. ``data_iter``
    yields batches with imgs (V, B, H, W, 3) in [-1, 1], pts3d,
    camera_pose (V, B, 4, 4), valid_mask (V, B, H, W) [, img,
    true_shape], as numpy arrays or tensors.

    The weights: the latest checkpoint of ``tcfg.ckpt_dir`` when
    ``tcfg.resume`` finds one, else ``init_params`` (a state_dict), else
    ``init_trainable``'s random draw from ``tcfg.seed`` (pass
    ``model.state_dict()`` to train from the weights the model holds). ``eval_fn(model, step)`` returns a
    dict that is logged with the step."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    fsdp = max(tcfg.fsdp, 1)
    if world % fsdp:
        from ..parallel.mesh import TORCHRUN_HINT
        raise ValueError(f"fsdp = {fsdp} needs a process group whose size "
                         f"it divides (world size {world}): "
                         + TORCHRUN_HINT)
    dev = resolve_device(device)
    model.to(dev)
    batch0 = next(data_iter)
    start_step = 0
    resumed = _load_latest_ckpt(tcfg.ckpt_dir) if tcfg.resume else None
    if resumed is not None:
        params, opt_state, start_step = resumed
        model.load_state_dict(params)
        if rank == 0:
            log_fn({"resumed_from_step": start_step})
    elif init_params is not None:
        model.load_state_dict(init_params)
    else:
        init_trainable(model,
                       torch.Generator(device=dev).manual_seed(tcfg.seed))
    mesh = dp_group = None
    if world > 1:
        from ..parallel.mesh import shard_batch
        mesh, dp_group = distribute(model, fsdp, dev.type)
    opt = make_optimizer(model.parameters(), tcfg.lr, tcfg.weight_decay,
                         tcfg.warmup_steps, tcfg.total_steps,
                         accum_steps=tcfg.accum_steps)
    if resumed is not None:
        opt.load_state_dict(opt_state)

    if tcfg.tbptt_chunk > 0:
        step_fn = make_tbptt_train_step(model, opt, chunk=tcfg.tbptt_chunk,
                                        grad_chunks=tcfg.tbptt_grad_chunks,
                                        dp_group=dp_group)
    else:
        step_fn = make_train_step(model, opt, dp_group=dp_group)

    t0 = time.time()
    for step in range(start_step, tcfg.total_steps):
        batch = batch0 if step == start_step else next(data_iter)
        if mesh is not None:
            batch = shard_batch(mesh, batch, axis="dp", dim=1)
        aux = step_fn(batch)
        if step % tcfg.log_every == 0 and rank == 0:
            loss = float(aux["total"])
            log_fn({"step": step, "loss": round(loss, 5),
                    "sec_per_step": round((time.time() - t0)
                                          / max(step - start_step, 1), 3)})
        if eval_fn is not None and tcfg.eval_every > 0 \
                and step > 0 and step % tcfg.eval_every == 0:
            ev = eval_fn(model, step) or {}
            if rank == 0:
                log_fn({"step": step, **ev})
        done = step + 1
        if done < tcfg.total_steps and done % tcfg.ckpt_every == 0:
            _save_ckpt(tcfg.ckpt_dir, model, opt, done, rank)
    _save_ckpt(tcfg.ckpt_dir, model, opt, tcfg.total_steps, rank)
    return model
