"""CUT3R training loop on one device (port of
``cut3r_slam_tpu/train/trainer.py``): the train step of ``train_step.py``
(or its truncated-BPTT form), JSON log lines, an optional eval hook, and
full train-state checkpoints (parameters, optimizer state, step) written
with ``torch.save`` and an atomic rename.

A checkpoint ``step_<k>.pt`` holds the state after ``k`` steps, so a
resumed run starts at step ``k`` and repeats the uninterrupted run when it
is fed the batches from the ``k``-th on. Data and FSDP parallelism over
several cards (the JAX trainer's mesh) wait for ``parallel/``:
``fsdp > 1`` raises.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from .. import resolve_device
from .train_step import init_trainable, make_optimizer, \
    make_tbptt_train_step, make_train_step

__all__ = ["TrainerConfig", "train"]


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


def _save_ckpt(path: str, model, opt, step: int):
    """The full train state (parameters, optimizer state, step) as
    ``step_<step>.pt``, written to a temporary name and renamed."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"step_{step}.pt.tmp")
    torch.save({"params": model.state_dict(), "opt_state": opt.state_dict(),
                "step": step}, tmp)
    os.replace(tmp, os.path.join(path, f"step_{step}.pt"))


def _load_latest_ckpt(path: str):
    """(params, opt_state, step) of the newest checkpoint, or None."""
    cands = glob.glob(os.path.join(path, "step_*.pt"))
    if not cands:
        return None
    latest = max(cands, key=lambda p: int(
        os.path.basename(p).split("_")[1].split(".")[0]))
    state = torch.load(latest, map_location="cpu", weights_only=False)
    return state["params"], state["opt_state"], int(state["step"])


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
    if tcfg.fsdp > 1:
        raise NotImplementedError(
            "fsdp > 1 needs the multi-device trainer (parallel/ -> "
            "torch.distributed), which is not ported yet")
    dev = resolve_device(device)
    model.to(dev)
    opt = make_optimizer(model.parameters(), tcfg.lr, tcfg.weight_decay,
                         tcfg.warmup_steps, tcfg.total_steps,
                         accum_steps=tcfg.accum_steps)
    batch0 = next(data_iter)
    start_step = 0
    resumed = _load_latest_ckpt(tcfg.ckpt_dir) if tcfg.resume else None
    if resumed is not None:
        params, opt_state, start_step = resumed
        model.load_state_dict(params)
        opt.load_state_dict(opt_state)
        log_fn({"resumed_from_step": start_step})
    elif init_params is not None:
        model.load_state_dict(init_params)
    else:
        init_trainable(model,
                       torch.Generator(device=dev).manual_seed(tcfg.seed))

    if tcfg.tbptt_chunk > 0:
        step_fn = make_tbptt_train_step(model, opt, chunk=tcfg.tbptt_chunk,
                                        grad_chunks=tcfg.tbptt_grad_chunks)
    else:
        step_fn = make_train_step(model, opt)

    t0 = time.time()
    for step in range(start_step, tcfg.total_steps):
        batch = batch0 if step == start_step else next(data_iter)
        aux = step_fn(batch)
        if step % tcfg.log_every == 0:
            loss = float(aux["total"])
            log_fn({"step": step, "loss": round(loss, 5),
                    "sec_per_step": round((time.time() - t0)
                                          / max(step - start_step, 1), 3)})
        if eval_fn is not None and tcfg.eval_every > 0 \
                and step > 0 and step % tcfg.eval_every == 0:
            log_fn({"step": step, **(eval_fn(model, step) or {})})
        done = step + 1
        if done < tcfg.total_steps and done % tcfg.ckpt_every == 0:
            _save_ckpt(tcfg.ckpt_dir, model, opt, done)
    _save_ckpt(tcfg.ckpt_dir, model, opt, tcfg.total_steps)
    return model
