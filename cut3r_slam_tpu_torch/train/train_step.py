"""CUT3R training steps (port of ``cut3r_slam_tpu/train/train_step.py``).

``make_optimizer`` is the JAX package's ``optax.chain(clip_by_global_norm
(1.0), adamw(warmup_cosine_decay_schedule, b1=0.9, b2=0.95))``, optionally
inside ``optax.MultiSteps``, written out as a ``torch.optim.Optimizer`` in
optax's order of operations:

* the schedule is evaluated at the count of updates applied so far, so
  with ``warmup_steps > 0`` the first update is zero (``lr_at``);
* the global gradient norm is clipped as optax does (no epsilon added);
* weight decay is added to the Adam direction of EVERY parameter,
  biases and norms included, also where a parameter got no gradient
  (its gradient counts as zero), as ``optax.adamw`` does without a mask;
* ``b2`` and ``max_norm`` default to the JAX train step's; the stereo /
  flow harness (``train/stereoflow.py``) runs optax's plain ``adamw``
  (b2 = 0.999, no clip: ``max_norm=None``);
* with ``accum_steps = k`` the running mean of k micro-gradients is
  applied on every k-th ``step`` and the parameters stay exactly as they
  are in between; the schedule and Adam's bias correction count applied
  updates only.

``make_train_step`` runs the full forward (all four heads) and the loss;
``make_tbptt_train_step`` encodes every view without gradient, then runs
the decoder in chunks whose carry is detached between chunks, the last
``grad_chunks`` of them with gradient (truncated BPTT).

Under data / FSDP parallelism (``train/trainer.py``) the model's
parameters and gradients are FSDP2 ``DTensor`` shards: the optimizer
updates each rank's local shard, and the clip takes the norm of the FULL
gradient (each tensor's local sum of squares in f64, summed over the
shards' ranks), the same on every rank. The step's ``dp_group`` makes
the loss each rank's part of the whole batch's (``losses.py``); the parts'
gradients are summed over dp by the trainer's FSDP reduction.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.cut3r import HEAD_OUTPUTS
from ..utils.profiling import span
from .losses import cut3r_total_loss

__all__ = ["AdamW", "lr_at", "make_optimizer", "init_trainable",
           "init_train_state", "make_train_step", "make_tbptt_train_step",
           "to_device"]

# the JAX step's fixed settings: clip_by_global_norm(1.0), adamw(b1=0.9,
# b2=0.95) with optax's default eps
B1, B2, EPS, MAX_NORM = 0.9, 0.95, 1e-8, 1.0
POINTMAP_HEAD_GAIN = 0.05


def lr_at(count: int, lr: float, warmup_steps: int, total_steps: int
          ) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1))`` at ``count``: a linear warmup
    from 0, then a cosine decay to 0; evaluated in f32 as optax does."""
    f = np.float32
    decay_steps = max(total_steps, warmup_steps + 1)
    if count < warmup_steps:
        frac = f(1) - f(count) / f(warmup_steps)
        return float(f(-lr) * frac + f(lr))
    t = f(min(count - warmup_steps, decay_steps - warmup_steps))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * t / f(decay_steps
                                                   - warmup_steps)))
    return float(f(lr) * cos)


class AdamW(torch.optim.Optimizer):
    """Clip by global norm, then AdamW, on a warmup-cosine schedule (see
    the module docstring); ``accum_steps > 1`` accumulates micro-gradients
    first. The counts live in the single parameter group, so
    ``state_dict`` / ``load_state_dict`` carry them."""

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 0.05,
                 warmup_steps: int = 100, total_steps: int = 100_000,
                 accum_steps: int = 1, b2: float = B2,
                 max_norm: Optional[float] = MAX_NORM):
        defaults = dict(lr=lr, weight_decay=weight_decay,
                        warmup_steps=warmup_steps, total_steps=total_steps,
                        accum_steps=accum_steps, b2=b2, max_norm=max_norm,
                        count=0, mini_step=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group")

    def load_state_dict(self, state_dict):
        """Moments and counts from ``state_dict``; the hyperparameters
        (learning rate, schedule, decay) stay this optimizer's own. Full
        moments of a sharded (``DTensor``) parameter become its shards."""
        keep = {k: v for k, v in self.param_groups[0].items()
                if k not in ("params", "count", "mini_step")}
        super().load_state_dict(state_dict)
        self.param_groups[0].update(keep)
        for p in self.param_groups[0]["params"]:
            for k, v in self.state[p].items():
                if _is_dtensor(p) and not _is_dtensor(v):
                    self.state[p][k] = _shard_like(p, v)

    def full_state_dict(self):
        """``state_dict`` with every sharded moment gathered whole (a
        collective: every rank calls it)."""
        sd = self.state_dict()
        sd["state"] = {i: {k: _full(v) for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step takes no closure")
        g = self.param_groups[0]
        params = g["params"]
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
                if g["accum_steps"] > 1:
                    self.state[p]["acc"] = torch.zeros_like(p)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        mesh_dims = _shard_dims(params[0])
        params = [_local(p) for p in params]
        grads = [_local(t) for t in grads]
        k = g["accum_steps"]
        state = [self.state[p] for p in g["params"]]
        if k > 1:
            # the running mean of the micro-gradients (optax's Welford form)
            n = g["mini_step"]
            acc = [_local(st["acc"]) for st in state]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), n + 1))
            g["mini_step"] = (n + 1) % k
            if n != k - 1:
                return None
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)

        # clip_by_global_norm: t / |g| * max_norm where |g| >= max_norm
        # (for max_norm = 1 dividing by |g| / max_norm is the same value).
        # The squares accumulate in f64: torch's f32 norm on the CPU sums
        # a tensor's squares with a relative error growing with its size
        # (9e-6 at 1 M elements, 6e-5 at 4 M), which scaled every clipped
        # gradient by that error; optax's XLA reduction has none of it.
        max_norm, b2 = g["max_norm"], g["b2"]
        if max_norm is not None:
            norms = torch.stack([torch.linalg.vector_norm(
                t, dtype=torch.float64) for t in grads])
            if mesh_dims:
                # the shards' squares summed over the ranks that shard them
                from ..parallel.mesh import all_reduce
                sq = norms * norms
                for group in mesh_dims:
                    sq = all_reduce(sq, group=group)
                norms = torch.sqrt(sq)
            norm = torch.linalg.vector_norm(norms).to(grads[0].dtype)
            denom = torch.where(norm < max_norm, torch.ones_like(norm),
                                norm / max_norm)
            torch._foreach_div_(grads, denom)

        count = g["count"]
        c = count + 1
        mu = [_local(st["mu"]) for st in state]
        nu = [_local(st["nu"]) for st in state]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1 - B1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        bc1 = 1 - float(np.float32(B1) ** np.float32(c))
        bc2 = 1 - float(np.float32(b2) ** np.float32(c))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        if g["weight_decay"]:
            torch._foreach_add_(upd, list(params), alpha=g["weight_decay"])
        torch._foreach_add_(list(params), upd,
                            alpha=-lr_at(count, g["lr"], g["warmup_steps"],
                                         g["total_steps"]))
        g["count"] = c
        return None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place updates reach it)."""
    return x.to_local() if _is_dtensor(x) else x


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a plain tensor as it is).
    The shards are padded to the largest before one ``all_gather`` per
    sharded mesh dim: ``full_tensor`` hands gloo the empty CUDA shard of an
    uneven split (a bias of one row over two ranks), which crashed the
    process on the H100's torch 2.11."""
    if not _is_dtensor(x):
        return x
    import torch.distributed as dist
    t = x.to_local()
    for d, pl in enumerate(x.placements):
        if not pl.is_shard():
            continue
        group = x.device_mesh.get_group(d)
        n, dim = dist.get_world_size(group), pl.dim
        sizes = [len(c) for c in torch.arange(x.shape[dim]).chunk(n)]
        sizes += [0] * (n - len(sizes))
        shape = list(t.shape)
        shape[dim] = max(sizes)
        pad = t.new_zeros(shape)
        pad.narrow(dim, 0, t.shape[dim]).copy_(t)
        parts = [torch.empty_like(pad) for _ in range(n)]
        dist.all_gather(parts, pad, group=group)
        t = torch.cat([q.narrow(dim, 0, k) for q, k in zip(parts, sizes)],
                      dim)
    return t


def _shard_like(p, full: torch.Tensor):
    """``full`` (the same on every rank) laid out as the DTensor ``p``:
    this rank's shard of it, cut locally."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(p.device), p.device_mesh, p.placements,
                             src_data_rank=None)


def _shard_dims(p) -> list:
    """The process groups of the mesh dims over which ``p`` is sharded
    (none for a plain tensor)."""
    if not _is_dtensor(p):
        return []
    return [p.device_mesh.get_group(d) for d, pl in enumerate(p.placements)
            if pl.is_shard()]


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.05,
                   warmup_steps: int = 100, total_steps: int = 100_000,
                   accum_steps: int = 1) -> AdamW:
    """AdamW + clip over ``params`` (+ gradient accumulation over
    ``accum_steps`` micro-batches)."""
    return AdamW(params, lr=lr, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 accum_steps=accum_steps)


@torch.no_grad()
def init_trainable(model, generator: torch.Generator):
    """Random weights to train from: ``model.init_random(generator)``,
    then the last convolution of the self and cross pointmap heads scaled
    by ``POINTMAP_HEAD_GAIN``. With the plain draw the first full-rate
    AdamW updates of the full-width model push the exp-mode pointmaps
    past 1e19, whose squared norms in the loss overflow f32 (NaN at step
    4 at lr 1e-4, bf16 and f32 alike); the small last layer keeps them
    finite. The tracking path's tensors other than these two are
    ``init_random``'s."""
    model.init_random(generator)
    head = model.downstream_head
    for dpt in (head.dpt_self, head.dpt_cross):
        dpt.head[4].weight.mul_(POINTMAP_HEAD_GAIN)
    return model


def init_train_state(model, generator: torch.Generator, **optimizer_kw
                     ) -> AdamW:
    """Random weights for ``model`` from ``generator`` (``init_trainable``)
    and a fresh optimizer over them (``make_optimizer``'s keywords)."""
    init_trainable(model, generator)
    return make_optimizer(model.parameters(), **optimizer_kw)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


def _gt(batch, s=None, e=None):
    keys = ["pts3d", "camera_pose", "valid_mask"] \
        + (["img"] if "img" in batch else [])
    return {k: batch[k][s:e] for k in keys}


def _whole_batch(aux: Dict, dp_group) -> Dict:
    """Detached aux values; under data parallelism the ranks' parts summed
    into the whole batch's."""
    out = {k: v.detach() for k, v in aux.items()}
    if dp_group is None:
        return out
    from ..parallel.mesh import all_reduce
    return {k: all_reduce(v, group=dp_group) for k, v in out.items()}


def make_train_step(model, opt: AdamW, dp_group=None
                    ) -> Callable[[Dict], Dict]:
    """Returns ``train_step(batch) -> aux``: the full forward, the loss,
    its gradient and one optimizer step, in place on ``model`` and
    ``opt``. batch: imgs (V, B, H, W, 3) in [-1, 1]; pts3d (V, B, H, W,
    3) world; camera_pose (V, B, 4, 4) camera-to-world; valid_mask
    (V, B, H, W); img and true_shape optional. aux holds detached
    loss_trans, loss_quat and total. ``dp_group``: the data-parallel
    process group when this rank's batch is a slice of the step's (the
    loss is then this rank's part and aux the whole batch's)."""

    def train_step(batch):
        batch = to_device(batch, model.device)
        opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            pred = model(batch["imgs"], true_shape=batch.get("true_shape"))
        with span("train.loss"):
            loss, aux = cut3r_total_loss(pred, _gt(batch), group=dp_group)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            opt.step()
        return _whole_batch(aux, dp_group)

    return train_step


def make_tbptt_train_step(model, opt: AdamW, chunk: int = 4,
                          grad_chunks: int = 4, dp_group=None
                          ) -> Callable[[Dict], Dict]:
    """Truncated-BPTT step: every view is encoded once without gradient
    (the encoder gets no gradient and keeps no activations); the views are
    split into decoder chunks of ``chunk``, the recurrent (state, mem)
    carry is detached between chunks, and only the losses of the last
    ``grad_chunks`` chunks (their mean) contribute gradients. The other
    chunks run the decoder only: their head outputs are never used."""

    def train_step(batch):
        batch = to_device(batch, model.device)
        imgs = batch["imgs"]
        V, B, H, W, _ = imgs.shape
        opt.zero_grad(set_to_none=True)
        # each chunk's loss (``train.loss``) lies inside the forward
        with span("train.forward"):
            with torch.no_grad():
                feat, pos = model.encode_image(imgs.reshape(V * B, H, W, 3))
            feat = feat.reshape(V, B, *feat.shape[1:])
            pos = pos.reshape(V, B, *pos.shape[1:])
            n_chunks = (V + chunk - 1) // chunk
            carry, total, n_loss = None, 0.0, 0
            for c in range(n_chunks):
                s, e = c * chunk, min((c + 1) * chunk, V)
                with_grad = c >= n_chunks - grad_chunks
                with torch.set_grad_enabled(with_grad):
                    out, carry = model.decode_views(
                        feat[s:e], pos[s:e], H, W, carry, s,
                        head_outputs=HEAD_OUTPUTS if with_grad else ())
                    if with_grad:
                        with span("train.loss"):
                            total = total + cut3r_total_loss(
                                out, _gt(batch, s, e), group=dp_group)[0]
                        n_loss += 1
                carry = tuple(x.detach() for x in carry)
            loss = total / max(n_loss, 1)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            opt.step()
        return _whole_batch({"total": loss}, dp_group)

    return train_step
