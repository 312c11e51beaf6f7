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
* with ``accum_steps = k`` the running mean of k micro-gradients is
  applied on every k-th ``step`` and the parameters stay exactly as they
  are in between; the schedule and Adam's bias correction count applied
  updates only.

``make_train_step`` runs the full forward (all four heads) and the loss;
``make_tbptt_train_step`` encodes every view without gradient, then runs
the decoder in chunks whose carry is detached between chunks, the last
``grad_chunks`` of them with gradient (truncated BPTT).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.cut3r import HEAD_OUTPUTS
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
                 accum_steps: int = 1):
        defaults = dict(lr=lr, weight_decay=weight_decay,
                        warmup_steps=warmup_steps, total_steps=total_steps,
                        accum_steps=accum_steps, count=0, mini_step=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group")

    def load_state_dict(self, state_dict):
        """Moments and counts from ``state_dict``; the hyperparameters
        (learning rate, schedule, decay) stay this optimizer's own."""
        keep = {k: v for k, v in self.param_groups[0].items()
                if k not in ("params", "count", "mini_step")}
        super().load_state_dict(state_dict)
        self.param_groups[0].update(keep)

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
        k = g["accum_steps"]
        if k > 1:
            # the running mean of the micro-gradients (optax's Welford form)
            n = g["mini_step"]
            acc = [self.state[p]["acc"] for p in params]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), n + 1))
            g["mini_step"] = (n + 1) % k
            if n != k - 1:
                return None
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)

        # clip_by_global_norm: t / |g| * MAX_NORM where |g| >= MAX_NORM
        # (for MAX_NORM = 1 dividing by |g| / MAX_NORM is the same value)
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        denom = torch.where(norm < MAX_NORM, torch.ones_like(norm),
                            norm / MAX_NORM)
        torch._foreach_div_(grads, denom)

        count = g["count"]
        c = count + 1
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
        bc1 = 1 - float(np.float32(B1) ** np.float32(c))
        bc2 = 1 - float(np.float32(B2) ** np.float32(c))
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


def make_train_step(model, opt: AdamW) -> Callable[[Dict], Dict]:
    """Returns ``train_step(batch) -> aux``: the full forward, the loss,
    its gradient and one optimizer step, in place on ``model`` and
    ``opt``. batch: imgs (V, B, H, W, 3) in [-1, 1]; pts3d (V, B, H, W,
    3) world; camera_pose (V, B, 4, 4) camera-to-world; valid_mask
    (V, B, H, W); img and true_shape optional. aux holds detached
    loss_trans, loss_quat and total."""

    def train_step(batch):
        batch = to_device(batch, model.device)
        opt.zero_grad(set_to_none=True)
        pred = model(batch["imgs"], true_shape=batch.get("true_shape"))
        loss, aux = cut3r_total_loss(pred, _gt(batch))
        loss.backward()
        opt.step()
        return {k: v.detach() for k, v in aux.items()}

    return train_step


def make_tbptt_train_step(model, opt: AdamW, chunk: int = 4,
                          grad_chunks: int = 4) -> Callable[[Dict], Dict]:
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
                    total = total + cut3r_total_loss(out, _gt(batch, s, e))[0]
                    n_loss += 1
            carry = tuple(x.detach() for x in carry)
        loss = total / max(n_loss, 1)
        loss.backward()
        opt.step()
        return {"total": loss.detach()}

    return train_step
