"""Stereo / optical-flow fine-tuning and evaluation of the CroCo backbone
(port of ``cut3r_slam_tpu/train/stereoflow.py``): ``train_stereoflow``
fine-tunes ``CroCoDownstreamBinocular`` with the Laplacian NLL under
AdamW on a warmup-cosine schedule; ``tiled_predict`` predicts a full
image from overlapping crops blended by the predicted confidence;
``flow_metrics`` / ``evaluate_stereoflow`` report the end-point error,
bad-pixel rates and D1.

The optimizer is the JAX harness's ``optax.adamw(warmup_cosine_decay_
schedule(0, lr, warmup, max(total, 2)), weight_decay)`` (b1 0.9, b2 0.999,
eps 1e-8, no clipping, decay on every tensor) written out on the port's
``train_step.AdamW`` in optax's order of operations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.blocks import init_random
from ..models.croco_pretrain import (CroCoConfig, CroCoDownstreamBinocular,
                                     laplacian_nll)
from .train_step import AdamW, to_device

__all__ = ["StereoFlowConfig", "make_stereoflow_optimizer",
           "make_stereoflow_step", "train_stereoflow", "evaluate_stereoflow",
           "tiled_predict", "flow_metrics"]


@dataclasses.dataclass
class StereoFlowConfig:
    task: str = "flow"              # "stereo" (1 channel) | "flow" (2)
    lr: float = 3e-5
    weight_decay: float = 0.05
    total_steps: int = 100
    warmup_steps: int = 10
    crop: Tuple[int, int] = (224, 224)   # train / inference tile (H, W)
    tile_overlap: float = 0.5
    log_every: int = 10

    @property
    def num_channels(self) -> int:
        return 1 if self.task == "stereo" else 2


def make_stereoflow_optimizer(params, tcfg: StereoFlowConfig) -> AdamW:
    """optax ``adamw`` over ``warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, 2))``."""
    return AdamW(params, lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                 warmup_steps=tcfg.warmup_steps,
                 total_steps=max(tcfg.total_steps, 2), b2=0.999,
                 max_norm=None)


def make_stereoflow_step(model: CroCoDownstreamBinocular, opt: AdamW
                         ) -> Callable[[Dict], torch.Tensor]:
    """``step(batch) -> loss``: the Laplacian NLL of one batch {img1, img2
    (B, H, W, 3) in [-1, 1], gt (B, H, W, C), valid (B, H, W)?}, its
    gradient and one optimizer step, in place."""
    def step(batch):
        b = to_device(batch, model.device)
        pred, conf = model(b["img1"], b["img2"])
        loss = laplacian_nll(pred, b["gt"], conf, b.get("valid"))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def train_stereoflow(model_cfg: CroCoConfig, data_iter: Iterator[Dict],
                     tcfg: StereoFlowConfig, init_params=None,
                     log_fn: Callable[[Dict], None] = print,
                     generator: Optional[torch.Generator] = None,
                     device="cuda"):
    """The fine-tune loop: ``tcfg.total_steps`` steps over ``data_iter``,
    logging the loss every ``log_every`` steps and at the last. The
    weights start from ``init_params`` (a state_dict) or are drawn from
    ``generator`` (seed 0 when None). Returns (model, losses)."""
    dev = resolve_device(device)
    model = CroCoDownstreamBinocular(model_cfg, tcfg.num_channels,
                                     with_conf=True, device=dev)
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    else:
        init_random(model, generator
                    or torch.Generator(device=dev).manual_seed(0))
    opt = make_stereoflow_optimizer(model.parameters(), tcfg)
    step = make_stereoflow_step(model, opt)
    losses = []
    for i in range(tcfg.total_steps):
        loss = float(step(next(data_iter)))
        if i % tcfg.log_every == 0 or i == tcfg.total_steps - 1:
            losses.append(loss)
            log_fn({"step": i, "loss": round(loss, 5)})
    return model, losses


# ---------------------------------------------------------------------------
# tiled full-resolution inference
# ---------------------------------------------------------------------------

def _tile_starts(full: int, crop: int, overlap: float):
    if full <= crop:
        return [0]
    stride = max(1, int(crop * (1.0 - overlap)))
    return sorted(set(list(range(0, full - crop, stride)) + [full - crop]))


@torch.no_grad()
def tiled_predict(model: CroCoDownstreamBinocular, img1: np.ndarray,
                  img2: np.ndarray, crop: Tuple[int, int] = (224, 224),
                  overlap: float = 0.5) -> np.ndarray:
    """Full-image prediction from overlapping crops, one batch, blended by
    the confidence (weight 1 / max(conf, 1e-3) per pixel). img1 / img2
    (H, W, 3) in [-1, 1]; returns (H, W, C)."""
    H, W = img1.shape[:2]
    ch, cw = crop
    boxes = [(y, x) for y in _tile_starts(H, ch, overlap)
             for x in _tile_starts(W, cw, overlap)]
    t1 = np.stack([img1[y:y + ch, x:x + cw] for y, x in boxes])
    t2 = np.stack([img2[y:y + ch, x:x + cw] for y, x in boxes])
    pred, conf = model(torch.as_tensor(t1, device=model.device),
                       torch.as_tensor(t2, device=model.device))
    pred = pred.float().cpu().numpy()
    conf = conf.float().cpu().numpy()
    acc = np.zeros((H, W, pred.shape[-1]), np.float32)
    wacc = np.zeros((H, W, 1), np.float32)
    for p, c, (y, x) in zip(pred, conf, boxes):
        w = 1.0 / np.maximum(c, 1e-3)[..., None]  # low s = confident
        acc[y:y + ch, x:x + cw] += p * w
        wacc[y:y + ch, x:x + cw] += w
    return acc / np.maximum(wacc, 1e-12)


def flow_metrics(pred: np.ndarray, gt: np.ndarray,
                 valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """End-point error and bad-pixel rates (bad@{1,3,5}px; D1 = error
    > 3 px and > 5% of the ground truth's magnitude)."""
    err = np.linalg.norm(pred - gt, axis=-1)
    mag = np.linalg.norm(gt, axis=-1)
    v = np.ones(err.shape, bool) if valid is None else valid.astype(bool)
    e, m = err[v], mag[v]
    out = {"epe": float(e.mean()) if e.size else 0.0,
           "n_valid": int(v.sum())}
    for t in (1.0, 3.0, 5.0):
        out[f"bad@{int(t)}px"] = float((e > t).mean()) if e.size else 0.0
    out["d1_all"] = float(((e > 3.0) & (e > 0.05 * np.maximum(m, 1e-6)))
                          .mean()) if e.size else 0.0
    return out


def evaluate_stereoflow(model: CroCoDownstreamBinocular, pairs,
                        crop=(224, 224), overlap: float = 0.5
                        ) -> Dict[str, float]:
    """The mean metrics over {img1, img2, gt[, valid]} samples, each
    predicted at full resolution by ``tiled_predict``."""
    agg: Dict[str, list] = {}
    for s in pairs:
        pred = tiled_predict(model, np.asarray(s["img1"]),
                             np.asarray(s["img2"]), crop, overlap)
        for k, val in flow_metrics(pred, np.asarray(s["gt"]),
                                   s.get("valid")).items():
            agg.setdefault(k, []).append(val)
    return {k: float(np.mean(v)) for k, v in agg.items()}
