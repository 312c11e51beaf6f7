"""Does training from ``init_random`` diverge in the JAX package as it does
in the port? One-off measurement, not a test.

Both packages start from one draw: the port's full-width ``CUT3R`` with
``init_random`` from seed 0 (no ``init_trainable`` head scaling), in f32 on
the CPU; its state_dict goes to the JAX package through
``cut3r_slam_tpu.models.convert.load_cut3r_params`` (the upstream
checkpoint layout, as tests/test_torch_ingest.py writes it). Each package
then takes the same AdamW steps (lr 1e-4, weight decay 0.05, warmup 2 of
10, the phase-9 schedule) on one procedural V=4, B=1 batch, and records
per step the loss, whether it is finite, and the largest |pointmap| of
the self and cross heads at the weights the step starts from.

The two halves run in separate processes so that the two full-width
states never share memory:

    python scripts/init_divergence_torch_vs_jax.py --only torch --hw 224 224
    python scripts/init_divergence_torch_vs_jax.py --only jax --hw 224 224

(without ``--only`` both run, one after the other; ``--probe-loss`` only
prints both packages' loss on pointmaps scaled up to f32 overflow, op by
op and jitted for JAX). Each half writes
``<out>/<torch|jax>_<H>x<W>.json`` and prints it; the torch half writes
the starting checkpoint and the batch that the JAX half reads into
``--work`` (``build/init_divergence/<H>x<W>``, ~3.2 GB at full width).
The port half imports nothing of JAX; the JAX half needs the JAX package
and flax.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=1e-4, weight_decay=0.05, warmup_steps=2, total_steps=10)


def torch_half(args, work):
    import torch
    sys.path.insert(0, ROOT)
    from cut3r_slam_tpu_torch.datasets import (MultiViewDataset,
                                               SceneFolderSource, SceneLayout,
                                               generate_multiview_scenes,
                                               make_batch_iter)
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.train import train_step as TS
    from cut3r_slam_tpu_torch.train.losses import cut3r_total_loss

    torch.set_num_threads(os.cpu_count() or 1)
    hw = tuple(args.hw)
    scenes = os.path.join(work, "scenes")
    generate_multiview_scenes(scenes, n_scenes=1, views_per_scene=8, hw=hw,
                              seed=0)
    batch = next(make_batch_iter(MultiViewDataset(
        SceneFolderSource(scenes, SceneLayout("synth")), num_views=4, span=6,
        resolution=hw, seed=0), 1, 0))
    np.savez(os.path.join(work, "batch.npz"), **batch)

    cfg = CUT3RConfig.tiny() if args.tiny else dataclasses.replace(
        CUT3RConfig(), compute_dtype=torch.float32)
    model = CUT3R(cfg, device="cpu")
    model.init_random(torch.Generator().manual_seed(0))
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    for h in ("dpt_self", "dpt_cross", "dpt_rgb"):   # the upstream aliases
        pre = f"module.downstream_head.{h}.scratch.layer"
        for i in range(4):
            sd[f"{pre}_rn.{i}.weight"] = sd[f"{pre}{i + 1}_rn.weight"]
    torch.save({"model": sd}, os.path.join(work, "init.pth"))
    del sd

    opt = TS.make_optimizer(model.parameters(), **OPT)
    b = TS.to_device(batch, "cpu")
    gt = TS._gt(b)
    rows = []
    for step in range(1, args.steps + 1):
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        pred = model(b["imgs"], true_shape=b.get("true_shape"))
        pmax = {k: float(torch.nan_to_num(pred[k].detach().abs().max(),
                                          nan=float("inf")))
                for k in ("pts3d_in_self_view", "pts3d_in_other_view")}
        loss, _ = cut3r_total_loss(pred, gt)
        loss.backward()
        opt.step()
        rows.append({"step": step, "loss": float(loss.detach()),
                     "finite_loss": bool(torch.isfinite(loss)),
                     "max_abs_pointmap": pmax,
                     "finite_params": all(bool(torch.isfinite(p).all())
                                          for p in model.parameters()),
                     "seconds": round(time.time() - t0, 2)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def jax_half(args, work):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, ROOT)
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.models.convert import load_cut3r_params
    from cut3r_slam_tpu.train import train_step as JS
    from cut3r_slam_tpu.train.losses import cut3r_total_loss

    batch = {k: jnp.asarray(v) for k, v in
             np.load(os.path.join(work, "batch.npz")).items()}
    params = load_cut3r_params(os.path.join(work, "init.pth"))
    model = CUT3R(CUT3RConfig.tiny() if args.tiny else dataclasses.replace(
        CUT3RConfig(), compute_dtype=jnp.float32))
    tx = JS.make_optimizer(**OPT)
    opt_state = tx.init(params)
    # the step's inputs are donated: without that the old and the new
    # params and AdamW moments (~16 GB at full width) live side by side
    step_fn = jax.jit(JS.make_train_step(model, tx), donate_argnums=(0, 1))

    @jax.jit
    def probe(params):
        pred = model.apply(params, batch["imgs"],
                           true_shape=batch.get("true_shape"))
        gt = {k: batch[k] for k in ("pts3d", "camera_pose", "valid_mask")
              + (("img",) if "img" in batch else ())}
        pmax = {k: jnp.max(jnp.nan_to_num(jnp.abs(pred[k]), nan=jnp.inf))
                for k in ("pts3d_in_self_view", "pts3d_in_other_view")}
        return cut3r_total_loss(pred, gt)[0], pmax

    rows = []
    for step in range(1, args.steps + 1):
        t0 = time.time()
        loss, pmax = probe(params)
        params, opt_state, aux = step_fn(params, opt_state, batch)
        finite_params = all(bool(jnp.isfinite(x).all())
                            for x in jax.tree_util.tree_leaves(params))
        rows.append({"step": step, "loss": float(loss),
                     "step_loss": float(aux["total"]),
                     "finite_loss": bool(np.isfinite(float(aux["total"]))),
                     "max_abs_pointmap": {k: float(v)
                                          for k, v in pmax.items()},
                     "finite_params": finite_params,
                     "seconds": round(time.time() - t0, 2)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def probe_loss():
    """Both packages' ``cut3r_total_loss`` on tests/test_torch_losses.py's
    inputs with the pointmaps scaled by 10^k: the JAX loss op by op and
    jitted, and the port's."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from cut3r_slam_tpu.train import losses as JL
    from cut3r_slam_tpu_torch.train import losses as TL
    from test_torch_losses import _inputs
    for e in (3, 18, 19, 20, 21, 22, 26):
        pred, gt = _inputs(3)
        for k in ("pts3d_in_self_view", "pts3d_in_other_view"):
            pred[k] = (pred[k] * 10.0 ** e).astype(np.float32)
        j = [{k: jnp.asarray(v) for k, v in d.items()} for d in (pred, gt)]
        t = [{k: torch.tensor(v) for k, v in d.items()} for d in (pred, gt)]
        print(json.dumps({"scale": f"1e{e}",
                          "jax_eager": float(JL.cut3r_total_loss(*j)[0]),
                          "jax_jit": float(jax.jit(JL.cut3r_total_loss)(
                              *j)[0]),
                          "port": float(TL.cut3r_total_loss(*t)[0])}))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--hw", type=int, nargs=2, default=[224, 224])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--only", choices=["torch", "jax"], default=None)
    p.add_argument("--tiny", action="store_true",
                   help="CUT3RConfig.tiny(): a quick rehearsal of the script")
    p.add_argument("--probe-loss", action="store_true",
                   help="only print both packages' loss on pointmaps "
                        "scaled up to f32 overflow")
    p.add_argument("--out", default=os.path.join(ROOT, "outputs",
                                                 "init_divergence"))
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "init_divergence"))
    args = p.parse_args()
    if args.probe_loss:
        probe_loss()
        return
    work = os.path.join(args.work, f"{args.hw[0]}x{args.hw[1]}")
    os.makedirs(work, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    if args.only is None:
        for half in ("torch", "jax"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--only", half, "--hw", *map(str, args.hw),
                            "--steps", str(args.steps), "--out", args.out,
                            "--work", args.work]
                           + (["--tiny"] if args.tiny else []),
                           check=True)
        return
    rows = (torch_half if args.only == "torch" else jax_half)(args, work)
    first_bad = next((r["step"] for r in rows if not r["finite_loss"]
                      or not all(np.isfinite(v) for v in
                                 r["max_abs_pointmap"].values())), None)
    res = {"package": args.only, "hw": args.hw, "steps": rows,
           "first_non_finite_step": first_bad, "optimizer": OPT}
    with open(os.path.join(args.out, f"{args.only}_{args.hw[0]}x"
                                     f"{args.hw[1]}.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({"package": args.only, "hw": args.hw,
                      "first_non_finite_step": first_bad}))


if __name__ == "__main__":
    main()
