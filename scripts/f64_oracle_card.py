"""The port's f32 training gradients on the card against a float64 oracle.
One-off measurement, not a test.

tests/test_torch_f64_oracle.py holds the port's f32 Adam first moment
after one ``make_train_step`` step at ``CUT3RConfig.tiny()`` against a
float64 oracle (the port in f64), per parameter tensor, within 3x the JAX
package's distance + 1e-6, on the CPU. This script asks the same of the
card, and measures phase 9 of ``chip_smoke.py`` (which holds the card's
tiny train and TBPTT steps to the CPU's at 1e-4 of each tensor's norm)
against the same kind of oracle. It runs in two halves, because the chip
machine has no JAX:

    python scripts/f64_oracle_card.py --only jax     # here: JAX on the CPU
    python scripts/f64_oracle_card.py --only port    # on the card

The JAX half draws the test's inputs (``jax_tiny_params(seed=1)``, one
procedural V=2 batch), runs the JAX f32 step and the port's f64 oracle on
the CPU, and writes the parameter shapes, the batch and JAX's per-tensor
distances from the oracle to ``--work`` (``build/f64_oracle/inputs.pt``,
~260 KB: the port half redraws the parameters from the same numpy seed).

The port half recomputes the oracle (the port in f64 on the CPU; float64
rounding lies far below the distances compared) and runs, in f32 under
``full_f32`` (no TF32, no cuDNN):

* the test's step: the port on the CPU (one thread) and on the card; on
  the CPU with the fused attention kernel on every read (``_sdpa`` takes
  the explicit softmax where a backward runs), and with the explicit
  softmax for one-query reads only; on the card with cuDNN on, with the
  fused kernel on every read, and with both; each run's median and worst
  distance and the tensors beyond 3x JAX + 1e-6;
* phase 9's tiny steps (``init_random`` seed 1, one train step on a V=2
  batch, one TBPTT step of chunk 2 with one gradient chunk on a V=4
  batch, 32x48, phase 9's scenes and seeds): the port on the CPU and on
  the card, and on the card with cuDNN on, the fused kernel on every read,
  or the explicit softmax on every read; each run's median and worst
  distance from the oracle, and each card run's worst difference from the
  CPU run by phase 9's measure.

The distance of a tensor is the norm of its difference over (the
reference tensor's norm + 1e-6 of the largest); tensors below that floor
are left out. Every run follows the oracle's branch at each ReLU of the
heads (``heads.ReluBranches``: the oracle records its masks, each f32 run
replays them and counts the elements whose own sign disagreed), so a
distance measures rounding only, as in the test and in phase 9. The JAX
half's distances are those of an unreplayed JAX step. ``--out`` writes
the report as JSON. The port half imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASE9_HW = (32, 48)


def draw_params(shapes, seed=1):
    """tests/test_torch_cut3r_train.py::jax_tiny_params's fill of the flat
    JAX parameter tree ``shapes`` (key -> shape) from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(shapes):
        shp, leaf = tuple(shapes[k]), k.rsplit("/", 1)[-1]
        z = rng.standard_normal(shp)
        if leaf == "kernel":
            v = z / math.sqrt(math.prod(shp[:-1]))
        else:
            v = (leaf == "scale") + 0.02 * z
        out[k] = v.astype(np.float32)
    return out


def distances(mu, ref):
    top = max(float(v.norm()) for v in ref.values())
    return {k: float((mu[k] - r).norm()) / (float(r.norm()) + 1e-6 * top)
            for k, r in ref.items() if float(r.norm()) > 1e-6 * top}


def jax_half(work):
    import jax
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_f64_oracle import jax_mu, port_mu
    from test_torch_cut3r_train import jax_tiny_params
    from test_torch_train_step import procedural_batches
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    batch = procedural_batches(tempfile.mkdtemp(prefix="f64_oracle_"), 2, 1,
                               seed=0)[0]
    flat = jax_tiny_params(seed=1)
    shapes = {k: list(v.shape) for k, v in flat.items()}
    assert all(np.array_equal(draw_params(shapes)[k], v)
               for k, v in flat.items())
    d = distances(jax_mu(flat, batch, x64=False),
                  port_mu(flat, batch, torch.float64))
    torch.save({"shapes": shapes, "batch": batch, "jax_dist": d},
               os.path.join(work, "inputs.pt"))
    print(f"wrote {os.path.join(work, 'inputs.pt')}: JAX distances of "
          f"{len(d)} tensors, median {np.median(list(d.values())):.3e}")


def phase9_batches(root):
    """Phase 9's tiny batches: one procedural scene of 18 views, a V=2
    batch (seed 0) and a V=4 batch (seed 1), span 16."""
    from cut3r_slam_tpu_torch.datasets import (
        MultiViewDataset, SceneFolderSource, SceneLayout,
        generate_multiview_scenes, make_batch_iter)
    d = generate_multiview_scenes(root, n_scenes=1, views_per_scene=18,
                                  hw=PHASE9_HW, seed=0)[0]

    def first(num_views, seed):
        ds = MultiViewDataset(
            SceneFolderSource(os.path.dirname(d), SceneLayout("synth"),
                              scenes=[os.path.basename(d)]),
            num_views=num_views, span=16, resolution=PHASE9_HW, seed=seed)
        return next(make_batch_iter(ds, batch_size=1, seed=seed))
    return first(2, 0), first(4, 1)


def port_half(work, out):
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig, blocks
    from cut3r_slam_tpu_torch.models.convert import params_from_jax
    from cut3r_slam_tpu_torch.models.heads import ReluBranches
    from cut3r_slam_tpu_torch.train import train_step as TS
    if not torch.cuda.is_available():
        sys.exit("the port half needs a CUDA device")
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    test_state = params_from_jax(draw_params(inp["shapes"]))
    init = CUT3R(CUT3RConfig.tiny(), device="cpu")
    init.init_random(torch.Generator().manual_seed(1))
    phase9_state = {k: v.clone() for k, v in init.state_dict().items()}
    b2, b4 = phase9_batches(tempfile.mkdtemp(prefix="f64_oracle_p9_"))

    def mu_after(state, make, batch, device, dtype, warmup, branches):
        m = CUT3R(CUT3RConfig.tiny(), device=device)
        m.load_state_dict(state, strict=True)
        m = m.to(dtype)
        opt = TS.make_optimizer(m.parameters(), lr=1e-4, weight_decay=0.05,
                                warmup_steps=warmup, total_steps=10)
        b = {k: (v.astype(np.float64) if dtype == torch.float64
                 and isinstance(v, np.ndarray) and v.dtype == np.float32
                 else v) for k, v in batch.items()}
        with branches:
            make(m, opt)(b)
        return {n: opt.state[p]["mu"].detach().cpu().double()
                for n, p in m.named_parameters()}

    def tbptt(m, opt):
        return TS.make_tbptt_train_step(m, opt, chunk=2, grad_chunks=1)

    steps = {"test step": (test_state, TS.make_train_step, inp["batch"], 2),
             "phase 9 train step": (phase9_state, TS.make_train_step, b2, 0),
             "phase 9 TBPTT step": (phase9_state, tbptt, b4, 0)}

    def fused(q, k, v, scale):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale)

    def explicit(q, k, v, scale):
        a = (q @ k.transpose(-2, -1)) * scale
        return torch.softmax(a, -1, dtype=torch.float32).to(v.dtype) @ v

    def one_query(q, k, v, scale):
        f = explicit if q.shape[-2] == 1 else fused
        return f(q, k, v, scale)

    variants = {"port cpu": ("cpu", None, False),
                "cpu fused": ("cpu", fused, False),
                "cpu one-query": ("cpu", one_query, False),
                "port card": ("cuda", None, False),
                "card cuDNN": ("cuda", None, True),
                "card fused": ("cuda", fused, False),
                "card fused cuDNN": ("cuda", fused, True),
                "card explicit": ("cuda", explicit, False)}

    def run(step, name, masks):
        state, make, batch, warmup = steps[step]
        device, attention, cudnn = variants[name]
        path = blocks._sdpa
        blocks._sdpa = attention or path
        torch.backends.cudnn.enabled = cudnn
        replay = ReluBranches(masks)
        try:
            return mu_after(state, make, batch, device, torch.float32,
                            warmup, replay), replay.flips
        finally:
            blocks._sdpa = path
            torch.backends.cudnn.enabled = False

    report = {"device": torch.cuda.get_device_name(0)}
    jax_d = inp["jax_dist"]
    print(f"test step          jax              median "
          f"{np.median(list(jax_d.values())):.3e} worst "
          f"{max(jax_d.values()):.3e}")
    with full_f32():
        for step, (state, make, batch, warmup) in steps.items():
            rec = ReluBranches()
            oracle = mu_after(state, make, batch, "cpu", torch.float64,
                              warmup, rec)
            names = (["port cpu", "cpu fused", "cpu one-query", "port card",
                      "card cuDNN", "card fused", "card fused cuDNN"]
                     if step == "test step" else
                     ["port cpu", "port card", "card cuDNN", "card fused",
                      "card explicit"])
            runs = {name: run(step, name, rec.masks) for name in names}
            for name, (mu, flips) in runs.items():
                d = distances(mu, oracle)
                worst = max(d, key=d.get)
                row = {"median": float(np.median(list(d.values()))),
                       "worst": d[worst], "worst_tensor": worst,
                       "tensors": len(d), "relu_flips": flips,
                       "relu_margin": rec.margin}
                line = (f"{step:18s} {name:16s} median {row['median']:.3e} "
                        f"worst {d[worst]:.3e} ({worst}); {flips} ReLU "
                        f"elements against their sign")
                if step == "test step":
                    far = [k for k in d if d[k] > 3 * jax_d[k] + 1e-6]
                    row["largest_ratio_to_jax"] = max(
                        d[k] / jax_d[k] for k in d)
                    row["beyond_3x_jax"] = far
                    line += (f"; largest ratio to JAX "
                             f"{row['largest_ratio_to_jax']:.2f}; beyond 3x "
                             f"JAX + 1e-6: {len(far)} of {len(d)}")
                elif name != "port cpu":
                    vs = distances(mu, runs["port cpu"][0])
                    w = max(vs, key=vs.get)
                    row["vs_cpu_worst"], row["vs_cpu_tensor"] = vs[w], w
                    line += f"; vs the CPU run {vs[w]:.3e} ({w})"
                report[f"{step} / {name}"] = row
                print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--only", choices=["jax", "port"], required=True)
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "f64_oracle"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    if args.only == "jax":
        jax_half(args.work)
    else:
        port_half(args.work, args.out)


if __name__ == "__main__":
    main()
