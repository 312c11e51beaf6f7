"""The pack gather's backward at the mapping shape, on one NVIDIA GPU:
torch's indexing backward of ``raw[entry_gauss]`` against K3
(``csrc/gs_pack_bwd.cu``).

    python3 scripts/profile_torch_pack_bwd.py [--out FILE]

The inputs are a real V = 6 window gradient's: the micro-bench arena of
2^18 slots with ~95k Gaussians alive, six poses 5 cm apart, 384x512
(768 tile rows x 512 entries a view, ``max_dup`` 16); the captured
cotangent dG (E, 16), entry ids and entry mask. Times, by CUDA events
over repeated calls after a warm-up:

* ``torch_index_backward``: ``torch.autograd.grad`` of ``raw[entry_gauss]``
  at dG (what the render ran before K3);
* ``k3``: ``pack_backward``, the whole launch sequence;
* ``spread_index_backward``: torch's indexing backward of the gather with
  every masked-out entry pointed at a row of its own (``arange(E) %
  n_rows`` in place of a view's Gaussian 0), the design without a kernel:
  the duplicate walk goes, the sort stays;
* under ``torch.profiler``: each of K3's kernels (the memset, the list
  build, the row sum) and both indexing backwards' top kernels, device
  time per call.

Also the bytes K3 must move (the index arrays and the masked-in
cotangent rows read, dRaw written) and that floor at 3.35 TB/s, the
count of masked-in entries, whether the three results are equal, and
nvcc's ``-Xptxas -v`` report (registers, shared memory, spills). Prints
one JSON line, also written to ``--out``; every number carries the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cut3r_slam_tpu_torch import full_f32  # noqa: E402
from cut3r_slam_tpu_torch.bench import micro_scene  # noqa: E402
from cut3r_slam_tpu_torch.kernels import build  # noqa: E402
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G  # noqa: E402
from cut3r_slam_tpu_torch.slam.renderer import render_window  # noqa: E402

H, W, ARENA, ALIVE, V = 384, 512, 2 ** 18, 95_000, 6
HBM_BYTES_S = 3.35e12


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def capture():
    """One window gradient's pack-backward inputs (dG, eg, em, n_rows,
    cap)."""
    dev = torch.device("cuda")
    params, _, w2c, K4, cfg = micro_scene(H, W, ARENA, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    alive = torch.rand(ARENA, generator=g, device=dev) < ALIVE / ARENA
    w2cs = w2c.repeat(V, 1, 1)
    w2cs[:, 0, 3] = 0.05 * torch.arange(V, device=dev)
    seen, orig = [], G.pack_backward

    def spy(*a):
        seen.append(a)
        return orig(*a)
    G.pack_backward = spy
    try:
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        out = render_window(p, alive, w2cs, K4, cfg)
        torch.autograd.grad(out["color"].mean() + 0.1 * out["depth"].mean(),
                            list(p.values()))
    finally:
        G.pack_backward = orig
    return seen[0]


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, reps, top=None):
    """Device ms per call of each kernel (or memset) ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and not e.key.startswith(("aten::", "cuda")):
            rows[e.key[:90]] = t / 1e3 / reps
    rows = dict(sorted(rows.items(), key=lambda kv: -kv[1]))
    return dict(list(rows.items())[:top]) if top else rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/pack_bwd/profile.json")
    args = ap.parse_args()
    card = card_line()
    build.build("gs_pack_bwd")
    with full_f32():
        dG, eg, em, n_rows, cap = capture()
    E = dG.shape[0]
    n_in = int(em.sum())
    raw = torch.zeros(n_rows, 16, device="cuda", requires_grad=True)
    gathered = raw[eg]

    def torch_bwd():
        return torch.autograd.grad(gathered, raw, dG, retain_graph=True)[0]

    def k3():
        return G.pack_backward(dG, eg, em, n_rows, cap)

    spread = torch.where(em, eg, torch.arange(E, device=eg.device) % n_rows)
    spread_gathered = raw[spread]

    def spread_bwd():
        return torch.autograd.grad(spread_gathered, raw, dG,
                                   retain_graph=True)[0]

    ref = k3()
    equal = bool(torch.equal(torch_bwd(), ref))
    spread_equal = bool(torch.equal(spread_bwd(), ref))
    t_torch = events_ms(torch_bwd, 5)
    t_k3 = events_ms(k3, 50)
    t_spread = events_ms(spread_bwd, 20)
    k_torch = kernel_ms(torch_bwd, 2, top=4)
    k_k3 = kernel_ms(k3, 20)
    k_spread = kernel_ms(spread_bwd, 5, top=6)
    # compulsory traffic: the ids and the mask of every entry, the
    # masked-in entries' cotangent rows, every row of dRaw
    need = E * (8 + 1) + n_in * 64 + n_rows * 64
    # with the scratch: the counts (memset, atomics, read), the list slots
    # (written, read)
    scratch = n_rows * 4 * 2 + n_in * (4 + 4 + 4)
    log = build.BUILD_LOG.get("gs_pack_bwd", "")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    rec = {"card": card, "torch": torch.__version__,
           "shape": {"V": V, "H": H, "W": W, "arena": ARENA,
                     "entries": E, "masked_in": n_in, "rows": n_rows,
                     "cap": cap},
           "bitwise_equal": equal, "spread_index_equal": spread_equal,
           "torch_index_backward_ms": t_torch, "k3_ms": t_k3,
           "spread_index_backward_ms": t_spread,
           "speedup": t_torch / t_k3,
           "kernels_ms_per_call": {"torch": k_torch, "k3": k_k3,
                                   "spread_index": k_spread},
           "bytes_compulsory": need, "bytes_with_scratch": need + scratch,
           "bound_ms": 1e3 * need / HBM_BYTES_S,
           "bound_ms_with_scratch": 1e3 * (need + scratch) / HBM_BYTES_S,
           "roofline_pct": 100.0 * (1e3 * need / HBM_BYTES_S) / t_k3,
           "ptxas": ptxas}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    if not equal:
        sys.exit("K3 differs from torch's indexing backward")


if __name__ == "__main__":
    main()
