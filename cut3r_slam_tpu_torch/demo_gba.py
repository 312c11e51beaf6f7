"""Offline global-BA resume (the port's counterpart of the repository's
``demo_gba.py``): load a mapper checkpoint (``gaussians.npz``, the JAX
package's key names, written by either package) with the run's
``intrinsics.npy`` beside it, run more global-BA iterations with
densification, and write ``gaussians_gba.npz``, ``3dgs_final.ply`` and
``gba_result.json`` (keyframe PSNR, Gaussian count, iterations).

    python -m cut3r_slam_tpu_torch.demo_gba \
        --ckpt outputs/room0/gaussians.npz --iters 5000 [--out outputs/gba]

Runs on the GPU; ``--cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="mapper .npz checkpoint")
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch path)")
    return p.parse_args(argv)


def load_mapper(ckpt: str, device):
    """A MappingBackend sized by the checkpoint, its state loaded."""
    from .slam.mapping import MappingBackend, MappingConfig
    z = np.load(ckpt)
    H, W = z["cams_image"].shape[1:3]
    # intrinsics travel next to the checkpoint
    K4 = np.load(os.path.join(os.path.dirname(ckpt), "intrinsics.npy"))[0][:4]
    mapper = MappingBackend(
        MappingConfig(height=H, width=W, capacity=z["arena_xyz"].shape[0],
                      cam_capacity=z["cams_w2c"].shape[0]), K4, device=device)
    mapper.load(ckpt)
    return mapper


def main(argv=None):
    args = parse_args(argv)
    from .utils.viz import save_gaussians_ply
    mapper = load_mapper(args.ckpt, "cpu" if args.cpu else "cuda")
    mapper.global_ba(args.iters, densify=True)

    out = args.out or os.path.dirname(args.ckpt)
    os.makedirs(out, exist_ok=True)
    mapper.save(os.path.join(out, "gaussians_gba.npz"))
    n = save_gaussians_ply(os.path.join(out, "3dgs_final.ply"), mapper.arena)
    valid = mapper.cams.valid.cpu().numpy()
    psnrs = [mapper.eval_view(i) for i in range(len(valid)) if valid[i]]
    result = {"psnr_kf": round(float(np.mean(psnrs)), 3) if psnrs else 0.0,
              "gaussians": int(n), "gba_iters": args.iters}
    with open(os.path.join(out, "gba_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return mapper, result


if __name__ == "__main__":
    main()
