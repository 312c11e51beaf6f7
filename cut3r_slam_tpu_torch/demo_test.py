"""Ground-truth-injection mapping driver (the port's counterpart of the
repository's ``demo_test.py``, with the same flags and ``result.json``):
read an RGB-D sequence with ground-truth poses, perturb every pose but the
first (sigma_t 0.05, sigma_r 0.01, ``default_rng(0)``), and drive the
Gaussian mapping backend alone on the keyframes: the first seeds the map
from its ground-truth depth, each later one is pose-refined, seeded and
optimized in a sliding window; a global BA with densification closes the
run. Writes ``result.json`` (frames, keyframes, seconds, keyframe PSNR,
ATE of the keyframe positions).

    python -m cut3r_slam_tpu_torch.demo_test --dataset replica \
        --folder data/replica/room0 --output outputs/test_room0

Runs on the GPU; ``--cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def perturb_pose(rng, c2w, sigma_t=0.05, sigma_r=0.01):
    """exp(xi) @ c2w with xi = [t ~ N(0, sigma_t), r ~ N(0, sigma_r)]."""
    import torch
    from .geometry.lie import se3_exp, se3_matrix
    xi = np.concatenate([rng.normal(0, sigma_t, 3),
                         rng.normal(0, sigma_r, 3)]).astype(np.float32)
    return se3_matrix(se3_exp(torch.as_tensor(xi))).numpy() @ c2w


def resize_depth(depth, H, W):
    """Nearest-neighbour resize (cv2's INTER_NEAREST; torch's
    ``nearest-exact`` has the same pixel centres where cv2 is missing)."""
    try:
        import cv2
    except ImportError:
        import torch
        return torch.nn.functional.interpolate(
            torch.as_tensor(depth)[None, None], (H, W),
            mode="nearest-exact")[0, 0].numpy()
    return cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="replica",
                   choices=["replica", "scannet", "tum"])
    p.add_argument("--folder", required=True)
    p.add_argument("--output", default="outputs/demo_test")
    p.add_argument("--length", type=int, default=30)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--kf_every", type=int, default=5)
    p.add_argument("--target_width", type=int, default=512)
    p.add_argument("--arena_capacity", type=int, default=2 ** 18)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch path)")
    p.add_argument("--no-perturb", action="store_true")
    p.add_argument("--calib", default=None,
                   help="calib file overriding the dataset default")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from .datasets.rgbd import get_dataset
    from .geometry.pointmap import depth_to_pointmap, pose_vec_to_matrix
    from .slam.mapping import MappingBackend, MappingConfig
    from .utils.eval import ate_rmse
    from .utils.image import resize_with_intrinsics

    device = "cpu" if args.cpu else "cuda"
    calib = None
    if args.calib:
        from .utils.config import load_calib
        calib = load_calib(args.calib)[:4]
    ds = get_dataset(args.dataset, args.folder, calib)
    rng = np.random.default_rng(0)
    os.makedirs(args.output, exist_ok=True)

    mapper = None
    gt_positions, est_keys = [], []
    t0 = time.time()
    n = 0
    for i in range(0, min(len(ds), args.length * args.stride), args.stride):
        item = ds[i]
        if "depth" not in item or "pose" not in item:
            raise RuntimeError("demo_test needs GT depth + pose")
        img, K4 = resize_with_intrinsics(item["image"], item["K4"],
                                         args.target_width, 2)
        H, W = img.shape[:2]
        depth = resize_depth(item["depth"], H, W)
        if mapper is None:
            mapper = MappingBackend(
                MappingConfig(height=H, width=W,
                              capacity=args.arena_capacity,
                              cam_capacity=max(args.length + 2, 8)),
                K4, device=device)

        c2w_gt = pose_vec_to_matrix(torch.as_tensor(item["pose"])).numpy()
        c2w = c2w_gt if (args.no_perturb or n == 0) \
            else perturb_pose(rng, c2w_gt)
        w2c = np.linalg.inv(c2w)

        if n % args.kf_every == 0:
            kf_idx = len(est_keys)
            mapper.add_keyframe(kf_idx, img, depth, w2c)
            colors = (img.astype(np.float32) / 255.0)[::2, ::2]
            if n == 0:
                pm = depth_to_pointmap(torch.as_tensor(depth),
                                       torch.as_tensor(K4),
                                       c2w=torch.as_tensor(c2w)).numpy()
                mapper.seed(kf_idx, pm[::2, ::2], colors,
                            np.ones((H // 2, W // 2), bool), 0)
                mapper.current_window = [0]
                mapper.optimization(50, [0])
                mapper.initialized = True
            else:
                if len(mapper.current_window) >= mapper.cfg.window_size:
                    mapper.current_window = mapper.current_window[1:]
                mapper.current_window.append(kf_idx)
                pointmap, valid = mapper.pose_refine(kf_idx)
                mapper.seed(kf_idx, torch.as_tensor(pointmap).cpu().numpy(),
                            colors, torch.as_tensor(valid).cpu().numpy() > 0,
                            kf_idx // 5)
                mapper.optimization(20, mapper.current_window)
            gt_positions.append(c2w_gt[:3, 3])
            est_keys.append(kf_idx)
        n += 1

    mapper.global_ba(10 * len(est_keys), densify=True)
    dt = time.time() - t0

    est_positions = [np.linalg.inv(np.asarray(mapper.cams.w2c[k].cpu()))[:3, 3]
                     for k in est_keys]
    psnrs = [mapper.eval_view(k) for k in est_keys]
    result = {
        "frames": n, "keyframes": len(est_keys),
        "seconds": round(dt, 1),
        "psnr_kf": round(float(np.mean(psnrs)), 2),
        "ate_rmse_m": round(ate_rmse(np.stack(est_positions),
                                     np.stack(gt_positions)), 4),
    }
    with open(os.path.join(args.output, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return mapper, result


if __name__ == "__main__":
    main()
