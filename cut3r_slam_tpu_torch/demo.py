"""Live SLAM demo driver of the port (the counterpart of the repository's
``demo.py``, with the same flags and outputs): stream an image directory
through ``SLAMSystem`` and write ``image_shape.txt``, ``timing.json``,
``traj_kf.txt``, ``intrinsics.npy``, ``result.json`` and ``terminate``'s
eval artifacts into ``--output``.

    python -m cut3r_slam_tpu_torch.demo --imagedir data/replica/room0/results \
        --calib calib/replica.txt --config config/replica.yaml \
        --output outputs/room0

Runs on the GPU; ``--cpu`` runs the plain PyTorch path on the CPU. The
model loads ``--ckpt``; without that file it takes random weights from
seed 0. ``--tiny-model`` builds the tiny configuration, which loads a
tiny checkpoint when ``--ckpt`` names one (the JAX driver's tiny model is
always random). ``--gui`` is not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--imagedir", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--output", default="outputs/run")
    p.add_argument("--ckpt", default="./checkpoints/cut3r_512_dpt_4_64.pth")
    p.add_argument("--buffer", type=int, default=512)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--cropborder", type=int, default=0)
    p.add_argument("--undistort", action="store_true")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=None)
    p.add_argument("--kf_every", type=int, default=0)
    p.add_argument("--no-mapping", action="store_true")
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--tiny-model", action="store_true",
                   help="the tiny configuration (random unless --ckpt "
                        "names a tiny checkpoint)")
    p.add_argument("--target_width", type=int, default=512,
                   help="tracking width (512 = reference resolution)")
    p.add_argument("--arena_capacity", type=int, default=2 ** 18)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch path)")
    p.add_argument("--finalize_iters", type=int, default=None,
                   help="override opt_params.position_lr_max_steps")
    p.add_argument("--gui", action="store_true",
                   help="the live viewer (not ported)")
    p.add_argument("--gui_port", type=int, default=8080)
    return p.parse_args(argv)


def build_model(args, device):
    """CUT3R (tiny with ``--tiny-model``) from ``--ckpt``, or with random
    weights from seed 0 when the file is absent."""
    import torch
    from .models import CUT3R, CUT3RConfig
    from .models.convert import load_cut3r_checkpoint
    mcfg = CUT3RConfig.tiny() if args.tiny_model else CUT3RConfig()
    model = CUT3R(mcfg, device=device)
    if not os.path.exists(args.ckpt):
        print(f"[demo] checkpoint {args.ckpt} unavailable -> random init")
        gen = torch.Generator(device=model.device).manual_seed(0)
        model.init_random(gen)
    else:
        model.load_state_dict(load_cut3r_checkpoint(args.ckpt))
    return model.eval()


def main(argv=None):
    args = parse_args(argv)
    if args.gui:
        raise NotImplementedError("the live viewer (--gui) is not ported to "
                                  "cut3r_slam_tpu_torch yet (see ROADMAP.md)")
    from .slam.system import SLAMSystem
    from .utils.config import DEFAULT_CONFIG, load_calib, load_config
    from .utils.image import _imread, list_images, mono_stream, \
        prefetch_stream
    from .utils.profiling import StageTimer

    device = "cpu" if args.cpu else "cuda"
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))
    if args.config:
        cfg.update(load_config(args.config))
    if args.kf_every:
        cfg.setdefault("Tracking", {}).setdefault("motion_filter", {})[
            "kf_every"] = args.kf_every
    calib = load_calib(args.calib)

    # the first image gives the resolution
    first = _imread(list_images(args.imagedir)[args.start])
    h0, w0 = first.shape[:2]
    if args.cropborder:
        h0, w0 = h0 - 2 * args.cropborder, w0 - 2 * args.cropborder
    tw = args.target_width
    Ht = int(tw / w0 * h0) // 16 * 16
    Hm = int(tw / w0 * h0) // 2 * 2

    model = build_model(args, device)
    cfg.setdefault("Mapping", {})["arena_capacity"] = args.arena_capacity
    if args.finalize_iters is not None:
        cfg.setdefault("opt_params", {})["position_lr_max_steps"] = \
            args.finalize_iters
    slam = SLAMSystem(model, cfg, buffer=args.buffer, img_hw=(Ht, tw),
                      map_hw=(Hm, tw), enable_mapping=not args.no_mapping,
                      enable_loop=not args.no_loop, output_dir=args.output,
                      device=device)
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "image_shape.txt"), "w") as f:
        f.write(f"track {Ht}x{tw} map {Hm}x{tw} src {h0}x{w0} "
                f"crop {args.cropborder}\n")
    # as demo.py: only whole frames and terminate are timed (attaching the
    # timer to ``slam`` would time, and synchronize, every stage)
    timer = StageTimer()
    t0 = time.time()
    n = 0
    prev = None
    stream = prefetch_stream(
        mono_stream(args.imagedir, calib, args.stride, args.cropborder,
                    args.undistort, args.start, args.length, target_w=tw),
        depth=8)
    for (t, img, K, img_map, K_map, is_last) in stream:
        with timer("frame"):
            slam.run(t, img, K, img_map, K_map, second_last=False,
                     last=is_last)
        n += 1
        prev = t
    with timer("terminate"):
        result = slam.terminate(prev if prev is not None else 0)
    timer.dump(os.path.join(args.output, "timing.json"))
    dt = time.time() - t0

    slam.save_trajectory(os.path.join(args.output, "traj_kf.txt"))
    result.update({"frames": n, "seconds": round(dt, 2),
                   "fps": round(n / max(dt, 1e-9), 2),
                   "keyframes": slam.keyframes.count})
    with open(os.path.join(args.output, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return slam, result


if __name__ == "__main__":
    main()
