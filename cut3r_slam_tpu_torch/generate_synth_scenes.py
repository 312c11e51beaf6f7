"""CLI for the procedural multiview generator (the port's counterpart of
the repository's ``scripts/generate_synth_scenes.py``, with the same
flags): renders N procedural scenes into the standard SceneLayout for the
training pipeline (``datasets/loaders.SceneFolderSource`` +
``datasets/multiview``).

    python -m cut3r_slam_tpu_torch.generate_synth_scenes --output data/synth \
        --n_scenes 8 --views 8 --height 192 --width 256

The scenes are ray-cast in numpy on the host (``datasets/synthscene``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output", required=True)
    p.add_argument("--n_scenes", type=int, default=4)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--hfov", type=float, default=60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min_overlap", type=float, default=0.1)
    p.add_argument("--max_overlap", type=float, default=0.9)
    args = p.parse_args(argv)

    from .datasets.synthscene import generate_multiview_scenes
    dirs = generate_multiview_scenes(
        args.output, n_scenes=args.n_scenes, views_per_scene=args.views,
        hw=(args.height, args.width), hfov_deg=args.hfov, seed=args.seed,
        min_overlap=args.min_overlap, max_overlap=args.max_overlap)
    print(f"wrote {len(dirs)} scenes under {args.output}")
    for d in dirs:
        print(" ", d)


if __name__ == "__main__":
    main()
