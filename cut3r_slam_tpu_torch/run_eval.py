"""Evaluation driver over a dataset's sequences (the port's counterpart of
the repository's ``scripts/run_{replica,scannet,tum,7scenes,scannetpp}.py``,
one module with the datasets in a table): per sequence run
``python -m cut3r_slam_tpu_torch.demo``, then (Replica) the TSDF mesh with
``python -m cut3r_slam_tpu_torch.tsdf_integrate``, then the ATE of the
keyframe trajectory against the ground truth; write ``summary.json``.
Sequences whose trajectory or mesh exists already are not run again.

    python -m cut3r_slam_tpu_torch.run_eval --dataset replica \
        --datadir data/replica --output outputs/replica \
        --extra "--target_width 512"

``--extra`` carries flags to the demo (``--cpu`` runs it on the CPU, as
it does the mesh); a dashed flag must be passed inside one quoted string.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
from dataclasses import dataclass
from typing import Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class EvalSet:
    sequences: Tuple[str, ...]
    images: str          # image folder inside a sequence
    name: str            # calib/<name>.txt, config/<name>_config.yaml
    gt: str              # "traj": traj.txt 4x4 rows; "tum": groundtruth.txt
    mesh: bool = False   # TSDF mesh of the rendered keyframes


DATASETS = {
    "replica": EvalSet(("room0", "room1", "room2", "office0", "office1",
                        "office2", "office3", "office4"), "results",
                       "replica", "traj", mesh=True),
    "scannet": EvalSet(("scene0000_00", "scene0059_00", "scene0106_00",
                        "scene0169_00", "scene0181_00", "scene0207_00",
                        "scene0054_00", "scene0233_00"), "color", "scannet",
                       "traj"),
    "tum": EvalSet(("rgbd_dataset_freiburg1_desk",
                    "rgbd_dataset_freiburg2_xyz",
                    "rgbd_dataset_freiburg3_long_office_household"), "rgb",
                   "tum", "tum"),
    "7scenes": EvalSet(("chess", "fire", "heads", "office", "pumpkin",
                        "redkitchen", "stairs"), "seq-01", "7scenes", "traj"),
    "scannetpp": EvalSet(("b20a261fdf", "8b5caf3398"), "rgb", "scannetpp",
                         "traj"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    p.add_argument("--datadir", required=True, help="dataset root")
    p.add_argument("--output", default=None,
                   help="default outputs/<dataset>")
    p.add_argument("--sequences", nargs="*", default=None)
    p.add_argument("--ckpt", default="./checkpoints/cut3r_512_dpt_4_64.pth")
    p.add_argument("--extra", nargs="*", default=[],
                   help="extra demo flags; dashed tokens must be passed as "
                        "ONE quoted string (argparse stops nargs='*' at a "
                        "leading dash)")
    args = p.parse_args(argv)
    args.extra = [t for item in args.extra for t in shlex.split(item)]
    args.output = args.output or os.path.join("outputs", args.dataset)
    return args


def sequence_ate(ds: EvalSet, seq_dir: str, traj_file: str):
    """ATE RMSE of the keyframe positions against the ground truth, or
    None without a ground-truth file."""
    from .utils.eval import ate_rmse
    est = np.loadtxt(traj_file, ndmin=2)
    if ds.gt == "tum":
        gt_file = os.path.join(seq_dir, "groundtruth.txt")
        if not os.path.exists(gt_file):
            return None
        with open(gt_file) as f:
            rows = np.asarray([[float(x) for x in ln.split()[:4]] for ln in f
                               if ln.strip() and not ln.startswith("#")])
        # keyframes pair with ground-truth rows by index
        n = min(len(est), len(rows))
        return ate_rmse(est[:n, 1:4], rows[:n, 1:4])
    gt_file = os.path.join(seq_dir, "traj.txt")
    if not os.path.exists(gt_file):
        return None
    gt = np.loadtxt(gt_file).reshape(-1, 4, 4)
    ts = est[:, 0].astype(int)
    ts = ts[ts < len(gt)]
    return ate_rmse(est[:len(ts), 1:4], gt[ts][:, :3, 3])


def main(argv=None):
    args = parse_args(argv)
    ds = DATASETS[args.dataset]
    py = [sys.executable, "-m"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    results = {}
    for seq in (args.sequences if args.sequences is not None
                else ds.sequences):
        out = os.path.join(args.output, seq)
        traj = os.path.join(out, "traj_kf.txt")
        if not os.path.exists(traj):
            cmd = py + ["cut3r_slam_tpu_torch.demo",
                        "--imagedir", os.path.join(args.datadir, seq,
                                                   ds.images),
                        "--calib", os.path.join(ROOT, "calib",
                                                f"{ds.name}.txt"),
                        "--config", os.path.join(ROOT, "config",
                                                 f"{ds.name}_config.yaml"),
                        "--output", out, "--ckpt", args.ckpt] + args.extra
            print("+", " ".join(cmd), flush=True)
            subprocess.run(cmd, check=True, env=env)

        res = {}
        rj = os.path.join(out, "result.json")
        if os.path.exists(rj):
            with open(rj) as f:
                res.update(json.load(f))
        if ds.mesh:
            mesh = os.path.join(out, "mesh.ply")
            if not os.path.exists(mesh) and os.path.isdir(
                    os.path.join(out, "renders_kf")):
                cmd = py + ["cut3r_slam_tpu_torch.tsdf_integrate",
                            "--rundir", out] + (
                    ["--cpu"] if "--cpu" in args.extra else [])
                print("+", " ".join(cmd), flush=True)
                subprocess.run(cmd, check=True, env=env)
            if os.path.exists(mesh):
                res["mesh_ply"] = mesh
        if os.path.exists(traj):
            ate = sequence_ate(ds, os.path.join(args.datadir, seq), traj)
            if ate is not None:
                res["ate_rmse_m"] = ate
        results[seq] = res
        print(seq, json.dumps(res), flush=True)

    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
