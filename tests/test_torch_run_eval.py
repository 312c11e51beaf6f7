"""``python -m cut3r_slam_tpu_torch.run_eval --dataset replica`` end to end
on the CPU: a 24-frame ``synth_replica`` sequence at the native 680x1200,
the demo with ``--tiny-model --cpu --target_width 64 --arena_capacity 8192
--kf_every 2 --finalize_iters 50`` and a config that inherits
``config/replica_config.yaml`` with the mapping and loop-closure
iteration counts cut (window 1, one optimization segment an event,
parallel keyframe refinement, no per-view polish or global BA between
events, 5 PGO steps) to stay inside the tier-1 budget; then the TSDF mesh
and the ATE. The artifact set is tests/test_eval_drivers.py's; a second
call runs nothing again. The demo subprocess loads a tiny checkpoint,
``chip_smoke.plausible_random_cut3r``'s random weights with the
self-pointmap and pose heads made plausible (a plane in front of a
near-static camera), through ``run_eval --ckpt``: the plain draw predicts
depths behind the camera, which render no surface to mesh.
"""
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import plausible_random_cut3r
from cut3r_slam_tpu_torch.datasets.synth_replica import write_replica_sequence
from cut3r_slam_tpu_torch.models import CUT3RConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUT_CONFIG = """\
inherit_from: {base}
Tracking:
  backend: {{loop_iters: 5}}
Mapping:
  window_size: 1
  iterations: 2
  pose_refine_iters: 1
  window_opt_iters: 1
  new_view_opt_iters: 0
  gba_per_view: 0
  parallel_kf_refine: true
"""

@pytest.fixture(autouse=True)
def few_threads():
    """Four intra-op threads (the 680x1200 frames render in as many; the
    demo subprocess takes two), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_run_eval_replica_end_to_end(tmp_path, monkeypatch):
    from cut3r_slam_tpu_torch import run_eval
    data = str(tmp_path / "data")
    write_replica_sequence(data, seq="synth0", n_frames=24, seed=0)
    weights = tmp_path / "cut3r_tiny.pth"
    model = plausible_random_cut3r(0, CUT3RConfig.tiny(), "cpu")
    torch.save({"model": model.state_dict()}, weights)
    cfg = tmp_path / "cut.yaml"
    cfg.write_text(CUT_CONFIG.format(
        base=os.path.join(ROOT, "config", "replica_config.yaml")))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    outdir = str(tmp_path / "replica_out")
    run_eval.main([
        "--dataset", "replica", "--datadir", data, "--output", outdir,
        "--sequences", "synth0", "--ckpt", str(weights), "--extra",
        "--tiny-model --cpu --target_width 64 --arena_capacity 8192"
        " --kf_every 2 --finalize_iters 50",
        f"--config {cfg}"])

    seq_out = os.path.join(outdir, "synth0")
    traj = np.loadtxt(os.path.join(seq_out, "traj_kf.txt"))
    assert traj.ndim == 2 and traj.shape[1] == 8 and len(traj) >= 5
    assert np.isfinite(traj).all()
    with open(os.path.join(seq_out, "result.json")) as f:
        result = json.load(f)
    assert result["keyframes"] >= 5 and np.isfinite(result["psnr_kf"])
    with open(os.path.join(seq_out, "psnr", "final",
                           "final_result_kf.json")) as f:
        kf_res = json.load(f)
    assert kf_res["n_views"] >= 5 and np.isfinite(kf_res["mean_psnr"])
    with open(os.path.join(outdir, "summary.json")) as f:
        summary = json.load(f)
    assert np.isfinite(summary["synth0"]["ate_rmse_m"])
    mesh = os.path.join(seq_out, "mesh.ply")
    assert summary["synth0"]["mesh_ply"] == mesh
    assert os.path.getsize(mesh) > 1000, "mesh.ply is degenerate"
    # a second call finds every output and runs nothing again
    stamp = os.path.getmtime(mesh)
    again = run_eval.main(["--dataset", "replica", "--datadir", data,
                           "--output", outdir, "--sequences", "synth0"])
    assert os.path.getmtime(mesh) == stamp
    assert again["synth0"]["ate_rmse_m"] == summary["synth0"]["ate_rmse_m"]


def test_tiny_demo_model_loads_its_checkpoint(tmp_path):
    """``--tiny-model`` builds the tiny configuration and loads ``--ckpt``
    when the file exists (random from seed 0 otherwise)."""
    from cut3r_slam_tpu_torch import demo
    weights = tmp_path / "cut3r_tiny.pth"
    want = plausible_random_cut3r(0, CUT3RConfig.tiny(), "cpu").state_dict()
    torch.save({"model": want}, weights)
    flags = ["--imagedir", str(tmp_path), "--calib", "x", "--tiny-model"]
    got = demo.build_model(demo.parse_args(
        flags + ["--ckpt", str(weights)]), "cpu").state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    drawn = demo.build_model(demo.parse_args(
        flags + ["--ckpt", str(tmp_path / "none.pth")]), "cpu").state_dict()
    last = "downstream_head.dpt_self.head.4.bias"
    assert not torch.equal(drawn[last], want[last])
