"""The live loop with view-parallel mapping (``Mapping.view_parallel: 2``)
at world size 2 over gloo on the CPU, against the same run on one rank:
tiny CUT3R from a seeded random draw, the drifting 32x48 sequence of
tests/test_torch_slam_slice.py (23 frames, a keyframe every 2nd, two
mapping events, loop closure on), a global BA of two views a step in
``terminate``.

* both ranks take every keyframe and mapping decision of the one-rank
  run, and end with bitwise-equal keyframe poses, depths and arenas;
* the keyframe poses written back by mapping agree with the one-rank run
  to ``POSE_ATOL`` (the split over ranks reorders the mapping's float
  sums only), and only rank 0 writes ``terminate``'s files;
* a decision forced to differ on rank 1 (its keyframe spacing) raises on
  both ranks at the frame where it first differs, well inside the
  process group's timeout, instead of leaving a rank in a collective.
"""
import os
import time

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from test_torch_parallel_mesh import PG_TIMEOUT_S, few_threads, \
    run_world, wait  # noqa: F401

H, W = 32, 48
N_FRAMES = 23
K4 = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = {
    "Tracking": {"motion_filter": {"kf_every": 2}},
    "Mapping": {"arena_capacity": 4096, "window_size": 3, "iterations": 4,
                "window_opt_iters": 2, "new_view_opt_iters": 2,
                "gba_per_view": 0, "gba_views_per_iter": 2},
    "opt_params": {"position_lr_max_steps": 2},
    "keep_all_frames": False,
}
MAP_EXTRA = {"pose_refine_iters": 2, "opt_segment": 2, "gba_segment": 4}
# largest keyframe-pose entry difference from the one-rank run allowed
POSE_ATOL = 1e-5


def _frames():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(H, W + 2 * N_FRAMES, 3))
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    base = base.astype(np.uint8)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + W])
            for i in range(N_FRAMES)]


def _system(out, view_parallel):
    model = CUT3R(CUT3RConfig.tiny(), device="cpu")
    model.init_random(torch.Generator().manual_seed(0))
    cfg = dict(CFG, Mapping=dict(CFG["Mapping"],
                                 view_parallel=view_parallel))
    slam = SLAMSystem(model.eval(), cfg, buffer=32, img_hw=(H, W),
                      output_dir=out, device="cpu")
    slam._map_cfg_extra.update(MAP_EXTRA)
    return slam


def _drive(slam, frames):
    events = []
    for t, f in enumerate(frames):
        _, viz = slam.run(t, f, K4, last=(t == len(frames) - 1))
        if viz is not None:
            events.append(list(viz))
    slam.terminate(len(frames) - 1)
    return events


def _result(slam, events):
    kf, n = slam.keyframes, slam.keyframes.count
    return {"events": events, "tstamp": kf.tstamp[:n].copy(),
            "pose": kf.pose[:n].copy(), "depth": kf.depth[:n].copy(),
            "arena": {k: v.clone() for k, v in slam.mapper.arena.params()
                      .items()},
            "alive": slam.mapper.arena.alive.clone()}


def _slam_worker(rank, world, out):
    slam = _system(f"{out}/rank{rank}", world)
    torch.save(_result(slam, _drive(slam, _frames())),
               f"{out}/slam{rank}.pt")


def _disagree_worker(rank, world, out):
    slam = _system(f"{out}/disagree{rank}", world)
    if rank == 1:
        slam.filter.kf_every = 3
    t0 = time.time()
    try:
        _drive(slam, _frames())
    except RuntimeError as e:
        msg = str(e)
    else:
        msg = None
    torch.save({"msg": msg, "seconds": time.time() - t0},
               f"{out}/disagree{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_slam")
    ranks = run_world(_slam_worker, tmp, str(tmp), join=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)      # as each rank
    seq = _system(str(tmp / "seq"), 0)
    ref = _result(seq, _drive(seq, _frames()))
    torch.set_num_threads(n)
    wait(ranks)
    ranks = [torch.load(tmp / f"slam{r}.pt", weights_only=False)
             for r in range(2)]
    return tmp, ref, ranks


def test_same_decisions_as_one_rank(runs):
    _, ref, ranks = runs
    assert len(ref["events"]) == 2
    for r in ranks:
        assert r["events"] == ref["events"]
        np.testing.assert_array_equal(r["tstamp"], ref["tstamp"])


def test_ranks_bitwise_equal(runs):
    _, _, (r0, r1) = runs
    for k in ("pose", "depth", "tstamp"):
        assert np.array_equal(r0[k], r1[k]), k
    assert torch.equal(r0["alive"], r1["alive"])
    for k, v in r0["arena"].items():
        assert torch.equal(v, r1["arena"][k]), k


def test_poses_match_one_rank(runs):
    _, ref, (r0, _) = runs
    err = np.abs(r0["pose"] - ref["pose"]).max()
    print(f"largest keyframe-pose difference from one rank: {err:.3e}")
    assert err <= POSE_ATOL, err
    np.testing.assert_allclose(r0["depth"], ref["depth"], rtol=1e-3,
                               atol=1e-4)
    assert not np.array_equal(ref["pose"][1:], ref["pose"][1:] * 0)


def test_rank0_alone_writes(runs):
    tmp = runs[0]
    assert os.path.exists(tmp / "rank0" / "gaussians.npz")
    assert not os.path.exists(tmp / "rank1")


def test_disagreement_raises_on_every_rank(tmp_path):
    run_world(_disagree_worker, tmp_path, str(tmp_path))
    for r in range(2):
        res = torch.load(tmp_path / f"disagree{r}.pt", weights_only=False)
        assert res["msg"] is not None and "disagree" in res["msg"], res
        assert res["seconds"] < PG_TIMEOUT_S / 2, res
