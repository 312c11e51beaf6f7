"""DROID-SLAM's frontend as a tracker of the port's ``SLAMSystem``
(``slam/droid_frontend.py``, ``Tracking.model: droid``) on the CPU at
64x96 (an 8x12 grid) with seeded random weights.

- The tracker's update iterations against the plain float32 reference
  (``port_bench/reference/droid.py``) from the inputs the iteration saw:
  the lookup, delta, weight, eta and the hidden state the graph carries
  on within 1e-5 relative (float32 on both sides; the program's and the
  reference's convolutions and the 128-long correlation dot products sum
  in different orders, ~1e-6 measured); the BA's step on poses and
  disparities within 1e-3 relative (the Schur complement's Cholesky in
  float32 amplifies the Hessian's rounding by its condition number,
  ~1e-5 measured; a bfloat16 BA reads ~1e-2).
- The correlation cache's bookkeeping: a pyramid is built with its edge
  and its slot freed with it, ``max_factors`` removes the oldest edges,
  ``max_age`` retires edges into the inactive set the BA keeps using.
- ``Tracking.model: droid`` through ``SLAMSystem.run`` and ``terminate``,
  mapping off and on; an unknown ``Tracking.model`` or ``Tracking.droid``
  key raises.
"""
import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.models.blocks import init_random
from cut3r_slam_tpu_torch.models.droid_net import DroidNet
from cut3r_slam_tpu_torch.slam import droid_frontend as fe
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from port_bench import frames as F
from port_bench.compare import rel_gap
from port_bench.reference import droid as ref

H, W = 64, 96
# the mapper's counts cut to the CPU, at a 32x48 map
MAP = {"arena_capacity": 2048, "iterations": 1, "pose_refine_iters": 1,
       "window_size": 2, "window_opt_iters": 1, "new_view_opt_iters": 0,
       "gba_per_view": 0}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads (under ``pytest -n`` every worker's default
    pool spans all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _net(seed=0):
    net = DroidNet(device="cpu")
    net.load_state_dict(ref.draw_state_dict(seed, "cpu"))
    return net.eval()


def _system(net, tmp_path, droid=None, kf_every=2, mapping=False, **kw):
    cfg = {"Tracking": {"model": "droid",
                        "motion_filter": {"kf_every": kf_every},
                        "droid": dict(droid or {})},
           "Mapping": MAP, "opt_params": {"position_lr_max_steps": 0}}
    return SLAMSystem(net, cfg, buffer=32, img_hw=(H, W),
                      map_hw=(H // 2, W // 2), enable_mapping=mapping,
                      enable_loop=False,
                      output_dir=str(tmp_path), device="cpu", **kw)


def _capture(monkeypatch, net, keep):
    """Patches that keep the inputs and outputs of the update iterations
    numbered in ``keep``."""
    seen, kept, cur = [0], [], {}
    orig_update = fe.DroidGraph.update

    def update(graph, t0=None):
        seen[0] += 1
        if seen[0] not in keep:
            return orig_update(graph, t0)
        v = graph.video
        it, jt = torch.as_tensor(graph.ii), torch.as_tensor(graph.jj)
        cur.clear()
        cur.update(ii=graph.ii.copy(), jj=graph.jj.copy(),
                   fi=v.fmaps[it].clone(), fj=v.fmaps[jt].clone(),
                   net=graph.net.clone(), inp=graph.inp.clone(),
                   target=graph.target.clone(),
                   poses=v.poses[:v.count].clone(),
                   disps=v.disps[:v.count].clone(),
                   intr=v.intrinsics[:v.count].clone(), on=True)
        out = orig_update(graph, t0)
        cur["net_after"] = graph.net.clone()
        cur["on"] = False
        kept.append(dict(cur))
        return out

    orig_lookup = fe.CorrCache.lookup

    def lookup(cache, slots, coords):
        out = orig_lookup(cache, slots, coords)
        if cur.get("on"):
            cur["corr"] = out.clone()
        return out
    orig_op = net.update.forward

    def op(*a):
        out = orig_op(*a)
        if cur.get("on"):
            cur.update(delta=out[1], weight=out[2], eta=out[3],
                       ii_loc=a[4].clone(), n_win=a[5])
        return out
    orig_ba = fe.bundle_adjust

    def ba(*a, **k):
        before = [x.clone() for x in a]      # the window is written after
        out = orig_ba(*a, **k)
        if cur.get("on"):
            cur["ba"] = (before, k, out)
        return out
    monkeypatch.setattr(fe.DroidGraph, "update", update)
    monkeypatch.setattr(fe.CorrCache, "lookup", lookup)
    monkeypatch.setattr(net.update, "forward", op)
    monkeypatch.setattr(fe, "bundle_adjust", ba)
    return kept


def test_update_iterations_match_the_reference(monkeypatch, tmp_path):
    net = _net(3)
    kept = _capture(monkeypatch, net, keep={1, 17, 30})
    slam = _system(net, tmp_path)
    frames = F.synth_frames(24, H, W, 11)
    K = F.intrinsics(H, W)
    for t, img in enumerate(frames):
        slam.run(t, img, K)
    assert len(kept) == 3
    r = ref.DroidNet()
    r.load_state_dict(net.state_dict())
    grid = ref.coords_grid(H // 8, W // 8, "cpu")
    with torch.no_grad(), ref.full_f32():
        for u in kept:
            lo = int(u["ii"][0] - u["ii_loc"][0])
            hi = lo + u["n_win"]
            G = ref.pose_mats(u["poses"][lo:hi])
            c1, _ = ref.reproject(G, u["disps"][lo:hi], u["intr"][lo:hi],
                                  u["ii_loc"], torch.as_tensor(u["jj"] - lo))
            corr = ref.lookup(ref.pyramid(u["fi"], u["fj"]), c1)
            motion = torch.cat([c1 - grid, u["target"] - c1], -1).clamp(-64,
                                                                       64)
            n1, delta, weight, eta, _ = r.update(
                u["net"], u["inp"], corr.permute(0, 3, 1, 2),
                motion.permute(0, 3, 1, 2), u["ii_loc"], u["n_win"])
            src = torch.as_tensor(np.unique(u["ii_loc"].numpy()))
            assert rel_gap(u["corr"], corr) < 1e-5
            assert rel_gap(u["delta"], delta) < 1e-5
            assert rel_gap(u["weight"], weight) < 1e-5
            assert rel_gap(u["eta"][src], eta[src]) < 1e-5
            assert rel_gap(u["net_after"], n1) < 1e-5
            a, k, (poses, disps, _) = u["ba"]
            target, wt, eta_ba, p0, d0, intr, ii, jj = a[:8]
            assert k["steps"] == 2
            Gr, dr = ref.dense_ba(target, wt, eta_ba, p0, d0, intr, ii, jj,
                                  k["fixedp"], iters=2)
            fx = k["fixedp"]
            G0 = ref.pose_mats(p0)[fx:]
            assert rel_gap(ref.pose_mats(poses)[fx:] - G0, Gr[fx:] - G0) \
                < 1e-3
            assert rel_gap(disps - d0, dr - d0) < 1e-3


def _video(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = fe.DroidVideo(16, (H, W), "cpu")
    for i in range(n):
        v.append(torch.randn(128, H // 8, W // 8, generator=g),
                 torch.zeros(128, H // 8, W // 8),
                 torch.zeros(128, H // 8, W // 8),
                 torch.tensor([60.0, 60.0, 6.0, 4.0]), first=i == 0)
    return v


def test_cache_frees_an_edges_pyramid_with_the_edge():
    net = _net()
    v = _video(6)
    g = fe.DroidGraph(net, v, max_factors=6)
    slots0 = g.cache.n_slots
    g.add_factors([0, 1, 2, 3], [1, 0, 3, 2])
    assert g.cache.in_use() == len(g) == 4
    # each edge's cached level 0 is its frames' correlation
    c = torch.einsum("chw,cyx->hwyx", v.fmaps[2] / 4, v.fmaps[3] / 4)
    lvl0 = g.cache.levels[0].reshape(-1, H // 8, W // 8, H // 8 * W // 8)
    assert torch.allclose(lvl0[int(g.slots[2])], c.reshape(lvl0.shape[1:]),
                          atol=1e-5)
    freed = set(g.slots[:2].tolist())
    g.rm_factors(np.array([True, True, False, False]), store=True)
    assert g.cache.in_use() == len(g) == 2
    assert list(zip(g.ii_inac, g.jj_inac)) == [(0, 1), (1, 0)]
    assert g.target_inac.shape[0] == 2
    # freed slots are reused; an edge already known is not added twice
    g.add_factors([0, 4, 5], [1, 5, 4])
    assert set(g.slots[-2:].tolist()) <= freed | set(range(slots0))
    assert len(g) == 4 and g.cache.in_use() == 4
    # max_factors 6: adding 4 with removal drops the 2 oldest
    g.age[:] = [5, 4, 1, 0]
    g.add_factors([1, 2, 3, 4], [2, 1, 4, 3], remove=True)
    assert len(g) == 6 and g.cache.in_use() == 6
    assert list(zip(g.ii[:2], g.jj[:2])) == [(4, 5), (5, 4)]
    assert g.cache.n_slots == slots0


def test_max_factors_and_max_age_hold_in_the_loop(monkeypatch, tmp_path):
    """Every frame through the flow filter (threshold 0) with keyframe
    removal (threshold 1e9): the cap, the age limit and the cache's slots
    hold at every update."""
    net = _net(1)
    slam = _system(net, tmp_path, kf_every=0,
                   droid={"filter_thresh": 0.0, "keyframe_thresh": 1e9})
    ages, sizes, inactive = [], [], []
    orig = fe.DroidGraph.update

    def update(graph, t0=None):
        assert graph.cache.in_use() == len(graph)
        ages.append(int(graph.age.max()))
        sizes.append(len(graph))
        inactive.append(len(graph.ii_inac))
        return orig(graph, t0)
    monkeypatch.setattr(fe.DroidGraph, "update", update)
    frames = F.synth_frames(24, H, W, 5)
    K = F.intrinsics(H, W)
    removed = 0
    for t, img in enumerate(frames):
        n0 = slam.keyframes.count
        slam.run(t, img, K)
        removed += int(slam.keyframes.count <= n0 and t >= 8)
    g = slam.graph
    assert removed > 0 and slam.keyframes.count == g.video.count
    # the age limit: edges retire at the start of a keyframe's update, so
    # are at most ITERS1 + ITERS2 updates older than MAX_AGE; retired
    # edges join the inactive ones past the initialisation's
    it = 2 * fe.INIT_ITERS
    assert max(ages[it:]) <= fe.MAX_AGE + fe.ITERS1 + fe.ITERS2
    assert max(ages) > fe.MAX_AGE and inactive[-1] > inactive[it]
    # the cap (new edges beyond it displace the oldest)
    assert max(sizes[it:]) <= fe.MAX_FACTORS + 2


@pytest.mark.parametrize("mapping", [False, True], ids=["no_map", "map"])
def test_droid_tracking_runs_through_slam_system(tmp_path, mapping):
    net = init_random(DroidNet(device="cpu"),
                      torch.Generator().manual_seed(2)).eval()
    slam = _system(net, tmp_path, mapping=mapping)
    n = 18
    frames = F.synth_frames(n, H, W, 4)
    K = F.intrinsics(H, W)
    events = []
    for t, img in enumerate(frames):
        took, viz = slam.run(t, img, K, img[::2, ::2].copy(), K / 2)
        if viz is not None:
            events.append(list(viz))
    res = slam.terminate(n - 1, eval_render=False, export_renders=False)
    kf = slam.keyframes
    # frames 0, 2, .., 16
    assert kf.count == 9 and kf.tstamp[:3].tolist() == [0, 2, 4]
    assert np.isfinite(kf.pose[:kf.count]).all()
    assert (kf.depth[:kf.count] > 0).all()
    # the first mapping event: the keyframes that can no longer be removed
    # once the 8 of the warm-up are initialised
    assert events == [list(range(0, 6))]
    # the keyframe store's poses are the video's, camera-to-world
    v = slam.graph.video
    c2w = fe.se3_inv(v.poses[:kf.count]).numpy()
    assert np.allclose(kf.pose[:kf.count, :3], c2w[:, :3], atol=1e-5)
    if mapping:
        assert int(slam.mapper.cams.valid.sum()) == 6
        assert int(slam.mapper.arena.alive.sum()) > 0
    else:
        assert slam.mapper is None and res == {}


def test_unknown_tracker_raises(tmp_path):
    net = _net()
    with pytest.raises(ValueError, match="Tracking.model"):
        SLAMSystem(net, {"Tracking": {"model": "orb"}}, buffer=4,
                   img_hw=(H, W), enable_loop=False, device="cpu",
                   output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unknown keys"):
        SLAMSystem(net, {"Tracking": {"model": "droid",
                                      "droid": {"max_factor": 4}}},
                   buffer=4, img_hw=(H, W), enable_loop=False, device="cpu",
                   output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="loop backend"):
        SLAMSystem(net, {"Tracking": {"model": "droid"}}, buffer=4,
                   img_hw=(H, W), device="cpu", output_dir=str(tmp_path))
