"""Loop-closure port vs the JAX package on the CPU: the submap PGOs
(``pgo_align``, ``pgo_align_multi``, ``apply_pgo``), loop detection and
NMS, the ``TrackBackend`` chain on a drifting store, and the whole slice:
``SLAMSystem.run_test`` (GT injection, loop closure, Sim(3) PGBA, mapping
off) on the out-and-back trajectory of tests/test_e2e_gt_loop.py, tiny
CUT3R carried across with ``params_from_jax``.

Tolerances: the PGOs minimize L1 objectives with Adam, so once the seams
close, residuals sit at zero and a float-rounding difference flips the
sign of their gradient; Adam then takes a full step of the other sign.
The two packages agree to 1e-6 over the first steps (10 for pgo_align, 3
for pgo_align_multi, whose LC-cloud transforms have components with
gradients at float noise that move by up to one step from the first) and
to two Adam steps (lr 5e-4) after 300 (measured: 1.6e-4 to 8.5e-4); pointmaps moved
by the corrections agree to 5e-3 (two steps times the point radius,
~2 m, with headroom). The whole run closes the
same loop at the same keyframes; keyframe poses, depths and submap
pointmaps after the 150-step PGO and the PGBA pass agree to 1e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.slam.backend import (TrackBackend as JBackend,
                                         pgo_align as j_pgo_align,
                                         pgo_align_multi as j_pgo_align_multi,
                                         _apply_pgo as j_apply_pgo)
from cut3r_slam_tpu.slam.factor_graph import FactorGraph as JGraph
from cut3r_slam_tpu.slam.keyframe import KeyframeStore as JKeyframes
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.slam.backend import (TrackBackend, pgo_align,
                                               pgo_align_multi, apply_pgo)
from cut3r_slam_tpu_torch.slam.factor_graph import FactorGraph
from cut3r_slam_tpu_torch.slam.keyframe import KeyframeStore, SUBMAP_SIZE
from cut3r_slam_tpu_torch.slam.system import SLAMSystem

from test_backend_loop import (_apply_T, _drift_mats, _grid_points,
                               _seam_err, H, W, h, w)
import test_e2e_gt_loop as e2e

from test_torch_cut3r_train import few_threads  # noqa: F401

LR = 5e-4
XI_TOL = 2 * LR      # two Adam steps, after 300
PTS_TOL = 5e-3       # pointmaps moved by corrections XI_TOL apart


def _chain(B, Bp=8, scale=0.03, seed=0):
    """The drift chain of tests/test_backend_loop.py: B submaps of one
    static plane under accumulating SE(3) drift, padded to Bp for JAX."""
    G = _grid_points()
    Ts = _drift_mats(B, scale=scale, seed=seed)
    pts = np.zeros((Bp, SUBMAP_SIZE + 1, h, w, 3), np.float32)
    for b in range(B):
        pts[b] = _apply_T(Ts[b], G)[None]
    conf = np.zeros((Bp, h, w), np.float32)
    conf[:B] = 1.0
    return G, pts, conf, (np.arange(Bp) < B).astype(np.float32)


@pytest.mark.parametrize("B", [4, 3])
def test_pgo_align_matches_jax(B):
    G, pts, conf, bw = _chain(B)

    def run(iters):
        xj = np.asarray(j_pgo_align(
            *map(jnp.asarray, (pts, conf, pts[B - 1, 0], G, bw)),
            iters=iters))
        xt = pgo_align(*map(torch.tensor, (pts[:B], conf[:B], pts[B - 1, 0],
                                           G)), iters=iters).numpy()
        np.testing.assert_array_equal(xj[B:], 0.0)   # JAX padding rows
        return xj[:B], xt

    xj, xt = run(10)
    np.testing.assert_allclose(xt, xj, atol=1e-6)
    xj, xt = run(300)
    np.testing.assert_array_equal(xt[0], 0.0)
    np.testing.assert_allclose(xt, xj, atol=XI_TOL)
    moved_j, _ = j_apply_pgo(jnp.asarray(pts), jnp.asarray(np.pad(
        xj, ((0, 8 - B), (0, 0)))))
    moved_t, _ = apply_pgo(torch.tensor(pts[:B]), torch.tensor(xt))
    np.testing.assert_allclose(moved_t.numpy(), np.asarray(moved_j)[:B],
                               atol=PTS_TOL)
    assert _seam_err(moved_t.numpy(), B) < 0.5 * _seam_err(pts, B)


def test_apply_pgo_matches_jax():
    _, pts, _, _ = _chain(3, Bp=3)
    xi = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32) * .1
    pj, Tj = j_apply_pgo(jnp.asarray(pts), jnp.asarray(xi))
    pt, Tt = apply_pgo(torch.tensor(pts), torch.tensor(xi))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)


@pytest.mark.parametrize("C", [2, 3])
def test_pgo_align_multi_matches_jax(C):
    """Repeat closures: C loops (JAX pads them to 4), B = 4 submaps, every
    loop matched to submap 0 and its LC cloud at the ground truth plus
    seeded noise (exact clouds would start the L1 terms at zero)."""
    B, Cp = 4, 4
    G, pts, conf, bw = _chain(B, scale=0.04, seed=3)
    cur_sub = np.array([2, 3, 1, 0][:C] + [0] * (Cp - C), np.int32)
    lc_fl = np.zeros((Cp, 2, h, w, 3), np.float32)
    lc_fl[:C] = np.stack([G, G])[None] + np.random.default_rng(C).normal(
        0, 0.01, (C, 2, h, w, 3)).astype(np.float32)
    cur = np.zeros((Cp, h, w, 3), np.float32)
    cur[:C] = pts[cur_sub[:C], 0]
    cw = (np.arange(Cp) < C).astype(np.float32)
    msub = np.zeros(Cp, np.int32)

    def run(iters):
        xj, lj = j_pgo_align_multi(
            *map(jnp.asarray, (pts, conf, bw, lc_fl, cur, cur_sub, msub, cw)),
            iters=iters)
        xt, lt = pgo_align_multi(
            *map(torch.tensor, (pts[:B], conf[:B], lc_fl[:C], cur[:C])),
            torch.tensor(cur_sub[:C]).long(), torch.tensor(msub[:C]).long(),
            iters=iters)
        return (np.asarray(xj)[:B], np.asarray(lj)[:C], xt.numpy(),
                lt.numpy())

    xj, lj, xt, lt = run(3)
    np.testing.assert_allclose(xt, xj, atol=1e-6)
    # a cloud-transform component whose gradient is at float noise takes
    # up to one Adam step of either sign from the first step on
    np.testing.assert_allclose(lt, lj, atol=LR)
    xj, lj, xt, lt = run(300)
    np.testing.assert_allclose(xt, xj, atol=XI_TOL)
    np.testing.assert_allclose(lt, lj, atol=XI_TOL)
    moved, _ = apply_pgo(torch.tensor(pts[:B]), torch.tensor(xt))
    assert _seam_err(moved.numpy(), B) < 0.5 * _seam_err(pts, B)


def _stores(B):
    """Both packages' keyframe stores holding B submaps of a drifting
    static scene (tests/test_backend_loop.py's ``_build_store``), with
    seeded encoder tokens."""
    from cut3r_slam_tpu.geometry.lie import se3_from_matrix
    n_kf = B * SUBMAP_SIZE + 1
    G = _grid_points()
    Ts = _drift_mats(B, scale=0.03, seed=1)
    feats = np.random.default_rng(7).normal(size=(n_kf, 5, 4)) \
        .astype(np.float32)
    jk = JKeyframes(64, (H, W), feat_tokens=5, feat_dim=4)
    tk = KeyframeStore(64, (H, W), feat_tokens=5, feat_dim=4)
    K = np.array([10.0, 10.0, W / 2, H / 2], np.float32)
    for i in range(n_kf):
        b = min(i // SUBMAP_SIZE, B - 1)
        pose = np.asarray(se3_from_matrix(jnp.asarray(Ts[b])))
        p = _apply_T(Ts[b], G)
        jk.append(i * 5, np.zeros((H, W, 3), np.uint8),
                  feat=jnp.asarray(feats[i]), pose=pose, intrinsic=K)
        jk.pts_ds = jk.pts_ds.at[i].set(jnp.asarray(p))
        tk.append(i * 5, np.zeros((H, W, 3), np.uint8),
                  feat=torch.tensor(feats[i]), pose=pose, intrinsic=K)
        tk.pts_ds[i] = torch.tensor(p)
    for b in range(B):
        pts = np.broadcast_to(_apply_T(Ts[b], G),
                              (SUBMAP_SIZE + 1, h, w, 3)).copy()
        cf = np.ones((SUBMAP_SIZE + 1, h, w), np.float32)
        jk.set_submap(b, jnp.asarray(pts), jnp.asarray(cf))
        tk.set_submap(b, torch.tensor(pts), torch.tensor(cf))
    return jk, tk, G


def test_detect_loop_and_nms_match_jax():
    jk, tk, _ = _stores(4)
    rng = np.random.default_rng(3)
    graphs = (JGraph(), FactorGraph())
    ii = rng.integers(0, 21, 60)
    jj = rng.integers(0, 21, 60)
    for g in graphs:
        g.add_factors(ii, jj)
        g.add_factors(jj, ii)
    from cut3r_slam_tpu_torch.slam.frontend import pose_vec_to_matrix_np
    c2w = pose_vec_to_matrix_np(tk.pose)
    K4 = tk.intrinsic[0] / 2
    n_pick = 0
    for cur in range(9, 21):
        cj = graphs[0].detect_loop(cur)
        ct = graphs[1].detect_loop(cur)
        assert (cj is None) == (ct is None)
        if cj is None:
            continue
        np.testing.assert_array_equal(ct, cj)
        for th in (0.3, 0.9):
            pj = graphs[0].nms(cj, cur, c2w, jk.pts_ds, jk.featI, K4, th=th)
            pt = graphs[1].nms(ct, cur, c2w, tk.pts_ds, tk.featI, K4, th=th)
            assert pt == pj
            n_pick += pt is not None
    assert n_pick > 0


class _StubFrontend:
    ds = 2
    params = None


def test_track_backend_chain_matches_jax(monkeypatch):
    """detect -> NMS -> pgo_align -> writeback, then a repeat closure
    through pgo_align_multi, the LC re-track stubbed by ground truth (as
    in tests/test_backend_loop.py) on both sides."""
    B = 4
    jk, tk, G = _stores(B)
    gt = np.broadcast_to(G, (SUBMAP_SIZE + 1, h, w, 3)).copy()
    cf = np.ones((SUBMAP_SIZE + 1, h, w), np.float32)
    jb = JBackend(_StubFrontend(), jk, JGraph(), loop_iters=300,
                  nms_thresh=0.3)
    tb = TrackBackend(_StubFrontend(), tk, FactorGraph(), loop_iters=300,
                      nms_thresh=0.3)
    monkeypatch.setattr(jb, "lc_track", lambda m, c: (jnp.asarray(gt),
                                                      jnp.asarray(cf)))
    monkeypatch.setattr(tb, "lc_track", lambda m, c: (torch.tensor(gt),
                                                      torch.tensor(cf)))
    cur = B * SUBMAP_SIZE - 2
    before = _seam_err(tk.submap_pts.numpy(), B)
    for b in (jb, tb):
        b.graph.add_factors([cur, 2], [2, cur])
    uj, ut = jb.run(cur + 2), tb.run(cur + 2)
    assert ut is not None and uj is not None
    assert tb.closed_loop["idx_matched"] == jb.closed_loop["idx_matched"]
    for k in ("submap_idx", "camera_idx"):
        np.testing.assert_array_equal(ut[k], uj[k])

    def close(a, b, atol):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)

    def same_state():
        n = tk.count
        close(tk.pose[:n, :3], jk.pose[:n, :3], PTS_TOL)
        close(tk.submap_pts[:B].numpy(), jk.submap_pts[:B], PTS_TOL)
        close(tk.pts_ds[:n].numpy(), jk.pts_ds[:n], PTS_TOL)

    same_state()
    close(ut["camera_pose"][:, :3], uj["camera_pose"][:, :3], PTS_TOL)
    assert _seam_err(tk.submap_pts.numpy(), B) < 0.5 * before
    assert tb.freeze_counter == jb.freeze_counter == 20
    assert tb.run(cur + 2) is None                     # frozen

    uj = jb.loop_closure(3, B * SUBMAP_SIZE - 1)
    ut = tb.loop_closure(3, B * SUBMAP_SIZE - 1)
    assert len(tb.closed_loop["lc_fl"]) == 2
    same_state()
    close(ut["pose_updates"][:, :3], uj["pose_updates"][:, :3], PTS_TOL)
    assert _seam_err(tk.submap_pts.numpy(), B) < 0.5 * before


# ---------------------------------------------------------------------------
# the slice: SLAMSystem.run_test on both packages
# ---------------------------------------------------------------------------

N_FRAMES = 34
CFG = {"Tracking": {"motion_filter": {"kf_every": 2},
                    "backend": {"loop_iters": 150},
                    "pgba": {"active": True, "iters": 4}},
       "keep_all_frames": False}


def _seam(kf, B):
    p = kf.submap_pts[:B]
    p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    return float(np.abs(p[:B - 1, -1] - p[1:B, 0]).mean())


def _drive(slam):
    """Run the trajectory. Each closure records, just before and just
    after, the two terms of its PGO objective: the seam error over submaps
    [0, current submap] and the loop error |current keyframe's world
    pointmap - its LC re-prediction| (the first closure leaves the LC
    cloud where it is)."""
    errs, gt = [], {}
    closure = slam.backend.loop_closure

    def recorded(matched, current):
        kf = slam.keyframes
        b, s = divmod(current, SUBMAP_SIZE)
        cur = np.array(kf.submap_pts[b, s])
        seam = _seam(kf, b + 1)
        out = closure(matched, current)
        lc = np.asarray(slam.backend.closed_loop["lc_fl"][-1][1])
        errs.append((seam, float(np.abs(cur - lc).mean()),
                     _seam(kf, b + 1),
                     float(np.abs(np.asarray(kf.submap_pts[b, s]) - lc)
                           .mean())))
        return out
    slam.backend.loop_closure = recorded
    txs = e2e._trajectory(N_FRAMES)
    for t, tx in enumerate(txs):
        img, depth, c2w = e2e._gt_frame(tx)
        gt[t] = c2w
        slam.run_test(t, img, e2e.K4, depth, c2w,
                      second_last=(t == len(txs) - 2),
                      last=(t == len(txs) - 1), sigma_t=0.02, sigma_r=0.004)
    return errs, gt


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 1, e2e.H, e2e.W, 3)))
    js = JSLAM(jm, params, CFG, buffer=64, img_hw=(e2e.H, e2e.W),
               enable_mapping=False,
               output_dir=str(tmp_path_factory.mktemp("jax")))
    seams_j, gt = _drive(js)
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flatten_dict(params["params"],
                                                    sep="/")))
    ts = SLAMSystem(tm, CFG, buffer=64, img_hw=(e2e.H, e2e.W),
                    enable_mapping=False, device="cpu",
                    output_dir=str(tmp_path_factory.mktemp("torch")))
    seams_t, _ = _drive(ts)
    return js, seams_j, ts, seams_t, gt


def test_run_test_closes_the_same_loop(loop_runs):
    js, _, ts, _, _ = loop_runs
    assert ts.keyframes.count == js.keyframes.count
    np.testing.assert_array_equal(ts.keyframes.tstamp, js.keyframes.tstamp)
    assert len(ts.backend.closed_loop["idx_current"]) >= 1
    for k in ("idx_current", "idx_matched"):
        assert ts.backend.closed_loop[k] == js.backend.closed_loop[k]


def test_run_test_state_matches_jax(loop_runs):
    js, seams_j, ts, seams_t, _ = loop_runs
    n = js.keyframes.count
    kj, kt = js.keyframes, ts.keyframes
    np.testing.assert_allclose(kt.pose[:n, :3], kj.pose[:n, :3], atol=1e-2)
    flip = np.sign(np.sum(kj.pose[:n, 3:] * kt.pose[:n, 3:], -1,
                          keepdims=True))
    np.testing.assert_allclose(kt.pose[:n, 3:] * flip, kj.pose[:n, 3:],
                               atol=1e-2)
    np.testing.assert_allclose(kt.depth[:n], kj.depth[:n], atol=1e-2)
    B = (n + SUBMAP_SIZE - 1) // SUBMAP_SIZE
    np.testing.assert_allclose(kt.submap_pts[:B].numpy(),
                               np.asarray(kj.submap_pts)[:B], atol=1e-2)
    np.testing.assert_allclose(seams_t, seams_j, atol=2e-3)


def test_run_test_closure_lowers_its_objective(loop_runs):
    """Across each closure the loop error and the PGO objective (seam +
    loop error) fall. Under GT injection with mapping off the seams are
    exact before the closure (both sides of a seam come from the same
    ground-truth depth and stored pose), so the closure trades seam error
    for loop error; with two submaps the L1 trade is nearly one for one
    (measured: seam 0 -> 0.015, loop 0.048 -> 0.032)."""
    _, _, ts, errs, gt = loop_runs
    assert errs
    for seam0, loop0, seam1, loop1 in errs:
        assert loop1 < 0.8 * loop0, errs
        assert seam1 + loop1 < seam0 + loop0, errs
    assert e2e._ate(ts, gt) < 0.075       # the JAX suite's absolute gate
