"""The SLAM system on the JAX package's production mapping schedule
(``Mapping.interleave`` 3, ``parallel_kf_refine``, ``opt_early_stop``
0.01, the batched global-BA keys), the port vs the JAX package on the
CPU: the drifting sequence, tiny CUT3R and mapping cuts of
tests/test_torch_slam_slice.py, with a two-view window and one iteration
a segment. ``gba_per_view=0``
keeps every random
draw out of the run (tests/test_torch_gba_blocks.py holds the
batched global BA).

The events and the mapping slices run in each frame agree (the port also
counts the slice that finishes an event, test_step_mapper_counts_the_
final_slice); the written-back keyframe poses and depths agree to 1e-2
(tests/test_torch_slam_slice.py's tolerance). ``reset_state`` then a
second pass over the same frames repeats the first pass: the same events
and slices, keyframes to 1e-6, Gaussians to float rounding.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.bench import frame_accounting
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from cut3r_slam_tpu_torch.utils.profiling import StageTimer
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)
from test_torch_slam_slice import CFG as SLICE_CFG, H, K4, W, _frames

SCHEDULE = {"parallel_kf_refine": True, "gba_views_per_iter": 4,
            "gba_resample_every": 4, "interleave": 3, "opt_early_stop": 0.01}
# a two-view window and one-iteration segments keep the JAX side's CPU
# renders affordable
CFG = dict(SLICE_CFG, Mapping=dict(SLICE_CFG["Mapping"], window_size=2,
                                   iterations=2, window_opt_iters=1,
                                   new_view_opt_iters=1, **SCHEDULE))
MAP_EXTRA = {"pose_refine_iters": 2, "opt_segment": 1}


def _drive(slam, frames):
    """(events as (frame, keyframes), mapping slices per frame, the bench's
    per-frame accounting inputs (new submap, slices, an interleaved event
    pending before and after)) of one pass, then terminate."""
    events, slices, acct = [], [], []
    for t, f in enumerate(frames):
        gen_before = slam._map_gen is not None
        _, viz = slam.run(t, f, K4, last=(t == len(frames) - 1))
        slices.append(slam.frame_map_slices)
        acct.append((viz is not None, slam.frame_map_slices, gen_before,
                     slam._map_gen is not None))
        if viz is not None:
            events.append((t, list(viz)))
    slam.terminate(len(frames) - 1, eval_render=False, export_renders=False)
    return events, slices, acct


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = _frames()
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    js = JSLAM(jm, params, CFG, buffer=32, img_hw=(H, W), enable_loop=False,
               output_dir=str(tmp_path_factory.mktemp("jax")))
    js._map_cfg_extra.update(MAP_EXTRA)
    out_j = _drive(js, frames)
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flatten_dict(params["params"],
                                                    sep="/")))
    ts = SLAMSystem(tm, CFG, buffer=32, img_hw=(H, W), enable_loop=False,
                    output_dir=str(tmp_path_factory.mktemp("torch")),
                    device="cpu")
    ts._map_cfg_extra.update(MAP_EXTRA)
    ts.timer = StageTimer()
    out_t = _drive(ts, frames)
    first = (ts.keyframes.pose.copy(), ts.keyframes.depth.copy(),
             ts.mapper.arena.xyz.clone())
    ts.reset_state()
    out_r = _drive(ts, frames)
    return js, out_j, ts, out_t, first, out_r


def test_schedule_events_and_slices(runs):
    js, (ev_j, sl_j, _), ts, (ev_t, sl_t, _), _, _ = runs
    assert ts.map_interleave == 3 and ts.mapper.cfg.parallel_kf_refine
    assert ts.mapper.cfg.gba_views_per_iter == 4
    assert ev_t == ev_j and len(ev_t) == 2
    # no frame without a new submap runs more than `interleave` slices; the
    # event spans frames
    t0, t1 = [t for t, _ in ev_t]
    assert all(n <= 3 for n in sl_t[:t1]) and sl_t[t0] == 3, sl_t
    busy = [t for t, n in enumerate(sl_t[:t1]) if n]
    assert busy == list(range(t0, busy[-1] + 1)) and len(busy) > 1, sl_t
    diff = np.asarray(sl_t) - np.asarray(sl_j)
    # the port counts the slice that finishes event 1, once, on the frame
    # it finishes; every other frame agrees
    assert sorted(diff.tolist()) == [0] * (len(diff) - 1) + [1]
    # the attached stage timer saw every stage of the schedule (the JAX
    # package's names); the mapper shares the system's timer
    timing = ts.timer.summary()
    assert ts.mapper.timer is ts.timer
    for stage in ("filter", "frontend", "mapping", "map_refine", "map_seed",
                  "map_window", "map_polish", "map_update"):
        assert timing[stage]["calls"] > 0 and \
            np.isfinite(timing[stage]["mean_ms"]), stage


def test_bench_accounting_against_jax(runs):
    """``cut3r_slam_tpu_torch.bench``'s per-frame accounting on both
    systems' runs: the same mapping events; the port's mapping frames
    exceed JAX's by at most one an event, each such frame one whose only
    slice finished a pending event (the port counts that slice, the JAX
    ``step_mapper`` does not: test_step_mapper_counts_the_final_slice).
    Here the finishing slice shares its frame with others, so the mapping
    frames agree; tests/test_torch_bench.py::test_frame_accounting holds
    the lone finishing slice."""
    _, (_, _, acct_j), _, (_, _, acct_t), _, _ = runs
    assert [a[0::2] for a in acct_t] == [a[0::2] for a in acct_j]
    res_j = [frame_accounting(*a) for a in acct_j]
    res_t = [frame_accounting(*a) for a in acct_t]
    events = sum(d for _, d in res_t)
    assert events == sum(d for _, d in res_j) >= 1
    extra = [t for t, ((mt, _), (mj, _)) in enumerate(zip(res_t, res_j))
             if mt != mj]
    assert all(res_t[t][0] and not res_j[t][0] for t in extra)
    assert len(extra) <= events
    for t in extra:
        has_viz, n_t, before, after = acct_t[t]
        assert (has_viz, n_t, acct_j[t][1], before, after) == \
            (False, 1, 0, True, False), (t, acct_t[t], acct_j[t])


def test_schedule_written_back_state(runs):
    js, _, ts, _, first, _ = runs
    n = js.keyframes.count
    assert n == ts.keyframes.count == 12
    assert int(ts.mapper.cams.valid.sum()) == 11
    np.testing.assert_allclose(first[0][:n, :3], js.keyframes.pose[:n, :3],
                               atol=1e-2)
    qj, qt = js.keyframes.pose[:n, 3:], first[0][:n, 3:]
    flip = np.sign(np.sum(qj * qt, -1, keepdims=True))
    np.testing.assert_allclose(qt * flip, qj, atol=1e-2)
    np.testing.assert_allclose(first[1][:n], js.keyframes.depth[:n],
                               atol=1e-2, rtol=1e-2)


def test_reset_state_repeats_the_pass(runs):
    _, _, ts, out_t, first, out_r = runs
    assert out_r == out_t
    n = ts.keyframes.count
    np.testing.assert_allclose(ts.keyframes.pose[:n], first[0][:n],
                               atol=1e-6)
    np.testing.assert_allclose(ts.keyframes.depth[:n], first[1][:n],
                               atol=1e-6)
    # the pack-gather backward accumulates in thread order: the Gaussians
    # repeat to well under one Adam step of position (1.6e-4)
    np.testing.assert_allclose(ts.mapper.arena.xyz.numpy(),
                               first[2].numpy(), atol=1e-4)


def test_step_mapper_counts_the_final_slice():
    """Deliberate divergence (ROADMAP §3): the JAX ``step_mapper``
    (system.py:436-442) does not count the slice whose ``StopIteration``
    ends an event, though that slice ran the event's ``data_update``; the
    port counts it. The same three-slice event on both: JAX 2, port 3."""
    def event():
        yield "refine"
        yield 0
        return None

    counts = {}
    for name, step in (("jax", JSLAM.step_mapper),
                       ("port", SLAMSystem.step_mapper)):
        me = types.SimpleNamespace(_map_gen=event(), frame_map_slices=0,
                                   _apply_map_update=lambda upd: None)
        step(me, 5)
        assert me._map_gen is None
        counts[name] = me.frame_map_slices
    assert counts == {"jax": 2, "port": 3}
