"""The port's benchmark driver (``python -m cut3r_slam_tpu_torch.bench``)
against the repository's ``bench.py``, on the CPU.

(a) the frames are byte-identical to ``bench.py``'s: its ``synth_frames``
is taken out of its source with ``ast`` and run alone (importing
``bench.py`` would set JAX's process-wide persistent compilation cache);
(b) the two modes' SLAM configurations equal the dicts of ``bench.py``
(its lines 209-242), written out here;
(c) the CPU smoke mode over the fewest frames that complete a mapping
event (13: the first event starts at frame 12) prints lines whose last has
``bench.py``'s keys but ``new_compile_cache_entries``, with ``value``
recomputed from the timed frames, the warm / steady / mapping flags set,
the plain rasterizer and four finite micro-bench times; the timed pass
repeats the warm pass (events, slices, keyframes; one intra-op thread);
(d) without ``--cpu`` and without a GPU ``main`` raises from
``resolve_device`` before it prints anything: there is no CPU fallback.
"""
import ast
import contextlib
import io
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch import bench
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES = 13

# bench.py:209-211, then :230-234 (TPU) and :241-242 (CPU)
JAX_CFG_TPU = {"Tracking": {"motion_filter": {"kf_every": 2}},
               "Mapping": {"arena_capacity": 2 ** 17, "iterations": 100,
                           "parallel_kf_refine": True,
                           "gba_views_per_iter": 4, "gba_resample_every": 4,
                           "interleave": 3, "opt_early_stop": 0.01}}
JAX_CFG_CPU = {"Tracking": {"motion_filter": {"kf_every": 2}},
               "Mapping": {"arena_capacity": 2 ** 11, "iterations": 20,
                           "window_opt_iters": 10, "new_view_opt_iters": 10,
                           "gba_per_view": 2}}
# the keys bench.py's last line can hold: the result (:183-184, :306,
# :310, :359-361), the breakdown (:268, :285, :308-309, :329, :363-372,
# :411-417); the stage names are read from the JAX package below
JAX_TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "frames",
                "breakdown", "warm_pass", "fps_mean_incl_compiles",
                "steady_state", "mapping_included"}
JAX_BREAKDOWN_KEYS = {"sync_rtt_ms", "warmup_cut_at_frame", "warmup_s",
                      "new_compile_cache_entries", "timed_cut_at_frame",
                      "n_mapping_events", "n_mapping_frames", "max_frame_s",
                      "mapping_frame_s_mean", "fps_tracking_only",
                      "raster_fwd_ms", "raster_bwd_ms", "raster_bin_ms",
                      "raster_bwd_cached_bins_ms", "raster_backend"}
MICRO_KEYS = ("raster_fwd_ms", "raster_bwd_ms", "raster_bin_ms",
              "raster_bwd_cached_bins_ms")


def _jax_bench_function(name):
    src = (ROOT / "bench.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py",
                 "exec"), ns)
    return ns[name]


def _jax_stage_names():
    system = (ROOT / "cut3r_slam_tpu/slam/system.py").read_text()
    mapping = (ROOT / "cut3r_slam_tpu/slam/mapping.py").read_text()
    return set(re.findall(r'tm\("(\w+)"\)', system)) \
        | set(re.findall(r'"(map_\w+)"', mapping))


@pytest.mark.parametrize("n,H,W,seed", [(18, 32, 48, 0), (40, 384, 512, 0),
                                        (5, 24, 40, 3)])
def test_synth_frames_byte_identical(n, H, W, seed):
    ref = _jax_bench_function("synth_frames")(n, H, W, seed)
    got = bench.synth_frames(n, H, W, seed)
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint8 and a.shape == (H, W, 3)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("card", [True, False])
def test_modes_match_bench_py(card):
    m = bench.bench_mode(card)
    assert m["cfg"] == (JAX_CFG_TPU if card else JAX_CFG_CPU)
    # bench.py:166-179, :110 and :140 (the micro-bench's arena, iterations)
    assert (m["tiny"], m["hw"], m["n_frames"], m["micro_n"],
            m["micro_iters"], m["metric"]) == (
        (False, (384, 512), 40, 2 ** 17, 10, "slam_e2e_fps_512x384")
        if card else
        (True, (32, 48), 18, 2 ** 12, 2, "slam_e2e_fps_tiny_cpu"))


@pytest.mark.parametrize("case", [
    # (has_viz, slices, gen_before, gen_after) -> (mapping frame, events)
    ((False, 0, False, False), (False, 0)),   # tracking only
    ((True, 1, False, False), (True, 1)),     # a drained event
    ((True, 3, False, True), (True, 0)),      # an event starts, pending
    ((False, 3, True, True), (True, 0)),      # its slices continue
    ((False, 1, True, False), (True, 1)),     # its finishing slice alone
    ((False, 0, True, False), (False, 1)),    # the same, counted by JAX
    ((True, 5, True, True), (True, 1)),       # backlog drained, next starts
    ((True, 4, True, False), (True, 2)),      # both finish in the frame
])
def test_frame_accounting(case):
    """The per-frame rules of bench.py:344-353 (did_map and the two
    ``n_events_done`` increments)."""
    args, want = case
    assert bench.frame_accounting(*args) == want


@pytest.fixture(scope="module")
def cpu_run(few_threads):
    """The CPU smoke mode over N_FRAMES frames on one intra-op thread: with
    more, the CPU's threaded reductions round in another order in each
    pass, and the chaotic mapping event amplifies it (2 threads: keyframe
    poses 1e-3 to 1e-2 apart after one event; 1 thread: bitwise equal)."""
    out = io.StringIO()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            run = bench.run_bench("cpu", n_frames=N_FRAMES)
    finally:
        torch.set_num_threads(2)
    return [json.loads(line) for line in out.getvalue().splitlines()], run


def test_cpu_run_last_line(cpu_run):
    lines, run = cpu_run
    last = lines[-1]
    assert last == run["result"]
    assert lines[0]["value"] is None        # the heartbeat
    assert set(last) == JAX_TOP_KEYS
    bd = last["breakdown"]
    stages = _jax_stage_names()
    assert {"filter", "frontend", "mapping", "map_refine"} <= stages
    jax_keys = (JAX_BREAKDOWN_KEYS - {"new_compile_cache_entries"}) | stages
    assert set(bd) <= jax_keys, set(bd) - jax_keys
    assert {"sync_rtt_ms", "warmup_s", "n_mapping_events",
            "n_mapping_frames", "max_frame_s", "mapping_frame_s_mean",
            "fps_tracking_only", "raster_backend", *MICRO_KEYS,
            "filter", "frontend", "mapping"} <= set(bd)
    assert last["metric"] == "slam_e2e_fps_tiny_cpu"
    assert last["warm_pass"] and last["steady_state"] \
        and last["mapping_included"]
    assert last["frames"] == N_FRAMES and bd["n_mapping_events"] == 1
    frame_s = run["timed"]["frame_s"]
    assert len(frame_s) == N_FRAMES
    assert last["value"] == round(N_FRAMES / sum(frame_s), 3)
    assert last["vs_baseline"] == round(
        N_FRAMES / sum(frame_s) / bench.BASELINE_FPS, 3)
    assert bd["raster_backend"] == "plain"
    for k in MICRO_KEYS:
        assert math.isfinite(bd[k]) and bd[k] > 0, k
    # one line a warm frame from the third, one a timed frame from the
    # third, the stage means, the micro-bench (no interleaved backlog
    # to drain on the CPU schedule)
    assert len(lines) == 1 + 2 * (N_FRAMES - 2) + 2


def test_timed_pass_repeats_the_warm_pass(cpu_run):
    _, run = cpu_run
    warm, timed = run["warm"], run["timed"]
    assert timed["viz"] == warm["viz"]
    assert timed["slices"] == warm["slices"]
    assert [t for t, v in enumerate(timed["viz"]) if v] == [N_FRAMES - 1]
    assert timed["kf_count"] == warm["kf_count"] == 7
    assert timed["closures"] == warm["closures"] == 0
    np.testing.assert_allclose(timed["kf_pose"], warm["kf_pose"], atol=1e-6)


def test_no_cpu_fallback(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""
