"""The span probe's attribution on hand-made events: an operation, its
launch and a wait count to the innermost span open on any thread at the
launch's host time; ``LaunchProfile`` leaves ``Profile``'s events, and so
``reduce``, as they were; the five readings."""
import pytest
import torch

from port_bench import span_probe as sp
from port_bench.trace import Profile, reduce

# the main thread's map.iter > map.backward; the autograd engine's
# raster.blend_bwd opens on its own thread inside it
SPANS = [(0.0, 10.0, "map.iter"), (1.0, 8.0, "map.backward"),
         (2.0, 4.0, "raster.blend_bwd"), (12.0, 14.0, "map.iter")]
OPS = [("k2", 3.5, 4.5, 1), ("sort_bwd", 5.0, 7.0, 2),
       ("adam", 9.5, 9.8, 3), ("copy", 12.5, 12.6, 9), ("set", 12.0, 12.5, 4)]
CALLS = [(3.0, 1, "cudaLaunchKernel"), (5.0, 2, "cuLaunchKernel"),
         (9.0, 3, "cudaLaunchKernel"), (11.0, 4, "cudaMemsetAsync")]
WAITS = [(6.0, 7.0, "cudaStreamSynchronize", 1),
         (9.6, 9.8, "cudaStreamSynchronize", 1),
         (20.0, 21.0, "cudaDeviceSynchronize", 1)]


def test_innermost_span_on_any_thread():
    att = sp.attribute(SPANS, OPS, CALLS, WAITS, (0.0, 15.0),
                       inside=("map.iter", "map.backward"),
                       cpu_ops=[(5.9, 7.1, 1, "aten::item")])
    by = att["by_span"]
    assert by["raster.blend_bwd"] == {"device_s": 1.0, "launches": 1,
                                      "waits": 0}
    assert by["map.backward"] == {"device_s": 2.0, "launches": 1,
                                  "waits": 1}
    assert by["map.iter"]["launches"] == 1 and by["map.iter"]["waits"] == 1
    # counted at its call: the set was issued between the iterations; the
    # copy has no call in the trace and counts at its start
    assert by["map.iter"]["device_s"] == pytest.approx(0.3 + 0.1)
    assert by[sp.OUTSIDE] == {"device_s": 0.5, "launches": 0, "waits": 0}
    assert att["unlinked"] == 1
    assert att["inside"]["map.backward"] == {"device_s": 3.0,
                                             "launches": 2, "waits": 1}
    assert att["inside"]["map.iter"]["launches"] == 3
    assert att["inside"]["map.iter"]["waits"] == 2   # the third is outside
    assert att["calls"] == {"map.iter": 2, "map.backward": 1,
                            "raster.blend_bwd": 1}
    assert ["map.backward", "aten::item", 1] in att["wait_sites"]
    r = sp.readings(att, {"render.views.sorted": 6,
                          "render.views.nograd": 2})
    assert r == {"render_bwd_ms.map": 1500.0,
                 "map_launches_per_iter.map": 1.5,
                 "map_syncs_per_iter.map": 1.0,
                 "planned_gather_share.map": 0.0}
    assert sp.readings(att, {}, steps=2)[
        "train_launches_per_step.train"] == 1.5


def test_readings_missing_inputs():
    empty = sp.attribute([], [], [], [], (0.0, 1.0))
    assert sp.readings(empty, {}) == {}
    assert sp.readings(empty, {"render.views.nograd": 3}) == {}
    assert sp.readings(empty, {"render.views.planned": 1,
                               "render.views.sorted": 3}) == {
        "planned_gather_share.map": 25.0}


class _Event:
    def __init__(self, name, dev, s, e, cid=0, tid=1):
        self._v = (name, dev, s, e, cid, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return int(self._v[2] * 1e9)

    def duration_ns(self):
        return int((self._v[3] - self._v[2]) * 1e9)

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[0].startswith("pb:")


def _fake(prof, events):
    class P:
        pass
    prof._prof = P()
    prof._prof.profiler = P()
    prof._prof.profiler.kineto_results = P()
    prof._prof.profiler.kineto_results.events = lambda: events
    return prof


def test_launch_profile_keeps_what_profile_keeps():
    events = [_Event("pb:traced_window", 0, 0.0, 10.0),
              _Event("pb:map.iter", 0, 0.5, 9.0),
              _Event("pb:map.iter", 1, 0.6, 8.0),     # the device's echo
              _Event("cudaLaunchKernel", 0, 1.0, 1.1, 7),
              _Event("aten::mul", 0, 0.5, 1.25),
              _Event("cudaStreamSynchronize", 0, 2.0, 3.0, 8),
              _Event("mul_kernel", 1, 1.5, 2.5, 7),
              _Event("copy_kernel", 1, 4.0, 5.0, 9)]
    old = _fake(Profile(), events).finish()
    new = _fake(sp.LaunchProfile(), events).finish()
    assert new.events == old.events and new.window == old.window
    assert reduce(new.events, new.window) == reduce(old.events, old.window)
    assert new.ops == [("mul_kernel", 1.5, 2.5, 7),
                       ("copy_kernel", 4.0, 5.0, 9)]
    assert new.calls == [(1.0, 7, "cudaLaunchKernel"),
                         (2.0, 8, "cudaStreamSynchronize")]
    assert new.waits == [(2.0, 3.0, "cudaStreamSynchronize", 1)]
    assert new.cpu_ops == [(0.5, 1.25, 1, "aten::mul")]


def test_counting_spans_keep_counters():
    from cut3r_slam_tpu_torch.utils.profiling import attach, count, span
    t = sp.CountingSpans()
    prev = attach(t)
    try:
        with span("map.iter"):
            count("render.views.sorted", 4)
    finally:
        attach(prev)
    assert t.counts == {"map.iter": 1}
    assert t.counters == {"render.views.sorted": 4}


@pytest.mark.parametrize("cell", ["slam_map", "train_v4"])
def test_cost_runs_attach_for_the_whole_window(cell):
    """The timer attached in the ``on`` runs sees the program's spans,
    the SLAM driver's ``slam.timer = None`` notwithstanding; nothing is
    attached afterwards."""
    from conftest import tiny_cell
    from cut3r_slam_tpu_torch.utils import profiling
    res = sp.cost_runs(tiny_cell(cell), 5, 0.2, 1, device="cpu")
    assert len(res["on"]) == len(res["off"]) == 1
    assert res["span_calls"][0] > 0 and res["noop"]["span_ns"] < 1e4
    assert profiling.attach(None) is None
