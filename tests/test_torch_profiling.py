"""The port's tracer (``utils/profiling.py``) on the CPU.

* With nothing attached, ``span`` returns one shared no-op context and
  ``count`` records nothing.
* A ``StageTimer`` attached to a tiny ``SLAMSystem`` run (the production
  schedule of tests/test_torch_schedule.py, plus one global-BA render a
  view): ``map.iter`` opens inside the mapping slices and ``map.backward``
  inside ``map.iter``; ``map.iter``'s count is the number of
  iterations the schedule ran (one loss call each), and the
  ``render.views.*`` counters add up to the views the mapper rendered.
  No span below the ten synchronizing stages calls
  ``torch.cuda.synchronize``.
* Under a CPU ``torch.profiler`` every span is a range of the trace whose
  summed length matches the timer's total: the spans lie on the trace's
  clock.
* One tiny training step of each kind opens each ``train.*`` span.
"""
import contextlib
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.slam import mapping
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from cut3r_slam_tpu_torch.train import train_step as TS
from cut3r_slam_tpu_torch.utils import profiling
from cut3r_slam_tpu_torch.utils.profiling import (StageTimer, attach, count,
                                                  span)
from test_torch_batched_mapping import (CFG as MAP_CFG, K4 as MAP_K4,
                                        _make_scene,
                                        few_threads)  # noqa: F401 (autouse)
from test_torch_schedule import CFG, MAP_EXTRA, _drive
from test_torch_slam_slice import H, W, _frames
from test_torch_train_step import procedural_batches, torch_from_flat
from test_torch_cut3r_train import jax_tiny_params

# the stages ``timed`` synchronizes; every other span must not
STAGES = {"filter", "frontend", "loop_backend", "mapping", "map_refine",
          "map_seed", "map_window", "map_polish", "map_gba", "map_update"}
SLICES = {"map_refine", "map_window", "map_polish", "map_gba"}


class NestingTimer(StageTimer):
    """A ``StageTimer`` that also keeps, for each span, the spans it
    opened inside (``parents``) and the stack of open spans."""

    def __init__(self):
        super().__init__()
        self.stack = []
        self.parents = defaultdict(set)

    @contextlib.contextmanager
    def __call__(self, stage):
        self.parents[stage].add(self.stack[-1] if self.stack else None)
        self.stack.append(stage)
        try:
            with super().__call__(stage):
                yield
        finally:
            self.stack.pop()


@pytest.fixture
def detached():
    """Nothing attached inside the test; the previous timer after it."""
    prev = attach(None)
    yield
    attach(prev)


def test_nothing_attached_is_a_shared_noop(detached):
    a, b = span("map.iter"), span("raster.blend")
    assert a is b is profiling._NOOP
    with a:
        with b:
            pass
    assert count("render.views.grad", 3) is None
    t = StageTimer()
    with span("x"):
        count("y")
    assert not t.totals and not t.counts and not t.counters
    # attached, the same calls reach the timer
    attach(t)
    with span("x"):
        count("y", 2)
    assert t.counts == {"x": 1} and t.counters == {"y": 2}


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    """(timer, mapping iterations, views rendered by the mapper) of a tiny
    SLAM run with the timer attached through ``SLAMSystem.timer``."""
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flatten_dict(params["params"],
                                                    sep="/")))
    cfg = dict(CFG, Mapping=dict(CFG["Mapping"], gba_per_view=1))
    slam = SLAMSystem(tm, cfg, buffer=32, img_hw=(H, W), enable_loop=False,
                      output_dir=str(tmp_path_factory.mktemp("slam")),
                      device="cpu")
    slam._map_cfg_extra.update(MAP_EXTRA)
    timer = NestingTimer()
    seen = {"iters": 0, "views": 0}
    MB = mapping.MappingBackend

    def counted(key, fn, n_views=None):
        def wrapped(*a, **k):
            seen[key] += 1 if n_views is None else n_views(*a, **k)
            return fn(*a, **k)
        return wrapped

    def synchronize(*a, **k):
        open_ = [s for s in timer.stack if s not in STAGES]
        raise AssertionError(f"torch.cuda.synchronize inside {open_}")

    orig = {"_window_loss": MB._window_loss, "_gba_batch": MB._gba_batch,
            "_pose_losses": MB._pose_losses}
    patches = {
        (MB, name): counted("iters", fn) for name, fn in orig.items()}
    patches[(mapping, "render_window")] = counted(
        "views", mapping.render_window,
        lambda params, alive, w2c, *a, **k: int(w2c.shape[0]))
    patches[(mapping, "render_view")] = counted(
        "views", mapping.render_view, lambda *a, **k: 1)
    patches[(torch.cuda, "synchronize")] = synchronize
    saved = {key: getattr(*key) for key in patches}
    prev = attach(None)
    try:
        for (obj, name), fn in patches.items():
            setattr(obj, name, fn)
        slam.timer = timer
        assert profiling._timer is timer
        _drive(slam, _frames())
    finally:
        for (obj, name), fn in saved.items():
            setattr(obj, name, fn)
        attach(prev)
    return timer, seen["iters"], seen["views"]


def test_mapping_spans_nest_and_count(slam_run):
    timer, iters, views = slam_run
    assert timer.parents["map.iter"] <= SLICES, timer.parents["map.iter"]
    assert timer.parents["map.iter"] >= {"map_refine", "map_window",
                                         "map_gba"}
    for inner in ("map.bin", "map.loss", "map.backward", "map.adam"):
        assert timer.parents[inner] == {"map.iter"}, inner
    assert timer.parents["map.render"] <= {"map.iter", "map_refine",
                                           "map_update"}
    assert "map.iter" in timer.parents["map.render"]
    for inner in ("raster.preprocess", "raster.pack", "raster.blend"):
        assert timer.parents[inner] == {"map.render"}, inner
    # on the CPU the backward runs on the calling thread, inside its span
    assert timer.parents["raster.blend_bwd"] == {"map.backward"}
    assert timer.counts["map.iter"] == iters > 0
    got = {k: v for k, v in timer.counters.items()
           if k.startswith("render.views.")}
    assert sum(got.values()) == views > 0
    # one gradient path and one without: the mapper hands no bin plan to a
    # render, and no render counts another path
    assert got.keys() == {"render.views.grad", "render.views.nograd"}
    assert got["render.views.grad"] > 0 and got["render.views.nograd"] > 0


def test_tracking_spans_and_stages(slam_run):
    timer = slam_run[0]
    assert timer.counts["cut3r.encode"] > 0
    assert timer.counts["cut3r.decode"] == timer.counts["cut3r.heads"] > 0
    assert timer.parents["cut3r.decode"] == {"frontend"}
    assert STAGES - {"loop_backend"} <= set(timer.counts)


def _mapper():
    """A port mapper with two keyframes of one scene and a map seeded from
    the first (tests/test_torch_batched_mapping.py's scene)."""
    img, depth = _make_scene()
    mb = mapping.MappingBackend(mapping.MappingConfig(
        **MAP_CFG, gba_views_per_iter=2, gba_resample_every=2,
        gba_segment=2), MAP_K4, device="cpu")
    for i in range(2):
        mb.add_keyframe(i, img, depth, np.eye(4, dtype=np.float32))
    fx, fy, cx, cy = MAP_K4
    yy, xx = np.meshgrid(np.arange(depth.shape[0]),
                         np.arange(depth.shape[1]), indexing="ij")
    pm = np.stack([(xx - cx) / fx * depth, (yy - cy) / fy * depth, depth],
                  -1).astype(np.float32)
    mb.seed(0, pm[::2, ::2], img[::2, ::2].astype(np.float32) / 255.0,
            np.ones(pm[::2, ::2].shape[:2], bool), 0)
    mb.current_window = [0, 1]
    return mb


def test_spans_lie_on_the_profiler_clock(detached, tmp_path):
    """Each span's summed ``record_function`` range against the timer's
    total, over mapping iterations of every kind and two training
    steps."""
    from torch.profiler import ProfilerActivity, profile
    mb = _mapper()
    tm = torch_from_flat(jax_tiny_params())
    opt = TS.make_optimizer(tm.parameters(), lr=1e-4, warmup_steps=0,
                            total_steps=10)
    step = TS.make_train_step(tm, opt)
    batch = procedural_batches(str(tmp_path), 2, 1, seed=0)[0]
    step(batch)                                   # warm the allocator
    timer = StageTimer()
    attach(timer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mb.pose_refine(1)
        mb.optimization(2, [0, 1])
        mb.global_ba(4, densify=False)
        for _ in range(2):
            step(batch)
    attach(None)
    ranges = defaultdict(float)
    for e in prof.events():
        if e.name in timer.totals:
            ranges[e.name] += e.time_range.elapsed_us() * 1e-6
    assert set(ranges) == set(timer.totals) >= {
        "map.iter", "map.bin", "map.render", "map.loss", "map.backward",
        "map.adam", "raster.preprocess", "raster.pack", "raster.blend",
        "raster.blend_bwd", "train.forward", "train.loss", "train.backward",
        "train.optimizer", "cut3r.encode", "cut3r.decode", "cut3r.heads"}
    for name, total in timer.totals.items():
        assert ranges[name] == pytest.approx(total, rel=0.05), name


@pytest.mark.parametrize("tbptt", [False, True])
def test_train_step_opens_each_span(tbptt, detached, tmp_path):
    tm = torch_from_flat(jax_tiny_params())
    opt = TS.make_optimizer(tm.parameters(), lr=1e-4, warmup_steps=0,
                            total_steps=10)
    step = TS.make_tbptt_train_step(tm, opt, chunk=1, grad_chunks=1) \
        if tbptt else TS.make_train_step(tm, opt)
    batch = procedural_batches(str(tmp_path), 2, 1, seed=0)[0]
    timer = NestingTimer()
    attach(timer)
    step(batch)
    attach(None)
    for name in ("train.forward", "train.loss", "train.backward",
                 "train.optimizer"):
        assert timer.counts[name] == 1, name
    assert timer.parents["train.loss"] == (
        {"train.forward"} if tbptt else {None})
    assert timer.parents["cut3r.encode"] == {"train.forward"}
