"""The prior cell ``omni_track`` on the CPU at 64x96 (DroidNet and Omnidata
at their published widths; the program computes in float32 there): a
sound run is correct and the control (the Omnidata reference under
bfloat16 autocast, DROID's reference in bfloat16) is not; each planted
fault that changes the network's output fails; a program whose system
holds no Omnidata prior stops before any frame; the networks run the
benchmark's draw; the metrics' arithmetic; ``omnidata_roofline``'s
counts. The readings at the cell's own
size, on the card, are in PERF.md."""
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from port_bench import harness
from port_bench import omnidata_roofline as OR
from port_bench.peaks import PEAK_BYTES, PEAK_FP32

SEED = 2 ** 33 + 41
LAST = 24


def _cell():
    cell = harness.load_cell("omni_track")
    cell.config["hw"] = [64, 96]
    cell.traffic["frames"] = 40
    cell.traffic["warmup"]["frames"] = 2
    return cell


def _run(cell=None, **kw):
    return harness.driver("omni_stream").run(cell or _cell(), SEED, 1e9,
                                             False, "cpu", last_frame=LAST,
                                             **kw)


@pytest.fixture(scope="module")
def cell_run():
    cell = _cell()
    return cell, _run(cell)


@pytest.fixture(scope="module")
def sound(cell_run):
    return cell_run[1]


def test_a_sound_run_is_correct_and_the_control_is_not(cell_run):
    cell, sound = cell_run
    report = sound["check"].report()
    assert all(v["value"] is not None for v in report.values()), report
    assert sound["check"].correct, report
    assert sound["readings"]["prior_keyframes"] == sound["readings"][
        "keyframes"] == LAST // 2 + 1
    assert sound["check"].extra["prior_compared"] == 3
    control = harness.driver("omni_stream").controls(cell, sound, "cpu")
    assert not control.correct, control.report()
    for k in ("prior_depth", "prior_normal", "vit_tokens"):
        assert control.values[k] > control.limits[k], control.report()


@pytest.mark.parametrize("fault", ["hook_blocks_7_11",
                                   "pos_grid_not_resized", "same_symmetric",
                                   "prev_keyframe_image"])
def test_each_fault_fails_the_check(fault):
    out = _run(fault=fault)
    assert not out["check"].correct, out["check"].report()


def test_unbiased_standardization_leaves_the_output_unchanged(sound):
    """GroupNorm follows every standardized convolution and takes out the
    filters' common gain sqrt((n - 1) / n): the fault moves the maps by
    rounding only, so no check of the output can see it."""
    out = _run(fault="std_unbiased")
    for k in ("prior_depth", "prior_normal", "vit_tokens"):
        assert out["check"].values[k] < 1e-3 < sound["check"].limits[k]


def test_a_program_without_the_prior_stops_before_any_frame(monkeypatch):
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    frames, run = [], SLAMSystem.run
    monkeypatch.setattr(SLAMSystem, "run", lambda self, t, *a, **k:
                        frames.append(t) or run(self, t, *a, **k))
    drv = harness.driver("omni_stream")
    cell = _cell()
    cell.config["slam"]["Tracking"]["motion_filter"]["use_prior"] = False
    with pytest.raises(drv.PriorMissing):
        drv.run(cell, SEED, 1e9, False, "cpu", last_frame=LAST)
    assert frames == []


def test_the_networks_run_the_benchmarks_draw(sound):
    """What the window's networks held is the benchmark's draw for the
    seed (``draw``), not the program's own (``random_omnidata``, another
    scheme from the same seed and gains)."""
    drv = harness.driver("omni_stream")
    want = drv.draw(_cell(), SEED, "cpu")
    nets = sound["prior_recorder"].nets
    assert sorted(nets) == ["depth", "normal"]
    for task, net in nets.items():
        got = net.state_dict()
        assert sorted(got) == sorted(want[task])
        assert all(torch.equal(got[k], want[task][k]) for k in got), task
    assert not torch.equal(want["depth"]["pretrained.model.pos_embed"],
                           want["normal"]["pretrained.model.pos_embed"])
    from cut3r_slam_tpu_torch.models.omnidata import random_omnidata
    pc = _cell().config["prior"]
    own = random_omnidata("depth", SEED + pc["seed_offset"], "cpu",
                          **pc["init"]["depth"]).state_dict()
    assert not torch.equal(own["pretrained.model.pos_embed"],
                           want["depth"]["pretrained.model.pos_embed"])


def test_metrics_read_the_run(sound):
    cell = _cell()
    r = dict(sound["readings"])
    got = harness.read_metrics(cell.per_layer, r)
    assert set(got) == {"mfu.droid"}           # the CPU run has no trace
    least = OR.least_s("depth", 384, 512) + OR.least_s("normal", 384, 512)
    r.update(prior_trace={"device_s": 0.012, "keyframes": 1,
                          "least_s": least},
             prior_least_s=200 * least, least_s=0.5, window_s=45.0,
             trace={"busy_s": 0.1, "window_s": 0.25},
             droid_trace={"updates": 6, "edges": 300,
                          "update_device_s": 0.03, "lookup_device_s": 0.002,
                          "lookup_bytes": 6.7e6})
    got = {k: v["value"] for k, v in
           harness.read_metrics(cell.per_layer, r).items()}
    assert got["prior_ms_per_keyframe.prior"] == pytest.approx(12.0)
    assert got["prior_roofline.prior"] == pytest.approx(100 * least / 0.012)
    assert got["mfu.prior"] == pytest.approx(
        100 * (0.5 + 200 * least) / 45.0)
    assert got["mfu.droid"] == pytest.approx(100 * 0.5 / 45.0)
    assert got["device_idle.droid"] == pytest.approx(60.0)
    assert got["droid_ms_per_update.droid"] == pytest.approx(5.0)
    assert got["corr_lookup_roofline.droid"] == pytest.approx(
        100 * 6.7e6 / PEAK_BYTES / 0.002)


def test_roofline_counts_the_published_network():
    c = OR.counts("depth", 384, 512)
    assert c["params"] == 121_196_289
    assert (c["conv"] + c["matmul"]) / 1e9 == pytest.approx(345.7, abs=0.05)
    assert c["conv"] / 1e9 == pytest.approx(189.6, abs=0.05)
    assert c["matmul"] / 1e9 == pytest.approx(156.1, abs=0.05)
    least = OR.least_s("depth", 384, 512)
    assert least == pytest.approx(c["conv"] / OR.PEAK_TF32
                                  + c["matmul"] / PEAK_FP32)
    assert least == pytest.approx(2.71e-3, abs=5e-6)
    assert least > 4 * c["params"] / PEAK_BYTES
    # the normal head's three channels add only its last 1x1 convolution
    n = OR.counts("normal", 384, 512)
    assert n["conv"] - c["conv"] == 2 * 32 * 2 * 384 * 512
    assert n["matmul"] == c["matmul"]


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom port_bench.reference import omnidata\n"
         "from port_bench import omnidata_roofline\n"
         "omnidata_roofline.counts('depth', 64, 64)\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout
    for name in ("'jax'", "'flax'", "'cut3r_slam_tpu'",
                 "'cut3r_slam_tpu_torch'"):
        assert name not in loaded
