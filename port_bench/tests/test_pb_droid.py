"""The DROID tracking cell's check on the CPU at 64x96 (an 8x12 grid; the
program computes in float32 there): a sound run is correct, each planted
fault (the lookup without its per-level scale, one BA iteration in place
of two, the GRU's hidden state reset between iterations, every edge's
context taken from its frame j, the BA's damping without its 0.2, the BA
given none of the retired edges) and the control
(the reference in bfloat16 in the program's place) are not; the reference
against the port's modules; the per-layer metrics' arithmetic. The
readings at the cell's own size, on the card, are in PERF.md."""
import pytest
import torch

from port_bench import droid_roofline as R
from port_bench import harness
from port_bench.peaks import PEAK_BYTES
from port_bench.reference import droid as ref

SEED = 2 ** 33 + 29


def _cell():
    cell = harness.load_cell("droid_track")
    cell.config["hw"] = [64, 96]
    cell.traffic["frames"] = 40
    cell.traffic["warmup"]["frames"] = 2
    return cell


@pytest.fixture(scope="module")
def sound():
    cell = _cell()
    drv = harness.driver("droid_stream")
    return cell, drv, drv.run(cell, SEED, 1e9, False, "cpu", last_frame=30)


def test_a_sound_run_is_correct_and_the_control_is_not(sound):
    cell, drv, out = sound
    report = out["check"].report()
    assert all(v["value"] is not None for v in report.values()), report
    assert out["check"].correct, report
    control = drv.controls(cell, out, "cpu")
    assert not control.correct, control.report()


@pytest.mark.parametrize("fault", ["lookup_unscaled", "ba_one_iter",
                                   "gru_reset", "ctx_from_j", "ba_damping",
                                   "ba_no_inactive"])
def test_each_fault_fails_the_check(fault):
    cell = _cell()
    out = harness.driver("droid_stream").run(cell, SEED, 1e9, False, "cpu",
                                             fault=fault, last_frame=30)
    assert not out["check"].correct, out["check"].report()


def test_metrics_read_the_run(sound):
    cell, _, out = sound
    r = dict(out["readings"])
    got = harness.read_metrics(cell.per_layer, r)
    assert set(got) == {"mfu.droid"}           # the CPU run has no trace
    r["droid_trace"] = {"updates": 6, "edges": 300, "update_device_s": 0.03,
                        "lookup_device_s": 0.002, "lookup_bytes": 6.7e6}
    r["trace"] = {"busy_s": 0.1, "window_s": 0.4}
    got = harness.read_metrics(cell.per_layer, r)
    assert got["droid_ms_per_update.droid"]["value"] == pytest.approx(5.0)
    assert got["corr_lookup_roofline.droid"]["value"] == pytest.approx(
        100 * 6.7e6 / PEAK_BYTES / 0.002)
    assert got["device_idle.droid"]["value"] == pytest.approx(75.0)


def test_the_reference_matches_the_ports_modules():
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    from cut3r_slam_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup
    sd = ref.draw_state_dict(4, "cpu")
    port = DroidNet(device="cpu")
    port.load_state_dict(sd, strict=True)
    r = ref.DroidNet()
    r.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(1)
    img = torch.rand(2, 64, 96, 3, generator=g) * 255
    with torch.no_grad():
        a = port.extract_features(img)
        b = r.encode(img)
        for x, y in zip(a, b):
            assert float((x - y).norm() / y.norm()) < 1e-5
        fm = b[0]
        coords = torch.rand(1, 8, 12, 2, generator=g) * 12 - 2
        pa = corr_lookup(build_corr_pyramid(fm[:1].permute(0, 2, 3, 1),
                                            fm[1:].permute(0, 2, 3, 1)),
                         coords)
        pb = ref.lookup(ref.pyramid(fm[:1], fm[1:]), coords)
        assert float((pa - pb).norm() / pb.norm()) < 1e-5


def test_lookup_bytes_count_the_distinct_window_cells():
    # at a 48x64 grid every level holds a whole 8x8 window but the last
    # (6x8 = 48 cells); fp16 cells, float32 coordinates, fp16 out
    per_px = (64 + 64 + 64 + 48) * 2 + 8 + 196 * 2
    assert R.lookup_bytes(3, 48, 64) == 3 * 48 * 64 * per_px
    fnet, cnet = R.encoder_flops(384, 512)
    assert fnet > 0 and cnet > fnet     # cnet's last projection is wider
    edge, frame = R.update_flops(48, 64)
    assert edge > 10 * frame > 0
