"""The check against broken programs: a run of each cell with the timed
path intact comes out correct, and with each fault the cell can have
planted underneath (a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced) it comes out not
correct. On the CPU at a tiny size; the harness's look for a card is
skipped, the rest of a run is driven as on the card. The exchange
between chips does not exist in these one-card cells."""
import pytest

from conftest import tiny_cell
from port_bench import harness

SEED = 2 ** 33 + 17


def _slam(fault):
    cell = tiny_cell("slam_map")
    drv = harness.driver("slam_stream")
    return drv.run(cell, SEED, 1e9, False, "cpu", fault=fault,
                   last_frame=23)


def _train(fault):
    cell = tiny_cell("train_v4")
    return harness.driver("train_steps").run(cell, SEED, 0.1, False, "cpu",
                                             fault=fault)


@pytest.mark.parametrize("run", [_slam, _train], ids=["slam_map", "train_v4"])
@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "answer_altered"])
def test_correct_only_without_a_fault(run, fault):
    out = run(fault)
    report = out["check"].report()
    assert all(v["value"] is not None for v in report.values()), report
    assert out["check"].correct == (fault is None), report
