"""CPU tests of the port's benchmark (``python -m pytest port_bench/tests``).
Tests that need the card are marked ``cuda`` and decide inside the test."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# CUT3R's topology at a size the CPU runs in seconds
TINY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=48,
            dec_depth=4, dec_num_heads=2, state_size=16, state_dec_num_heads=2,
            local_mem_size=8)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(name):
    """The cell ``name`` cut to the CPU: tiny CUT3R in float32, 32x48,
    the mapper's counts cut (the shapes of what is compared, not its
    definition)."""
    from port_bench import harness
    cell = harness.load_cell(name)
    cell.config["model"]["widths"].update(TINY)
    cell.config["model"]["compute_dtype"] = "float32"
    cell.config["hw"] = [32, 48]
    m = cell.config.get("slam", {}).get("Mapping")
    if m is not None:
        m.update(arena_capacity=2 ** 12, iterations=4, pose_refine_iters=2,
                 window_opt_iters=2, new_view_opt_iters=2, gba_per_view=1)
        cell.traffic["frames"] = 40
    return cell
