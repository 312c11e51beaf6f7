"""The least time of an Omnidata DPT-Hybrid forward on the card: its
operations counted by ``FlopCounterMode`` on the reference network
(``reference/omnidata.py``) on the ``meta`` device, the convolutions at
the TF32 tensor cores' dense peak (the configuration runs them through
cuDNN with TF32 allowed) and the matrix products at the float32 peak
(TF32 off), their sum or, if larger, the float32 weights read once at
the HBM rate."""
from __future__ import annotations

from functools import lru_cache

from port_bench.peaks import PEAK_BYTES, PEAK_FP32

__all__ = ["PEAK_TF32", "counts", "least_s"]

PEAK_TF32 = 494.7e12   # FLOP/s, TF32 tensor cores, dense (H100 SXM sheet)
MATMUL_OPS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


@lru_cache(maxsize=8)
def counts(task: str, H: int, W: int) -> dict:
    """{"conv": FLOP of the convolutions, "matmul": FLOP of the matrix
    products, "params": parameters} of one forward of ``task`` on one
    (H, W) image at the published widths."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from port_bench.reference.omnidata import OmnidataDPT
    with torch.device("meta"):
        net = OmnidataDPT(task)
    img = torch.zeros(1, H, W, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        net(img)
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    out = {"conv": sum(v for k, v in by_op.items() if "convolution" in k),
           "matmul": sum(by_op.get(k, 0) for k in MATMUL_OPS),
           "params": sum(p.numel() for p in net.parameters())}
    other = set(by_op) - set(MATMUL_OPS) - {k for k in by_op
                                            if "convolution" in k}
    if other:
        raise ValueError(f"operations counted under no peak: {other}")
    return out


def least_s(task: str, H: int, W: int) -> float:
    """The least time of one forward: max(conv / PEAK_TF32 + matmul /
    PEAK_FP32, 4 x params / PEAK_BYTES)."""
    c = counts(task, H, W)
    return max(c["conv"] / PEAK_TF32 + c["matmul"] / PEAK_FP32,
               4.0 * c["params"] / PEAK_BYTES)
