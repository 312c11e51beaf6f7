"""PyTorch/CUDA port of ``cut3r_slam_tpu`` for NVIDIA Hopper (H100).

Same subpackage layout and public surface as the JAX package
(``geometry/ ops/ models/ slam/ train/ datasets/ utils/``):
``SLAMSystem.run/terminate``, ``MappingBackend``, ``CUT3R``,
``rasterize*``, ``train``. The two TPU tile-blend
kernels of ``ops/gs_raster_pallas.py`` are hand-written CUDA kernels here
(``csrc/gs_blend_fwd.cu``, ``csrc/gs_blend_bwd.cu``), built with ``nvcc``
on first CUDA use (``kernels/build.py``); every kernel has a plain PyTorch
version beside it that the CPU path runs.

Entry points take a ``device`` that defaults to ``"cuda"``; constructing
one without a GPU raises unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without a visible GPU
    raises: there is no silent CPU path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cut3r_slam_tpu_torch: device='cuda' requested but no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products and convolutions without TF32 inside the
    block (or the decorated function), the caller's settings restored
    after. The mapping path and the kernel parity checks run under it: the
    TPU kernels run their contractions at Precision.HIGHEST."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
