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
import threading

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


_F32_LOCK = threading.Lock()
_F32_DEPTH = 0
_F32_SAVED = None


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products and convolutions at float32 accuracy inside
    the block (or the decorated function), the caller's settings restored
    after: no TF32, and torch's own convolutions in place of cuDNN, whose
    float32 backward algorithms left the card's training gradients far
    from a float64 oracle (scripts/f64_oracle_card.py). The mapping path,
    the kernel parity checks and the card-vs-CPU training checks run under
    it: the TPU kernels run their contractions at Precision.HIGHEST.

    The settings are process-wide, so the blocks are counted across
    threads (the live viewer renders from its server thread): the first
    block to enter saves and sets them, the last to leave restores them."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        if _F32_DEPTH == 0:
            _F32_SAVED = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32,
                          torch.backends.cudnn.enabled)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.enabled = False
        _F32_DEPTH += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_DEPTH -= 1
            if _F32_DEPTH == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.enabled) = _F32_SAVED
