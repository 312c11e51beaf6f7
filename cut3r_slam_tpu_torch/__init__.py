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

__all__ = ["resolve_device", "full_f32", "default_precision"]


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


_PREC_LOCK = threading.Lock()
_PREC_DEPTH = {"f32": 0, "default": 0}
_PREC_SAVED = None
# (matmul TF32, cuDNN TF32, cuDNN enabled) of each pinned precision
_PREC_FLAGS = {"f32": (False, False, False), "default": (False, True, True)}


def _backend_flags(values=None):
    b = torch.backends
    if values is None:
        return b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled = values


@contextlib.contextmanager
def _pinned(kind):
    """The process-wide flags of ``kind`` inside the block. The blocks are
    counted across threads (the live viewer renders from its server
    thread): the first block to enter saves the flags, the last to leave
    restores them, and while any ``full_f32`` block is open its flags
    hold."""
    global _PREC_SAVED

    def current():
        return _PREC_FLAGS["f32" if _PREC_DEPTH["f32"] else "default"]
    with _PREC_LOCK:
        if not any(_PREC_DEPTH.values()):
            _PREC_SAVED = _backend_flags()
        _PREC_DEPTH[kind] += 1
        _backend_flags(current())
    try:
        yield
    finally:
        with _PREC_LOCK:
            _PREC_DEPTH[kind] -= 1
            _backend_flags(current() if any(_PREC_DEPTH.values())
                           else _PREC_SAVED)


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products and convolutions at float32 accuracy inside
    the block (or the decorated function), the caller's settings restored
    after: no TF32, and torch's own convolutions in place of cuDNN, whose
    float32 backward algorithms left the card's training gradients far
    from a float64 oracle (scripts/f64_oracle_card.py). The mapping path,
    the kernel parity checks and the card-vs-CPU training checks run under
    it: the TPU kernels run their contractions at Precision.HIGHEST.
    Blocks on other threads count too (``_pinned``)."""
    with _pinned("f32"):
        yield


@contextlib.contextmanager
def default_precision():
    """PyTorch's default float32 precision inside the block, whatever the
    process holds: convolutions through cuDNN with TF32 allowed, matrix
    products in float32 with TF32 off (the precision under which
    Omnidata's and HI-SLAM2's public code run the monocular prior). While
    a ``full_f32`` block is open, on any thread, its flags hold: a caller
    that asked for float32 accuracy keeps it."""
    with _pinned("default"):
        yield
