"""Lazy nvcc build + ctypes loading of the port's CUDA kernels."""
from .build import SOURCES, build_all, load  # noqa: F401
