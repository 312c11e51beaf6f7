"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes on the same inputs."""
from __future__ import annotations

import torch

__all__ = ["rel_gap", "centered_gap", "rel_gap_by_leaf", "norm_gap_by_leaf",
           "Check"]


def rel_gap(got, ref) -> float:
    """||got - ref|| / ||ref|| over the whole tensor, in float64."""
    got, ref = got.double(), ref.double()
    den = torch.linalg.vector_norm(ref)
    return float(torch.linalg.vector_norm(got - ref) / torch.clamp(den,
                                                                   min=1e-30))


def centered_gap(got, ref, dims) -> float:
    """||got - ref|| over the norm of ``ref`` less its mean over ``dims``:
    the gap against what varies in the reference, not against a constant
    that every answer shares (a pointmap's plane, an identity pose)."""
    got, ref = got.double(), ref.double()
    spread = torch.linalg.vector_norm(ref - ref.mean(dims, keepdim=True))
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.clamp(spread, min=1e-30))


def rel_gap_by_leaf(got, ref) -> float:
    """The worst leaf's ||got - ref|| over the larger of its reference
    norm and the median leaf's (a leaf whose true gradient is nought, as
    a quaternion's on an isotropic Gaussian, reads rounding on both
    sides)."""
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(norms)[len(norms) // 2]
    return max(float(torch.linalg.vector_norm(g.double() - r.double()))
               / max(n, med, 1e-30) for g, r, n in zip(got, ref, norms))


def norm_gap_by_leaf(got_norms: dict, ref_norms: dict, keep=None):
    """The worst leaf's |‖got‖ - ‖ref‖| over the larger of its reference
    norm and the median leaf's (the training check's measure); ``keep``
    names the leaves that count. Returns (gap, leaf)."""
    names = [k for k in ref_norms if keep is None or k in keep]
    ref = torch.tensor([ref_norms[k] for k in ref_norms], dtype=torch.float64)
    med = float(ref.median())
    worst, leaf = 0.0, None
    for k in names:
        gap = abs(got_norms[k] - ref_norms[k]) / max(ref_norms[k], med,
                                                     1e-30)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


class Check:
    """The numbers a run compares, each with its limit, in order;
    ``extra`` holds numbers that are read beside them and not compared."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values = {}
        self.extra = {}

    def add(self, name, value):
        if name not in self.limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        prev, value = self.values.get(name, 0.0), float(value)
        self.values[name] = max(prev, value) \
            if value == value and prev == prev else float("nan")

    @property
    def correct(self) -> bool:
        return bool(self.values) and set(self.values) == set(self.limits) \
            and all(v == v and v <= self.limits[k]
                    for k, v in self.values.items())

    def report(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]}
                for k in self.limits}
