"""YAML config loading with recursive ``inherit_from`` merge + calib parsing
(the port's own copy of ``cut3r_slam_tpu/utils/config.py``). Calib files
hold ``fx fy cx cy [k1 k2 p1 p2 k3]``."""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

__all__ = ["load_config", "load_calib", "DEFAULT_CONFIG"]


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Dict[str, Any]:
    """Load YAML, recursively resolving ``inherit_from`` parents."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("inherit_from", None)
    if parent:
        if not os.path.isabs(parent):
            parent = os.path.join(os.path.dirname(path), os.path.basename(parent))
            if not os.path.exists(parent):
                parent = os.path.join(os.path.dirname(path), "..",
                                      cfg.get("inherit_from", ""))
        base = load_config(parent)
        cfg = _merge(base, cfg)
    return cfg


def load_calib(path: str) -> np.ndarray:
    """Returns [fx, fy, cx, cy, (k1 k2 p1 p2 k3 if present)]."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


# defaults of the live config schema (config/base_config.yaml)
DEFAULT_CONFIG: Dict[str, Any] = {
    "Dataset": {"type": "generic"},
    "Tracking": {
        "motion_filter": {"skip": 5, "thresh": 0.9},
        "frontend": {"warmup": 6, "submap_size": 5},
        "backend": {"loop_iters": 2000, "loop_lr": 5e-4,
                    "loop_gap": 8, "nms_thresh": 0.4},
    },
    "Mapping": {
        "lambda_depth": 0.5,
        "lambda_normal": 0.05,
        "lambda_iso": 10.0,
        "pose_refine_iters": 50,
        "window_size": 10,
        "iterations": 100,
    },
    "Training": {
        "pose_lr": 0.0003,
        "position_lr_init": 0.00016,
        "position_lr_final": 0.0000016,
        "position_lr_max_steps": 20000,
        "feature_lr": 0.0025,
        "opacity_lr": 0.05,
        "scaling_lr": 0.001,
        "rotation_lr": 0.001,
        "exposure_lr": 0.001,
        "densify_grad_threshold": 0.0002,
        "densification_interval": 100,
        "opacity_threshold": 0.005,
    },
}
