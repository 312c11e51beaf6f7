"""Quaternions, SO(3)/SE(3) and pointmap utilities (PyTorch)."""
