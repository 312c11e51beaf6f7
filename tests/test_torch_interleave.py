"""A loop-closure writeback (``gaussian_update``) landing while a mapping
event's window optimization is pending, the port vs the JAX
MappingBackend on the CPU (XLA): under interleaved mapping this happens
when the loop backend and a new submap come back on one frame (the
closure runs before the pending event drains).
"""
import numpy as np

from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)
from test_torch_parallel_refine import _drain, _packet, _pair, ITERS


def test_gaussian_update_mid_event_keeps_the_move():
    """Deliberate divergence (ROADMAP §3). The JAX window optimization
    holds its own copy of the arena across its yields and writes it back
    when it resumes (mapping.py:1054-1088), so a rigid loop-closure move
    made in between is overwritten: its Gaussians return to where they
    were. The port's optimization works on views of the arena, so the
    move stands and the optimization continues from it. A 0.3 m move of
    every Gaussian: after the drain the JAX map sits within 0.05 m of the
    unmoved one, the port's within 0.05 m of the moved one."""
    jb, tb, _ = _pair()
    shift = np.asarray([0.3, 0.0, 0.0], np.float32)
    upd = np.concatenate([shift, [0, 0, 0, 1]])[None].astype(np.float32)
    alive = np.asarray(jb.arena.alive)
    out = {}
    for name, be in (("jax", jb), ("port", tb)):
        gen = be.run_steps(_packet([0, 1, 2, 3]), ITERS,
                           **({} if name == "jax" else {
                               "view_idx": [np.zeros((2, 1), int)] * 4,
                               "split_noise": np.zeros((2048, 3))}))
        ys = []
        while len([y for y in ys if isinstance(y, float)]) < 1:
            ys.append(next(gen))
        assert ys[:2] == ["refine", "seed"]   # a window segment is pending
        xyz0 = np.asarray(be.arena.xyz)[alive].copy() if name == "jax" \
            else be.arena.xyz.numpy()[alive].copy()
        w2c = np.asarray(be.cams.w2c)[:1].copy() if name == "jax" \
            else be.cams.w2c.numpy()[:1].copy()
        w2c[:, :3, 3] -= w2c[:, :3, :3] @ shift   # the camera moves along
        be.gaussian_update([0], upd, [0], list(w2c))
        _drain(gen)
        xyz1 = np.asarray(be.arena.xyz)[alive] if name == "jax" \
            else be.arena.xyz.numpy()[alive]
        out[name] = (xyz0, xyz1)
    xyz0, xyz1 = out["jax"]
    assert np.abs(xyz1 - xyz0).max() < 0.05
    xyz0, xyz1 = out["port"]
    assert np.abs(xyz1 - (xyz0 + shift)).max() < 0.05
