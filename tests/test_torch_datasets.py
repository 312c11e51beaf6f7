"""The port's training-data pipeline vs the JAX package's (both numpy) on
the CPU, for the same seeds: ``generate_multiview_scenes`` writes the same
files (images, depths, cameras, overlaps), ``SceneFolderSource`` /
``make_source`` read the same items, ``sample_view_offsets`` and
``MultiViewDataset`` draw the same views, the ``+`` / ``@`` combinators
index alike, and ``make_batch_iter`` yields the same batches.

Everything is compared exactly (the same numpy code and draws), except
``make_batch_iter``'s ground-truth pointmaps and camera matrices, which
each package computes with its own f32 geometry (torch vs jnp):
within 1e-6 relative to their scale.
"""
import os

import numpy as np
import pytest

from cut3r_slam_tpu.datasets import loaders as JLd
from cut3r_slam_tpu.datasets import multiview as JMv
from cut3r_slam_tpu.datasets import synthscene as JSy
from cut3r_slam_tpu_torch.datasets import loaders as TLd
from cut3r_slam_tpu_torch.datasets import multiview as TMv
from cut3r_slam_tpu_torch.datasets import synthscene as TSy

from test_torch_cut3r_train import few_threads  # noqa: F401

HW = (24, 32)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    a = str(tmp_path_factory.mktemp("jax"))
    b = str(tmp_path_factory.mktemp("port"))
    kw = dict(n_scenes=2, views_per_scene=7, hw=HW, seed=3)
    return JSy.generate_multiview_scenes(a, **kw), \
        TSy.generate_multiview_scenes(b, **kw), a, b


def _equal_tree(x, y, what=""):
    if isinstance(x, dict):
        assert set(x) == set(y), what
        for k in x:
            _equal_tree(x[k], y[k], f"{what}/{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), what
        for i, (u, v) in enumerate(zip(x, y)):
            _equal_tree(u, v, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)


def test_generated_scenes_are_identical(scenes):
    dj, dt, a, b = scenes
    assert [os.path.basename(d) for d in dj] == \
        [os.path.basename(d) for d in dt]
    for sj, st in zip(dj, dt):
        files = sorted(os.path.relpath(os.path.join(r, f), sj)
                       for r, _, fs in os.walk(sj) for f in fs)
        assert files == sorted(os.path.relpath(os.path.join(r, f), st)
                               for r, _, fs in os.walk(st) for f in fs)
        for f in files:
            if f.endswith(".png"):
                with open(os.path.join(sj, f), "rb") as u, \
                        open(os.path.join(st, f), "rb") as v:
                    assert u.read() == v.read(), f
            elif f.endswith(".npy"):
                _equal_tree(np.load(os.path.join(sj, f)),
                            np.load(os.path.join(st, f)), f)
            else:
                _equal_tree(dict(np.load(os.path.join(sj, f))),
                            dict(np.load(os.path.join(st, f))), f)


def test_scene_sources_read_the_same_items(scenes):
    _, _, a, b = scenes
    sj = JLd.SceneFolderSource(a, JLd.SceneLayout("synth"))
    st = TLd.SceneFolderSource(b, TLd.SceneLayout("synth"))
    assert len(sj) == len(st) == 14 and sj.scene_of == st.scene_of
    for i in range(len(sj)):
        _equal_tree(sj[i], st[i], str(i))
    assert TLd.list_datasets() == JLd.list_datasets()
    mj, mt = JLd.make_source("mp3d", a), TLd.make_source("mp3d", b)
    _equal_tree(mj[3], mt[3], "mp3d")
    with pytest.raises(ValueError, match="unknown dataset"):
        TLd.make_source("nope", b)


@pytest.mark.parametrize("num_views,span", [(4, 24), (16, 8), (2, 1),
                                            (32, 64)])
def test_sample_view_offsets(num_views, span):
    for seed in range(40):
        _equal_tree(
            JMv.sample_view_offsets(np.random.default_rng(seed), num_views,
                                    span),
            TMv.sample_view_offsets(np.random.default_rng(seed), num_views,
                                    span), str(seed))


def test_multiview_dataset_and_combinators(scenes):
    _, _, a, b = scenes
    kw = dict(num_views=3, span=5, resolution=(16, 24), seed=11)
    dj = JMv.MultiViewDataset(JLd.SceneFolderSource(a, JLd.SceneLayout("s")),
                              **kw)
    dt = TMv.MultiViewDataset(TLd.SceneFolderSource(b, TLd.SceneLayout("s")),
                              **kw)
    mix_j, mix_t = dj @ 2 + dj, 2 @ dt + dt
    assert isinstance(mix_t, TMv.CatDataset) and \
        isinstance(mix_t.parts[0], TMv.MulDataset)
    assert len(mix_j) == len(mix_t) == 3 * len(dt)
    for i in range(len(mix_t)):
        _equal_tree(mix_j[i], mix_t[i], str(i))


def test_make_batch_iter(scenes):
    _, _, a, b = scenes
    kw = dict(num_views=4, span=6, resolution=HW, seed=5)
    dj = JMv.MultiViewDataset(JLd.SceneFolderSource(a, JLd.SceneLayout("s")),
                              **kw)
    dt = TMv.MultiViewDataset(TLd.SceneFolderSource(b, TLd.SceneLayout("s")),
                              **kw)
    ij, it = JMv.make_batch_iter(dj, 2, seed=7), \
        TMv.make_batch_iter(dt, 2, seed=7)
    for _ in range(2):
        bj, bt = next(ij), next(it)
        assert set(bj) == set(bt)
        for k in bj:
            assert bj[k].shape == bt[k].shape and bj[k].dtype == bt[k].dtype
            if k in ("pts3d", "camera_pose"):
                scale = np.abs(bj[k]).max()
                assert np.abs(bt[k] - bj[k]).max() <= 1e-6 * scale, k
            else:
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
