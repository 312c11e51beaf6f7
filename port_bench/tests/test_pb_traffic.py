"""The traffic and the weights are made from the seed alone."""
import numpy as np
import torch

from conftest import TINY
from port_bench import frames
from port_bench.weights import draw_state_dict

BIG = 2 ** 33 + 12345      # seeds run past 32 signed bits


def test_frames_repeat_by_seed():
    a = frames.synth_frames(6, 32, 48, BIG)
    b = frames.synth_frames(6, 32, 48, BIG)
    c = frames.synth_frames(6, 32, 48, BIG + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (32, 48, 3) and a[0].dtype == np.uint8
    # the camera pans: frame 1 is frame 0 moved 8 px
    assert np.array_equal(a[1][:, :-8], a[0][:, 8:])


def test_weights_repeat_by_seed():
    a = draw_state_dict(TINY, BIG, "cpu")
    b = draw_state_dict(TINY, BIG, "cpu")
    c = draw_state_dict(TINY, BIG + 1, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_blocks.0.attn.qkv.weight"],
                           c["enc_blocks.0.attn.qkv.weight"])
    assert torch.all(a["enc_norm.weight"] == 1)
    assert torch.all(a["enc_blocks.0.attn.qkv.bias"] == 0)
    w = a["enc_blocks.0.mlp.fc1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.002


def test_weights_load_into_the_port():
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    model = CUT3R(CUT3RConfig(**TINY, compute_dtype=torch.float32),
                  device="cpu")
    model.load_state_dict(draw_state_dict(TINY, 7, "cpu"), strict=True)


def test_scenes_repeat_by_seed():
    from port_bench import scenes
    a = scenes.draw_scenes(2, 3, (32, 48), BIG)
    b = scenes.draw_scenes(2, 3, (32, 48), BIG)
    c = scenes.draw_scenes(2, 3, (32, 48), BIG + 1)
    for x, y in zip(a, b):
        for k in ("rgb", "depth", "c2w", "K"):
            assert np.array_equal(getattr(x, k), getattr(y, k))
    assert not np.array_equal(a[0].rgb, c[0].rgb)
    # every pixel sees a surface in front of the camera
    assert all(float(x.depth.min()) > 0.1 and np.isfinite(x.depth).all()
               for x in a)


def test_training_scenes_repeat_by_seed(tmp_path):
    from conftest import tiny_cell
    from port_bench.drivers import train_steps as T
    cell = tiny_cell("train_v4")
    a = T._distinct(T._batches(str(tmp_path / "a"), cell.config,
                               cell.traffic, BIG)[0], 3)
    b = T._distinct(T._batches(str(tmp_path / "b"), cell.config,
                               cell.traffic, BIG)[0], 3)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_reference_batches_match_what_the_program_read(tmp_path):
    """The reference builds the program's batches again from the scenes'
    arrays, not from the files the program read."""
    from conftest import tiny_cell
    from port_bench.drivers import train_steps as T
    cell = tiny_cell("train_v4")
    it, drawn = T._batches(str(tmp_path), cell.config, cell.traffic, BIG)
    for b in T._distinct(it, 3):
        r = T.reference_batch(drawn, b)
        assert r.keys() == b.keys()
        for k in b:
            assert r[k].shape == b[k].shape, k
            assert np.allclose(r[k], b[k], rtol=0, atol=1e-5), k
