"""The monocular prior on DROID's keyframes (HI-SLAM2's tracking front) on
the CPU: ``Tracking.model: droid`` with ``motion_filter.use_prior`` and
``prior_model: omnidata`` stores, for every keyframe the store holds
(keyframe removal included), the maps a direct call of the system's own
networks gives on that keyframe's image; ``KeyframeStore.remove`` moves
the prior maps with their keyframe; the buffers live on the store's
device; ``default_precision`` pins PyTorch's defaults and leaves a
``full_f32`` block alone.

Omnidata runs at a reduced width here (64 wide, 4 blocks, one bottleneck
a stage, 32 features: ``random_omnidata`` given those widths in place of
the published ones) on 64x96 frames; the CPU computes the stored and the
direct maps with the same kernels in the same order, so they are equal.
"""
import functools

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch import default_precision, full_f32
from cut3r_slam_tpu_torch.models.droid_net import DroidNet
from cut3r_slam_tpu_torch.models.omnidata import random_omnidata
from cut3r_slam_tpu_torch.slam import system as system_mod
from cut3r_slam_tpu_torch.slam.keyframe import KeyframeStore
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from cut3r_slam_tpu_torch.utils.profiling import StageTimer
from port_bench import frames as F
from port_bench.reference import droid as ref

H, W = 64, 96
SMALL = dict(vit_dim=64, vit_depth=4, vit_heads=4, hook_blocks=[2, 3],
             features=32, resnet_layers=[1, 1, 1])
INIT = {"scale": {"scratch.output_conv.4.weight": 0.05},
        "assign": {"scratch.output_conv.4.bias": 1.0}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system(monkeypatch, tmp_path, **droid):
    monkeypatch.setattr(system_mod, "random_omnidata",
                        functools.partial(random_omnidata, **SMALL))
    net = DroidNet(device="cpu")
    net.load_state_dict(ref.draw_state_dict(3, "cpu"))
    cfg = {"Tracking": {"model": "droid",
                        "motion_filter": {
                            "kf_every": 0, "use_prior": True,
                            "prior_model": "omnidata", "prior_seed": 5,
                            "prior_init": {"depth": INIT, "normal": INIT}},
                        "droid": droid}}
    return SLAMSystem(net.eval(), cfg, buffer=32, img_hw=(H, W),
                      enable_mapping=False, enable_loop=False,
                      output_dir=str(tmp_path), device="cpu")


def test_remove_keeps_each_prior_with_its_keyframe():
    kf = KeyframeStore(6, (4, 5), 1, 1, device="cpu")
    kf.ensure_prior_buffers()
    assert kf.prior_depth.device == kf.device
    for i in range(5):
        kf.append(10 + i, np.full((4, 5, 3), i, np.uint8))
        kf.prior_depth[i] = float(i)
        kf.prior_normal[i] = torch.tensor([i, -i, 2.0 * i])
    kf.remove(2)
    assert kf.count == 4 and kf.tstamp[:4].tolist() == [10, 11, 13, 14]
    for i in range(4):
        shade = float(kf.image[i, 0, 0, 0])
        assert (kf.prior_depth[i] == shade).all()
        assert (kf.prior_normal[i] == torch.tensor(
            [shade, -shade, 2.0 * shade])).all()
    # the slot left behind holds what it held: only [0, count) is live
    assert (kf.prior_depth[4] == 4.0).all()


def test_droid_keyframes_store_their_networks_maps(monkeypatch, tmp_path):
    """Every frame through the flow filter (threshold 0) with keyframe
    removal (threshold 1e9): each keyframe left in the store holds the
    maps of its own image, and ``prior.keyframes`` counts every keyframe
    the filter took."""
    slam = _system(monkeypatch, tmp_path, filter_thresh=0.0,
                   keyframe_thresh=1e9)
    timer = StageTimer()
    slam.timer = timer
    depth_fn, normal_fn = slam.prior
    assert slam.filter.prior is slam.prior
    nets = (depth_fn.net, normal_fn.net)
    assert [n.task for n in nets] == ["depth", "normal"]
    assert len(nets[0].pretrained.model.blocks) == 4
    # two draws from one seed pair: depth from prior_seed, normal from +1
    assert not torch.equal(nets[0].pretrained.model.pos_embed,
                           nets[1].pretrained.model.pos_embed)
    frames = F.synth_frames(20, H, W, 6)
    K = F.intrinsics(H, W)
    taken = 0
    for t, img in enumerate(frames):
        took, _ = slam.run(t, img, K)
        taken += int(took)
    slam.timer = None
    kf = slam.keyframes
    n = kf.count
    assert taken > n >= 8                       # keyframes were removed
    assert timer.counters["prior.keyframes"] == taken
    assert timer.counts["prior.depth"] == timer.counts["prior.normal"] \
        == timer.counts["prior.store"] == taken
    assert timer.counts["omni.backbone"] == 2 * taken
    with torch.no_grad():
        for i in range(n):
            want_d, want_n = depth_fn(kf.image[i]), normal_fn(kf.image[i])
            assert torch.equal(kf.prior_depth[i], want_d), i
            assert torch.equal(kf.prior_normal[i], want_n), i
            assert (want_d > 0).all() and want_d.std() > 0


def test_reset_state_gives_the_new_store_prior_buffers(monkeypatch,
                                                       tmp_path):
    slam = _system(monkeypatch, tmp_path)
    K = F.intrinsics(H, W)
    frames = F.synth_frames(2, H, W, 7)
    slam.run(0, frames[0], K)
    nets = [fn.net for fn in slam.prior]
    slam.reset_state()
    kf = slam.keyframes
    assert kf.count == 0 and not kf.prior_depth.any()
    assert [fn.net for fn in slam.filter.prior] == nets    # built once
    slam.run(0, frames[1], K)
    with torch.no_grad():
        assert torch.equal(kf.prior_depth[0], slam.prior[0](frames[1]))


def test_unknown_prior_model_raises(tmp_path):
    with pytest.raises(ValueError, match="prior_model"):
        SLAMSystem(DroidNet(device="cpu"),
                   {"Tracking": {"model": "droid", "motion_filter": {
                       "use_prior": True, "prior_model": "midas"}}},
                   buffer=4, img_hw=(H, W), enable_mapping=False,
                   enable_loop=False, output_dir=str(tmp_path),
                   device="cpu")


def test_a_drawn_prior_takes_no_checkpoint(tmp_path):
    """``prior_model: omnidata`` is the seeded draw; checkpoints load
    through ``omnidata_ckpt_<task>`` without it."""
    with pytest.raises(ValueError, match="omnidata_ckpt"):
        system_mod.build_prior_fns(
            {"prior_model": "omnidata",
             "omnidata_ckpt_depth": str(tmp_path / "depth.ckpt")},
            (H, W), "cpu")


def test_default_precision_pins_the_defaults_and_yields_to_full_f32():
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled)
    try:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = True, False
        with default_precision():
            assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                    b.cudnn.enabled) == (False, True, True)
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == (True,
                                                                 False)
        with full_f32(), default_precision():
            assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                    b.cudnn.enabled) == (False, False, False)
        # a full_f32 block opened inside (another thread's) and left after
        # it keeps float32 accuracy, then restores what preceded both
        pin, exact = default_precision(), full_f32()
        pin.__enter__()
        exact.__enter__()
        pin.__exit__(None, None, None)
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                b.cudnn.enabled) == (False, False, False)
        exact.__exit__(None, None, None)
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == (True,
                                                                 False)
        # two pins that overlap without nesting (two threads): the pin
        # holds until the last leaves, then what preceded both comes back
        first, second = default_precision(), default_precision()
        first.__enter__()
        second.__enter__()
        first.__exit__(None, None, None)
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                b.cudnn.enabled) == (False, True, True)
        second.__exit__(None, None, None)
        assert (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) == (True,
                                                                 False)
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.enabled) = saved
