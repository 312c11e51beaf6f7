"""The port's trainer (``cut3r_slam_tpu_torch/train/trainer.py``) on the CPU
at the tiny config: ``train`` writes its JSON log lines and its
checkpoints (parameters, optimizer state, step; atomic rename), and a run
that crashes after its step-2 checkpoint and is resumed from it ends with
the same parameters and optimizer state as the uninterrupted run
(bitwise: the same CPU ops in the same order); with nothing to resume
and no weights given it starts from ``init_trainable``'s draw."""
import json
import os

import pytest
import torch

from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.train.trainer import (
    TrainerConfig, _load_latest_ckpt, _save_ckpt, train)
from cut3r_slam_tpu_torch.train.train_step import (POINTMAP_HEAD_GAIN,
                                                   make_optimizer)

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_train_step import procedural_batches


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    return procedural_batches(str(tmp_path_factory.mktemp("scenes")), 2, 3,
                              seed=2)


def _cfg(ckpt_dir, **kw):
    return TrainerConfig(**dict(dict(lr=1e-4, warmup_steps=1, total_steps=3,
                                     log_every=1, ckpt_every=2,
                                     ckpt_dir=str(ckpt_dir), seed=3), **kw))


def _model():
    return CUT3R(CUT3RConfig.tiny(), device="cpu")


@pytest.fixture(scope="module")
def whole(batches, tmp_path_factory):
    """The uninterrupted run: (model, log lines, checkpoint dir)."""
    ckpt = tmp_path_factory.mktemp("whole")
    logs = []
    model = train(_model(), iter(batches), _cfg(ckpt), log_fn=logs.append,
                  device="cpu")
    return model, logs, ckpt


def test_train_logs_and_checkpoints(whole):
    model, logs, ckpt = whole
    assert [m["step"] for m in logs] == [0, 1, 2]
    for m in logs:
        assert set(m) == {"step", "loss", "sec_per_step"}
        assert m["loss"] == m["loss"] and m["sec_per_step"] >= 0
    json.dumps(logs)
    assert sorted(os.listdir(ckpt)) == ["step_2.pt", "step_3.pt"]
    params, opt_state, step = _load_latest_ckpt(str(ckpt))
    assert step == 3 and opt_state["param_groups"][0]["count"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v), k


def test_train_starts_from_init_trainable(batches, tmp_path):
    """With no checkpoint and no ``init_params``, ``train`` starts from
    ``init_random``'s draw at its seed with the pointmap heads' last
    convolution scaled by ``POINTMAP_HEAD_GAIN`` (``init_trainable``; the
    one step taken is at lr 0 by the schedule)."""
    model = train(_model(), iter(batches), _cfg(tmp_path, total_steps=1),
                  log_fn=lambda m: None, device="cpu")
    ref = _model()
    ref.init_random(torch.Generator().manual_seed(3))
    scaled = {f"downstream_head.{h}.head.4.weight"
              for h in ("dpt_self", "dpt_cross")}
    got = model.state_dict()
    for k, v in ref.state_dict().items():
        want = v * POINTMAP_HEAD_GAIN if k in scaled else v
        assert torch.equal(got[k], want), k


def test_checkpoint_round_trip(tmp_path):
    model = _model()
    model.init_random(torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters())
    _save_ckpt(str(tmp_path), model, opt, 7)
    assert os.listdir(tmp_path) == ["step_7.pt"]   # no temporary left
    params, opt_state, step = _load_latest_ckpt(str(tmp_path))
    assert step == 7
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v), k
    assert _load_latest_ckpt(str(tmp_path / "none")) is None


def test_resume_reproduces_the_uninterrupted_run(batches, whole, tmp_path):
    def crashing():
        yield from batches[:2]
        raise RuntimeError("lost the data server")

    with pytest.raises(RuntimeError, match="data server"):
        train(_model(), crashing(), _cfg(tmp_path), log_fn=lambda m: None,
              device="cpu")
    assert os.listdir(tmp_path) == ["step_2.pt"]
    logs = []
    resumed = train(_model(), iter(batches[2:]), _cfg(tmp_path, resume=True),
                    log_fn=logs.append, device="cpu")
    assert logs[0] == {"resumed_from_step": 2}
    assert [m["step"] for m in logs[1:]] == [2]
    for k, v in whole[0].state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    a = _load_latest_ckpt(str(whole[2]))[1]
    b = _load_latest_ckpt(str(tmp_path))[1]
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(b["state"][i][k], v), (i, k)


def test_train_needs_a_gpu_unless_told_cpu(batches, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_model(), iter(batches), _cfg(tmp_path))
