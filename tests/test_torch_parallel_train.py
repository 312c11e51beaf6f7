"""Data-parallel and FSDP training of the port (``train/trainer.py`` over
``torch.distributed``) at world size 2 over gloo on the CPU, tiny CUT3R
with the linear head (a checkpoint of 5 MB where the DPT heads' makes
660 MB), V=2 views of 32x48, a global batch of B=2 whose two halves have
DIFFERENT ``valid_mask`` counts (the second sample loses a band of
rows), so the whole-batch masked means of the JAX step are tested:

* one AdamW step at dp 2 and one at fsdp 2, each through ``train`` (the
  state read from its checkpoint), against the JAX step on the whole batch
  on one device: the loss (the log's 5 decimals), every tensor's gradient
  via Adam's first moment within ``grads_close``'s bound and every
  parameter within ``_params_close``'s (tests/test_torch_train_step.py);
  the dp ranks' replicated parameters bitwise equal;
* one truncated-BPTT step at fsdp 2 against the port's one-rank TBPTT
  step, at the same bounds;
* a checkpoint written at world size 2 (fsdp 2) resumed at world size 1,
  and one written at world size 1 resumed at world size 2, each against
  the uninterrupted run at its first world size.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.train.trainer import TrainerConfig, train
from test_torch_parallel_mesh import few_threads, run_world, \
    wait  # noqa: F401

H, W = 32, 48
OPT = dict(lr=1e-4, weight_decay=0.05, warmup_steps=0, total_steps=2)
TBPTT = dict(tbptt_chunk=1, tbptt_grad_chunks=1)


def _model():
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    return CUT3R(dataclasses.replace(CUT3RConfig.tiny(), head_type="linear"),
                 device="cpu")


def _link_ckpt(src, dst_dir):
    """A checkpoint directory whose latest checkpoint is ``src``."""
    os.makedirs(dst_dir)
    os.symlink(src, os.path.join(dst_dir, os.path.basename(src)))


def _train(flat, batches, ckpt_dir, fsdp=1, resume=False, logs=None,
           steps=2, **kw):
    """``train`` over ``batches`` from the params ``flat`` (or the latest
    checkpoint of ``ckpt_dir`` with ``resume``), a checkpoint every step,
    stopped after ``steps`` steps of ``OPT``'s schedule."""
    from cut3r_slam_tpu_torch.models.convert import params_from_jax
    tcfg = TrainerConfig(**OPT, log_every=1, ckpt_every=1,
                         ckpt_dir=str(ckpt_dir), fsdp=fsdp, resume=resume,
                         **kw)
    tcfg.total_steps = steps
    model = train(_model(), iter(batches), tcfg,
                  init_params=params_from_jax(flat),
                  log_fn=(logs.append if logs is not None else
                          lambda m: None), device="cpu")
    return model


def _train_worker(rank, world, flat, batches, out):
    from torch.distributed.tensor import DTensor
    logs = {}
    for name, fsdp, steps in (("dp2", 1, 1), ("fsdp2", 2, 2)):
        logs[name] = []
        model = _train(flat, batches, f"{out}/{name}", fsdp=fsdp,
                       logs=logs[name], steps=steps)
        if name == "dp2":
            full = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
                    .clone() for k, v in model.state_dict().items()}
            torch.save(full, f"{out}/dp2_params_rank{rank}.pt")
    _train_tbptt(flat, batches, f"{out}/tbptt_fsdp2", 2)
    # resume at world size 2 from the one-rank run's step-1 checkpoint
    _train(flat, batches[1:], f"{out}/resume_at2", fsdp=2, resume=True)
    if rank == 0:
        torch.save(logs, f"{out}/logs.pt")


def _train_tbptt(flat, batches, ckpt_dir, fsdp):
    return _train(flat, batches, ckpt_dir, fsdp=fsdp, steps=1, **TBPTT)


def _batches(root):
    """Two global batches of B=2 from one procedural scene; the second
    sample of each loses its first 8 rows of valid pixels."""
    from cut3r_slam_tpu_torch.datasets import (
        MultiViewDataset, SceneFolderSource, SceneLayout, make_batch_iter,
        generate_multiview_scenes)
    generate_multiview_scenes(root, n_scenes=1, views_per_scene=8,
                              hw=(H, W), seed=0)
    it = make_batch_iter(MultiViewDataset(
        SceneFolderSource(root, SceneLayout("synth")), num_views=2, span=6,
        resolution=(H, W), seed=0), 2, 0)
    out = [next(it) for _ in range(2)]
    for b in out:
        b["valid_mask"][:, 1, :8] = False
        counts = b["valid_mask"].sum((0, 2, 3))
        assert counts[0] != counts[1] and counts.min() > 0, counts
    return out


def _load(path):
    """(model, optimizer) holding the checkpoint at ``path``."""
    from cut3r_slam_tpu_torch.train.train_step import make_optimizer
    st = torch.load(path, map_location="cpu", weights_only=False)
    model = _model()
    model.load_state_dict(st["params"])
    opt = make_optimizer(model.parameters(), OPT["lr"], OPT["weight_decay"],
                         OPT["warmup_steps"], OPT["total_steps"])
    opt.load_state_dict(st["opt_state"])
    return model, opt


def _mu(path):
    model, opt = _load(path)
    return {n: opt.state[p]["mu"] for n, p in model.named_parameters()}


def _jax_model():
    from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
    return JCUT3R(dataclasses.replace(JConfig.tiny(), head_type="linear"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp
    from test_torch_prior import jax_random_params
    tmp = tmp_path_factory.mktemp("parallel_train")
    flat = jax_random_params(_jax_model(), jnp.zeros((1, 1, H, W, 3)),
                             seed=1)
    batches = _batches(str(tmp / "scenes"))
    # one intra-op thread, as in the ranks: the runs compared differ in
    # their world size only, not in torch's reduction splits
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # the one-rank runs: two plain steps, one TBPTT step
    logs1 = []
    _train(flat, batches, tmp / "seq", logs=logs1)
    _link_ckpt(str(tmp / "seq" / "step_1.pt"), tmp / "resume_at2")
    ranks = run_world(_train_worker, tmp, flat, batches, str(tmp),
                      join=False)
    _train_tbptt(flat, batches, tmp / "tbptt_seq", 1)
    jax_ref = _jax_step(flat, batches)
    wait(ranks)
    # resume at world size 1 from the fsdp-2 run's step-1 checkpoint
    _link_ckpt(str(tmp / "fsdp2" / "step_1.pt"), tmp / "resume_at1")
    _train(flat, batches[1:], tmp / "resume_at1", resume=True)
    torch.set_num_threads(n_threads)
    logs = torch.load(tmp / "logs.pt", weights_only=False)
    return tmp, logs, jax_ref


def _jax_step(flat, batches):
    """The JAX step on the whole first batch: (params, opt_state, aux)."""
    import jax
    import jax.numpy as jnp
    from cut3r_slam_tpu.train import train_step as JS
    from test_torch_prior import as_jax
    tx = JS.make_optimizer(**OPT)
    params = as_jax(flat)
    step = jax.jit(JS.make_train_step(_jax_model(), tx))
    return step(params, tx.init(params),
                {k: jnp.asarray(v) for k, v in batches[0].items()})


@pytest.mark.parametrize("name", ["dp2", "fsdp2"])
def test_one_step_matches_jax_whole_batch(runs, name):
    from test_torch_train_step import (_params_close, adam_mu_jax,
                                       grads_close)
    from cut3r_slam_tpu_torch.train.train_step import lr_at
    tmp, logs, (params_j, opt_j, aux_j) = runs
    assert abs(logs[name][0]["loss"] - float(aux_j["total"])) <= 1e-5, \
        (logs[name][0], float(aux_j["total"]))
    model, opt = _load(tmp / name / "step_1.pt")
    worst = grads_close(adam_mu_jax(opt_j), model, opt)
    print(f"{name}: worst tensor's gradient differs by {worst:.3e}")
    _params_close(params_j, model, [lr_at(0, OPT["lr"], 0, 2)])


def test_dp_ranks_replicated_bitwise(runs):
    tmp = runs[0]
    r0, r1 = (torch.load(tmp / f"dp2_params_rank{r}.pt", weights_only=False)
              for r in range(2))
    assert all(torch.equal(v, r1[k]) for k, v in r0.items())


def test_tbptt_step_at_fsdp2(runs):
    """The one-rank TBPTT step is the reference: a whole-batch mean over
    the same chunks; FSDP reorders the gradient sums only."""
    from test_torch_train_step import grads_close
    tmp = runs[0]
    ref = _mu(tmp / "tbptt_seq" / "step_1.pt")
    model, opt = _load(tmp / "tbptt_fsdp2" / "step_1.pt")
    grads_close(ref, model, opt)


@pytest.mark.parametrize("resumed, uninterrupted", [
    ("resume_at1", "fsdp2"), ("resume_at2", "seq")],
    ids=["world2_to_1", "world1_to_2"])
def test_checkpoint_resumes_across_world_sizes(runs, resumed,
                                               uninterrupted):
    from test_torch_train_step import grads_close
    tmp = runs[0]
    want = _mu(tmp / uninterrupted / "step_2.pt")
    model, opt = _load(tmp / resumed / "step_2.pt")
    grads_close(want, model, opt)
    # an element whose gradient lies at the rounding floor may take an
    # Adam step of either sign: two full steps apart at most
    from cut3r_slam_tpu_torch.train.train_step import lr_at
    bound = 2 * sum(lr_at(i, OPT["lr"], 0, 2) for i in range(2))
    ref, _ = _load(tmp / uninterrupted / "step_2.pt")
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=bound, err_msg=k)
    assert opt.param_groups[0]["count"] == 2
