"""The truncated-BPTT training step of the port vs
``cut3r_slam_tpu/train/train_step.make_tbptt_train_step`` on the CPU at
the tiny config: V=4 views of a procedural scene (B=1, 32x48), decoder
chunks of 2, gradient through the last chunk only. One step from the
same params on the same batch: the loss within 1e-5 relative, the
gradient of every parameter tensor within 1e-4 of its norm plus a floor
(``test_torch_train_step.grads_close``: the encoder's is zero in both),
and every parameter within 1e-5 absolute on all but 1e-4 of the
elements, the rest within two Adam steps
(``test_torch_train_step._params_close``; weight decay on: the encoder
moves by decay alone in both); and, with weight decay 0, the encoder
and patch embedding bitwise unchanged while the decoder moves.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.train import train_step as JS
from cut3r_slam_tpu_torch.train import train_step as TS

from test_torch_cut3r_train import (few_threads, jax_params,  # noqa: F401
                                    jax_tiny_params, torch_from_flat)
from test_torch_train_step import (OPT, _params_close, adam_mu_jax,
                                   grads_close, procedural_batches)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    return procedural_batches(str(tmp_path_factory.mktemp("scenes")), 4, 1,
                              seed=1)[0]


@pytest.fixture(scope="module")
def flat():
    return jax_tiny_params(seed=1)


def test_tbptt_step_matches_jax(flat, batch):
    """One truncated-BPTT step over 4 views in chunks of 2, gradient
    through the last chunk only, weight decay on: the loss, the gradient
    of every parameter tensor, and every parameter (the encoder moves by
    decay alone in both)."""
    jm = JCUT3R(JConfig.tiny())
    kw = dict(OPT, warmup_steps=0)
    tx = JS.make_optimizer(**kw)
    params = jax_params(flat)
    b4 = batch
    p1, st, aux_j = jax.jit(JS.make_tbptt_train_step(
        jm, tx, chunk=2, grad_chunks=1))(
        params, tx.init(params), {k: jnp.asarray(v) for k, v in b4.items()})
    tm = torch_from_flat(flat)
    opt = TS.make_optimizer(tm.parameters(), **kw)
    aux_t = TS.make_tbptt_train_step(tm, opt, chunk=2, grad_chunks=1)(b4)
    np.testing.assert_allclose(float(aux_t["total"]), float(aux_j["total"]),
                               rtol=1e-5)
    worst = grads_close(adam_mu_jax(st), tm, opt)
    print(f"worst tensor's gradient differs by {worst:.3e} of its norm + "
          f"the floor")
    _params_close(p1, tm, [kw["lr"]])


def test_tbptt_freezes_the_encoder(flat, batch):
    """With weight decay 0 the encoder and patch embedding are bitwise
    unchanged after a TBPTT step and the decoder moves (the JAX suite's
    check in tests/test_trainer.py)."""
    tm = torch_from_flat(flat)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = TS.make_optimizer(tm.parameters(), lr=1e-3, weight_decay=0.0,
                            warmup_steps=0)
    aux = TS.make_tbptt_train_step(tm, opt, chunk=2, grad_chunks=1)(
        batch)
    assert np.isfinite(float(aux["total"]))
    after = tm.state_dict()
    enc = [k for k in before if k.startswith(("enc_", "patch_embed."))]
    dec = [k for k in before if k.startswith("dec_blocks")]
    assert enc and dec
    assert all(torch.equal(before[k], after[k]) for k in enc)
    assert any(not torch.equal(before[k], after[k]) for k in dec)
