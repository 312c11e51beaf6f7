"""The port's ``parallel/`` mesh helpers and sharded CUT3R inference, at
world size 2 over gloo on the CPU (``torch.multiprocessing.spawn``; the
process group meets at a file under ``tmp_path``, so concurrent test
workers never share a port).

* ``make_mesh`` shapes and its refusals, ``shard_batch`` / ``replicate``;
* ``fsdp_shard_params``: every parameter is a dim-0 shard over ``fsdp``
  (FSDP2; the JAX layout shards only large parameters on their largest
  divisible dim) and the shards reassemble the full tensors bitwise;
* ``tp_param_specs`` against the JAX package's ``tp_param_specs`` on the
  tiny model's params, names mapped through the converter;
* ``make_sharded_forward`` (tiny CUT3R, V=2, B=2 over dp 2) and
  ``make_tp_sharded_forward`` (tp 2), each against the JAX ``model.apply``
  of the same params at rtol 2e-3 / atol 2e-4 (tests/test_parallel.py).

Worker functions sit at module level and this module imports no JAX at
its top, so the spawned ranks never load it; the JAX references are
computed in the test process.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cut3r_slam_tpu_torch.parallel import (init_distributed, make_mesh,
                                           shard_batch, replicate,
                                           fsdp_shard_params)

PG_TIMEOUT_S = 60.0
H, W = 32, 48
FWD_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rank_entry(rank, fn, world, init_file, args):
    torch.set_num_threads(1)
    init_distributed(backend="gloo", timeout_s=PG_TIMEOUT_S,
                     init_method=f"file://{init_file}", rank=rank,
                     world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn, tmp_path, *args, world=2, join=True):
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one gloo process group; a rank that raises fails the call. With
    ``join=False`` returns at once: ``wait(<returned context>)`` joins (the
    caller computes its references meanwhile)."""
    init = tmp_path / f"pg_{fn.__name__}"
    if init.exists():
        init.unlink()
    ctx = mp.spawn(_rank_entry, args=(fn, world, str(init), args),
                   nprocs=world, join=False)
    if join:
        wait(ctx)
    return ctx


def wait(ctx):
    """Join the spawned ranks; re-raises a rank's failure."""
    while not ctx.join():
        pass


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def _mesh_worker(rank, world, out):
    m1 = make_mesh(2, axes=("mv",))
    m2 = make_mesh(2, axes=("dp", "fsdp"), shape=(1, 2))
    assert tuple(m1.shape) == (2,) and tuple(m2.shape) == (1, 2)
    assert m2.mesh_dim_names == ("dp", "fsdp")
    for bad in [dict(n_devices=4, axes=("mv",)),
                dict(axes=("dp", "fsdp"), shape=(2, 2))]:
        try:
            make_mesh(**bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"make_mesh({bad}) did not raise")
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    part = shard_batch(m1, {"x": x, "n": np.arange(4)[None].repeat(2, 0)},
                       axis="mv", dim=1)
    try:
        shard_batch(m1, torch.zeros(3, 3), axis="mv", dim=0)
    except ValueError:
        pass
    else:
        raise AssertionError("an odd dim was sharded")
    mine = torch.full((5,), float(rank + 1))
    replicate(m1, {"t": mine})
    # FSDP2 over the (dp 1, fsdp 2) mesh
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3))
    full = {k: v.clone() for k, v in net.state_dict().items()}
    fsdp_shard_params(m2, net)
    shards = {k: (type(v).__name__,
                  [f"shard{p.dim}" if p.is_shard() else "replicate"
                   for p in v.placements],
                  v.to_local().clone(), v.full_tensor())
              for k, v in net.state_dict().items()}
    torch.save({"x": part["x"], "n": part["n"], "bcast": mine,
                "full": full, "shards": shards}, f"{out}/mesh{rank}.pt")


def test_mesh_shard_replicate_fsdp(tmp_path):
    run_world(_mesh_worker, tmp_path, str(tmp_path))
    r = [torch.load(tmp_path / f"mesh{i}.pt", weights_only=False)
         for i in range(2)]
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    for i in range(2):
        assert torch.equal(r[i]["x"], x[:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(r[i]["n"], np.arange(2 * i, 2 * i + 2)
                                      [None].repeat(2, 0))
        assert torch.equal(r[i]["bcast"], torch.ones(5))   # rank 0's
    for k, v in r[0]["full"].items():
        kinds = [r[i]["shards"][k] for i in range(2)]
        for kind, pl, _, whole in kinds:
            assert kind == "DTensor" and pl == ["replicate", "shard0"], \
                (k, pl)
            assert torch.equal(whole, v), k
        # dim-0 shards in rank order (torch.chunk sizes: 4 + 3 of 7 rows)
        assert torch.equal(torch.cat([kinds[0][2], kinds[1][2]]), v), k
        assert kinds[0][2].shape[0] == -(-v.shape[0] // 2), k


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, axes=("mv",))


# ---------------------------------------------------------------------------
# tensor-parallel layout
# ---------------------------------------------------------------------------

def test_tp_param_specs_match_jax():
    """Every parameter of the tiny model: the port's placement over ``tp``
    is the JAX package's PartitionSpec under the converter's name."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict
    from jax.sharding import PartitionSpec as P
    from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
    from cut3r_slam_tpu.parallel.inference import tp_param_specs as j_specs
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.models.convert import params_from_jax
    from cut3r_slam_tpu_torch.parallel.inference import tp_param_specs

    shapes = jax.eval_shape(JCUT3R(JConfig.tiny()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, H, W, 3)))
    flat = flatten_dict(unfreeze(shapes["params"]), sep="/")
    specs = flatten_dict(unfreeze(j_specs(shapes)["params"]), sep="/")
    # every array filled with its key's index: the converter moves values,
    # so each converted tensor names the JAX key it came from
    keys = sorted(specs)
    conv = params_from_jax({k: np.full(flat[k].shape, i, np.float32)
                            for i, k in enumerate(keys)})
    code = {P(): "replicate", P(None, "tp"): "col", P("tp"): "col",
            P("tp", None): "row"}
    want = {name: code[specs[keys[int(t.reshape(-1)[0])]]]
            for name, t in conv.items()}
    got = tp_param_specs(CUT3R(CUT3RConfig.tiny(), device="cpu"))
    assert set(got) == set(want)
    assert got == want
    assert sum(v == "col" for v in got.values()) > 0
    assert sum(v == "row" for v in got.values()) > 0


# ---------------------------------------------------------------------------
# sharded forwards
# ---------------------------------------------------------------------------

def _tiny_model(flat):
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.models.convert import params_from_jax
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return tm.eval()


def _forward_worker(rank, world, flat, imgs, out):
    from cut3r_slam_tpu_torch.parallel.inference import (
        make_sharded_forward, make_tp_sharded_forward)
    x = torch.as_tensor(imgs)
    with torch.no_grad():
        fn = make_sharded_forward(_tiny_model(flat),
                                  make_mesh(2, axes=("dp",)))
        dp = fn(x)
        fn = make_tp_sharded_forward(_tiny_model(flat),
                                     make_mesh(2, axes=("dp", "tp"),
                                               shape=(1, 2)))
        tp = fn(x)
    torch.save({"dp": dp, "tp": tp}, f"{out}/fwd{rank}.pt")


def test_sharded_and_tp_forward_match_jax(tmp_path):
    import jax
    from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
    from test_torch_cut3r_train import jax_params, jax_tiny_params

    flat = jax_tiny_params(seed=3)
    imgs = np.random.default_rng(5).uniform(-1, 1, (2, 2, H, W, 3)) \
        .astype(np.float32)
    ranks = run_world(_forward_worker, tmp_path, flat, imgs, str(tmp_path),
                      join=False)
    ref = jax.jit(JCUT3R(JConfig.tiny()).apply)(jax_params(flat), imgs)
    wait(ranks)
    outs = [torch.load(tmp_path / f"fwd{i}.pt", weights_only=False)
            for i in range(2)]
    for kind in ("dp", "tp"):
        for k in ("pts3d_in_self_view", "pts3d_in_other_view", "conf",
                  "conf_self", "camera_pose"):
            got = outs[0][kind][k]
            assert torch.equal(got, outs[1][kind][k]), (kind, k)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[k]),
                                       err_msg=f"{kind} {k}", **FWD_TOL)
