"""ZeRO-1, FSDP and their resharding at n = 2: the port against JAX.

JAX: ``make_zero_train_step`` with ``optax.adam`` and ``make_fsdp_train_step``
(GSPMD) on 2 devices of the ``hvd`` axis, 3 steps from the same Flax
params and batch (the MLP; FSDP also GPT tiny, 2 layers); ``elastic``'s
``zero_reshard`` and ``fsdp_reshard`` on the same host values. Port: one
2-process gloo world over an ``hvd`` DeviceMesh: ``make_zero_train_step``
with ``torch.optim.Adam`` (optax's defaults), beside the replicated
``hvd.DistributedOptimizer`` through ``make_train_step`` (the counterpart
of ``TestZero::test_matches_replicated_adam``); and one running
``make_fsdp_train_step`` on both models; each rank on its half of the batch.

Tolerances (fp32), those of JAX's own tests: losses rtol 1e-5; ZeRO's
parameters and moments rtol 1e-4 / atol 1e-6 (``test_matches_replicated_adam``),
FSDP's MLP rtol 1e-4 / atol 1e-5 (``TestFSDP::test_matches_single_device_
trajectory``). JAX's own FSDP GPT test checks only that the loss falls;
here GPT's moments are held to rtol 1e-4 / atol 1e-5 and its parameters
as ``test_torch_gpt_dp_slice.py`` holds GPT: every element within atol
2 * LR (Adam moves an element whose gradient is at noise level by about LR
either way: GPT's key bias, whose gradient is zero in exact arithmetic,
measured 0.66 LR), and the elements whose JAX second moment is above fp32
noise (sqrt(nu) >= 1e-6 of the tensor's largest) within 5e-3 of the
tensor's largest movement over the run (measured 1.6e-3, one element of
an MLP kernel; a port that did not step, or stepped the other way, is
outside by 100x); the resharded vectors rtol 1e-6
(``test_round_trip_through_resized_mesh``); shard placement exactly.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import torch_parallel_helpers as ph
import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu import elastic as jelastic
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models.gpt import GPT, GPTConfig
from horovod_tpu.models.mlp import MLP
from horovod_tpu.parallel import ZeroTrainState, make_zero_train_step
from horovod_tpu.parallel.fsdp import make_fsdp_train_step, shard_batch
from horovod_tpu_torch.models.gpt import flax_key

N, STEPS, LR = 2, 3, 1e-2
MLP_KW = dict(features=(32, 16, 4), in_features=20)
GPT_KW = dict(num_layers=2, max_position_embeddings=64)
MIN_SIZE = 512
TREE = {"w": np.arange(32.0, dtype=np.float32).reshape(16, 2),
        "tiny": np.ones((3,), np.float32)}


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), (HVD_AXIS,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree, prefix=()):
    """{port parameter name: leaf} of a Flax-shaped tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, prefix + (k,)))
        else:
            out[flax_key(prefix + (k,))] = np.asarray(v)
    return out


def _mlp_loss(model):
    def loss(p, b):
        return jnp.mean((model.apply({"params": p}, b["x"]) - b["y"]) ** 2)
    return loss


def _gpt_loss(model):
    def loss(p, b):
        logits = model.apply({"params": p}, b["ids"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), b["ids"][:, 1:]).mean()
    return loss


def _models():
    return (MLP(features=MLP_KW["features"]),
            GPT(GPTConfig.tiny(tp_axis=None, ep_axis=None, **GPT_KW)))


def _draw():
    rng = np.random.default_rng(5)
    mlp, gpt = _models()
    x = rng.standard_normal((8, 20)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    mlp_params = _np(mlp.init(jax.random.PRNGKey(1), x[:1])["params"])
    ids = rng.integers(0, 256, (4, 32)).astype(np.int32)
    gpt_params = _np(gpt.init(jax.random.PRNGKey(2), ids[:1])["params"])
    return mlp_params, x, y, gpt_params, ids


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    mlp_params, x, y, gpt_params, ids = shared(tmp_path_factory,
                                               "zero_fsdp_data", _draw)
    mlp, gpt = _models()
    return {"mlp": (mlp, mlp_params, {"x": x, "y": y}),
            "gpt": (gpt, gpt_params, {"ids": ids})}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """JAX's ZeRO and FSDP runs and the port's two worlds, once for the
    whole run (``torch_shared.shared``); the worlds run while JAX
    computes. JAX's ZeRO state is resharded here, on the port's gathered
    moments, for ``test_zero_reshard_round_trip_matches_jax``."""
    def compute():
        zero, fsdp = _port_futures(data)
        jz, jf = _jax_zero(data), _jax_fsdp(data)
        zero, fsdp = zero.result(), fsdp.result()
        jz["reshard"] = _jax_reshard(jz.pop("state"), zero[0]["host"])
        return jz, jf, zero, fsdp
    return shared(tmp_path_factory, "zero_fsdp_runs", compute)


def _jax_reshard(state, host):
    """n = 2 -> 1 -> 2 on the host with JAX's ``zero_reshard``, the port's
    gathered moments in JAX's state: the moments at n = 1 and n = 2."""
    jstate = state.replace(opt_state=(state.opt_state[0]._replace(
        mu=host["exp_avg"], nu=host["exp_avg_sq"]),) + state.opt_state[1:])
    one = jelastic.zero_reshard(jstate, _mesh(1))
    two = jelastic.zero_reshard(one, _mesh(N))
    return {n: {leaf: np.asarray(getattr(s.opt_state[0], leaf))
                for leaf in ("mu", "nu")} for n, s in ((1, one), (2, two))}


def _port_futures(data):
    mlp_spec = ("mlp", MLP_KW, data["mlp"][1])
    gpt_spec = ("gpt", GPT_KW, data["gpt"][1])
    zero = helpers.run_world_async(
        ph.zero_world, N, args=(mlp_spec, data["mlp"][2], STEPS, LR))
    fsdp = helpers.run_world_async(
        ph.fsdp_world, N, args=({"mlp": mlp_spec, "gpt": gpt_spec},
                                {"mlp": data["mlp"][2],
                                 "gpt": {"ids": data["gpt"][2]["ids"].astype(
                                     np.int64)}},
                                STEPS, LR, MIN_SIZE, TREE))
    return zero, fsdp


def _jax_zero(data):
    model, params, batch = data["mlp"]
    mesh = _mesh(N)
    tx = optax.adam(LR)
    state = ZeroTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                         params), tx, mesh)
    step = make_zero_train_step(_mlp_loss(model), tx, mesh, donate=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        losses.append(float(loss))
    state = jax.device_get(state)
    return {"losses": losses, "params": _named(state.params),
            "mu": np.asarray(state.opt_state[0].mu),
            "nu": np.asarray(state.opt_state[0].nu), "state": state}


def _jax_fsdp(data):
    out = {}
    mesh = _mesh(N)
    for name, loss in (("mlp", _mlp_loss), ("gpt", _gpt_loss)):
        model, params, batch = data[name]
        init_fn, step_fn = make_fsdp_train_step(
            loss(model), optax.adam(LR), mesh, donate=False,
            min_size=MIN_SIZE)
        p, s = init_fn(jax.tree_util.tree_map(jnp.asarray, params))
        b = shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh)
        losses = []
        for _ in range(STEPS):
            p, s, l = step_fn(p, s, b)
            losses.append(float(l))
        out[name] = {"losses": losses, "params": _named(_np(p)),
                     "mu": _named(_np(s[0].mu)), "nu": _named(_np(s[0].nu))}
    return out


@pytest.fixture(scope="module")
def jax_zero(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_fsdp(runs):
    return runs[1]


@pytest.fixture(scope="module")
def zero(runs):
    return runs[2]


@pytest.fixture(scope="module")
def fsdp(runs):
    return runs[3]


def _close(got, want, msg="", atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=msg)


def test_zero_trajectory_matches_jax(jax_zero, zero):
    for rank in range(N):
        np.testing.assert_allclose(zero[rank]["zero_losses"],
                                   jax_zero["losses"], rtol=1e-5)
        for name, want in jax_zero["params"].items():
            got = zero[rank]["zero_params"][name]
            _close(got.T if got.ndim == 2 else got, want, name)


def test_zero_flat_moments_match_jax_layout(jax_zero, zero):
    """The gathered flat moments are JAX's: ``ravel_pytree``'s order and
    Flax layout, padded to n * shard_len."""
    for rank in range(N):
        _close(zero[rank]["host"]["exp_avg"], jax_zero["mu"])
        _close(zero[rank]["host"]["exp_avg_sq"], jax_zero["nu"])


def test_zero_moments_are_sharded(zero):
    numel = zero[0]["numel"]
    padded = numel + (-numel) % N
    for rank in range(N):
        assert zero[rank]["shard_len"] == padded // N
        for key in ("exp_avg", "exp_avg_sq"):
            assert zero[rank]["moments"][key].shape == (padded // N,)
        # the two shards are different halves of the vector
        np.testing.assert_array_equal(
            zero[rank]["moments"]["exp_avg"],
            zero[rank]["host"]["exp_avg"][rank * padded // N:
                                          (rank + 1) * padded // N])


def test_zero_matches_replicated_adam(zero):
    """The counterpart of JAX's replicated-Adam oracle: ZeRO-1 against
    ``hvd.DistributedOptimizer(Adam)`` through ``make_train_step``."""
    for rank in range(N):
        np.testing.assert_allclose(zero[rank]["zero_losses"],
                                   zero[rank]["ref_losses"], rtol=1e-5)
        for name, want in zero[rank]["ref_params"].items():
            _close(zero[rank]["zero_params"][name], want, name)


def test_zero_refuses_a_non_elementwise_optimizer(zero):
    assert "elementwise" in zero[0]["lbfgs"] and "LBFGS" in zero[0]["lbfgs"]


def test_eval_step_averages_metrics_over_the_axis(zero):
    """``make_eval_step`` averages each metric over the axis (JAX's
    ``pmean``): both ranks get the mean of their local values."""
    want = np.mean([zero[r]["eval_local"] for r in range(N)])
    for rank in range(N):
        np.testing.assert_allclose(zero[rank]["eval"], want, rtol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "gpt"])
def test_fsdp_restore_after_reshard_steps_as_the_original(fsdp, name):
    """The gathered host state, resharded 2 -> 1 -> 2 and restored into a
    fresh FSDP model and optimizer, takes the same next step, bit for
    bit (a layout change, not a value change)."""
    for rank in range(N):
        assert fsdp[rank][name]["restored_step_diff"] == 0.0


def test_zero_reshard_round_trip_matches_jax(jax_zero, zero):
    """n = 2 -> 1 -> 2 on the host: JAX's ``zero_reshard`` on the same
    values, the logical prefix kept and the pad zero; a step from the
    restored state equals a step of the original."""
    one, two = jax_zero["reshard"][1], jax_zero["reshard"][2]
    numel = zero[0]["numel"]
    for rank in range(N):
        for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            np.testing.assert_allclose(zero[rank]["n1"][key], one[leaf],
                                       rtol=1e-6)
            np.testing.assert_allclose(zero[rank]["n2"][key], two[leaf],
                                       rtol=1e-6)
            assert zero[rank]["n1"][key].shape == (numel,)
            assert not zero[rank]["n2"][key][numel:].any()
        for name, want in zero[rank]["continued_params"].items():
            np.testing.assert_allclose(zero[rank]["restored_params"][name],
                                       want, rtol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "gpt"])
def test_fsdp_trajectory_matches_jax(data, jax_fsdp, fsdp, name):
    ref = jax_fsdp[name]
    for rank in range(N):
        got = fsdp[rank][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        host = got["host"]
        init = _named(data[name][1])
        for leaf, want in ref["params"].items():
            got_p = host["params"][leaf]
            if name == "mlp":
                _close(got_p, want, leaf, atol=1e-5)
                continue
            nu = np.sqrt(ref["nu"][leaf])
            signal = nu >= 1e-6 * nu.max()
            moved = np.abs(want - init[leaf]).max()
            np.testing.assert_allclose(got_p[signal], want[signal], rtol=0,
                                       atol=5e-3 * moved, err_msg=leaf)
            np.testing.assert_allclose(got_p, want, rtol=0, atol=2 * LR,
                                       err_msg=leaf)
        for leaf, want in ref["mu"].items():
            _close(host["opt_state"][leaf]["exp_avg"], want, leaf, 1e-5)
            _close(host["opt_state"][leaf]["exp_avg_sq"], ref["nu"][leaf],
                   leaf, 1e-5)


@pytest.mark.parametrize("name", ["mlp", "gpt"])
def test_fsdp_holds_one_nth_of_sharded_params_and_moments(data, fsdp, name):
    """Each sharded leaf (JAX's ``fsdp_spec`` rule on the Flax shape) is
    held 1/n on each rank, its moments too; leaves under ``min_size`` stay
    whole."""
    from horovod_tpu.parallel.fsdp import fsdp_spec
    full = _named(data[name][1])
    got = fsdp[0][name]
    sharded = []
    for leaf, value in full.items():
        spec = fsdp_spec(value.shape, N, MIN_SIZE)
        shape = got["shapes"][leaf]
        if any(a is not None for a in spec):
            sharded.append(leaf)
            assert int(np.prod(shape)) * N == value.size, leaf
        else:
            assert int(np.prod(shape)) == value.size, leaf
        assert got["moment_shapes"][leaf] == shape, leaf
    assert sharded and sorted(sharded) == got["sharded"]
    assert len(sharded) < len(full)        # some leaves stay replicated


def test_fsdp_frees_gathered_bf16_weights_after_their_module(fsdp):
    """GPT tiny in bf16 at n = 2: at the end of the forward no storage the
    autograd graph holds for the backward has a full sharded weight's
    shape (or its transpose), while the unsharded model's graph holds its
    bf16 weights; the gathered weights come back in the backward, where
    each shard's gradient equals the unsharded model's gradient averaged
    over the ranks, bit for bit (one bf16 forward on the same weights, one
    fp32 sum of two)."""
    for rank in range(N):
        got = fsdp[rank]["bf16_saved"]
        full = {tuple(s) for s in got["full_shapes"]}
        full |= {s[::-1] for s in full}

        def weights(saved):
            return [(shape, nbytes) for shape, nbytes in saved
                    if shape in full and nbytes]
        assert weights(got["plain"]), "the walk sees the unsharded weights"
        assert not weights(got["fsdp"]), weights(got["fsdp"])
        assert got["grad_max_diff"] == 0.0


def test_fsdp_reshard_matches_jax_placement(fsdp):
    """``fsdp_reshard`` of JAX's test tree at n = 2: this rank's shards are
    JAX's shards on device ``rank``; after 2 -> 1 -> 2 the same again."""
    placed = jelastic.fsdp_reshard(TREE, _mesh(N), min_size=8)
    for rank in range(N):
        for key, arr in placed.items():
            want = next(s.data for s in arr.addressable_shards
                        if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(fsdp[rank]["tree"][key],
                                          np.asarray(want))
            np.testing.assert_array_equal(fsdp[rank]["tree_back"][key],
                                          np.asarray(want))
            np.testing.assert_array_equal(fsdp[rank]["tree_n1"][key],
                                          TREE[key])
