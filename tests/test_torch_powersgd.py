"""The port's PowerSGD (``horovod_tpu_torch/optim/powersgd.py``, the
``DistributedOptimizer`` route, ``Compression.powersgd``) against the JAX
package's ``optim/powersgd.py`` on the same numpy inputs.

The functional core, in a 2-rank gloo world started on a thread while JAX
compiles, against ``powersgd_gradients_transform`` in a ``shard_map`` over
2 CPU devices: the same per-rank gradients for 3 rounds, from the same
initial state (JAX's Q, drawn from ``PRNGKey(17 + i)``, carried across),
each side carrying its own state after that. Leaves: a (32, 16) matrix, a
bias, a 2 x 2 matrix (below ``min_compression_rate``: plain) and a bf16
(24, 20) matrix, with ``ef_dtype=float32``; Average, and Sum with a
prescale and a postscale.

Tolerances: ``jnp.linalg.qr`` and ``torch.linalg.qr`` (LAPACK on both) may
flip a column's sign and round in another order, so Q is compared up to
column sign, and the updates, residuals and Q within rtol 1e-4, atol 1e-5
(JAX's own PowerSGD tests), the bf16 leaf's update within two bf16 steps
(rtol 2^-7); the plain leaves within rtol 1e-6. The reconstruction
identity M̂ + e_new = M (the prescaled gradient plus e_prev) holds within
fp32 rounding on every rank.

The 2-rank MLP trained with ``DistributedOptimizer(SGD(0.05, momentum
0.9), compression=Compression.powersgd(4))`` against JAX's
``DistributedOptimizer(optax.sgd(...), compression=...)`` from the same
weights and initial PowerSGD state (loaded by ``load_flax``): parameters
and losses after 4 steps within rtol 1e-4, atol 1e-5. Every Dense kernel
is compressed in its Flax view, (in, out); in torch's (out, in) the factors
would differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_helpers as helpers
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models import mlp as jm
from horovod_tpu.ops.collective_ops import Average, Sum
from horovod_tpu.ops.compression import Compression as JCompression
from horovod_tpu.ops.in_jit import mark_varying
from horovod_tpu.optim import DistributedOptimizer as JDistributedOptimizer
from horovod_tpu.optim import powersgd as jp
from horovod_tpu.parallel import TrainState, make_train_step
from horovod_tpu_torch.models import MLP, load_flax_mlp
from horovod_tpu_torch.models.resnet import Conv
from horovod_tpu_torch.optim import powersgd as tp
from horovod_tpu_torch.parallel.tp import Dense, flax_view, from_flax_view
from test_torch_bert import draw_params

RANK = 2
LEAVES = {"a_mat": ((32, 16), "float32"), "b_bias": ((16,), "float32"),
          "c_tiny": ((2, 2), "float32"), "d_bf16": ((24, 20), "bfloat16")}
CASES = [("avg", "Average", 1.0, 1.0), ("sum", "Sum", 0.5, 3.0)]
ROUNDS = 3
MLP_STEPS, MLP_LR, MLP_BATCH, MLP_RANK = 4, 0.05, 16, 4
RTOL, ATOL = 1e-4, 1e-5
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _jax_state0(tx):
    zeros = {k: jnp.zeros(s, _JDT[dt]) for k, (s, dt) in LEAVES.items()}
    st = tx.init(zeros)
    return {k: [np.asarray(v, np.float32) for v in vs]
            for k, vs in st.items()}


def _rounds(seed):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal((2,) + s).astype(np.float32), dt)
             for s, dt in LEAVES.values()] for _ in range(ROUNDS)]


def _jax_core(op, pre, post, rounds, state0):
    """JAX's transform, round after round, per rank: (updates, q, err)."""
    tx = jp.powersgd_gradients_transform(
        rank=RANK, op=op, prescale_factor=pre, postscale_factor=post,
        ef_dtype=jnp.float32)
    names = list(LEAVES)
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))

    def body(gs, qs, errs):
        g = {k: mark_varying(x[0]) for k, x in zip(names, gs)}
        state = {"q": tuple(q[0] for q in qs),
                 "err": tuple(mark_varying(e[0]) for e in errs)}
        u, s = tx.update(g, state)
        return (tuple(u[k][None] for k in names),
                tuple(mark_varying(q)[None] for q in s["q"]),
                tuple(e[None] for e in s["err"]))

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(HVD_AXIS),
                              out_specs=P(HVD_AXIS)))
    qs = tuple(np.stack([q, q]) for q in state0["q"])
    errs = tuple(np.stack([e, e]) for e in state0["err"])
    got = []
    for leaves in rounds:
        gs = tuple(jnp.asarray(a, _JDT[dt]) for a, dt in leaves)
        u, qs, errs = f(gs, qs, errs)
        got.append({"out": [np.asarray(x, np.float32) for x in u],
                    "q": [np.asarray(x) for x in qs],
                    "err": [np.asarray(x) for x in errs]})
    return got


@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((MLP_BATCH, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, MLP_BATCH).astype(np.int32)
    model = jm.MLP()
    params = draw_params(model, x[:1], seed=22)
    opt = JDistributedOptimizer(optax.sgd(MLP_LR, momentum=0.9),
                                compression=JCompression.powersgd(MLP_RANK))
    psgd0 = opt.init(jax.tree_util.tree_map(jnp.asarray, params))[0]
    state0 = {k: [np.asarray(v) for v in vs] for k, vs in psgd0.items()}
    return model, params, opt, state0, x, y


@pytest.fixture(scope="module")
def worlds(mlp_data):
    _, params, _, state0, x, y = mlp_data
    tx = jp.powersgd_gradients_transform(rank=RANK, ef_dtype=jnp.float32)
    s0 = _jax_state0(tx)
    core = [(case, op, pre, post, RANK, _rounds(i), s0)
            for i, (case, op, pre, post) in enumerate(CASES)]
    data = {"core": core,
            "mlp": (params, state0, x, y, MLP_STEPS, MLP_LR, MLP_RANK)}
    port = helpers.run_world_async(helpers.powersgd_world, 2, args=(data,))
    refs = {case: _jax_core({"Average": Average, "Sum": Sum}[op], pre,
                            post, rounds, st)
            for case, op, pre, post, _, rounds, st in core}
    return data, refs, port.result()


def _align(q, ref):
    """``q``'s columns with the sign of ``ref``'s."""
    s = np.sign(np.sum(q * ref, axis=0))
    return q * np.where(s == 0, 1, s)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_core_matches_jax_transform(worlds, case):
    _, refs, port = worlds
    for r in range(2):
        for got, want in zip(port[r][case], refs[case]):
            for i, (name, (_, dt)) in enumerate(LEAVES.items()):
                rtol = 2.0 ** -7 if dt == "bfloat16" else \
                    1e-6 if name in ("b_bias", "c_tiny") else RTOL
                np.testing.assert_allclose(
                    got["out"][i], want["out"][i][r], rtol=rtol, atol=ATOL,
                    err_msg=f"{case} {name} update")
                np.testing.assert_allclose(
                    got["err"][i], want["err"][i][r], rtol=RTOL, atol=ATOL,
                    err_msg=f"{case} {name} residual")
                if got["q"][i].size:
                    np.testing.assert_allclose(
                        _align(got["q"][i], want["q"][i][r]),
                        want["q"][i][r], rtol=RTOL, atol=ATOL,
                        err_msg=f"{case} {name} Q")


def test_error_feedback_reconstruction_identity(worlds):
    """M̂ + e_new = M + e_prev on every rank (Average, no scales): what
    the wire dropped is this rank's residual; a control without the
    residual's re-injection misses by e_prev."""
    data, _, port = worlds
    case, _, _, _, _, rounds, s0 = data["core"][0]
    for r in range(2):
        prev = [np.asarray(e) for e in s0["err"]]
        for leaves, got in zip(rounds, port[r][case]):
            g = leaves[0][0][r]                    # the fp32 matrix
            m_hat, e = got["out"][0], got["err"][0]
            np.testing.assert_allclose(m_hat + e, g + prev[0], rtol=1e-5,
                                       atol=1e-5)
            if np.abs(prev[0]).max() > 1e-3:
                assert not np.allclose(m_hat + e, g, atol=1e-5)
            prev = got["err"]


def test_mlp_trajectory_matches_jax(mlp_data, worlds):
    model, params, opt, _, x, y = mlp_data
    _, _, port = worlds
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["x"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, b["y"]).mean()

    step = make_train_step(loss_fn, opt, mesh, donate=False)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                              opt)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    losses = []
    for _ in range(MLP_STEPS):
        state, loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        losses.append(float(loss))
    ref = {n: helpers.to_np(t) for n, t in load_flax_mlp(
        MLP(), jax.tree_util.tree_map(np.asarray, state.params))
        .named_parameters()}
    for r in range(2):
        got = port[r]["mlp"]
        for name, want in ref.items():
            np.testing.assert_allclose(got["params"][name], want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        assert got["state_keys"] == ["momentum_buffer", "powersgd_err",
                                     "powersgd_q"]
        # Each step: the P's (with the plain biases) then the Q's as one
        # group.
        for step_buckets in got["buckets"]:
            assert [sorted({n.split(".")[0] + "." + n.split(".")[1]
                            if n.startswith("powersgd") else "plain"
                            for n in b}) for b in step_buckets] == [
                ["plain", "powersgd.p"], ["powersgd.q"]], step_buckets
    mean = np.mean([port[r]["mlp"]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=RTOL, atol=ATOL)
    assert mean[-1] < mean[0]


def _module_params():
    gen = torch.Generator().manual_seed(3)
    dense = Dense(16, 40)
    conv3 = Conv(4, 8, (3, 3))
    conv1 = Conv(32, 64, (1, 1))
    for m in (dense, conv3, conv1):
        m.reset_parameters(gen)
    return {"dense": dense.weight, "conv3x3": conv3.weight,
            "conv1x1": conv1.weight}


@pytest.mark.parametrize("which", ["dense", "conv3x3", "conv1x1"])
def test_flax_view_gives_jax_decision_and_factors(which):
    """A port Dense / Conv parameter, matrixized through its Flax view, gets
    JAX's compress-or-not verdict on the Flax leaf and JAX's factors
    (P = M Q, its QR, Q = Mᵀ P) on the same Q; a 1 x 1 convolution is
    compressed in torch's layout but not in JAX's (dim 0 is its height)."""
    p = _module_params()[which]
    g = torch.randn(p.shape, generator=torch.Generator().manual_seed(4))
    leaf = flax_view(p, g)
    flax_shape = {"dense": (16, 40), "conv3x3": (3, 3, 4, 8),
                  "conv1x1": (1, 1, 32, 64)}[which]
    assert tuple(leaf.shape) == flax_shape
    assert torch.equal(from_flax_view(p, leaf), g)
    decision = jp._use_powersgd(flax_shape, 4, 2.0)
    assert tp.use_powersgd(leaf.shape, 4, 2.0) == decision
    assert decision == (which == "dense")
    if which == "conv1x1":
        assert tp.use_powersgd(tuple(g.shape), 4, 2.0)   # the wrong layout
    if not decision:
        return
    core = tp.PowerSGD(rank=4)
    q = np.array(jp._init_q(flax_shape, 4, 0, jnp.float32))
    m = core.error_fed(leaf, torch.zeros(leaf.shape))
    pm = core.phase1(m, torch.from_numpy(q))
    pq, q2 = core.phase2(m, pm)
    jm_ = jp._as_matrix(jnp.asarray(leaf.numpy()))
    jpm = jm_ @ q
    jpq = jnp.linalg.qr(jpm)[0]
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_align(pq.numpy(), np.asarray(jpq)),
                               np.asarray(jpq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_align(q2.numpy(), np.asarray(jm_.T @ jpq)),
                               np.asarray(jm_.T @ jpq), rtol=1e-4,
                               atol=1e-5)
    # In torch's layout the matrix, and so P, is another one.
    assert tuple(tp.as_matrix(g).shape) != tuple(jm_.shape)


def test_wire_numbers_equal_jax():
    shapes = [(1024, 1024), (1024,), (2, 2), (768, 2304), (3, 3, 64, 64),
              (1, 1, 256, 1024), (50304, 768), (5,), ()]
    for r in (1, 2, 4, 8):
        for rate in (1.0, 2.0, 4.0):
            for k in range(1, len(shapes) + 1):
                assert tp.powersgd_wire_numbers(shapes[:k], r, rate) == \
                    jp.powersgd_wire_numbers(shapes[:k], r, rate)
    for shape in shapes:
        for r in (1, 4):
            assert tp.use_powersgd(shape, r, 2.0) == \
                jp._use_powersgd(shape, r, 2.0)


def test_misuse_raises_as_jax():
    import horovod_tpu_torch as hvd
    with pytest.raises(ValueError, match="rank must be >= 1"):
        hvd.Compression.powersgd(rank=0)
    with pytest.raises(ValueError, match="Sum/Average only"):
        tp.PowerSGD(rank=2, op=hvd.Min)
    with pytest.raises(ValueError, match="stateful"):
        hvd.allreduce(torch.ones(64, 64),
                      compression=hvd.Compression.powersgd(rank=2))
    c = hvd.Compression.powersgd(rank=3, ef_dtype=torch.float32)
    assert (c.rank, c.min_compression_rate, c.ef_dtype) == \
        (3, 2.0, torch.float32)


def test_load_flax_round_trips_powersgd_state(mlp_data):
    """JAX's PowerSGD state (Flax leaf order) into the port's optimizer by
    name, in the Flax view, and back: equal; uncompressed leaves hold
    none. A step of the wrapped AdamW then initializes its own state
    beside it (its lazy init wants a state without PowerSGD's keys) and
    leaves PowerSGD's as loaded."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import _leaves, flax_key
    from horovod_tpu_torch.torch.optimizer import POWERSGD_ERR, POWERSGD_Q
    _, params, _, state0, _, _ = mlp_data
    model = MLP()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.powersgd(MLP_RANK))
    rng = np.random.default_rng(5)
    state = {"q": state0["q"],
             "err": [rng.standard_normal(e.shape).astype(np.float32)
                     for e in state0["err"]]}
    load_flax_mlp(model, params, optimizer=opt, powersgd_state=state)
    named = dict(model.named_parameters())
    back = {"q": [], "err": []}
    for path in sorted(p for p, _ in _leaves(params)):
        st = opt.state.get(named[flax_key(path)], {})
        back["q"].append(helpers.to_np(st[POWERSGD_Q]) if st
                         else np.zeros((0,), np.float32))
        back["err"].append(helpers.to_np(st[POWERSGD_ERR]) if st
                           else np.zeros((0,), np.float32))
        if st:     # a kernel: Q is (out, r), the residual (in, out)
            assert st[POWERSGD_ERR].shape == tuple(
                flax_view(named[flax_key(path)],
                          named[flax_key(path)]).shape)
    for k in ("q", "err"):
        assert len(back[k]) == len(state[k]) == 6
        for a, b in zip(back[k], state[k]):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    before = {p: [t.clone() for t in st.values()]
              for p, st in opt.state.items()}
    for p in named.values():
        p.grad = torch.zeros_like(p)        # no hook: nothing to reduce
    opt.step()
    for p in named.values():
        keys = set(opt.state[p])
        assert {"step", "exp_avg", "exp_avg_sq"} <= keys
        if p in before:
            assert keys >= {POWERSGD_Q, POWERSGD_ERR}
            assert all(torch.equal(a, b) for a, b in zip(
                before[p], (opt.state[p][POWERSGD_Q],
                            opt.state[p][POWERSGD_ERR])))
    opt._remove_hooks()
