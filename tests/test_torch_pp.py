"""The port's pipeline schedules against the JAX package's.

JAX: ``parallel/pp.py``'s ``pipeline`` (GPipe, differentiated by AD) and
``pipeline_1f1b`` on the 8-device CPU mesh, the cases of
``test_parallel_strategies.py::TestPipelineParallel``. Port: the same
schedules (``horovod_tpu_torch/parallel/pp.py``) over 8 virtual stages in
one process (``virtual_hop`` hands each stage's output to the next where
the ``ppermute`` would), the same stage functions a rank runs over a real
axis (``test_torch_composite.py`` drives those over gloo). Also the
public ``pipeline``/``pipeline_1f1b`` with no axis bound (one stage), the
tick counts, the 1F1B stash, a dropped-hop control and the helpers.

Tolerance: JAX's own for these cases (rtol 1e-5 on outputs and losses,
rtol 1e-4 / atol 1e-5 on gradients; fp32, sums in another order); 1e-5
against the port's own sequential stack (microbatched products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu_torch.parallel import pp

S = 8


def _mesh():
    return Mesh(np.array(jax.devices()[:S], dtype=object), ("pp",))


def jax_layer(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def torch_layer(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _params(rng, n_layers, d):
    return {"w": np.asarray(rng.standard_normal((n_layers, d, d)) * 0.3,
                            np.float32),
            "b": np.asarray(rng.standard_normal((n_layers, d)) * 0.1,
                            np.float32)}


def _stages(params, mbs, n_stages=S, grad_mbs=False):
    """One StageRun per virtual stage over its block of the stacked
    layers."""
    lps = params["w"].shape[0] // n_stages
    runs = []
    for s in range(n_stages):
        sp = {k: torch.tensor(v[s * lps:(s + 1) * lps], requires_grad=True)
              for k, v in params.items()}
        m = torch.tensor(mbs, requires_grad=grad_mbs)
        runs.append(pp.StageRun(torch_layer, sp, s, n_stages, m))
    return runs


def _stage_grads(runs):
    return {k: np.concatenate([r.grads[i].numpy() for r in runs])
            for i, k in enumerate(("w", "b"))}


def _head_loss_jax(hp, y, t):
    return jnp.mean((y @ hp["wh"] - t) ** 2)


def _head_loss_torch(hp, y, t):
    return ((y @ hp["wh"] - t) ** 2).mean()


@pytest.mark.parametrize("n_micro", [1, 4])
def test_gpipe_outputs_match_jax(rng, n_micro):
    from horovod_tpu.parallel.pp import pipeline
    d, n_layers = 8, 16
    params = _params(rng, n_layers, d)
    mbs = np.asarray(rng.standard_normal((n_micro, 4, d)), np.float32)
    spec = {"w": P("pp"), "b": P("pp")}
    want = np.asarray(jax.jit(jax.shard_map(
        lambda p, m: pipeline(jax_layer, p, m, "pp"), mesh=_mesh(),
        in_specs=(spec, P()), out_specs=P()))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mbs)))
    runs = _stages(params, mbs)
    assert pp.gpipe_forward(runs, pp.virtual_hop) == n_micro + S - 1
    got = np.stack([runs[-1].outputs[m].numpy() for m in range(n_micro)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gpipe_gradients_match_jax(rng):
    """GPipe's reverse ticks against JAX's AD of the forward scan: the
    loss sum(out^2), every stage's gradients and the input's."""
    from horovod_tpu.parallel.pp import pipeline
    d, n_layers, n_micro = 6, 8, 2
    params = _params(rng, n_layers, d)
    mbs = np.asarray(rng.standard_normal((n_micro, 3, d)), np.float32)
    spec = {"w": P("pp"), "b": P("pp")}

    def local(p, m):
        return jax.value_and_grad(
            lambda p, m: jnp.sum(pipeline(jax_layer, p, m, "pp") ** 2),
            argnums=(0, 1))(p, m)

    loss, (grads, d_mb) = jax.jit(jax.shard_map(
        local, mesh=_mesh(), in_specs=(spec, P()),
        out_specs=(P(), (spec, P("pp")))))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mbs))
    runs = _stages(params, mbs, grad_mbs=True)
    pp.gpipe_forward(runs, pp.virtual_hop)
    out = torch.stack([runs[-1].outputs[m] for m in range(n_micro)])
    np.testing.assert_allclose(float((out ** 2).sum()), float(loss),
                               rtol=1e-5)
    assert pp.gpipe_backward(runs, pp.virtual_hop,
                             [2 * out] * S) == n_micro + S - 1
    for k, v in _stage_grads(runs).items():
        np.testing.assert_allclose(v, np.asarray(grads[k]), rtol=1e-4,
                                   atol=1e-5)
    # JAX's d_mb out_spec P("pp") stacks each device's; stage 0's is real.
    got = np.stack([runs[0].d_mb[m].numpy() for m in range(n_micro)])
    np.testing.assert_allclose(got, np.asarray(d_mb)[:n_micro], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n_micro", [2, 16])   # 16 > 2S-1: the stash wraps
def test_1f1b_matches_jax(rng, n_micro):
    from horovod_tpu.parallel.pp import pipeline_1f1b
    d, n_layers = 6, 16
    params = _params(rng, n_layers, d)
    head = {"wh": np.asarray(rng.standard_normal((d, 3)) * 0.5, np.float32)}
    mbs = np.asarray(rng.standard_normal((n_micro, 3, d)), np.float32)
    tgts = np.asarray(rng.standard_normal((n_micro, 3, 3)), np.float32)
    spec = {"w": P("pp"), "b": P("pp")}
    loss, (d_stage, d_head, d_mb) = jax.jit(jax.shard_map(
        lambda p, h, m, t: pipeline_1f1b(jax_layer, _head_loss_jax, p, h, m,
                                         t, "pp"),
        mesh=_mesh(), in_specs=(spec, P(), P(), P()),
        out_specs=(P(), (spec, P(), P()))))(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, head), jnp.asarray(mbs),
            jnp.asarray(tgts))

    runs = _stages(params, mbs, grad_mbs=True)
    hp = {"wh": torch.tensor(head["wh"], requires_grad=True)}
    heads = [pp.Head(_head_loss_torch, hp, torch.tensor(tgts), n_micro)
             if r.last else None for r in runs]
    assert pp.run_1f1b(runs, pp.virtual_hop, heads) == n_micro + 2 * S - 2
    assert runs[0].ssize == min(n_micro, 2 * S - 1)
    np.testing.assert_allclose(float(heads[-1].loss_sum), float(loss),
                               rtol=1e-5)
    for k, v in _stage_grads(runs).items():
        np.testing.assert_allclose(v, np.asarray(d_stage[k]), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(heads[-1].grads[0].numpy(),
                               np.asarray(d_head["wh"]), rtol=1e-4,
                               atol=1e-5)
    got = np.stack([runs[0].d_mb[m].numpy() for m in range(n_micro)])
    np.testing.assert_allclose(got, np.asarray(d_mb), rtol=1e-4, atol=1e-5)


def test_dropped_hop_control_fails(rng):
    """A schedule with one forward hop dropped (stage 3 gets zeros at one
    tick) must miss the sequential outputs by far more than the bound."""
    d, n_layers, n_micro = 8, 16, 4
    params = _params(rng, n_layers, d)
    mbs = np.asarray(rng.standard_normal((n_micro, 4, d)), np.float32)
    calls = []

    def dropping(sends, step):
        got = pp.virtual_hop(sends, step)
        calls.append(None)
        if len(calls) == 5:
            got[3] = torch.zeros_like(got[3])
        return got

    outs = {}
    for name, hop in (("ok", pp.virtual_hop), ("dropped", dropping)):
        runs = _stages(params, mbs)
        pp.gpipe_forward(runs, hop)
        outs[name] = np.stack([runs[-1].outputs[m].numpy()
                               for m in range(n_micro)])
    x = torch.tensor(mbs)
    for i in range(n_layers):
        x = torch_layer({k: torch.tensor(v[i]) for k, v in params.items()},
                        x)
    ref = x.numpy()
    bound = 1e-5 * (1 + np.abs(ref).max())
    assert np.abs(outs["ok"] - ref).max() <= bound
    assert np.abs(outs["dropped"] - ref).max() > 10 * bound


def test_unbound_axis_is_one_stage(rng):
    """With no pp axis bound, ``pipeline`` and ``pipeline_1f1b`` run one
    stage: the sequential stack and its autograd."""
    d, n_layers, n_micro = 6, 4, 3
    params = _params(rng, n_layers, d)
    mbs = np.asarray(rng.standard_normal((n_micro, 2, d)), np.float32)
    tgts = np.asarray(rng.standard_normal((n_micro, 2, d)), np.float32)

    def seq(p, m):
        x = m
        for i in range(n_layers):
            x = torch_layer({k: v[i] for k, v in p.items()}, x)
        return x

    ref_p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    ref_m = torch.tensor(mbs, requires_grad=True)
    (seq(ref_p, ref_m) ** 2).sum().backward()
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    m = torch.tensor(mbs, requires_grad=True)
    (pp.pipeline(torch_layer, p, m) ** 2).sum().backward()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), ref_p[k].grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.grad.numpy(), ref_m.grad.numpy(),
                               rtol=1e-5, atol=1e-5)

    def mse(hp, y, t):
        return ((y * hp["s"] - t) ** 2).mean()
    hp = {"s": torch.tensor(1.5, requires_grad=True)}
    loss, (d_stage, d_head, d_mb) = pp.pipeline_1f1b(
        torch_layer, mse, p, hp, torch.tensor(mbs, requires_grad=True),
        torch.tensor(tgts))
    ref_p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    ref_h = torch.tensor(1.5, requires_grad=True)
    ref_m = torch.tensor(mbs, requires_grad=True)
    ref = torch.stack([mse({"s": ref_h}, seq(ref_p, ref_m[i]),
                           torch.tensor(tgts[i])) for i in range(n_micro)])
    ref.mean().backward()
    np.testing.assert_allclose(float(loss), float(ref.mean()), rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(d_stage[k].numpy(),
                                   ref_p[k].grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(d_head["s"]), float(ref_h.grad),
                               rtol=1e-5)
    np.testing.assert_allclose(d_mb.numpy(), ref_m.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_stack_and_split_helpers():
    per_layer = [{"w": torch.full((2,), float(i))} for i in range(8)]
    stacked = pp.stack_stage_params(per_layer, 4)
    assert stacked["w"].shape == (8, 2)
    assert stacked["w"][5].tolist() == [5.0, 5.0]
    batch = {"x": torch.zeros((12, 5))}
    assert pp.split_microbatches(batch, 4)["x"].shape == (4, 3, 5)
    with pytest.raises(ValueError, match="divisible"):
        pp.split_microbatches(batch, 5)
    with pytest.raises(ValueError, match="divisible"):
        pp.stack_stage_params(per_layer, 3)
