"""The port's MoE layer and MoE GPT against the JAX package, in one process.

JAX: ``parallel/moe.py``'s ``MoEMlp`` and ``_router`` with no axis bound
(every expert local, the oracle of ``TestMoE``), and ``models/gpt.py``'s
GPT with MoE blocks. Port: ``horovod_tpu_torch/parallel/moe.py`` (the
route as indices) and ``models/gpt.py`` (``GPTMoEBlock``, ``moe_aux``), with
the Flax weights carried by ``load_flax``.

- the route: each token's choice of (expert, slot) and its gate, against
  JAX's dense one-hot dispatch and combine tensors, bit for bit, top-1 and
  top-2, with drops; the aux loss;
- ``MoEMlp``: outputs, aux and the gradients of sum(y^2) + aux (input,
  router, experts), top-1 and top-2, with and without drops; identical
  tokens overflow their expert;
- GPT tiny with MoE blocks every second layer: logits, the aux losses JAX
  sows under ``losses/moe_aux`` (``model.moe_aux``), the loss and every
  gradient; remat bit-equal.

Tolerance: rtol 2e-4 / atol 1e-5 on the layer (``TestMoE``'s own); the GPT
as ``test_torch_gpt.py`` holds it (logits rtol 1e-4 / atol 1e-5, each
gradient within 1e-4 of its tensor's largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import gpt as jg
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.parallel import moe as tmoe
from test_torch_a2a_hierarchy import moe_params

TOL = dict(rtol=2e-4, atol=1e-5)
CASES = {          # name -> (k, capacity_factor, T, seed)
    "k1": (1, 8.0, 64, 0),
    "k2": (2, 8.0, 64, 1),
    "k1_drop": (1, 0.5, 64, 2),
    "k2_drop": (2, 0.75, 64, 3),
}
D, F_, E = 8, 16, 8


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_matches_jax_dispatch(name):
    """The port's (slot, gate) route, laid out densely, is JAX's dispatch
    and combine tensors bit for bit; the aux loss too."""
    k, cf, T, seed = CASES[name]
    rng = np.random.default_rng(seed)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((T, E)),
                                       jnp.float32) * 2.0, axis=-1)
    C = max(1, int(cf * k * T / E))
    dispatch, combine, aux = jmoe._router(None, probs, k, C)
    route = tmoe._router(torch.from_numpy(np.asarray(probs)), k, C)
    dense = torch.zeros(T, E * C + 1)
    gates = torch.zeros(T, E * C + 1)
    for j in range(k):
        dense[torch.arange(T), route.slot[:, j]] = 1.0
        gates[torch.arange(T), route.slot[:, j]] = route.gate[:, j]
    np.testing.assert_array_equal(_np(dense[:, :E * C]).reshape(T, E, C),
                                  np.asarray(dispatch))
    np.testing.assert_array_equal(_np(gates[:, :E * C]).reshape(T, E, C),
                                  np.asarray(combine))
    np.testing.assert_allclose(float(route.aux), float(aux), rtol=1e-6)
    if name.endswith("drop"):
        assert int((route.slot == E * C).sum()) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_matches_jax(name):
    k, cf, T, seed = CASES[name]
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal((T, D)), np.float32)
    jm = jmoe.MoEMlp(num_experts=E, hidden_size=D, intermediate_size=F_,
                     k=k, capacity_factor=cf, axis_name=None)
    params = moe_params(rng, D, F_, E)

    def loss(p, xx):
        y, aux = jm.apply({"params": p}, xx)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tm = tg.load_flax(tmoe.MoEMlp(E, D, F_, k=k, capacity_factor=cf,
                                  axis_name=None),
                      params)
    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = tm(xt)
    ((ty ** 2).sum() + taux).backward()
    np.testing.assert_allclose(_np(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), **TOL)
    np.testing.assert_allclose(_np(tm.router.weight.grad.t()),
                               np.asarray(gp["router"]["kernel"]), **TOL)
    np.testing.assert_allclose(_np(tm.w_in.grad), np.asarray(gp["w_in"]),
                               **TOL)
    np.testing.assert_allclose(_np(tm.w_out.grad), np.asarray(gp["w_out"]),
                               **TOL)


def test_identical_tokens_overflow_their_expert():
    """JAX's ``test_capacity_drops_overflow``: 64 identical tokens all
    route to one expert of capacity 2; the rest pass through as zeros."""
    m = tmoe.MoEMlp(8, 4, 8, capacity_factor=0.25, axis_name=None)
    y, aux = m(torch.ones(64, 4))
    assert y.shape == (64, 4)
    assert int((y.abs().sum(-1) > 1e-12).sum()) <= 2
    assert int(m.last_dropped) == 62
    assert np.isfinite(float(aux))


GPT_KW = dict(num_layers=4, max_position_embeddings=64, tp_axis=None,
              ep_axis=None, num_experts=4, capacity_factor=4.0)


@pytest.fixture(scope="module")
def gpt_moe():
    model = jg.GPT(jg.GPTConfig.tiny(**GPT_KW))
    ids = np.random.default_rng(7).integers(0, 256, (2, 32)).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])

    def loss(p):
        logits, sown = model.apply({"params": p}, jnp.asarray(ids),
                                   mutable=["losses"])
        aux = [v["moe_aux"][0] for _, v in sorted(sown["losses"].items())]
        ce = -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits[:, :-1]), ids[:, 1:, None], -1))
        return ce + 0.01 * sum(aux), (logits, aux)

    (l, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return ids, params, {"loss": float(l), "logits": np.asarray(logits),
                         "aux": [float(a) for a in aux],
                         "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_loss(m, ids):
    logits = m(ids)
    ce = F.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())
    return ce + 0.01 * sum(m.moe_aux), logits


def test_gpt_moe_matches_flax(gpt_moe):
    ids, params, ref = gpt_moe
    m = tg.load_flax(tg.GPT(tg.GPTConfig.tiny(**GPT_KW)), params)
    assert [type(getattr(m, f"layer_{i}")).__name__ for i in range(4)] == [
        "TPTransformerBlock", "GPTMoEBlock"] * 2
    loss, logits = _port_loss(m, torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(_np(logits), ref["logits"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose([float(a) for a in m.moe_aux], ref["aux"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    named = dict(m.named_parameters())
    n = 0
    for path, g in tg._leaves(ref["grads"]):
        p = named[tg.flax_key(path)]
        got = _np(p.grad.t() if path[-1] == "kernel" else p.grad)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg="/".join(path))
        n += 1
    assert n == len(named)


def test_gpt_moe_remat_bit_equal(gpt_moe):
    ids, params, _ = gpt_moe
    grads = []
    for remat in (False, True):
        m = tg.load_flax(tg.GPT(tg.GPTConfig.tiny(**GPT_KW, remat=remat)),
                         params)
        _port_loss(m, torch.from_numpy(ids).long())[0].backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
