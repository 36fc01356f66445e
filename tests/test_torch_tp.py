"""Tensor parallelism at tp = 2: the port against the JAX package.

JAX: ``TPMlp``, ``TPSelfAttention`` (causal and not), ``TPSwiGLUMlp`` and
LLaMA's block (GQA 4/2) initialised and applied inside ``shard_map`` on a
2-device ``tp`` mesh, as ``TestTensorParallel`` and
``TestLlamaParallel::test_block_tp_matches_dense`` do; the gradients of
sum(y^2) with respect to the parameters (sharded as JAX lays them out) and
the replicated input. Port: one 2-process gloo world whose modules are
built inside ``in_step.axes`` over a ``tp`` DeviceMesh, each taking its
shard of the same Flax params through ``load_flax``.

Tolerances (fp32): outputs as JAX's own tests hold them against the dense
model (MLP rtol 1e-4 / atol 1e-5, attention and the LLaMA block rtol 2e-3
/ atol 2e-4); gradients, each reassembled from the two ranks' shards,
within 1e-4 of the tensor's largest entry (sums in another order: measured
~1e-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_parallel_helpers as ph
import torch_port_helpers as helpers
from horovod_tpu.models import LlamaBlock, LlamaConfig
from horovod_tpu.parallel.tp import TPMlp, TPSelfAttention, TPSwiGLUMlp
from horovod_tpu_torch.models.gpt import flax_key

TP = 2
COL, ROW = P(None, "tp"), P("tp", None)
D, F, H, KV = 32, 64, 4, 2
TOL = {"mlp": (1e-4, 1e-5), "swiglu": (1e-4, 1e-5),
       "attention": (2e-3, 2e-4), "attention_causal": (2e-3, 2e-4),
       "llama_block": (2e-3, 2e-4)}
SPECS = {
    "mlp": {"in": {"shard": {"kernel": COL, "bias": P("tp")}},
            "out": {"shard": {"kernel": ROW}, "bias": P()}},
    "swiglu": {"gate_up": {"shard": {"kernel": COL}},
               "out": {"shard": {"kernel": ROW}}},
    "attention": {"qkv": {"shard": {"kernel": COL, "bias": P("tp")}},
                  "out": {"shard": {"kernel": ROW}, "bias": P()}},
    "llama_block": {"ln_attn": {"scale": P()}, "ln_mlp": {"scale": P()},
                    "attention": {"qkv": {"shard": {"kernel": COL}},
                                  "out": {"shard": {"kernel": ROW}}},
                    "mlp": {"gate_up": {"shard": {"kernel": COL}},
                            "out": {"shard": {"kernel": ROW}}}}}
SPECS["attention_causal"] = SPECS["attention"]


def _jax_modules():
    cfg = LlamaConfig.tiny(hidden_size=D, num_heads=H, num_kv_heads=KV,
                           intermediate_size=F, tp_axis="tp")
    return {"mlp": TPMlp(intermediate_size=F, hidden_size=D),
            "swiglu": TPSwiGLUMlp(intermediate_size=F, hidden_size=D),
            "attention": TPSelfAttention(num_heads=H, hidden_size=D),
            "attention_causal": TPSelfAttention(num_heads=H, hidden_size=D,
                                                causal=True),
            "llama_block": LlamaBlock(cfg)}


def _port_kind(name):
    return {"attention_causal": "attention",
            "llama_block": "llama"}.get(name, name)


def _mesh():
    return Mesh(np.array(jax.devices()[:TP]), ("tp",))


def _jax_init(module, x, specs):
    """Params (global, JAX's sharded layout), drawn inside ``shard_map``."""
    return jax.jit(jax.shard_map(
        lambda r, xl: module.init(r, xl)["params"], mesh=_mesh(),
        in_specs=(P(), P()), out_specs=specs))(jax.random.PRNGKey(0), x)


def _jax_apply(module, params, x, specs):
    """y and the gradients of sum(y^2) with respect to the params and x."""
    def local(p, xl):
        def loss(p, xl):
            y = module.apply({"params": p}, xl)
            return jnp.sum(y.astype(jnp.float32) ** 2), y
        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(p, xl)
        return y, gp, gx

    out = jax.jit(jax.shard_map(
        local, mesh=_mesh(), in_specs=(specs, P()),
        out_specs=(P(), specs, P())))(params, x)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = {name: np.asarray(rng.standard_normal((2, 12, D)), np.float32)
         for name in SPECS}
    modules, params, cases = _jax_modules(), {}, {}
    for name, module in modules.items():
        params[name] = _jax_init(module, jnp.asarray(x[name]), SPECS[name])
        kw = dict(d=D, f=F, H=H, kv=KV, causal=name == "attention_causal")
        cases[name] = (_port_kind(name), kw,
                       jax.tree_util.tree_map(np.asarray, params[name]),
                       x[name])
    # The gloo world runs while JAX compiles its forward and backward.
    future = helpers.run_world_async(ph.tp_world, TP, args=(cases,))
    ref = {}
    for name, module in modules.items():
        y, gp, gx = _jax_apply(module, params[name], jnp.asarray(x[name]),
                               SPECS[name])
        ref[name] = {"y": y, "grads": gp, "dx": gx}
    return ref, future


@pytest.fixture(scope="module")
def port(data):
    return data[1].result()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _global(name, shards):
    """A parameter's gradient in the Flax layout, the ranks' shards joined
    as JAX lays the global array out."""
    flax = [s.T if name.endswith("shard.weight") else s for s in shards]
    parent = name.split(".")[-3] if name.endswith("shard.weight") or \
        name.endswith("shard.bias") else None
    if parent in ("in", "qkv", "gate_up"):
        return np.concatenate(flax, axis=-1)
    if parent == "out" and name.endswith("shard.weight"):
        return np.concatenate(flax, axis=0)
    np.testing.assert_array_equal(flax[0], flax[1], err_msg=name)
    return flax[0]


@pytest.mark.parametrize("name", list(SPECS))
def test_outputs_and_input_gradient_match_jax(data, port, name):
    ref = data[0][name]
    rtol, atol = TOL[name]
    for rank in range(TP):
        got = port[rank][name]
        np.testing.assert_allclose(got["y"], ref["y"], rtol=rtol, atol=atol)
        np.testing.assert_allclose(got["dx"], ref["dx"], rtol=0,
                                   atol=1e-4 * np.abs(ref["dx"]).max())


@pytest.mark.parametrize("name", list(SPECS))
def test_parameter_gradients_match_jax(data, port, name):
    ref = {flax_key(p): np.asarray(v) for p, v in
           _leaves(data[0][name]["grads"])}
    got = port[0][name]["grads"]
    assert set(got) == set(ref)
    for key, want in ref.items():
        have = _global(key, [port[r][name]["grads"][key] for r in range(TP)])
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


def test_shards_hold_one_nth_of_the_sharded_weights(port):
    shapes = port[0]["attention"]["shapes"]
    assert shapes["qkv.shard.weight"] == (3 * D // TP, D)
    assert shapes["out.shard.weight"] == (D, D // TP)
    assert shapes["out.bias"] == (D,)
    llama = port[0]["llama_block"]["shapes"]
    assert llama["attention.qkv.shard.weight"] == ((H + 2 * KV) * (D // H)
                                                   // TP, D)
    assert llama["mlp.gate_up.shard.weight"] == (2 * F // TP, D)


def test_divisibility_errors(port):
    for rank in range(TP):
        errors = port[rank]["errors"]
        assert all(e is not None and "divisible" in e for e in errors), \
            errors


def test_own_init_draws_distinct_shards(port):
    """Each shard of a sharded weight is drawn with its index folded in;
    the replicated parameters are drawn alike on both ranks."""
    a, b = port[0]["init"], port[1]["init"]
    sharded = [n for n in a if ".shard.weight" in n]
    assert sharded
    for n in sharded:
        assert not np.array_equal(a[n], b[n]), n
    for n in ("embed.tok_emb.weight", "embed.pos_emb", "head.lm_head.weight"):
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
