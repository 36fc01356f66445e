"""GPT and LLaMA under sequence and tensor parallelism against JAX.

JAX: the unsharded GPT and LLaMA (tiny) logits on the same ids and Flax
params, the oracle of ``TestSequenceParallelGPT::test_logits_match_unsharded``
and ``TestLlamaParallel::test_sp_logits_match_unsharded``. Port: a
2-process gloo world over an ``hvd`` DeviceMesh (sp = 2: ring and Ulysses,
LLaMA also through the flash ring) and one 4-process world over an
(sp, tp) = (2, 2) mesh (tp x sp, ring through the flash kernels' plain
versions and Ulysses), each model built inside the mesh and taking its tp
shard of the unsharded weights, which the test first lays out as JAX's
``shard_map`` out_specs lay sharded ones out (:func:`blocked`); each rank
returns its token shard's logits. Also the position-overflow error,
one SGD step through ``parallel/dp.py::make_train_step`` on a
(dp, sp) = (1, 2) mesh against the unsharded model's step, and, in the
4-process world, ``ops/in_step.py``'s collectives against
``ops/in_jit.py``'s under ``shard_map`` on 4 devices (fp32, rtol 1e-6:
one sum in another order; the set's ops exactly where they select).

Tolerance (fp32): rtol 2e-3 / atol 2e-3, JAX's own for these logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_helpers as ph
import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.models.gpt import GPT, GPTConfig
from horovod_tpu.models.llama import Llama, LlamaConfig

GPT_KW = dict(num_heads=8, hidden_size=64, max_position_embeddings=64)
LLAMA_KW = dict(num_heads=8, num_kv_heads=4, hidden_size=64,
                max_position_embeddings=64)
# name -> (family, port config kwargs beyond the base, base kwargs)
SP_CASES = {
    "gpt_ring": ("gpt", dict(sp_axis="hvd", sp_impl="ring")),
    "gpt_ulysses": ("gpt", dict(sp_axis="hvd", sp_impl="ulysses")),
    "llama_ring": ("llama", dict(sp_axis="hvd", sp_impl="ring")),
    "llama_ulysses": ("llama", dict(sp_axis="hvd", sp_impl="ulysses")),
    "llama_ring_flash": ("llama", dict(sp_axis="hvd", sp_impl="ring",
                                       use_flash=True, num_layers=2)),
}
TP_SP_CASES = {
    "gpt_ring_flash": ("gpt", dict(sp_axis="sp", tp_axis="tp",
                                   sp_impl="ring", use_flash=True)),
    "gpt_ulysses": ("gpt", dict(sp_axis="sp", tp_axis="tp",
                                sp_impl="ulysses")),
    "llama_ring_flash": ("llama", dict(sp_axis="sp", tp_axis="tp",
                                       sp_impl="ring", use_flash=True,
                                       num_layers=2)),
    "llama_ulysses": ("llama", dict(sp_axis="sp", tp_axis="tp",
                                    sp_impl="ulysses")),
}


def _jax_model(family, layers):
    if family == "gpt":
        return GPT(GPTConfig.tiny(tp_axis=None, ep_axis=None,
                                  num_layers=layers, **GPT_KW))
    return Llama(LlamaConfig.tiny(tp_axis=None, num_layers=layers,
                                  **LLAMA_KW))


def blocked(tree, n, hidden, path=()):
    """The unsharded Flax params with each fused column leaf in JAX's
    tp-sharded layout: QKV as ``[q_s|k_s|v_s] * n`` (Q ``hidden`` wide, K
    and V the rest halved), gate_up as ``[gate_s|up_s] * n``; the inverse
    of ``test_parallel_strategies.py``'s reconstruction."""
    out = {}
    for key, v in tree.items():
        if hasattr(v, "items"):
            out[key] = blocked(v, n, hidden, path + (key,))
            continue
        w = v.shape[-1]
        if "qkv" in path:
            widths = (hidden, (w - hidden) // 2, (w - hidden) // 2)
        elif "gate_up" in path:
            widths = (w // 2, w // 2)
        else:
            out[key] = v
            continue
        parts = np.split(v, np.cumsum(widths)[:-1], axis=-1)
        out[key] = np.concatenate([np.split(part, n, axis=-1)[s]
                                   for s in range(n) for part in parts],
                                  axis=-1)
    return out


def _port_kw(family, kw):
    base = dict(GPT_KW if family == "gpt" else LLAMA_KW)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return shared(tmp_path_factory, "sp_models_data", _data)


def _data():
    ids = np.random.default_rng(21).integers(0, 256, (2, 64)).astype(
        np.int32)
    refs, params = {}, {}
    for family in ("gpt", "llama"):
        for layers in (2, 4):
            m = _jax_model(family, layers)
            p = m.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
            params[family, layers] = jax.tree_util.tree_map(np.asarray, p)
            refs[family, layers] = np.asarray(m.apply({"params": p},
                                                      jnp.asarray(ids)))

    def cases(table, tp):
        out = {}
        for name, (family, kw) in table.items():
            layers = kw.get("num_layers", 4)
            p = params[family, layers]
            if tp > 1:
                p = blocked(p, tp, _port_kw(family, kw)["hidden_size"])
            out[name] = (family, _port_kw(family, kw), p,
                         ids.astype(np.int64))
        return out
    return refs, cases(SP_CASES, 1), cases(TP_SP_CASES, 2)


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """The 2- and 4-process worlds, once for the whole run
    (``torch_shared.shared``)."""
    return shared(tmp_path_factory, "sp_models_worlds",
                  lambda: _worlds(data))


def _worlds(data):
    _, sp, tp_sp = data
    a = helpers.run_world_async(ph.sp_models_world, 2,
                                args=({"hvd": 2}, sp))
    b = helpers.run_world_async(ph.sp_models_world, 4,
                                args=({"sp": 2, "tp": 2}, tp_sp))
    return a.result(), b.result()


def _ref(data, table, name):
    family, kw = table[name]
    return data[0][family, kw.get("num_layers", 4)]


@pytest.mark.parametrize("name", list(SP_CASES))
def test_sp_logits_match_unsharded(data, worlds, name):
    got = np.concatenate([worlds[0][r][name] for r in range(2)], axis=1)
    np.testing.assert_allclose(got, _ref(data, SP_CASES, name), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("name", list(TP_SP_CASES))
def test_tp_sp_logits_match_unsharded(data, worlds, name):
    """Ranks (sp, tp) = (i, 0) and (i, 1) hold token shard i; the tp pair
    returns the same logits."""
    out = worlds[1]
    got = np.concatenate([out[0][name], out[2][name]], axis=1)
    np.testing.assert_allclose(got, _ref(data, TP_SP_CASES, name),
                               rtol=2e-3, atol=2e-3)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_allclose(out[a][name], out[b][name], rtol=1e-6,
                                   atol=1e-6)


def test_position_overflow_raises(worlds):
    """A global sequence past max_position_embeddings fails loudly, as
    JAX's ``test_sp_position_overflow_raises`` requires."""
    for out in worlds:
        for rank_out in out:
            assert rank_out["overflow"] is not None
            assert "max_position_embeddings" in rank_out["overflow"]


def test_make_train_step_sums_gradients_over_sp(worlds):
    """One SGD step through ``make_train_step`` on a (dp, sp) = (1, 2)
    mesh, each rank's loss its shard's share of the global loss: the
    gradients summed over sp make the step the unsharded model's, every
    parameter within 1e-4 of its update (fp32 sums in another order)."""
    for rank_out in worlds[0]:
        assert rank_out["train_step"] <= 1e-4, rank_out["train_step"]


def _jax_in_jit(size):
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd
    from horovod_tpu.ops import in_jit

    mesh = Mesh(np.array(jax.devices()[:size]), ("hvd",))
    ps = jhvd.ProcessSet(ph.IN_STEP_SET)
    x = jnp.asarray(ph.in_step_inputs(size))
    ops = {"Sum": jhvd.Sum, "Average": jhvd.Average, "Min": jhvd.Min,
           "Max": jhvd.Max, "Product": jhvd.Product}

    def local(xl):
        xl = xl[0]
        out = {}
        for name, op in ops.items():
            out[f"allreduce_{name}"] = in_jit.allreduce(
                xl, op, prescale_factor=0.5, postscale_factor=3.0)
            out[f"allreduce_{name}_set"] = in_jit.allreduce(
                xl, op, process_set=ps)
        out["allgather"] = in_jit.allgather(xl, axis=1)
        out["allgather_set"] = in_jit.allgather(xl, process_set=ps)
        out["broadcast"] = in_jit.broadcast(xl, 2)
        for name in ("Sum", "Average"):
            out[f"reducescatter_{name}"] = in_jit.reducescatter(xl,
                                                                ops[name])
            out[f"reducescatter_{name}_set"] = in_jit.reducescatter(
                xl[:3], ops[name], process_set=ps)
        out["alltoall"] = in_jit.alltoall(xl, split_axis=0, concat_axis=1)
        out["alltoall_set"] = in_jit.alltoall(xl[:3], process_set=ps,
                                              split_axis=0, concat_axis=1)
        out["ppermute"] = in_jit.ppermute(xl, [(0, 1), (1, 2), (2, 0)])
        return {k: v[None] for k, v in out.items()}

    got = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("hvd"),
                                out_specs=P("hvd"), check_vma=False))(x)
    return {k: np.asarray(v) for k, v in got.items()}


def test_in_step_collectives_match_in_jit(worlds):
    want = _jax_in_jit(4)
    out = worlds[1]
    for name, rows in want.items():
        for rank in range(4):
            np.testing.assert_allclose(out[rank]["in_step"][name],
                                       rows[rank], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} rank {rank}")
