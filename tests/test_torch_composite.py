"""The port's composite trainer and its pipelines over real axes.

The single-device oracle against JAX's composite: JAX's ``CompositeGPT``
(the shared 4-expert MoE FFN, aux loss weighted 0.01) on a one-device
(dp 1, pp 1, tp 1) mesh and ``CompositeLlama`` (GQA 4/2) on a (dp 1, pp 2,
tp 1) mesh, each from JAX's own init, whose global tree the port takes
through ``load_flax``: the port's trainer with no mesh gives the first
step's loss and every gradient of JAX's gpipe step, and JAX's 3-step SGD
trajectory (losses and final tree). At pp 2 with MoE, JAX's step counts the
aux loss's gradient once per stage (every stage runs the embedding and the
MoE FFN, and the pp psum adds them): its gradients are the port's at
``pp x aux_weight`` (ROADMAP §C).

One 4-process gloo world (``torch_a12_helpers.composite_world``):

- ``pipeline`` and ``pipeline_1f1b`` at pp = 4 against JAX's on 4 CPU
  devices (``TestPipelineParallel``'s cases): the outputs, the loss and
  every gradient, each stage's on its rank;
- the composite trainers, each held to the single-device oracle (the same
  trainer with no mesh, on the whole batch, from the same weights; JAX's
  own composite is no oracle here: ROADMAP §C): 3 SGD steps of GPT tiny
  with a shared 4-expert MoE FFN at (dp 2, pp 2) under gpipe (no-drop
  capacity, the aux loss weighted 0); LLaMA tiny (GQA 4/2) at (dp 1, pp 2,
  tp 2) under gpipe and 1F1B; LLaMA tiny at (dp 1, pp 2, sp 2, tp 1), the
  4-D mesh, under both schedules, against its sp = 1 trajectory. Each
  rank's losses and final shards (the oracle's sliced as the mesh lays
  them out: the pp block of layers, tp shards in JAX's sharded layout, the
  dp block of experts); replicated leaves bit-equal on every rank.

In one process: the refusals (sp without the 4-D mesh, sp with MoE, 1F1B
with MoE, an unknown schedule, indivisible batches and layers, a missing
mesh axis, a conflicting LLaMA ``tp_axis``), ``remat`` inherited from the
config, and remat and 1F1B trajectories against gpipe's with no mesh.

Tolerances: the oracle against JAX, first-step gradients rtol 1e-4 /
atol 1e-6 and the trajectory as the world's below; JAX's pipeline
tolerances (rtol 1e-5 outputs and losses, rtol
1e-4 / atol 1e-5 gradients); the composite against the oracle, losses
rtol 1e-4 / atol 1e-5 (``test_4d_sp_matches_3d_trajectory``'s) and
parameters after 3 steps rtol 1e-4 / atol 1e-6 (fp32 sums in another
order).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_a12_helpers as a12
import torch_port_helpers as helpers
from test_torch_sp_models import blocked

N = 4
CASES = {   # name -> (family, config kwargs, mesh axes, schedule)
    "gpt_moe_dp2_pp2": ("gpt", dict(num_experts=4, capacity_factor=4.0),
                        dict(dp=2, pp=2, tp=1), "gpipe"),
    "llama_pp2_tp2_gpipe": ("llama", {}, dict(dp=1, pp=2, tp=2), "gpipe"),
    "llama_pp2_tp2_1f1b": ("llama", {}, dict(dp=1, pp=2, tp=2), "1f1b"),
    "llama_4d_gpipe": ("llama", dict(sp_axis="sp"),
                       dict(dp=1, pp=2, sp=2, tp=1), "gpipe"),
    "llama_4d_1f1b": ("llama", dict(sp_axis="sp"),
                      dict(dp=1, pp=2, sp=2, tp=1), "1f1b"),
}
JAX_CASES = {   # name -> (family, config kwargs, JAX mesh's pp, aux weight)
    "gpt_moe_pp1": ("gpt", dict(num_experts=4, capacity_factor=4.0), 1,
                    0.01),
    "llama_pp2": ("llama", {}, 2, 0.01),
    "gpt_moe_pp2": ("gpt", dict(num_experts=4, capacity_factor=4.0), 2,
                    0.01),
}
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _pipe_case():
    rng = np.random.default_rng(11)
    d, n_layers, n_micro = 6, 8, 4
    params = {"w": np.asarray(rng.standard_normal((n_layers, d, d)) * 0.3,
                              np.float32),
              "b": np.asarray(rng.standard_normal((n_layers, d)) * 0.1,
                              np.float32)}
    head = {"wh": np.asarray(rng.standard_normal((d, 3)) * 0.5, np.float32)}
    mbs = np.asarray(rng.standard_normal((n_micro, 3, d)), np.float32)
    tgts = np.asarray(rng.standard_normal((n_micro, 3, 3)), np.float32)
    return params, head, mbs, tgts


def _pipe_refs(case):
    from horovod_tpu.parallel.pp import pipeline, pipeline_1f1b
    params, head, mbs, tgts = case
    mesh = Mesh(np.array(jax.devices()[:N], dtype=object), ("pp",))
    spec = {"w": P("pp"), "b": P("pp")}

    def layer(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def head_loss(hp, y, t):
        return jnp.mean((y @ hp["wh"] - t) ** 2)

    def gpipe(p, m):
        def loss(p, m):
            y = pipeline(layer, p, m, "pp")
            return jnp.sum(y ** 2), y
        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1),
                                       has_aux=True)(p, m)
        return y, g
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y, (gp, gm) = jax.jit(jax.shard_map(
        gpipe, mesh=mesh, in_specs=(spec, P()),
        out_specs=(P(), (spec, P("pp")))))(jp, jnp.asarray(mbs))
    f1b = jax.jit(jax.shard_map(
        lambda p, h, m, t: pipeline_1f1b(layer, head_loss, p, h, m, t, "pp"),
        mesh=mesh, in_specs=(spec, P(), P(), P()),
        out_specs=(P(), (spec, P(), P()))))(
            jp, jax.tree_util.tree_map(jnp.asarray, head), jnp.asarray(mbs),
            jnp.asarray(tgts))
    return {"gpipe": (np.asarray(y), jax.tree_util.tree_map(np.asarray, gp),
                      np.asarray(gm)[:mbs.shape[0]]),
            "1f1b": jax.tree_util.tree_map(np.asarray, f1b)}


def _jax_composite(family, cfg_kw, pp, aux_weight, ids, steps=3):
    """JAX's composite trainer on a (1, pp, 1) mesh from its own init:
    the global initial tree, the first step's loss and gradients (the
    body of its gpipe step up to the optimizer), and ``steps`` SGD steps'
    losses and final tree (at pp 1)."""
    import optax
    from jax import lax

    from horovod_tpu.parallel.composite import (CompositeGPT,
                                                CompositeLlama,
                                                build_mesh3d)
    base = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
                intermediate_size=64, max_position_embeddings=16)
    if family == "llama":
        from horovod_tpu.models import LlamaConfig
        cls, cfg = CompositeLlama, LlamaConfig.tiny(
            **{**base, "num_kv_heads": 2, **cfg_kw})
    else:
        from horovod_tpu.models.gpt import GPTConfig
        cls, cfg = CompositeGPT, GPTConfig.tiny(**{**base, **cfg_kw})
    comp = cls(cfg, build_mesh3d(1, pp, 1), optax.sgd(0.1), n_micro=2,
               aux_weight=aux_weight)
    jids = jnp.asarray(ids, jnp.int32)
    params, opt_state, specs = comp.init(jax.random.PRNGKey(0), jids)

    def grads(p, i):
        loss, g = jax.value_and_grad(comp._loss_local)(p, i)
        for k in ("embed", "moe"):
            if k in g:
                g[k] = jax.tree_util.tree_map(lambda v: lax.psum(v, "pp"),
                                              g[k])
        return loss, jax.tree_util.tree_map(lambda v: lax.pmean(v, "dp"), g)
    loss, g = jax.jit(jax.shard_map(
        grads, mesh=comp.mesh, in_specs=(specs[0], P("dp")),
        out_specs=(P(), specs[0]), check_vma=False))(params, jids)
    out = {"init": jax.tree_util.tree_map(np.asarray, params),
           "loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray,
                                                                g)}
    if pp == 1:
        step = comp.make_train_step(specs, donate=False)
        losses = []
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, jids)
            losses.append(float(loss))
        out["losses"] = losses
        out["final"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _oracle(family, cfg_kw, seed=0):
    """The single-device trainer: its initial Flax tree (stages stacked),
    3 SGD steps on the whole batch, its losses and final tree."""
    oracle_kw = {k: v for k, v in cfg_kw.items() if k != "sp_axis"}
    cls = a12.composite_config
    from horovod_tpu_torch.parallel import CompositeGPT, CompositeLlama
    comp = (CompositeLlama if family == "llama" else CompositeGPT)(
        cls(family, **oracle_kw), None,
        functools.partial(torch.optim.SGD, lr=0.1), n_micro=2,
        aux_weight=0.0).init(torch.Generator().manual_seed(seed))
    return comp.flax_params()


def _ids():
    return np.random.default_rng(5).integers(0, 64, (8, 16)).astype(np.int64)


def _world_params(family, axes_, tree):
    return blocked(tree, axes_["tp"], 32) if axes_["tp"] > 1 else tree


@pytest.fixture(scope="module")
def results():
    ids = _ids()
    inits, cases = {}, {}
    for name, (family, cfg_kw, axes_, schedule) in CASES.items():
        key = (family, tuple(sorted(cfg_kw.items())))
        if key not in inits:
            inits[key] = _oracle(family, cfg_kw)
        cases[name] = (family, cfg_kw, axes_,
                       _world_params(family, axes_, inits[key]), schedule)
    pipe_case = _pipe_case()
    fut = helpers.run_world_async(a12.composite_world, N,
                                  (pipe_case, cases, ids), timeout=240)
    oracles = {}
    for name, (family, cfg_kw, axes_, schedule) in CASES.items():
        key = (family, tuple(sorted(cfg_kw.items())))
        oracle_kw = {k: v for k, v in cfg_kw.items() if k != "sp_axis"}
        losses, tree, _ = a12.run_composite(family, oracle_kw, None,
                                            inits[key], ids, "gpipe")
        oracles[name] = (losses, tree)
    refs = _pipe_refs(pipe_case)
    jax_refs = {name: _jax_composite(family, cfg_kw, pp, aux, ids)
                for name, (family, cfg_kw, pp, aux) in JAX_CASES.items()}
    return {"world": fut.result(), "oracles": oracles, "pipe_refs": refs,
            "pipe_case": pipe_case, "jax": jax_refs}


def _assert_trees(got, want, name, **tol):
    n = 0
    for path, v in _leaves(want):
        ref = got
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(ref, v, **tol,
                                   err_msg=f"{name} {'/'.join(path)}")
        n += 1
    assert n == len(list(_leaves(got)))


@pytest.mark.parametrize("name", ["gpt_moe_pp1", "llama_pp2"])
def test_oracle_matches_jax_composite(results, name):
    """The single-device oracle, loaded with JAX's global tree, against
    JAX's composite gpipe step: the first step's loss and every gradient,
    and (at pp 1) the 3-step SGD trajectory."""
    family, cfg_kw, _, aux = JAX_CASES[name]
    ref, ids = results["jax"][name], _ids()
    loss, grads = a12.composite_grads(family, cfg_kw, ref["init"], ids, aux)
    np.testing.assert_allclose(loss, ref["loss"], **LOSS_TOL)
    _assert_trees(grads, ref["grads"], name, **GRAD_TOL)
    if "losses" in ref:
        losses, tree, _ = a12.run_composite(family, cfg_kw, None,
                                            ref["init"], ids, "gpipe",
                                            aux_weight=aux)
        np.testing.assert_allclose(losses, ref["losses"], **LOSS_TOL)
        _assert_trees(tree, ref["final"], name, **PARAM_TOL)


def test_jax_composite_counts_the_moe_aux_once_per_stage(results):
    """JAX's composite at pp 2 with MoE: every stage runs the embedding and
    the MoE FFN and the pp psum adds their gradients, so the aux loss's
    gradient comes pp times. Its gradients are the port's at pp x
    aux_weight, and its router's (which only the aux reaches at top-1, the
    renormalized gate being 1) twice the port's at aux_weight."""
    family, cfg_kw, pp, aux = JAX_CASES["gpt_moe_pp2"]
    ref, ids = results["jax"]["gpt_moe_pp2"], _ids()
    _, grads = a12.composite_grads(family, cfg_kw, ref["init"], ids,
                                   pp * aux)
    _assert_trees(grads, ref["grads"], "gpt_moe_pp2", **GRAD_TOL)
    _, once = a12.composite_grads(family, cfg_kw, ref["init"], ids, aux)
    router = ref["grads"]["moe"]["router"]["kernel"]
    np.testing.assert_allclose(router, pp * once["moe"]["router"]["kernel"],
                               **GRAD_TOL)


def test_pipelines_over_gloo_match_jax(results):
    ref = results["pipe_refs"]
    lps = results["pipe_case"][0]["w"].shape[0] // N
    for r, w in enumerate(results["world"]):
        y, grads, d_mb = w["pipelines"]["gpipe"]
        np.testing.assert_allclose(y, ref["gpipe"][0], rtol=1e-5, atol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(
                grads[k], ref["gpipe"][1][k][r * lps:(r + 1) * lps],
                rtol=1e-4, atol=1e-5)
        if r == 0:    # the microbatches enter at stage 0
            np.testing.assert_allclose(d_mb, ref["gpipe"][2], rtol=1e-4,
                                       atol=1e-5)
        loss, d_stage, d_head, d_mb = w["pipelines"]["1f1b"]
        jloss, (jstage, jhead, jmb) = ref["1f1b"]
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(d_stage[k],
                                       jstage[k][r * lps:(r + 1) * lps],
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(d_head, jhead["wh"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(d_mb, jmb, rtol=1e-4, atol=1e-5)


def _cut(v, axis, idx, n):
    return np.array_split(v, n, axis=axis)[idx]


def _expected(tree, coord, axes_, lps, path=()):
    """The oracle's tree as this rank holds it: the stage block of layers,
    tp shards in JAX's sharded layout, the dp block of experts."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _expected(v, coord, axes_, lps, p)
            continue
        if p[0] == "moe" and k in ("w_in", "w_out"):
            v = _cut(v, 0, coord["dp"], axes_["dp"])
        elif p[0] == "stages":
            s = coord["pp"]
            v = v[s * lps:(s + 1) * lps]
            if p[-2:] == ("shard", "kernel"):
                col = any(c in p for c in ("qkv", "in", "gate_up"))
                v = _cut(v, -1 if col else 1, coord["tp"], axes_["tp"])
            elif p[-2:] == ("shard", "bias"):
                v = _cut(v, -1, coord["tp"], axes_["tp"])
        out[k] = v
    return out


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", sorted(CASES))
def test_composite_matches_single_device(results, name):
    family, _, axes_, _ = CASES[name]
    losses, tree = results["oracles"][name]
    lps = 2 // axes_["pp"]
    for w in results["world"]:
        got = w[name]
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        assert got["losses"][-1] < got["losses"][0]
        want = _expected(
            _world_params(family, axes_, tree), got["coord"], axes_, lps)
        n = 0
        for path, v in _leaves(got["params"]):
            ref = want
            for k in path:
                ref = ref[k]
            np.testing.assert_allclose(v, ref, **PARAM_TOL,
                                       err_msg=f"{name} {'/'.join(path)}")
            n += 1
        assert n == len(list(_leaves(want)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_leaves_stay_bit_equal(results, name):
    """After 3 SGD steps every rank holds the same replicated leaves, bit
    for bit (JAX's composite lets them drift: ROADMAP §C), and the ranks
    of one stage the same replicated stage leaves."""
    world = [w[name] for w in results["world"]]
    first = world[0]["params"]
    for w in world[1:]:
        for part in ("embed", "head"):
            for path, v in _leaves(w["params"][part]):
                ref = first[part]
                for k in path:
                    ref = ref[k]
                np.testing.assert_array_equal(v, ref, err_msg=str(path))
        if "moe" in first:
            np.testing.assert_array_equal(
                w["params"]["moe"]["router"]["kernel"],
                first["moe"]["router"]["kernel"])
    by_stage = {}
    for w in world:
        by_stage.setdefault(w["coord"]["pp"], []).append(w["params"])
    for trees in by_stage.values():
        for t in trees[1:]:
            for path, v in _leaves(t["stages"]):
                if "shard" in path:
                    continue                  # tp shards differ by design
                ref = trees[0]["stages"]
                for k in path:
                    ref = ref[k]
                np.testing.assert_array_equal(v, ref, err_msg=str(path))


def test_expert_shards_differ_across_dp(results):
    """Each dp rank keeps its own experts (never averaged with another
    rank's); the two blocks of the oracle's experts."""
    world = results["world"]
    by_dp = {w["gpt_moe_dp2_pp2"]["coord"]["dp"]:
             w["gpt_moe_dp2_pp2"]["params"]["moe"]["w_in"] for w in world}
    assert by_dp[0].shape == (2, 32, 64)
    assert not np.array_equal(by_dp[0], by_dp[1])


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------

def _make(family, mesh=None, optimizer=None, **kw):
    from horovod_tpu_torch.parallel import CompositeGPT, CompositeLlama
    cfg_kw = {k: v for k, v in kw.items()
              if k not in ("n_micro", "remat", "aux_weight")}
    trainer_kw = {k: v for k, v in kw.items() if k not in cfg_kw}
    cls = CompositeLlama if family == "llama" else CompositeGPT
    return cls(a12.composite_config(family, **cfg_kw), mesh,
               optimizer or functools.partial(torch.optim.SGD, lr=0.1),
               **{"n_micro": 2, **trainer_kw})


def _stub(*names, sizes=None):
    """A stand-in mesh: its dim names and sizes, this rank at 0."""
    sizes = sizes or (1,) * len(names)
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda dim: sizes[dim],
                                 get_coordinate=lambda: [0] * len(names))


def test_refusals():
    with pytest.raises(NotImplementedError, match="build_mesh4d"):
        _make("llama", _stub("dp", "pp", "tp"), sp_axis="sp")
    with pytest.raises(NotImplementedError, match="MoE"):
        _make("gpt", _stub("dp", "pp", "sp", "tp"), sp_axis="sp",
              num_experts=2)
    with pytest.raises(ValueError, match="mesh must have axis 'tp'"):
        _make("gpt", _stub("dp", "pp"))
    with pytest.raises(ValueError, match="conflicts"):
        _make("llama", tp_axis="model")
    with pytest.raises(ValueError, match="not divisible by pp=2"):
        _make("llama", _stub("dp", "pp", "tp", sizes=(1, 2, 1)),
              num_layers=3)
    comp = _make("gpt", num_experts=2).init(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids())
    with pytest.raises(NotImplementedError, match="1f1b"):
        comp.make_train_step("1f1b")(ids)
    with pytest.raises(ValueError, match="unknown schedule"):
        comp.make_train_step("interleaved")
    with pytest.raises(ValueError, match="n_micro"):
        comp.make_train_step()(ids[:3])


def test_remat_inherits_config_and_keeps_the_trajectory():
    import dataclasses
    ids = torch.from_numpy(_ids())
    runs = {}
    for remat in (False, True):
        comp = _make("gpt", remat=remat).init(
            torch.Generator().manual_seed(1))
        step = comp.make_train_step()
        runs[remat] = [float(step(ids)) for _ in range(3)]
    assert runs[True] == runs[False]
    cfg = dataclasses.replace(a12.composite_config("llama"), remat=True)
    from horovod_tpu_torch.parallel import CompositeLlama
    opt = functools.partial(torch.optim.SGD, lr=0.1)
    assert CompositeLlama(cfg, None, opt).remat is True
    assert CompositeLlama(cfg, None, opt, remat=False).remat is False


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_1f1b_trajectory_matches_gpipe(family):
    """JAX's ``test_1f1b_schedule_matches_gpipe`` (SGD, scale-sensitive),
    which its composite cannot run (ROADMAP §C), on the port with no
    mesh."""
    ids = torch.from_numpy(_ids())
    runs = {}
    for schedule in ("gpipe", "1f1b"):
        comp = _make(family).init(torch.Generator().manual_seed(2))
        step = comp.make_train_step(schedule)
        runs[schedule] = [float(step(ids)) for _ in range(4)]
    np.testing.assert_allclose(runs["1f1b"], runs["gpipe"], **LOSS_TOL)
