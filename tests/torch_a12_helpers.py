"""Scenarios of the port's MoE, alltoall-tier and composite tests.

Each function runs in every process of a gloo world that
``torch_port_helpers.run_world`` starts and returns numpy results for the
parent to hold against the JAX package or the single-device oracle. This
module imports torch and the port only, never JAX.
"""

import functools
import os

import numpy as np
import torch


def _np(t):
    return None if t is None else t.detach().float().numpy().copy()


def _bytes():
    from horovod_tpu_torch.parallel import strategies
    b = strategies.a2a_wire_bytes()
    strategies.reset_a2a_wire_bytes()
    return {f"{k[0]}/{k[1]}": v for k, v in b.items()}


# ---------------------------------------------------------------------------
# The alltoall tier and MoE at ep = 4 (a 2 x 2 slice layout)
# ---------------------------------------------------------------------------

def _eager(rank, xs):
    """``hvd.alltoall`` flat, then through the strategy registry and the
    knob: each call's output and the bytes it booked."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import wire
    out = {}

    def call(name, x):
        _bytes()
        out[name] = (_np(hvd.alltoall(torch.from_numpy(x[rank]))), _bytes())

    call("flat", xs["big"])
    hvd.set_alltoall_strategy("hier")
    call("hier", xs["big"])
    call("flat_q", xs["q"])
    hvd.set_alltoall_strategy("hier_qcross")
    hvd.set_alltoall_cross_dtype("int8")
    call("int8", xs["q"])
    call("sub_block", xs["small"])
    os.environ["HOROVOD_MESH_SLICES"] = "1"          # read live
    call("one_slice", xs["small"])
    os.environ["HOROVOD_MESH_SLICES"] = "2"
    wire.clear_wire_registry()
    wire.clear_strategy_registry()
    cfg = basics._get_state().config
    cfg.hierarchical_alltoall = True                  # the knob's default
    call("knob", xs["big"])
    cfg.hierarchical_alltoall = False
    call("disarmed", xs["big"])
    return out


def _in_step(rank, x, g):
    """The tiered alltoall over an in-step axis against the flat one, the
    int8 cross leg's forward and its exact backward, and the hierarchy
    resolution chain."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import in_step, wire
    from horovod_tpu_torch.parallel import strategies as S
    out = {}
    xt, gt = torch.from_numpy(x[rank]), torch.from_numpy(g[rank])
    flat = in_step.alltoall(xt, "ep", split_axis=0, concat_axis=0)
    _bytes()
    tiered = S.alltoall_tiered_groups(xt, "ep", 2)
    out["tiered"] = (_np(flat), _np(tiered), _bytes())
    xq = xt.clone().requires_grad_()
    yq = S.alltoall_tiered_groups(xq, "ep", 2, cross_wire="int8")
    yq.backward(gt)
    out["int8"] = (_np(yq), _np(xq.grad), _bytes(),
                   _np(in_step.alltoall(gt, "ep", split_axis=0,
                                        concat_axis=0)))
    chain = {"default": S.a2a_hierarchy_for("ep"),
             "forced": S.a2a_hierarchy_for("ep", True),
             "refused": S.a2a_hierarchy_for("ep", False)}
    hvd.set_alltoall_cross_dtype("int8")
    chain["forced_int8"] = S.a2a_hierarchy_for("ep", True)
    hvd.set_alltoall_strategy("hier")
    chain["hier_pin"] = S.a2a_hierarchy_for("ep")
    hvd.set_alltoall_strategy("hier_qcross")
    chain["qcross_pin"] = S.a2a_hierarchy_for("ep")
    hvd.set_alltoall_strategy("flat")
    chain["flat_pin"] = S.a2a_hierarchy_for("ep")
    wire.clear_wire_registry()
    wire.clear_strategy_registry()
    out["chain"] = chain
    return out


def _moe(rank, size, cases):
    """Each MoE case on this rank's token shard: the output, the
    ep-averaged aux, and the gradients of sum(y^2) + pmean(aux) (the
    router's summed over ep, as JAX's replicated parameter's is)."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt import load_flax
    from horovod_tpu_torch.ops import in_step, wire
    from horovod_tpu_torch.parallel.moe import MoEMlp
    out = {}
    for name, (kw, params, x) in cases.items():
        kw = dict(kw)
        hvd.set_alltoall_cross_dtype(kw.pop("cross_dtype", ""))
        moe = load_flax(MoEMlp(axis_name="ep", **kw), params)
        T = x.shape[0] // size
        xt = torch.from_numpy(x[rank * T:(rank + 1) * T]).requires_grad_()
        _bytes()
        y, aux = moe(xt)
        booked = _bytes()
        ((y ** 2).sum() + aux / size).backward()
        router = moe.router.weight.grad.clone()
        dist.all_reduce(router, group=in_step.axis_group("ep"))
        aux_mean = aux.detach().clone()
        dist.all_reduce(aux_mean, group=in_step.axis_group("ep"))
        out[name] = {"y": _np(y), "aux": float(aux_mean) / size,
                     "dx": _np(xt.grad), "router": _np(router.t()),
                     "w_in": _np(moe.w_in.grad), "w_out": _np(moe.w_out.grad),
                     "dropped": int(moe.last_dropped), "bytes": booked}
    wire.clear_wire_registry()
    try:
        MoEMlp(6, 4, 8, axis_name="ep")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _boundary(rank):
    """Process 0's alltoall strategy and cross wire reach every rank on the
    fusion runtime's boundary stream (a runtime sync), and a rank's own
    pin stands: each rank's registry after a fused allreduce, then after
    rank 1 pins ``flat``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import wire
    wire.clear_wire_registry()
    wire.clear_strategy_registry()

    def read():
        return (wire.alltoall_strategy_for("global"),
                wire.wire_dtype_for("a2a:global", "", tier="dcn"))
    if rank == 0:
        hvd.set_alltoall_strategy("hier_qcross")
        hvd.set_alltoall_cross_dtype("int8")
    hvd.allreduce(torch.ones(4), name="a2a_boundary.0")
    out = {"synced": read()}
    if rank == 1:
        hvd.set_alltoall_strategy("flat")
    hvd.allreduce(torch.ones(4), name="a2a_boundary.1")
    out["pinned"] = read()
    wire.clear_wire_registry()
    wire.clear_strategy_registry()
    return out


def a2a_world(rank, size, xs, x_axis, g_axis, moe_cases):
    from horovod_tpu_torch.ops import in_step
    out = {"eager": _eager(rank, xs)}
    mesh = in_step.make_mesh({"ep": size})
    with in_step.axes(mesh):
        out["in_step"] = _in_step(rank, x_axis, g_axis)
        out["moe"] = _moe(rank, size, moe_cases)
    out["boundary"] = _boundary(rank)
    return out


# ---------------------------------------------------------------------------
# Pipelines over a real pp axis and the composite trainers
# ---------------------------------------------------------------------------

def _layer(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _head_loss(hp, y, t):
    return ((y @ hp["wh"] - t) ** 2).mean()


def _pipelines(rank, size, case):
    """``pipeline`` and ``pipeline_1f1b`` over a pp axis of the world, on
    this stage's block of the stacked layers."""
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import pipeline, pipeline_1f1b
    params, head, mbs, tgts = case
    lps = params["w"].shape[0] // size
    mesh = in_step.make_mesh({"pp": size})

    def stage():
        return {k: torch.tensor(v[rank * lps:(rank + 1) * lps],
                                requires_grad=True)
                for k, v in params.items()}
    out = {}
    with in_step.axes(mesh):
        p = stage()
        m = torch.tensor(mbs, requires_grad=True)
        y = pipeline(_layer, p, m, "pp")
        (y ** 2).sum().backward()
        out["gpipe"] = (_np(y), {k: _np(v.grad) for k, v in p.items()},
                        _np(m.grad))
        p = stage()
        hp = {"wh": torch.tensor(head["wh"], requires_grad=True)}
        loss, (d_stage, d_head, d_mb) = pipeline_1f1b(
            _layer, _head_loss, p, hp, torch.tensor(mbs, requires_grad=True),
            torch.tensor(tgts), "pp")
        out["1f1b"] = (float(loss), {k: _np(v) for k, v in d_stage.items()},
                       _np(d_head["wh"]), _np(d_mb))
    return out


def composite_config(family, **kw):
    """The tiny configs of the composite cases (test_parallel_strategies'
    sizes)."""
    base = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
                intermediate_size=64, max_position_embeddings=16)
    if family == "llama":
        from horovod_tpu_torch.models.llama import LlamaConfig
        return LlamaConfig.tiny(**{**base, "num_kv_heads": 2, **kw})
    from horovod_tpu_torch.models.gpt import GPTConfig
    return GPTConfig.tiny(**{**base, **kw})


def run_composite(family, cfg_kw, mesh, params, ids, schedule, steps=3,
                  lr=0.1, aux_weight=0.0, n_micro=2):
    """``steps`` SGD steps of a composite trainer on ``ids`` (this rank's
    shard) from ``params``: the losses and the final parameters (this
    rank's shards, Flax layout)."""
    from horovod_tpu_torch.parallel import CompositeGPT, CompositeLlama
    cls = CompositeLlama if family == "llama" else CompositeGPT
    comp = cls(composite_config(family, **cfg_kw), mesh,
               functools.partial(torch.optim.SGD, lr=lr), n_micro=n_micro,
               aux_weight=aux_weight)
    comp.load_flax(params).to()
    step = comp.make_train_step(schedule)
    losses = [float(step(torch.from_numpy(ids))) for _ in range(steps)]
    return losses, comp.flax_params(), comp


def composite_grads(family, cfg_kw, params, ids, aux_weight):
    """The trainer with no mesh, from ``params``: its first step's loss
    and every parameter's gradient, as a Flax tree (Dense kernels (in,
    out), as ``flax_params`` lays the weights out)."""
    _, _, comp = run_composite(family, cfg_kw, None, params, ids, "gpipe",
                               steps=0, aux_weight=aux_weight)
    loss = float(comp.loss_and_grads(torch.from_numpy(ids)))
    with torch.no_grad():
        for p in comp.model.parameters():
            p.copy_(p.grad)
    return loss, comp.flax_params()


def composite_world(rank, size, pipe_case, cases, ids):
    """The pipelines at pp = size, then each composite case on its mesh:
    this rank's losses, final shards and coordinates."""
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import build_mesh3d, build_mesh4d
    out = {"pipelines": _pipelines(rank, size, pipe_case)}
    for name, (family, cfg_kw, axes_, params, schedule) in cases.items():
        if "sp" in axes_:
            mesh = build_mesh4d(axes_["dp"], axes_["pp"], axes_["sp"],
                                axes_["tp"])
        else:
            mesh = build_mesh3d(axes_["dp"], axes_["pp"], axes_["tp"])
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        B, L = ids.shape
        b = B // axes_["dp"]
        ls = L // axes_.get("sp", 1)
        local = ids[coord["dp"] * b:(coord["dp"] + 1) * b,
                    coord.get("sp", 0) * ls:(coord.get("sp", 0) + 1) * ls]
        with in_step.axes(mesh):
            losses, tree, _ = run_composite(family, cfg_kw, mesh, params,
                                            np.ascontiguousarray(local),
                                            schedule)
        out[name] = {"losses": losses, "params": tree, "coord": coord}
    return out
