"""Scenarios of the port's tensor-, sequence- and sharded-parallel tests.

Each function runs in every process of a gloo world that
``torch_port_helpers.run_world`` starts, builds its in-step mesh and
returns numpy results for the parent to hold against the JAX package. This
module imports torch and the port only, never JAX.
"""

import numpy as np
import torch


def _t(x, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.requires_grad_() if grad else t


def _np(t):
    return None if t is None else t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# Tensor parallelism at tp = 2
# ---------------------------------------------------------------------------

def _tp_module(kind, kw):
    from horovod_tpu_torch.models.llama import LlamaBlock, LlamaConfig
    from horovod_tpu_torch.parallel import tp
    if kind == "mlp":
        return tp.TPMlp(kw["f"], kw["d"])
    if kind == "swiglu":
        return tp.TPSwiGLUMlp(kw["f"], kw["d"])
    if kind == "attention":
        return tp.TPSelfAttention(kw["H"], kw["d"], causal=kw["causal"])
    return LlamaBlock(LlamaConfig.tiny(
        hidden_size=kw["d"], num_heads=kw["H"], num_kv_heads=kw["kv"],
        intermediate_size=kw["f"], tp_axis="tp"))


def tp_world(rank, size, cases):
    """``cases``: name -> (kind, kw, Flax params (global, JAX's sharded
    layout), x). Each module is built inside the tp axis, takes its shard
    of the params, runs on x (replicated) and back-propagates sum(y^2).
    Returns y, dx and each parameter's gradient by name; then the
    divisibility errors and whether independently drawn shards differ."""
    from horovod_tpu_torch.models import GPT, GPTConfig, load_flax
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import tp

    mesh = in_step.make_mesh({"tp": size})
    out = {}
    with in_step.axes(mesh):
        for name, (kind, kw, params, x) in cases.items():
            m = _tp_module(kind, kw)
            load_flax(m, params)
            xt = _t(x, grad=True)
            y = m(xt)
            (y.float() ** 2).sum().backward()
            out[name] = {"y": _np(y), "dx": _np(xt.grad),
                         "grads": {n: _np(p.grad)
                                   for n, p in m.named_parameters()},
                         "shapes": {n: tuple(p.shape)
                                    for n, p in m.named_parameters()}}
        errors = []
        for make in (lambda: tp.ColumnParallelDense(4, 13),
                     lambda: tp.RowParallelDense(13, 4),
                     lambda: tp.TPSelfAttention(3, 24),
                     lambda: tp.TPSelfAttention(4, 32, num_kv_heads=1)):
            try:
                make()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = errors
        g = GPT(GPTConfig.tiny(num_layers=1, tp_axis="tp"),
                generator=torch.Generator().manual_seed(5))
        out["init"] = {n: _np(p) for n, p in g.named_parameters()}
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism over the "hvd" axis
# ---------------------------------------------------------------------------

def sp_world(rank, size, cases, ids):
    """``cases``: name -> (impl, causal, flash, q, k, v), full (B, L, H, D)
    inputs; each rank takes its token shard, runs the scheme inside the
    ``hvd`` axis and back-propagates sum(o^2) (fp32). Returns the shard's
    o and dq/dk/dv by case, the sharded labels of ``ids`` and, outside the
    axis, the unsharded fallbacks on the full inputs of the first case."""
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import sequence as sq

    mesh = in_step.make_mesh({"hvd": size})
    out = {}
    fns = {"ring": sq.ring_attention, "ulysses": sq.ulysses_attention}
    for name, (impl, causal, flash, q, k, v) in cases.items():
        L = q.shape[1] // size
        qt, kt, vt = (_t(a[:, rank * L:(rank + 1) * L], grad=True)
                      for a in (q, k, v))
        with in_step.axes(mesh):
            o = fns[impl](qt, kt, vt, causal=causal, use_flash=flash)
            (o.float() ** 2).sum().backward()
        out[name] = [_np(o), _np(qt.grad), _np(kt.grad), _np(vt.grad)]
    L = ids.shape[1] // size
    with in_step.axes(mesh):
        out["labels"] = sq.next_token_labels(
            _t(ids[:, rank * L:(rank + 1) * L])).numpy()
    impl, causal, flash, q, k, v = next(iter(cases.values()))
    out["fallback"] = {
        f"{impl}_{fl}": _np(fns[impl](_t(q), _t(k), _t(v), causal=causal,
                                      use_flash=fl))
        for impl in fns for fl in (False, True)}
    out["fallback_labels"] = sq.next_token_labels(_t(ids)).numpy()
    return out


# ---------------------------------------------------------------------------
# GPT and LLaMA logits at sp = 2 and at tp x sp = 2 x 2
# ---------------------------------------------------------------------------

def _model(family, kw):
    from horovod_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
    if family == "gpt":
        return GPT(GPTConfig.tiny(**kw))
    return Llama(LlamaConfig.tiny(**kw))


def sp_models_world(rank, size, axes_, cases):
    """``axes_``: the mesh ({"hvd": 2} or {"sp": 2, "tp": 2}). ``cases``:
    name -> (family, config kwargs, the unsharded model's Flax params, ids
    (B, L)). Each model is built inside the mesh, takes its tp shard of the
    weights (JAX's sharded layout) and returns the logits of this rank's
    token shard; then the position-overflow error."""
    from horovod_tpu_torch.models import load_flax
    from horovod_tpu_torch.ops import in_step

    mesh = in_step.make_mesh(axes_)
    out = {}
    with in_step.axes(mesh):
        for name, (family, kw, params, ids) in cases.items():
            sp = kw["sp_axis"]
            n, idx = in_step.axis_size(sp), in_step.axis_index(sp)
            m = _model(family, kw)
            load_flax(m, params)
            L = ids.shape[1] // n
            with torch.no_grad():
                out[name] = _np(m(_t(ids[:, idx * L:(idx + 1) * L]).long()))
        sp = next(iter(cases.values()))[1]["sp_axis"]
        m = _model("gpt", dict(sp_axis=sp, max_position_embeddings=16,
                               num_heads=8, hidden_size=64))
        try:
            m(torch.zeros(1, 16).long())
            out["overflow"] = None
        except ValueError as e:
            out["overflow"] = str(e)
    if "hvd" in axes_:
        out["train_step"] = sp_train_step(rank, size, cases)
    else:
        out["in_step"] = in_step_collectives(rank, size)
    return out


def t5_tp_world(rank, size, params, src, tgt, mask):
    """T5 tiny built inside a ``tp`` axis of ``size`` ranks, filled with its
    shard of ``params`` (JAX's sharded layout): the encoder memory and the
    logits on the whole batch, and the rows of the first encoder layer's
    QKV shard."""
    from horovod_tpu_torch.models.t5 import T5, T5Config, load_flax_t5
    from horovod_tpu_torch.ops import in_step

    mesh = in_step.make_mesh({"tp": size})
    with in_step.axes(mesh), torch.no_grad():
        m = load_flax_t5(T5(T5Config.tiny(tp_axis="tp")), params)
        tsrc, ttgt, tmask = _t(src).long(), _t(tgt).long(), _t(mask)
        return {"memory": _np(m.encode(tsrc, tmask)),
                "logits": _np(m(tsrc, ttgt, tmask)),
                "qkv_rows": m.encoder.layer_0.attention.qkv.shard.weight
                .shape[0]}


def lora_train_step_world(rank, size, params, config_kw, ids):
    """GPT tiny (Flax ``params``) with LoRA adapters stepped by
    ``make_train_step`` and a ``DistributedOptimizer`` on a dp mesh over
    the world: the losses, whether the base moved, and every fused
    bucket's (name, numel) entries."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig, load_flax, lora
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.parallel import dp

    model = load_flax(GPT(GPTConfig.tiny(**config_kw)), params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lo = lora.lora_init(model, rank=4, rng=torch.Generator().manual_seed(1))

    def loss_fn(p, batch):
        logits = torch.func.functional_call(model, p, (batch,))
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].flatten(0, 1), batch[:, 1:].flatten())
    mesh = in_step.make_mesh({"dp": size})
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(lo["adapters"].parameters(), lr=1e-2),
        named_parameters=lo["adapters"].named_parameters(),
        process_set=dp.axis_process_set(mesh, "dp"))
    step = dp.make_train_step(lora.adapter_loss_fn(
        loss_fn, lora.frozen_params(model), lo), opt, mesh, axis_name="dp")
    state = dp.TrainState.create(lo["adapters"], opt)
    mark = get_runtime().flush_stats()["buckets"]
    losses = []
    for _ in range(3):
        state, loss = step(state, _t(ids).long())
        losses.append(loss.item())
    closed = get_runtime().recent_buckets(
        get_runtime().flush_stats()["buckets"] - mark)
    return {"losses": losses,
            "base_moved": any(not torch.equal(p, before[n])
                              for n, p in model.named_parameters()),
            "entries": [e for _, sig in closed for e in sig[-1]],
            "adapters": {n: p.numel() for n, p in
                         lo["adapters"].named_parameters()}}


IN_STEP_SET = [0, 2, 3]      # positions on the axis: a 3-member set of 4


def in_step_inputs(size):
    """Each rank's rows: (size, 4, 6) fp32 from a numpy seed."""
    return np.random.default_rng(31).standard_normal(
        (size, 4, 6)).astype(np.float32)


def in_step_collectives(rank, size):
    """The in-step collectives over a flat ``hvd`` axis of ``size`` ranks,
    on this rank's row of :func:`in_step_inputs`, with and without the
    3-member process set; ``name -> numpy``, as the JAX test computes
    them per device."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import in_step as st

    mesh = st.make_mesh({"hvd": size})
    x = _t(in_step_inputs(size)[rank])
    ps = hvd.ProcessSet(IN_STEP_SET)
    out = {}
    with st.axes(mesh):
        for name in ("Sum", "Average", "Min", "Max", "Product"):
            op = getattr(hvd, name)
            out[f"allreduce_{name}"] = _np(st.allreduce(
                x, op, prescale_factor=0.5, postscale_factor=3.0))
            out[f"allreduce_{name}_set"] = _np(st.allreduce(
                x, op, process_set=ps))
        out["allgather"] = _np(st.allgather(x, axis=1))
        out["allgather_set"] = _np(st.allgather(x, process_set=ps))
        out["broadcast"] = _np(st.broadcast(x, 2))
        for name in ("Sum", "Average"):
            op = getattr(hvd, name)
            out[f"reducescatter_{name}"] = _np(st.reducescatter(x, op))
            out[f"reducescatter_{name}_set"] = _np(st.reducescatter(
                x[:3], op, process_set=ps))
        out["alltoall"] = _np(st.alltoall(x, split_axis=0, concat_axis=1))
        out["alltoall_set"] = _np(st.alltoall(x[:3], process_set=ps,
                                              split_axis=0, concat_axis=1))
        out["ppermute"] = _np(st.ppermute(x, [(0, 1), (1, 2), (2, 0)]))
    return out


def sp_train_step(rank, size, cases):
    """One SGD step of GPT tiny (the first case's weights and ids) through
    ``make_train_step`` on a (dp, sp) = (1, size) mesh, the ring through
    the flash kernels' plain versions, each rank's loss its shard's share
    of the global next-token loss (``next_token_labels`` over the axis):
    the gradients summed over sp and the dp reduction a 1-rank process
    set's. Returns the largest difference of the stepped parameters from
    the same step of the unsharded model, relative to its update."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import load_flax
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.parallel.sequence import next_token_labels

    family, kw, params, ids = next(iter(cases.values()))
    kw = dict(kw, sp_axis="sp", sp_impl="ring", use_flash=True)
    mesh = in_step.make_mesh({"dp": 1, "sp": size})
    lr, count = 0.1, ids.shape[0] * (ids.shape[1] - 1)

    def loss_fn(model, x):
        labels = next_token_labels(x, axis_name="sp")
        return F.cross_entropy(model(x).flatten(0, 1), labels.flatten(),
                               ignore_index=-100, reduction="sum") / count
    with in_step.axes(mesh):
        m = load_flax(_model(family, kw), params)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=lr),
        named_parameters=m.named_parameters(),
        process_set=dp.axis_process_set(mesh, "dp"))
    step = dp.make_train_step(loss_fn, opt, mesh, axis_name="dp",
                              sum_axes=("sp",))
    L = ids.shape[1] // size
    step(dp.TrainState.create(m, opt), _t(ids[:, rank * L:(rank + 1) * L]))
    ref = load_flax(_model(family, dict(kw, sp_axis=None)), params)
    before = {n: p.detach().clone() for n, p in ref.named_parameters()}
    loss_fn(ref, _t(ids)).backward()
    worst = 0.0
    with torch.no_grad():
        for n, p in ref.named_parameters():
            want = p - lr * p.grad
            moved = (want - before[n]).abs().max().clamp_min(1e-30)
            got = dict(m.named_parameters())[n]
            worst = max(worst, ((got - want).abs().max() / moved).item())
    return worst


# ---------------------------------------------------------------------------
# make_train_step, ZeRO-1 and FSDP at n = 2
# ---------------------------------------------------------------------------

def _mse(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def _xent(model, batch):
    import torch.nn.functional as F
    logits = model(batch["ids"])
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           batch["ids"][:, 1:].flatten())


def _build(spec):
    from horovod_tpu_torch.models import MLP, GPT, GPTConfig, load_flax
    kind, kw, params = spec
    m = MLP(**kw) if kind == "mlp" else GPT(GPTConfig.tiny(**kw))
    return load_flax(m, params)


def _local(batch, rank, size):
    return {k: _t(v).long() if v.dtype.kind == "i" else _t(v)
            for k, v in {k: np.array_split(v, size)[rank]
                         for k, v in batch.items()}.items()}


def zero_world(rank, size, spec, batch, steps, lr):
    """ZeRO-1 (Adam) against the replicated ``hvd.DistributedOptimizer``
    (Adam) through ``make_train_step``, from the same weights on this
    rank's half of ``batch``; then the reshard round trip n = 2 -> 1 -> 2
    on the host and one more step from the restored state against one more
    step of the original."""
    import functools

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import sharded
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import dp

    mesh = in_step.make_mesh({"hvd": size})
    local = _local(batch, rank, size)
    tx = functools.partial(torch.optim.Adam, lr=lr)
    zstate = dp.ZeroTrainState.create(_build(spec), tx, mesh)
    zstep = dp.make_zero_train_step(_mse, tx, mesh)
    model = _build(spec)
    opt = hvd.DistributedOptimizer(
        tx(model.parameters()), named_parameters=model.named_parameters(),
        process_set=dp.axis_process_set(mesh))
    rstate = dp.TrainState.create(model, opt)
    rstep = dp.make_train_step(_mse, opt, mesh)
    out = {"zero_losses": [], "ref_losses": []}
    for _ in range(steps):
        zstate, zl = zstep(zstate, local)
        rstate, rl = rstep(rstate, local)
        out["zero_losses"].append(zl.item())
        out["ref_losses"].append(rl.item())
    out["zero_params"] = {n: _np(p) for n, p in
                          zstate.model.named_parameters()}
    out["ref_params"] = {n: _np(p) for n, p in model.named_parameters()}
    out["moments"] = {k: _np(v) for k, v in zstate.moments().items()}
    out["shard_len"], out["numel"] = zstate.shard_len, zstate.numel
    host = sharded.gather_to_host(zstate)
    out["host"] = {k: np.asarray(v) for k, v in host.opt_state.items()}
    one = sharded.zero_reshard(host, 1)
    out["n1"] = {k: np.asarray(v) for k, v in one.opt_state.items()}
    two = sharded.zero_reshard(one, mesh)
    out["n2"] = {k: np.asarray(v) for k, v in two.opt_state.items()}
    restored = sharded.zero_restore(
        dp.ZeroTrainState.create(_build(spec), tx, mesh), two)
    restored, _ = zstep(restored, local)
    zstate, _ = zstep(zstate, local)
    out["restored_params"] = {n: _np(p) for n, p in
                              restored.model.named_parameters()}
    out["continued_params"] = {n: _np(p) for n, p in
                               zstate.model.named_parameters()}
    try:
        dp.ZeroTrainState.create(_build(spec), torch.optim.LBFGS, mesh)
        out["lbfgs"] = None
    except TypeError as e:
        out["lbfgs"] = str(e)
    evaluate = dp.make_eval_step(lambda m, b: {"mse": _mse(m, b)}, mesh)
    out["eval"] = evaluate(model, local)["mse"].item()
    with torch.no_grad():
        out["eval_local"] = _mse(model, local).item()
    return out


def fsdp_world(rank, size, specs, batches, steps, lr, min_size, tree):
    """FSDP (Adam) trajectories: ``specs``/``batches`` name -> the model and
    global batch; each rank trains on its half. Returns the losses, the
    shard shapes of parameters and moments, and the gathered host state;
    then :func:`fsdp_reshard` of ``tree`` at this world (this rank's
    shards) and after the round trip n = 2 -> 1 -> 2."""
    import functools

    from horovod_tpu_torch.elastic import sharded
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import fsdp as tf

    mesh = in_step.make_mesh({"hvd": size})
    out = {}
    for name, spec in specs.items():
        loss_fn = _mse if spec[0] == "mlp" else _xent
        init_fn, step_fn = tf.make_fsdp_train_step(
            loss_fn, functools.partial(torch.optim.Adam, lr=lr), mesh,
            min_size=min_size)
        fsdp, opt = init_fn(_build(spec))
        local = _local(batches[name], rank, size)
        losses = []
        for _ in range(steps):
            fsdp, opt, loss = step_fn(fsdp, opt, local)
            losses.append(loss.item())
        named = dict(fsdp.model.named_parameters())
        host = sharded.gather_to_host(fsdp, opt)
        out[name] = {
            "losses": losses, "sharded": sorted(fsdp.dims),
            "shapes": {n: tuple(p.shape) for n, p in named.items()},
            "moment_shapes": {n: tuple(opt.state[p]["exp_avg"].shape)
                              for n, p in named.items()},
            "host": host}
        # The host state resharded (2 -> 1 -> 2) into a fresh FSDP model
        # and optimizer steps as the original does.
        fsdp2, opt2 = init_fn(_build(spec))
        sharded.fsdp_restore(fsdp2, opt2, sharded.fsdp_reshard(
            sharded.fsdp_reshard(host, 1, min_size=min_size), mesh,
            min_size=min_size))
        for f, o in ((fsdp, opt), (fsdp2, opt2)):
            step_fn(f, o, local)
        out[name]["restored_step_diff"] = max(
            (a - b).abs().max().item() for a, b in zip(
                fsdp.model.parameters(), fsdp2.model.parameters()))
    out["bf16_saved"] = fsdp_bf16_saved(specs["gpt"], _local(
        batches["gpt"], rank, size), mesh, min_size)
    out["tree"] = sharded.fsdp_reshard(tree, mesh, min_size=8)
    whole = sharded.fsdp_reshard(tree, 1, min_size=8)
    out["tree_n1"] = whole
    out["tree_back"] = sharded.fsdp_reshard(whole, mesh, min_size=8)
    return out


def saved_by_autograd(loss):
    """Every tensor the autograd graph of ``loss`` holds for its backward
    (each node's ``_saved_*`` values and a custom Function's
    ``saved_tensors``): ``[(shape, bytes of its storage now)]``, one entry
    per storage."""
    seen, out, stack, nodes = set(), [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.add(node)
        stack.extend(f for f, _ in node.next_functions)
        values = [getattr(node, a) for a in dir(node)
                  if a.startswith("_saved_")]
        values += list(getattr(node, "saved_tensors", ()) or ())
        for v in values:
            for t in (v if isinstance(v, (tuple, list)) else [v]):
                if not isinstance(t, torch.Tensor):
                    continue
                key = t.untyped_storage().data_ptr()
                if key and key not in seen:
                    seen.add(key)
                    out.append((tuple(t.shape), t.untyped_storage().nbytes()))
    return out


def fsdp_bf16_saved(spec, local, mesh, min_size):
    """GPT tiny in bf16 under FSDP and unsharded, one forward and backward
    each on this rank's batch cut to 24 tokens a row (48 in all, so that no
    activation has a weight's shape): what each autograd graph holds for
    its backward at the end of the forward (:func:`saved_by_autograd`), the
    full shapes of the sharded weights, and the largest difference of each
    shard's gradient from the unsharded model's gradient averaged over the
    ranks."""
    import torch.distributed as dist

    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import fsdp as tf

    kind, kw, params = spec
    local = {"ids": local["ids"][:, :24]}
    bf16 = (kind, dict(kw, dtype=torch.bfloat16), params)
    plain, model = _build(bf16), _build(bf16)
    fs = tf.shard_params(model, mesh, min_size=min_size)
    full = {n: tuple(plain.get_parameter(n).shape) for n in fs.dims}
    loss = _xent(plain, local)
    plain_saved = saved_by_autograd(loss)
    loss.backward()
    with in_step.axes(mesh):
        loss = _xent(model, local)
        fsdp_saved = saved_by_autograd(loss)
        loss.backward()
    fs.remove()
    group = mesh.get_group("hvd")
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    worst = 0.0
    for name, (_, dim) in fs.dims.items():
        want = plain.get_parameter(name).grad.clone()
        dist.all_reduce(want, group=group)
        want = (want / n).chunk(n, dim=dim)[idx]
        got = model.get_parameter(name).grad
        worst = max(worst, (got - want).abs().max().item())
    return {"full_shapes": sorted(set(full.values())),
            "fsdp": fsdp_saved, "plain": plain_saved,
            "grad_max_diff": worst}
