"""Composite parallelism: dp x pp x tp (x sp), with the experts over dp.

Port of the JAX package's ``parallel/composite.py``. An in-step mesh
(``ops/in_step.py``) of axes ``(dp, pp, tp)`` (:func:`build_mesh3d`) or
``(dp, pp, sp, tp)`` (:func:`build_mesh4d`):

- **dp** carries the batch; an MoE FFN's experts are sharded over it and
  dispatched with alltoalls (``parallel/moe.py``);
- **pp** carries the pipeline's stages (``parallel/pp.py``: GPipe or 1F1B);
- **tp** carries Megatron-sharded attention and MLP weights
  (``parallel/tp.py``);
- **sp** (``config.sp_axis="sp"`` over a 4-D mesh) shards the sequence:
  ring or Ulysses attention in every block, global positions, the
  boundary-correct next-token labels and an sp-global token mean.

The model: embed -> (an MoE FFN shared by the batch, residual, experts over
dp) -> the pipelined transformer blocks -> head. Each rank builds its own
shards inside the mesh: its stage's ``config.num_layers / pp`` blocks
(their tp shards), its ``num_experts / dp`` experts, and replicated copies
of the rest.

Gradients, held to the single-device model on the whole batch (JAX's
``pmean`` of every gradient over dp would average the experts of
different ranks, and its replicated leaves drift; ROADMAP §C):

- the embedding and the MoE FFN run on pp stage 0 alone, and their
  gradients are summed over pp; the head runs on the last stage alone and
  its gradients are summed over pp too (unless the head holds a
  collective, ``parallel/pp.py``: then every stage runs it, as JAX does,
  and each holds the same gradients);
- every gradient is summed over sp (each rank's loss sees its tokens);
- replicated and pp-sharded gradients are averaged over dp; an expert's
  comes back through the alltoall's backward with every dp rank's tokens
  in it, and is scaled by ``1 / dp``, never averaged across ranks;
- tp layers keep their own f and g.

So replicated leaves stay bit-equal on every rank: each all-reduce hands
every member the same sum, and the optimizer does the same arithmetic on
it. ``mesh=None`` is one rank with no axis bound: the single-device
oracle.
"""

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch.common.topology import DP_AXIS, SP_AXIS, TP_AXIS
from horovod_tpu_torch.common.topology import PP_AXIS as PPL_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.ops.collective_ops import Average, Sum
from horovod_tpu_torch.ops.wire import fp32_reciprocal
from horovod_tpu_torch.parallel import pp as _pp
from horovod_tpu_torch.parallel.dp import sum_over
from horovod_tpu_torch.parallel.tp import remat as _remat


def build_mesh3d(dp, pp, tp, device_type=None):
    """A (dp, pp, tp) mesh over the world: tp innermost, dp outermost, as
    JAX's layout puts the most frequent collectives on the nearest ranks.
    Collective."""
    return in_step.make_mesh({DP_AXIS: dp, PPL_AXIS: pp, TP_AXIS: tp},
                             device_type)


def build_mesh4d(dp, pp, sp, tp, device_type=None):
    """A (dp, pp, sp, tp) mesh for composite training with sequence
    parallelism. Collective."""
    return in_step.make_mesh({DP_AXIS: dp, PPL_AXIS: pp, SP_AXIS: sp,
                              TP_AXIS: tp}, device_type)


def _stage_leaf_spec(name):
    """JAX's PartitionSpec (as a tuple, Flax layout) of one pp-stacked
    block leaf, from its port parameter name within the block."""
    if name.endswith("shard.weight"):
        if "qkv" in name or ".in." in f".{name}" or "gate_up" in name:
            return (PPL_AXIS, None, TP_AXIS)        # column-parallel
        return (PPL_AXIS, TP_AXIS, None)            # row-parallel
    if name.endswith("shard.bias"):
        return (PPL_AXIS, TP_AXIS)                  # column-parallel bias
    return (PPL_AXIS,)                              # norms, row bias


def flax_params(module):
    """``module``'s parameters as a Flax tree of numpy arrays, the inverse
    of ``models.gpt.load_flax`` for this rank's shards: Dense kernels
    (in, out), norm ``scale``, ``embedding``."""
    from horovod_tpu_torch.parallel.tp import Dense, LayerNorm, RMSNorm
    tree = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            leaf = pname
            if pname == "weight":
                leaf = ("kernel" if isinstance(m, Dense) else "scale"
                        if isinstance(m, (LayerNorm, RMSNorm))
                        else "embedding")
            v = p.detach().float().cpu()
            if leaf == "kernel":
                v = v.t()
            node = tree
            for k in [k for k in mname.split(".") if k]:
                node = node.setdefault(k, {})
            node[leaf] = v.numpy().copy()
    return tree


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _layer(tree, g):
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


class _CompositeLM:
    """Pipelined, tensor-parallel causal-LM training over ``mesh``.

    ``optimizer(params) -> torch.optim.Optimizer`` (e.g.
    ``functools.partial(torch.optim.SGD, lr=0.1)``), built over this rank's
    parameters by :meth:`init`. ``n_micro`` microbatches per step;
    ``aux_weight`` weighs the MoE load-balancing loss; ``remat``: None
    inherits ``config.remat`` (each pipelined block under
    ``torch.utils.checkpoint`` in the gpipe schedule; 1F1B recomputes by
    construction and ignores it). Use :meth:`init` (or
    :meth:`load_flax`), then :meth:`make_train_step`: ``step(ids) ->
    loss`` on this rank's ``(dp, sp)`` shard of the batch. Subclasses
    build the family's embed, head, block and optional MoE modules."""

    def __init__(self, config, mesh, optimizer, n_micro=4, aux_weight=0.01,
                 remat=None):
        self.config, self.mesh, self.optimizer = config, mesh, optimizer
        self.n_micro, self.aux_weight = n_micro, aux_weight
        names = () if mesh is None else tuple(mesh.mesh_dim_names)
        if mesh is not None:
            for ax in (DP_AXIS, PPL_AXIS, TP_AXIS):
                if ax not in names:
                    raise ValueError(f"mesh must have axis {ax!r}")
        c = config
        self.sp = getattr(c, "sp_axis", None)
        if self.sp is not None and (self.sp != SP_AXIS
                                    or (mesh is not None
                                        and SP_AXIS not in names)):
            raise NotImplementedError(
                f"{type(self).__name__} supports config.sp_axis only as "
                f"{SP_AXIS!r} over a build_mesh4d mesh (got "
                f"sp_axis={self.sp!r}, mesh axes {names})")
        if self.sp is not None and getattr(c, "num_experts", 0):
            raise NotImplementedError(
                "sp_axis does not compose with MoE blocks yet "
                "(num_experts > 0): the router and load-balance aux would "
                "see only local token shards")
        self.remat = bool(getattr(c, "remat", False)) if remat is None \
            else remat
        with self._axes():
            self.pp = in_step.axis_size_or_1(PPL_AXIS)
            self.stage = in_step.axis_index(PPL_AXIS) \
                if in_step.axis_bound(PPL_AXIS) else 0
            if c.num_layers % self.pp:
                raise ValueError(
                    f"{c.num_layers} layers not divisible by pp={self.pp}")
            self.layers_per_stage = c.num_layers // self.pp
            self.model = nn.Module()
            self._build_modules()
        self.opt = None

    def _build_modules(self):
        raise NotImplementedError

    def _axes(self):
        return contextlib.nullcontext() if self.mesh is None \
            else in_step.axes(self.mesh)

    # ---- shardings and weights ----

    def param_specs(self):
        """``{parameter name: JAX PartitionSpec as a tuple}``: the stage
        leaves as JAX's stacked ones (``pp`` first, Megatron's tp
        placement), the experts over dp, the rest replicated."""
        specs = {}
        for name, _ in self.model.named_parameters():
            if name.startswith("stages."):
                specs[name] = _stage_leaf_spec(name.split(".", 2)[2])
            elif name in ("moe.w_in", "moe.w_out"):
                specs[name] = (DP_AXIS,)
            else:
                specs[name] = ()
        return specs

    def global_layer(self, i):
        """The global index of this stage's ``i``-th block."""
        return self.stage * self.layers_per_stage + i

    def init(self, generator=None, device=None):
        """Draw the weights with Flax's initializers (each block from a
        generator of its own, seeded by one draw of ``generator`` and its
        global index, so every pp layout draws the same blocks), move the
        model to ``device`` and build the optimizer. Returns self."""
        from horovod_tpu_torch.models.gpt import GPTEmbed
        from horovod_tpu_torch.parallel.tp import reset_flax_
        with self._axes():
            embed, moe = self.model.embed, self.model.moe
            if isinstance(embed, GPTEmbed):
                embed.reset_parameters(generator)
            else:
                reset_flax_(embed, generator)
            if moe is not None:
                reset_flax_(moe, generator)
                moe.reset_parameters(generator)
            reset_flax_(self.model.head, generator)
            dev = generator.device if generator is not None else "cpu"
            base = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                     device=dev))
            for i, block in enumerate(self.model.stages):
                g = torch.Generator(device=dev).manual_seed(
                    (base + self.global_layer(i)) % 2 ** 63)
                reset_flax_(block, g)
        return self.to(device)

    def to(self, device=None):
        """The model on ``device``, and a fresh optimizer over it."""
        if device is not None:
            self.model.to(device)
        self.opt = self.optimizer(list(self.model.parameters()))
        return self

    def load_flax(self, params):
        """Fill this rank's shards from JAX's global composite tree
        (``{"embed", "moe", "stages", "head"}``, numpy): the stage leaves
        stacked ``(num_layers, ...)`` (this stage's block of them), tp
        leaves in JAX's sharded layout, experts ``(E, ...)`` (this dp
        rank's block). Returns self."""
        from horovod_tpu_torch.models.gpt import load_flax
        for name in ("embed", "moe", "head"):
            m = getattr(self.model, name, None)
            if m is not None:
                load_flax(m, params[name])
        for i, block in enumerate(self.model.stages):
            load_flax(block, _layer(params["stages"], self.global_layer(i)))
        return self

    def flax_params(self):
        """This rank's shards as a composite tree (the stage leaves
        stacked over this stage's blocks)."""
        out = {name: flax_params(getattr(self.model, name))
               for name in ("embed", "moe", "head")
               if getattr(self.model, name, None) is not None}
        out["stages"] = _stack([flax_params(b) for b in self.model.stages])
        return out

    # ---- the step ----

    def _head_loss(self, head, y, ids):
        """Head and next-token loss over one (micro)batch, the one loss
        both schedules use: labels from ``next_token_labels`` (under sp,
        each shard's last label is the next shard's first token), the
        token mean global over sp (an all-reduce of the sums)."""
        from horovod_tpu_torch.parallel.sequence import next_token_labels
        logits = head(y)
        labels = next_token_labels(ids, self.sp)
        valid = labels != -100
        ce = torch.nn.functional.cross_entropy(
            logits.float().flatten(0, -2),
            torch.where(valid, labels, 0).flatten(), reduction="none")
        num = (ce * valid.flatten()).sum()
        den = valid.sum().to(torch.float32)
        if self.sp and in_step.axis_bound(SP_AXIS):
            num = in_step.allreduce(num, Sum, SP_AXIS)
            den = in_step.allreduce(den, Sum, SP_AXIS)
        return num / den

    def _head_collective(self):
        return bool(self.sp) and in_step.axis_size_or_1(SP_AXIS) > 1

    def _layer_fn(self, block, h):
        return block(h)

    def _microbatches(self, ids):
        """Stage 0's embedded (and MoE'd) microbatches and the aux loss;
        zeros of the same shape on another stage, which never reads
        them."""
        c = self.config
        B, L = ids.shape
        if B % self.n_micro:
            raise ValueError(
                f"local batch {B} not divisible by n_micro={self.n_micro}")
        shape = (self.n_micro, B // self.n_micro, L, c.hidden_size)
        if self.stage != 0:
            return torch.zeros(shape, dtype=c.dtype, device=ids.device), \
                None, None
        x = self.model.embed(ids)
        aux = None
        if getattr(self.model, "moe", None) is not None:
            h, aux = self.model.moe(x)
            x = x + h
        return x.reshape(shape), aux, x

    def _loss_local(self, ids):
        """gpipe: every microbatch's stage graph is kept to the backward
        (``pp.pipeline``), the loss backward-propagated here. Returns this
        rank's loss part (head on the last stage, aux on stage 0)."""
        last = self.stage == self.pp - 1
        mbs, aux, _ = self._microbatches(ids)
        layer = (lambda blk, h: _remat(blk, (h,))) if self.remat \
            else self._layer_fn
        y = _pp.gpipe_outputs(layer, self.model.stages, mbs, PPL_AXIS)
        everywhere = self._head_collective()
        if everywhere:
            y = _pp._bcast_from_last(y, PPL_AXIS)
        terms, cts = [], []
        part = torch.zeros((), device=ids.device)
        if last or everywhere:
            loss = self._head_loss(self.model.head, y.reshape(
                ids.shape + (self.config.hidden_size,)), ids)
            terms.append(loss)
            cts.append(torch.ones_like(loss))
            if last:
                part = part + loss.detach()
        else:
            terms.append(y)                    # reach the pipeline's node
            cts.append(torch.zeros_like(y))
        if aux is not None:
            terms.append(aux)
            cts.append(torch.full_like(aux, self.aux_weight))
            part = part + self.aux_weight * aux.detach()
        torch.autograd.backward(terms, cts)
        return part

    def _grads_1f1b(self, ids):
        """1F1B (``pp.run_1f1b_over_axis``): the schedule differentiates
        the stages and the head itself; the embedding backward-propagates
        stage 0's input gradients."""
        if getattr(self.model, "moe", None) is not None:
            raise NotImplementedError(
                "schedule='1f1b' does not support MoE blocks yet (the aux "
                "loss and expert grads are outside the pipelined backward)")
        mbs, _, x = self._microbatches(ids)
        tgts = ids.reshape((self.n_micro, -1) + tuple(ids.shape[1:]))
        run, head = _pp.run_1f1b_over_axis(
            self._layer_fn, self._head_loss, self.model.stages,
            self.model.head, mbs, tgts, PPL_AXIS, self._head_collective())
        for w, g in zip(run.weights, run.grads):
            w.grad = g
        if self.stage == self.pp - 1:
            for w, g in zip(head.weights, head.grads):
                w.grad = g
        if x is not None and run.d_mb:
            x.backward(torch.stack([run.d_mb[m] for m in range(run.M)])
                       .reshape(x.shape))
        if self.stage == self.pp - 1:
            return head.loss_sum
        return torch.zeros((), device=ids.device)

    def _reduce(self, head_everywhere):
        """The gradient reductions of the module docstring."""
        named = dict(self.model.named_parameters())
        for p in named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        once = [p for n, p in named.items()
                if n.startswith(("embed.", "moe."))
                or (n.startswith("head.") and not head_everywhere)]
        sum_over(once, PPL_AXIS)
        if self.sp:
            sum_over(list(named.values()), SP_AXIS)
        specs = self.param_specs()
        sum_over([p for n, p in named.items() if DP_AXIS not in specs[n]],
                 DP_AXIS)
        n = in_step.axis_size_or_1(DP_AXIS)
        if n > 1:
            scale = fp32_reciprocal(n)
            for p in named.values():
                p.grad.mul_(scale)

    def loss_and_grads(self, ids, schedule="gpipe"):
        """One step's loss on this rank's ``(B_local, L_local)`` shard of
        the batch (fp32, the mean loss of the global batch, the same on
        every rank), every parameter's gradient reduced into its
        ``.grad``. ``schedule``: ``"gpipe"`` keeps every microbatch's
        activations to the backward, ``"1f1b"`` the stage inputs of the
        microbatches in flight (O(pp)), with the same gradients."""
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        with self._axes():
            for p in self.model.parameters():
                p.grad = None
            if schedule == "1f1b":
                part = self._grads_1f1b(ids)
            else:
                part = self._loss_local(ids)
            self._reduce(schedule == "gpipe" and self._head_collective())
            loss = part.detach()
            if in_step.axis_bound(PPL_AXIS):
                loss = in_step.reduce_from_axis(loss, PPL_AXIS)
            if in_step.axis_bound(DP_AXIS):
                loss = in_step.allreduce(loss, Average, DP_AXIS)
        return loss

    def make_train_step(self, schedule="gpipe"):
        """``step(ids) -> loss``: :meth:`loss_and_grads`, then one step of
        the optimizer (JAX's ``make_train_step``)."""
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if self.opt is None:
            self.to()

        def step(ids):
            loss = self.loss_and_grads(ids, schedule)
            self.opt.step()
            return loss
        return step


class CompositeGPT(_CompositeLM):
    """Pipelined, tensor-parallel GPT, with an MoE FFN (experts over dp)
    after the embedding when ``config.num_experts``."""

    def _build_modules(self):
        from horovod_tpu_torch.models.gpt import GPTEmbed, GPTHead
        from horovod_tpu_torch.parallel.moe import MoEMlp
        from horovod_tpu_torch.parallel.tp import TPTransformerBlock
        c = self.config
        self.model.embed = GPTEmbed(c)
        self.model.moe = None
        if c.num_experts:
            self.model.moe = MoEMlp(
                c.num_experts, c.hidden_size, c.intermediate_size,
                k=c.moe_k, capacity_factor=c.capacity_factor, dtype=c.dtype,
                axis_name=DP_AXIS, hierarchical=c.moe_hierarchical)
        self.model.stages = nn.ModuleList(
            TPTransformerBlock(c.num_heads, c.hidden_size,
                               c.intermediate_size, dtype=c.dtype,
                               axis_name=TP_AXIS, causal=True,
                               use_flash=c.use_flash, sp_axis=c.sp_axis,
                               sp_impl=c.sp_impl)
            for _ in range(self.layers_per_stage))
        self.model.head = GPTHead(c)


class CompositeLlama(_CompositeLM):
    """Pipelined, tensor-parallel LLaMA: the same machinery with the
    family's RMSNorm, RoPE (positions from each block's own token window),
    SwiGLU and GQA blocks (``models/llama.py``). The blocks take a copy of
    the config pinned to the mesh's tp axis; a conflicting
    ``config.tp_axis`` raises."""

    def _build_modules(self):
        from horovod_tpu_torch.models.llama import (LlamaBlock, LlamaEmbed,
                                                    LlamaHead)
        if self.config.tp_axis not in (None, TP_AXIS):
            raise ValueError(
                f"config.tp_axis={self.config.tp_axis!r} conflicts with "
                f"the composite mesh's tensor-parallel axis {TP_AXIS!r}; "
                "leave it as None (or set it to the mesh axis)")
        c = dataclasses.replace(self.config, tp_axis=TP_AXIS)
        self.model.embed = LlamaEmbed(c)
        self.model.moe = None
        self.model.stages = nn.ModuleList(
            LlamaBlock(c) for _ in range(self.layers_per_stage))
        self.model.head = LlamaHead(c)


__all__ = ["build_mesh3d", "build_mesh4d", "CompositeGPT", "CompositeLlama",
           "flax_params"]
