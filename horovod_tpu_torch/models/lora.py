"""LoRA: low-rank adaptation for parameter-efficient fine-tuning.

Port of the JAX package's ``models/lora.py`` (Hu et al. 2021): frozen base
weights ``W`` adapted as ``W + (alpha/r) A B`` with trainable rank-``r``
factors. The adapters are kept apart from the model and merged
functionally into the parameters before each forward
(``torch.func.functional_call``), so any model of the port works
unchanged, gradients reach the adapters only, and a
``hvd.DistributedOptimizer`` (or ``parallel/dp.py::make_train_step``) over
the adapters moves adapter bytes alone through the fused buckets:
``r (n + m)`` elements per adapted ``(n, m)`` kernel instead of ``n m``.

Adapters are keyed by the Flax path of the kernel they adapt
(``layer_0/attention/qkv/shard/kernel``; ``models/gpt.py::flax_key`` maps it
to the port's parameter name), so a ``targets`` regex selects the kernels
it selects in JAX. ``a`` is (n_in, r) and ``b`` (r, n_out), in the Flax
layout, and the delta ``a @ b`` is added to each kernel in its Flax view.
``lora["adapters"]`` is an ``nn.ModuleDict`` of ``nn.ParameterDict``s
``{"a", "b"}``: a module, so an optimizer, ``make_train_step`` and
``.to(device)`` take it as they take a model::

    lora = lora_init(model, rank=8, rng=torch.Generator().manual_seed(1))
    base = frozen_params(model)
    loss = adapter_loss_fn(loss_fn, base, lora)   # loss(adapters, batch)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(lora["adapters"].parameters(), lr=1e-4),
        named_parameters=lora["adapters"].named_parameters())
    ...
    export = lora_merge(base, lora)                # a standalone state

``loss_fn(params, batch)`` takes a ``{name: tensor}`` parameter dict, as
JAX's takes a params tree, and runs the model on it with
``torch.func.functional_call(model, params, (batch,))``.
"""

import math
import re

import torch
from torch import nn

from horovod_tpu_torch.models.gpt import flax_key
from horovod_tpu_torch.parallel.tp import FlaxKernel


def _flax_path(name):
    """The Flax path of a ``FlaxKernel`` parameter's port name
    (``layer_0.attention.qkv.shard.weight`` ->
    ``layer_0/attention/qkv/shard/kernel``)."""
    return "/".join(name.split(".")[:-1] + ["kernel"])


def _named(params):
    """``{name: tensor}`` of a module's parameters or of a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _kernel_leaves(model, targets):
    """``(flax path, parameter)`` of the 2-D ``kernel`` leaves of ``model``
    whose Flax path matches the ``targets`` regex."""
    out = []
    for name, p in model.named_parameters():
        if isinstance(p, FlaxKernel) and p.dim() == 2:
            path = _flax_path(name)
            if re.search(targets, path):
                out.append((path, p))
    return out


def lora_init(model, rank=8, alpha=None, targets=r".", rng=None,
              dtype=None):
    """The adapters of every 2-D ``kernel`` (n_in, n_out) of ``model`` whose
    Flax path matches ``targets``: ``a`` (n_in, r) normal with variance
    1/n_in, drawn from ``rng`` (a ``torch.Generator``; a fresh one seeded 0
    when None), and ``b`` (r, n_out) zero, so the adapted model starts
    exactly at the base. Returns ``{"rank", "alpha", "adapters"}``, the
    adapters on each kernel's device in its dtype (or ``dtype``)."""
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    alpha = float(alpha) if alpha is not None else float(rank)
    selected = _kernel_leaves(model, targets)
    if not selected:
        raise ValueError(
            f"lora_init: no 2-D 'kernel' leaves match targets={targets!r}")
    adapters = nn.ModuleDict()
    for path, w in selected:
        n_in, n_out = FlaxKernel.to_flax(w).shape
        r = min(rank, n_in, n_out)
        dt = dtype or w.dtype
        a = torch.randn((n_in, r), generator=rng, device=rng.device) \
            * (1.0 / math.sqrt(max(n_in, 1)))
        adapters[path] = nn.ParameterDict({
            "a": nn.Parameter(a.to(w.device, dt)),
            "b": nn.Parameter(torch.zeros((r, n_out), dtype=dt,
                                          device=w.device))})
    return {"rank": rank, "alpha": alpha, "adapters": adapters}


def _delta(ad, alpha, rank):
    scale = alpha / max(1, min(rank, ad["a"].shape[1]))
    return (ad["a"] @ ad["b"]) * scale


def lora_apply(params, lora):
    """A NEW parameter dict for ``functional_call``: ``W + (alpha/r) a b``
    (in ``W``'s Flax view) at every adapted kernel, every other entry of
    ``params`` (a module or ``{name: tensor}``) as it is. The base tensors
    stay untouched."""
    merged = _named(params)
    alpha, rank = lora["alpha"], lora["rank"]
    for path, ad in lora["adapters"].items():
        name = flax_key(tuple(path.split("/")))
        w = merged[name]
        merged[name] = w + FlaxKernel.from_flax(
            _delta(ad, alpha, rank)).to(w.dtype)
    return merged


def lora_merge(params, lora):
    """Export: the adapters folded into a standalone parameter dict (the
    names of ``params``), detached, for serving without LoRA:
    ``model.load_state_dict(lora_merge(...), strict=False)``."""
    with torch.no_grad():
        return {k: v.detach() for k, v in lora_apply(params, lora).items()}


def lora_wire_numbers(params, lora):
    """(adapter_bytes, full_bytes) an allreduce moves with LoRA against full
    fine-tuning, counted in fp32 as JAX counts them."""
    adapter = sum(ad["a"].numel() + ad["b"].numel()
                  for ad in lora["adapters"].values()) * 4
    full = sum(t.numel() for t in _named(params).values()) * 4
    return adapter, full


def frozen_params(model):
    """``model``'s parameters detached: a base no gradient reaches."""
    return {k: v.detach() for k, v in model.named_parameters()}


def adapter_loss_fn(loss_fn, base_params, lora):
    """The LoRA adapter for the training machinery: given the model's
    ``loss_fn(params, batch)``, return ``adapter_loss(adapters, batch)``,
    which merges ``adapters`` into the frozen ``base_params`` (detach them:
    :func:`frozen_params`) before calling through. The base is a closure
    constant; :func:`adapter_loss_fn_via_extra` passes it as an operand."""
    rank, alpha = lora["rank"], lora["alpha"]

    def adapter_loss(adapters, batch):
        merged = lora_apply(base_params, {"rank": rank, "alpha": alpha,
                                          "adapters": adapters})
        return loss_fn(merged, batch)

    return adapter_loss


def adapter_loss_fn_via_extra(loss_fn, lora):
    """:func:`adapter_loss_fn` with the frozen base passed at each call,
    ``adapter_loss(adapters, batch, base) -> (loss, base)`` (the
    ``has_aux`` extra contract of ``make_train_step``)."""
    rank, alpha = lora["rank"], lora["alpha"]

    def adapter_loss(adapters, batch, base):
        merged = lora_apply(base, {"rank": rank, "alpha": alpha,
                                   "adapters": adapters})
        return loss_fn(merged, batch), base

    return adapter_loss


__all__ = ["lora_init", "lora_apply", "lora_merge", "lora_wire_numbers",
           "adapter_loss_fn", "adapter_loss_fn_via_extra", "frozen_params"]
