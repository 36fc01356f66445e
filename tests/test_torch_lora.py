"""The port's LoRA (``horovod_tpu_torch/models/lora.py``) against the JAX
package's ``models/lora.py``, on GPT tiny (2 layers) with Flax's initial
weights carried across by ``load_flax_gpt``.

- ``targets`` regexes select the same Flax paths on both sides.
- Zero-initialised ``b``: the adapted model's logits equal the base's bit
  for bit.
- On the same adapters (``a`` and ``b`` drawn with numpy): ``lora_apply``
  and ``lora_merge`` against JAX's, each kernel in its Flax view;
  ``lora_wire_numbers`` equal; the adapters' gradients of the next-token
  loss against ``jax.grad`` of JAX's ``adapter_loss_fn``;
  ``adapter_loss_fn_via_extra`` equal to ``adapter_loss_fn``.
- Fine-tuning the adapters (Adam): the loss falls, the base parameters stay
  bit-unchanged, and the merged export differs from the base; through
  ``make_train_step`` with a ``DistributedOptimizer`` in a one-rank gloo
  world, the fused buckets carry the adapters' gradients and nothing else.

Tolerances (fp32): merged kernels rtol 1e-6 / atol 1e-7 (the rank-4
product sums four terms in either order); logits and the loss as
``test_torch_gpt.py`` (rtol 1e-4 / atol 1e-5, loss rtol 1e-5); each
adapter gradient within 1e-4 of its tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import gpt as jg
from horovod_tpu.models import lora as jlora
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.models import lora as tlora
from horovod_tpu_torch.parallel.tp import FlaxKernel

KW = dict(num_layers=2, max_position_embeddings=16, tp_axis=None,
          ep_axis=None)


def _ids():
    return np.random.default_rng(4).integers(0, 256, (4, 8)).astype(
        np.int32)


@pytest.fixture(scope="module")
def flax_params():
    model = jg.GPT(jg.GPTConfig.tiny(**KW))
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(_ids()))["params"])


def _port(params):
    return tg.load_flax_gpt(tg.GPT(tg.GPTConfig.tiny(**KW)), params)


def _jax_loss(params, ids):
    logits = jg.GPT(jg.GPTConfig.tiny(**KW)).apply({"params": params}, ids)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1].astype(jnp.float32), ids[:, 1:]).mean()


def _port_loss(model):
    def loss_fn(params, ids):
        logits = torch.func.functional_call(model, params, (ids,))
        return F.cross_entropy(logits[:, :-1].flatten(0, 1),
                               ids[:, 1:].flatten())
    return loss_fn


def _drawn(lora, seed=7):
    """The JAX adapters of ``lora`` with ``a`` and ``b`` drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {**lora, "adapters": {
        path: {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in ad.items()}
        for path, ad in lora["adapters"].items()}}


def _load(port_lora, jax_lora):
    with torch.no_grad():
        for path, ad in port_lora["adapters"].items():
            for k in ("a", "b"):
                ad[k].copy_(torch.from_numpy(
                    np.asarray(jax_lora["adapters"][path][k])))


@pytest.mark.parametrize("targets", [r".", r"attn|qkv",
                                     r"layer_\d+/(attention|mlp)/",
                                     r"mlp/out"])
def test_targets_select_the_same_paths(flax_params, targets):
    want = jlora.lora_init(flax_params, rank=2, targets=targets)
    got = tlora.lora_init(_port(flax_params), rank=2, targets=targets)
    assert sorted(got["adapters"]) == sorted(want["adapters"])
    for path, ad in got["adapters"].items():
        for k in ("a", "b"):
            assert tuple(ad[k].shape) == want["adapters"][path][k].shape


def test_init_errors_and_zero_b(flax_params):
    model = _port(flax_params)
    with pytest.raises(ValueError, match="no 2-D 'kernel'"):
        tlora.lora_init(model, rank=2, targets=r"nonexistent_layer_xyz")
    with pytest.raises(ValueError, match="rank"):
        tlora.lora_init(model, rank=0)
    lora = tlora.lora_init(model, rank=4,
                           rng=torch.Generator().manual_seed(1))
    assert all(not ad["b"].any() for ad in lora["adapters"].values())
    a = next(iter(lora["adapters"].values()))["a"]
    assert a.requires_grad and a.std().item() > 0


def test_zero_init_is_identity(flax_params):
    model = _port(flax_params)
    lora = tlora.lora_init(model, rank=4,
                           rng=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        base = model(ids)
        adapted = torch.func.functional_call(
            model, tlora.lora_apply(tlora.frozen_params(model), lora), (ids,))
    assert torch.equal(adapted, base)


def test_apply_merge_and_wire_numbers_match_jax(flax_params):
    model = _port(flax_params)
    jl = _drawn(jlora.lora_init(flax_params, rank=4,
                                targets=r"layer_\d+/(attention|mlp)/"))
    tl = tlora.lora_init(model, rank=4,
                         targets=r"layer_\d+/(attention|mlp)/")
    _load(tl, jl)
    want = jlora.lora_merge(flax_params, jl)
    base = tlora.frozen_params(model)
    for merged in (tlora.lora_apply(base, tl), tlora.lora_merge(base, tl)):
        ref = dict(_port(jax.tree_util.tree_map(np.asarray, want))
                   .named_parameters())
        for name, t in merged.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       ref[name].detach().numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        assert all(torch.equal(merged[n], base[n]) for n in base
                   if "attention" not in n and "mlp" not in n)
    assert tlora.lora_wire_numbers(model, tl) == jlora.lora_wire_numbers(
        flax_params, jl)
    assert tlora.lora_wire_numbers(base, tl) == tlora.lora_wire_numbers(
        model, tl)


def test_adapter_gradients_match_jax(flax_params):
    ids = _ids()
    model = _port(flax_params)
    jl = _drawn(jlora.lora_init(flax_params, rank=4))
    adapter_loss = jlora.adapter_loss_fn(_jax_loss, flax_params, jl)
    loss, grads = jax.jit(jax.value_and_grad(adapter_loss))(
        jax.tree_util.tree_map(jnp.asarray, jl["adapters"]),
        jnp.asarray(ids))
    tl = tlora.lora_init(model, rank=4)
    _load(tl, jl)
    tloss = tlora.adapter_loss_fn(_port_loss(model),
                                  tlora.frozen_params(model), tl)(
        tl["adapters"], torch.from_numpy(ids).long())
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    tloss.backward()
    assert not any(p.grad is not None for p in model.parameters())
    assert len(tl["adapters"]) == 9
    for path, ad in tl["adapters"].items():
        for k in ("a", "b"):
            want = np.asarray(grads[path][k])
            np.testing.assert_allclose(ad[k].grad.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{path}/{k}")


def test_via_extra_equals_the_closure_variant(flax_params):
    model = _port(flax_params)
    jl = _drawn(jlora.lora_init(flax_params, rank=4))
    ids = torch.from_numpy(_ids()).long()
    base = tlora.frozen_params(model)
    out = []
    for via_extra in (False, True):
        tl = tlora.lora_init(model, rank=4)
        _load(tl, jl)
        if via_extra:
            loss, back = tlora.adapter_loss_fn_via_extra(
                _port_loss(model), tl)(tl["adapters"], ids, base)
            assert back is base
        else:
            loss = tlora.adapter_loss_fn(_port_loss(model), base, tl)(
                tl["adapters"], ids)
        loss.backward()
        out.append((loss, [p.grad for p in tl["adapters"].parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_finetune_learns_with_the_base_frozen(flax_params):
    model = _port(flax_params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lora = tlora.lora_init(model, rank=4,
                           rng=torch.Generator().manual_seed(1))
    base = tlora.frozen_params(model)
    step_loss = tlora.adapter_loss_fn(_port_loss(model), base, lora)
    opt = torch.optim.Adam(lora["adapters"].parameters(), lr=1e-2)
    ids = torch.from_numpy(_ids()).long()
    losses = []
    for _ in range(30):
        opt.zero_grad()
        loss = step_loss(lora["adapters"], ids)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    merged = tlora.lora_merge(base, lora)
    changed = [n for n in merged if not torch.equal(merged[n], before[n])]
    assert changed and all(isinstance(dict(model.named_parameters())[n],
                                      FlaxKernel) for n in changed)


def test_make_train_step_steps_the_adapters_only(flax_params):
    """The adapters are a module ``make_train_step`` steps: the loss falls,
    the base stays, and the fused buckets carry the adapters' gradients
    and nothing else (JAX's distributed fine-tuning test, one rank)."""
    import torch_parallel_helpers as ph
    import torch_port_helpers as helpers
    [got] = helpers.run_world(ph.lora_train_step_world, 1,
                              args=(flax_params, KW, _ids()))
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    assert not got["base_moved"]
    names = {n.split(".", 1)[-1] for n, _ in got["entries"]}
    assert names == set(got["adapters"]), sorted(names)[:4]
    assert sum(k for _, k in got["entries"]) == 3 * sum(
        got["adapters"].values())
