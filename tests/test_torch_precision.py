"""The port's fp32 products at the JAX package's precision.

No layer of the JAX package's GPT or ResNet sets a ``precision``, so every
product there runs at ``lax.Precision.DEFAULT`` (TF32 for fp32 operands on
an H100); every product of the port runs through
``parallel/tp.py::at_precision`` at the same default (a ``Dense`` may ask
for ``"highest"``), which on CUDA runs fp32 products in TF32, forward and
backward, and leaves PyTorch's process-wide TF32 flags as it found them. On
the CPU precision changes nothing: ``None`` and ``"highest"`` give
bit-identical results. The card's side (the lm_head
within a TF32 bound that a bf16 product fails) is in
tests/test_torch_cuda_kernels.py and chip_smoke.py's ``precision`` phase.
"""

import weakref

import jax
import jax.numpy as jnp
import pytest
import torch

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import GPT, GPTConfig, ResNet
from horovod_tpu_torch.models import resnet as presnet
from horovod_tpu_torch.models.resnet import BottleneckResNetBlock
from horovod_tpu_torch.parallel import tp
from horovod_tpu_torch.parallel.tp import Dense, plain_attention

GPT_KW = dict(num_layers=2, max_position_embeddings=16, tp_axis=None,
              ep_axis=None, use_flash=False)
RESNET_KW = dict(stage_sizes=[1, 1], block_cls=BottleneckResNetBlock,
                 num_classes=10, num_filters=8, dtype=torch.float32)


def _products(jaxpr):
    """(primitive, precision) of every dot_general and convolution in a
    jaxpr, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            out.append((eqn.primitive.name, eqn.params.get("precision")))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _products(inner)
    return out


def _default(p):
    return p is None or all(x in (None, jax.lax.Precision.DEFAULT)
                            for x in (p if isinstance(p, tuple) else (p,)))


def _reference_products(name):
    if name == "gpt":
        model = jgpt.GPT(jgpt.GPTConfig.tiny(**GPT_KW))
        x = jnp.zeros((1, 8), jnp.int32)
    else:
        model = jresnet.ResNet(stage_sizes=[1, 1],
                               block_cls=jresnet.BottleneckResNetBlock,
                               num_classes=10, num_filters=8,
                               dtype=jnp.float32)
        x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)

    def loss(v):
        out = model.apply(v, x, mutable=["batch_stats"]) if name == "resnet" \
            else model.apply(v, x)
        out = out[0] if isinstance(out, tuple) else out
        return out.astype(jnp.float32).sum()
    return _products(jax.make_jaxpr(jax.grad(loss))(variables).jaxpr)


def _port_model(name):
    torch.manual_seed(0)
    if name == "gpt":
        return GPT(GPTConfig.tiny(**GPT_KW)), torch.randint(0, 256, (2, 8))
    return ResNet(**RESNET_KW), torch.randn(2, 16, 16, 3)


@pytest.mark.parametrize("name", ["gpt", "resnet"])
def test_every_product_declares_default_as_its_flax_counterpart(name,
                                                                monkeypatch):
    """The reference's forward and backward products all run at DEFAULT;
    so does every product of the port: each Dense, convolution and plain
    attention goes through ``at_precision`` at None."""
    ref = _reference_products(name)
    assert ref and all(_default(p) for _, p in ref), ref
    seen, at_precision = [], tp.at_precision

    def record(precision, fn, *args):
        seen.append((fn.__name__, precision))
        return at_precision(precision, fn, *args)
    monkeypatch.setattr(tp, "at_precision", record)
    monkeypatch.setattr(presnet, "at_precision", record)
    model, x = _port_model(name)
    model(x)
    want = {"gpt": {"linear", "_plain_attention"},
            "resnet": {"linear", "conv2d"}}[name]
    assert {f for f, _ in seen} == want
    assert all(p is None for _, p in seen), seen


@pytest.mark.parametrize("name", ["gpt", "resnet"])
def test_default_and_highest_agree_on_the_cpu(name):
    model, x = _port_model(name)
    results = []
    for p in (None, "highest"):
        for m in model.modules():
            if isinstance(m, Dense):
                m.precision = p
        model.zero_grad()
        out = model(x)
        out.float().square().mean().backward()
        results.append([out.detach().clone()] + [
            q.grad.clone() for q in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*results))


@pytest.mark.parametrize("allow", [True, False])
def test_flags_set_in_forward_and_backward_and_restored(allow):
    """The scoped product sees the flags its precision asks for in its
    forward and in its backward, leaves them as it found them, and gives
    the gradients of the bare product."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (cuda.allow_tf32, cudnn.allow_tf32)
    seen = {}

    def product(x, w):
        seen["forward"] = (cuda.allow_tf32, cudnn.allow_tf32)
        y = x @ w
        y.register_hook(lambda g: seen.__setitem__(
            "backward", (cuda.allow_tf32, cudnn.allow_tf32)))
        return y

    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 7, generator=g, requires_grad=True)
    w = torch.randn(7, 3, generator=g, requires_grad=True)
    y = tp._Scoped.apply(product, allow, x, w)
    assert (cuda.allow_tf32, cudnn.allow_tf32) == before
    y.square().sum().backward()
    assert (cuda.allow_tf32, cudnn.allow_tf32) == before
    assert seen == {"forward": (allow, allow), "backward": (allow, allow)}
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (x @ w).square().sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)


def test_cpu_products_run_bare_and_unknown_precision_raises():
    x = torch.randn(3, 4, requires_grad=True)
    layer = Dense(4, 2)
    assert type(layer(x).grad_fn).__name__ != "_ScopedBackward"
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    assert type(plain_attention(q, q, q, torch.float32).grad_fn
                ).__name__ != "_ScopedBackward"
    assert tp.allows_tf32(None) and not tp.allows_tf32("highest")
    for unknown in ("high", "default", jax.lax.Precision.HIGHEST):
        with pytest.raises(ValueError):
            Dense(4, 2, precision=unknown)


def _product_seen(refs):
    def product(x, w):
        y = x @ w
        refs.append(weakref.ref(y))
        return y
    return product


def test_scoped_product_keeps_no_output_for_the_backward():
    """The scoped function keeps its graph's edge, not its output: the
    output is freed with the caller's last use, before the backward, and
    the gradients are those of the bare product."""
    refs = []
    g = torch.Generator().manual_seed(2)
    x = torch.randn(6, 5, generator=g, requires_grad=True)
    w = torch.randn(5, 4, generator=g, requires_grad=True)
    loss = tp._Scoped.apply(_product_seen(refs), True, x, w).square().sum()
    assert refs[0]() is None
    loss.backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (x @ w).square().sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)


def test_scoped_product_refuses_a_double_backward():
    """Its backward is once differentiable: asking for second-order terms
    through it raises rather than dropping them."""
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 2, requires_grad=True)
    y = tp._Scoped.apply(_product_seen([]), True, x, w)
    gx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        gx.sum().backward()
