"""What the port keeps alive once its caller lets go.

- A dropped ``hvd.DistributedOptimizer`` and its model are collected: the
  gradient hooks hold the wrapper weakly, so no cycle (parameter -> hook ->
  optimizer -> parameter) through autograd's C++ side outlives the caller,
  which the collector could not break (one process over gloo).
- ``parallel/tp.py``'s ``_Scoped`` (an fp32 CUDA product under the TF32
  flags) keeps its inner graph's saved tensors detached: a forward whose
  backward never runs frees that graph, also where a node saves its own
  output (softmax), and the gradients of one that runs are unchanged. The
  Function is called directly here, as the CPU never takes that route.
"""

import gc
import weakref

import torch

import torch_port_helpers as helpers
from horovod_tpu_torch.parallel import tp


def _dropped_optimizer(rank, size):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig

    def train():
        model = GPT(GPTConfig.tiny(num_layers=1),
                    generator=torch.Generator().manual_seed(0))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters())
        ids = torch.randint(0, 256, (2, 16))
        for _ in range(2):
            opt.zero_grad()
            logits = model(ids)
            torch.nn.functional.cross_entropy(
                logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten()).backward()
            opt.step()
        return (weakref.ref(opt), weakref.ref(model.head.lm_head.weight),
                float(model.head.lm_head.weight.sum()))

    opt, weight, _ = train()
    gc.collect()
    return opt() is None, weight() is None


def test_dropped_distributed_optimizer_frees_its_model():
    [(opt_gone, weight_gone)] = helpers.run_world(_dropped_optimizer, 1)
    assert opt_gone and weight_gone


def _attention(q, k):
    return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ k


def test_scoped_forward_without_backward_frees_its_graph():
    q = torch.randn(2, 8, 16, requires_grad=True)
    k = torch.randn(2, 8, 16, requires_grad=True)
    seen = []

    def fn(a, b):
        out = _attention(a, b)
        seen.append(weakref.ref(a))
        return out
    out = tp._Scoped.apply(fn, True, q, k)
    assert out.shape == (2, 8, 16)
    del out
    gc.collect()
    assert seen[0]() is None, "the inner graph outlived its output"


def test_scoped_gradients_unchanged():
    q = torch.randn(2, 8, 16, requires_grad=True)
    k = torch.randn(2, 8, 16, requires_grad=True)
    g = torch.randn(2, 8, 16)
    tp._Scoped.apply(_attention, True, q, k).backward(g)
    got = q.grad.clone(), k.grad.clone()
    q.grad = k.grad = None
    _attention(q, k).backward(g)
    assert torch.equal(got[0], q.grad) and torch.equal(got[1], k.grad)
