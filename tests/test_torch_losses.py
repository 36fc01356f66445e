"""The port's chunked next-token loss (``horovod_tpu_torch/optim/losses.py``)
and ``parallel/sequence.py::next_token_labels`` against the JAX package's.

- ``next_token_xent_chunked`` on the same numpy hidden states (2, 16, 32),
  a linear head to V = 64 and labels with some -100 (and a -1), chunk 4,
  against JAX's: the loss within rtol 1e-5, the gradients of the hidden
  states and of the head within rtol 2e-4, atol 1e-6 (the tolerances of
  JAX's own ``test_chunked_xent_matches_full_logits``; fp32 on both sides,
  sums in another order).
- The port's GPT tiny and LLaMA tiny (2 layers): the chunked loss over
  ``features_only`` states and the model's head against the full-logits
  next-token loss, in torch alone, with the same tolerances on the loss and
  every parameter's gradient. (JAX's GPT is not compiled here: its own
  test of this costs ~70 s.)
- ``next_token_labels``: equal to JAX's for ``axis_name=None``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.optim import next_token_xent_chunked as jax_chunked
from horovod_tpu.parallel import next_token_labels as jax_labels
from horovod_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from horovod_tpu_torch.optim import next_token_xent_chunked
from horovod_tpu_torch.parallel.sequence import next_token_labels

B, L, H, V, CHUNK = 2, 16, 32, 64, 4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 1e-6


def _inputs():
    rng = np.random.default_rng(31)
    hidden = rng.standard_normal((B, L, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) / np.sqrt(H)).astype(np.float32)
    labels = rng.integers(0, V, (B, L)).astype(np.int32)
    labels[0, 5] = labels[1, 0] = labels[1, L - 1] = -100
    labels[0, 9] = -1
    return hidden, w, labels


def test_chunked_loss_matches_jax():
    hidden, w, labels = _inputs()

    def jloss(h, w_):
        return jax_chunked(lambda x: x @ w_, h, jnp.asarray(labels),
                           chunk=CHUNK)

    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(w))
    h = torch.from_numpy(hidden).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = next_token_xent_chunked(lambda x: x @ wt, h,
                                   torch.from_numpy(labels).long(),
                                   chunk=CHUNK)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgh),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # The masked positions count for nothing: the same loss without them.
    keep = labels >= 0
    logits = torch.from_numpy(hidden[keep] @ w)
    full = F.cross_entropy(logits, torch.from_numpy(labels[keep]).long())
    np.testing.assert_allclose(loss.item(), full.item(), rtol=LOSS_RTOL)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_chunked_matches_full_logits(family):
    gen = torch.Generator().manual_seed(5)
    if family == "gpt":
        model = GPT(GPTConfig.tiny(num_layers=2), generator=gen)
    else:
        model = Llama(LlamaConfig.tiny(num_layers=2), generator=gen)
    ids = torch.randint(0, 256, (2, 16), generator=gen)

    def grads(fn):
        model.zero_grad()
        loss = fn()
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    lf, gf = grads(lambda: F.cross_entropy(
        model(ids)[:, :-1].float().flatten(0, 1), ids[:, 1:].flatten()))
    lc, gc = grads(lambda: next_token_xent_chunked(
        model.head, model(ids, features_only=True), next_token_labels(ids),
        chunk=4))
    np.testing.assert_allclose(lc, lf, rtol=LOSS_RTOL)
    assert set(gc) == set(gf)
    for name in gf:
        np.testing.assert_allclose(gc[name].numpy(), gf[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    with pytest.raises(ValueError, match="divisible"):
        next_token_xent_chunked(model.head, model(ids, features_only=True),
                                next_token_labels(ids), chunk=5)


def test_next_token_labels_match_jax():
    ids = np.random.default_rng(3).integers(0, 100, (3, 7)).astype(np.int32)
    for pad in (-100, 0):
        want = np.asarray(jax_labels(jnp.asarray(ids), axis_name=None,
                                     pad_id=pad))
        got = next_token_labels(torch.from_numpy(ids), pad_id=pad).numpy()
        np.testing.assert_array_equal(got, want)
    # An axis that is not bound (no in-step mesh here) is the plain shift,
    # as JAX's outside shard_map; the sharded form is test_torch_sequence's.
    want = np.asarray(jax_labels(jnp.asarray(ids), axis_name="sp"))
    got = next_token_labels(torch.from_numpy(ids), axis_name="sp").numpy()
    np.testing.assert_array_equal(got, want)
