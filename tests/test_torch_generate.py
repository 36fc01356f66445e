"""The port's re-forward decoding (``horovod_tpu_torch/models/generate.py``
and ``speculative.py``) against the JAX package's, on the same weights
(Flax's init, ``load_flax``), fp32, on the CPU.

- ``_filter_logits`` bit-equal to JAX's on the same logits (top-k, top-p,
  both, and JAX's own property cases).
- Greedy ``generate`` token streams equal to JAX's on GPT tiny, LLaMA tiny
  (GQA 4/2) and the MoE GPT tiny; EOS latching and padding as JAX's;
  ``top_k=1`` sampling equals greedy; one generator seed, one stream.
- ``beam_search`` sequences equal to JAX's, scores within rtol 1e-5 (sums
  of log-probabilities), with and without EOS and a length penalty; one
  beam is greedy.
- ``speculative_accept``: the count and the accepted tokens bit-equal to
  JAX's for the same ``p, q, x, u`` (the replacement and bonus draws come
  from torch's generator, so only their support is checked) and JAX's
  deterministic cases; the first emitted token's frequency over 4000 rows
  within 0.03 of the target's distribution (JAX's test).
- Greedy ``speculative_generate`` equal to greedy ``generate`` with an
  independent draft and with the target as its own draft (the block count
  then minimal), and under EOS.
- Every KV-cache route runs (its parity with the re-forward routes and
  with JAX is ``test_torch_decode_cache.py``'s): the cached generate, beam
  search and speculative decoding give the re-forward tokens, a
  ``prefix_state`` without ``use_cache`` raises JAX's ``ValueError``, and
  the cache helpers allocate, prefill, reorder and rewind.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt as jg
from horovod_tpu.models import llama as jl
from horovod_tpu.models import speculative as jspec
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models import load_flax
from horovod_tpu_torch.models import speculative as tspec

# The packages export the function ``generate`` under the module's name.
jgen = importlib.import_module("horovod_tpu.models.generate")
tgen = importlib.import_module("horovod_tpu_torch.models.generate")
MAX_LEN = 12
FAMILIES = {
    "gpt": (lambda **kw: jg.GPT(jg.GPTConfig.tiny(**kw)),
            lambda **kw: tg.GPT(tg.GPTConfig.tiny(**kw)),
            dict(num_layers=2, max_position_embeddings=16, tp_axis=None,
                 ep_axis=None)),
    "llama": (lambda **kw: jl.Llama(jl.LlamaConfig.tiny(**kw)),
              lambda **kw: tl.Llama(tl.LlamaConfig.tiny(**kw)),
              dict(num_layers=2, max_position_embeddings=16, tp_axis=None)),
    "gpt_moe": (lambda **kw: jg.GPT(jg.GPTConfig.tiny(**kw)),
                lambda **kw: tg.GPT(tg.GPTConfig.tiny(**kw)),
                dict(num_layers=2, max_position_embeddings=16, tp_axis=None,
                     ep_axis=None, num_experts=4)),
}


def _prompt(B=3, P=4, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (B, P)).astype(
        np.int32)


def _pair(family, seed=0, **extra):
    make_j, make_t, kw = FAMILIES[family]
    kw = {**kw, **extra}
    jm = make_j(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.asarray(_prompt()))["params"])
    return jm, params, load_flax(make_t(**kw), params).eval()


@pytest.fixture(scope="module")
def gpt():
    return _pair("gpt")


def test_filter_logits_bit_equal_to_jax():
    logits = np.random.default_rng(1).standard_normal((4, 50)).astype(
        np.float32) * 3
    for k, p in ((5, 1.0), (0, 0.9), (7, 0.5), (0, 1e-6), (99, 1.0),
                 (0, 1.0)):
        want = np.asarray(jgen._filter_logits(jnp.asarray(logits), k, p))
        got = tgen._filter_logits(torch.from_numpy(logits), k, p).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} p={p}")
    small = torch.tensor([[3.0, 1.0, 0.0, -1.0, 2.0]])
    k2 = tgen._filter_logits(small, 2, 1.0)
    assert (k2 > -1e29).sum() == 2 and k2[0, 0] == 3.0 and k2[0, 4] == 2.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_streams_match_jax(family):
    jm, params, tm = _pair(family)
    prompt = _prompt()
    want = np.asarray(jgen.generate(jm, params, prompt, MAX_LEN))
    got = tgen.generate(tm, prompt, MAX_LEN)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_latches_as_jax(gpt):
    jm, params, tm = gpt
    prompt = _prompt()
    base = tgen.generate(tm, prompt, MAX_LEN).numpy()
    eos = int(base[0, 7])                 # a token row 0 emits mid-decode
    want = np.asarray(jgen.generate(jm, params, prompt, MAX_LEN,
                                    eos_id=eos))
    got = tgen.generate(tm, prompt, MAX_LEN, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    first = np.argmax(got[0, 4:] == eos) + 4
    assert (got[0, first:] == eos).all()


def test_sampling_top_k_one_and_reproducible(gpt):
    _, _, tm = gpt
    prompt = _prompt()
    greedy = tgen.generate(tm, prompt, MAX_LEN)
    one = tgen.generate(tm, prompt, MAX_LEN, temperature=1.0, top_k=1,
                        rng=torch.Generator().manual_seed(3))
    assert torch.equal(one, greedy)
    runs = [tgen.generate(tm, prompt, MAX_LEN, temperature=0.8, top_p=0.9,
                          rng=torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="rng"):
        tgen.generate(tm, prompt, MAX_LEN, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        tgen.generate(tm, prompt, MAX_LEN, top_p=0.0)
    with pytest.raises(ValueError, match="position capacity"):
        tgen.generate(tm, prompt, 17)


@pytest.mark.parametrize("eos", [False, True], ids=["plain", "eos_lp"])
def test_beam_search_matches_jax(gpt, eos):
    jm, params, tm = gpt
    prompt = _prompt()
    kw = {}
    if eos:
        kw = dict(eos_id=int(tgen.generate(tm, prompt, MAX_LEN)[1, 6]),
                  length_penalty=0.6)
    want_seqs, want_scores = jgen.beam_search(jm, params, prompt, MAX_LEN,
                                              num_beams=3, **kw)
    seqs, scores = tgen.beam_search(tm, prompt, MAX_LEN, num_beams=3, **kw)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5)


def test_one_beam_is_greedy(gpt):
    _, _, tm = gpt
    prompt = _prompt()
    seqs, _ = tgen.beam_search(tm, prompt, MAX_LEN, num_beams=1)
    assert torch.equal(seqs, tgen.generate(tm, prompt, MAX_LEN))


def test_speculative_accept_matches_jax():
    B, gamma, V = 256, 3, 6
    rng = np.random.default_rng(8)

    def probs(*shape):
        w = rng.random(shape).astype(np.float32) ** 3
        w[rng.random(shape) < 0.2] = 0.0           # filtered-out tokens
        w[..., 0] += 1e-3
        return (w / w.sum(-1, keepdims=True)).astype(np.float32)

    p, q = probs(B, gamma + 1, V), probs(B, gamma, V)
    x = np.stack([[rng.choice(V, p=q[b, i]) for i in range(gamma)]
                  for b in range(B)]).astype(np.int32)
    u = rng.random((B, gamma)).astype(np.float32)
    jtoks, jcount = jspec.speculative_accept(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(x), jnp.asarray(u),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    toks, count = tspec.speculative_accept(
        *(torch.from_numpy(a) for a in (p, q, x, u)),
        torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert 1 < len(set(count.tolist())) and count.max() == gamma + 1
    jtoks = np.asarray(jtoks)
    for b in range(B):
        k = int(count[b])
        np.testing.assert_array_equal(toks[b, :k - 1].numpy(),
                                      jtoks[b, :k - 1])
        last = int(toks[b, k - 1])
        src = p[b, gamma] if k == gamma + 1 else \
            np.maximum(p[b, k - 1] - q[b, k - 1], 0)
        assert src[last] > 0 or not src.any(), (b, k, last)


def test_speculative_accept_deterministic_cases():
    gamma, V = 2, 4
    onehot = torch.eye(V)
    q = torch.stack([onehot[1], onehot[2]])[None]
    x = torch.tensor([[1, 2]])
    g = torch.Generator().manual_seed(0)
    p = torch.stack([onehot[1], onehot[2], onehot[3]])[None]
    toks, count = tspec.speculative_accept(p, q, x, torch.zeros(1, gamma), g)
    assert int(count[0]) == 3 and toks[0].tolist() == [1, 2, 3]
    p2 = torch.stack([onehot[0], onehot[2], onehot[3]])[None]
    toks, count = tspec.speculative_accept(p2, q, x,
                                           torch.full((1, gamma), 0.5), g)
    assert int(count[0]) == 1 and int(toks[0, 0]) == 0


def test_first_token_marginal_is_the_target_distribution():
    V, gamma, n = 4, 2, 4000
    p0 = torch.tensor([0.5, 0.3, 0.15, 0.05])
    q0 = torch.tensor([0.1, 0.2, 0.3, 0.4])
    g = torch.Generator().manual_seed(42)
    p = p0.expand(n, gamma + 1, V)
    q = q0.expand(n, gamma, V)
    x = torch.multinomial(q0, n * gamma, replacement=True,
                          generator=g).reshape(n, gamma)
    u = torch.rand((n, gamma), generator=g)
    toks, _ = tspec.speculative_accept(p, q, x, u, g)
    freq = np.bincount(toks[:, 0].numpy(), minlength=V) / n
    np.testing.assert_allclose(freq, p0.numpy(), atol=0.03)


def test_greedy_speculative_equals_greedy_generate(gpt):
    _, _, target = gpt
    _, _, draft = _pair("gpt", seed=1, num_layers=1)
    prompt = _prompt()
    want = tgen.generate(target, prompt, MAX_LEN)
    assert torch.equal(tspec.speculative_generate(target, draft, prompt,
                                                  MAX_LEN, gamma=3), want)
    got, stats = tspec.speculative_generate(target, target, prompt, MAX_LEN,
                                            gamma=3, return_stats=True)
    assert torch.equal(got, want)
    assert stats["blocks"] == math.ceil((MAX_LEN - 4) / 4), stats
    eos = int(want[0, 7])
    assert torch.equal(
        tspec.speculative_generate(target, draft, prompt, MAX_LEN, gamma=3,
                                   eos_id=eos),
        tgen.generate(target, prompt, MAX_LEN, eos_id=eos))
    sampled = [tspec.speculative_generate(
        target, draft, prompt, MAX_LEN, gamma=3, temperature=1.0, top_k=20,
        rng=torch.Generator().manual_seed(6)) for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    assert torch.equal(sampled[0][:, :4], want[:, :4])


def _reordered(m):
    """Rows 0..5 of a 2 x 3-beam cache, filled with their row index, after
    a reorder by origin [[2, 2, 0], [1, 0, 1]]: each row holds its origin
    beam's, the cursors shared."""
    cache = tgen.init_decode_cache(m, 6)
    for path, t in cache.items():
        if torch.is_tensor(t):
            t.copy_(torch.arange(6.0).view(6, *[1] * (t.dim() - 1))
                    .expand_as(t))
    out = tgen.beam_reorder_cache(cache, torch.tensor([[2, 2, 0],
                                                       [1, 0, 1]]), 2, 3)
    rows = [t[:, 0, 0, 0].tolist() for p, t in out.items()
            if torch.is_tensor(t)]
    return all(r == [2, 2, 0, 4, 3, 4] for r in rows) and all(
        v == 0 for p, v in out.items() if p.endswith("/idx"))


def _prefix_needs_cache(m):
    with pytest.raises(ValueError, match="requires use_cache"):
        tgen.generate(m, _prompt(), 8, prefix_state={})
    return True


def _rewound(m):
    cache = tgen.init_decode_cache(m, 3)
    with torch.no_grad():
        m(torch.from_numpy(_prompt()).long(), pos=0, cache=cache)
    return all(v == 1 for p, v in tspec.rewind_cache(cache, 1).items()
               if p.endswith("/idx"))


@pytest.mark.parametrize("call", [
    lambda m: torch.equal(tgen.generate(m, _prompt(), 8, use_cache=True),
                          tgen.generate(m, _prompt(), 8)),
    _prefix_needs_cache,
    lambda m: torch.equal(
        tgen.beam_search(m, _prompt(), 8, use_cache=True)[0],
        tgen.beam_search(m, _prompt(), 8)[0]),
    lambda m: torch.equal(
        tspec.speculative_generate(m, m, _prompt(), 8, use_cache=True),
        tgen.generate(m, _prompt(), 8)),
    lambda m: sorted(tgen.init_decode_cache(m, 3).entries) == [
        f"layer_{i}/attention/{n}" for i in range(2)
        for n in ("idx", "k", "v")],
    lambda m: all(v == 4 for p, v in tgen.prefill_prefix(
        m, _prompt())["cache"].items() if p.endswith("/idx")),
    _reordered,
    _rewound,
], ids=["generate_cache", "prefix_state", "beam_cache", "speculative_cache",
        "init_decode_cache", "prefill_prefix", "beam_reorder_cache",
        "rewind_cache"])
def test_cache_routes_raise_naming_a15(gpt, call):
    """Once each of these raised naming A15; now each runs: the cached
    generate, beam search and speculation give the re-forward tokens, the
    cache helpers allocate, prefill, reorder and rewind, and a
    ``prefix_state`` without ``use_cache`` raises JAX's ``ValueError``."""
    assert call(gpt[2])
