"""The port's decode cache (``parallel/tp.py::DecodeCache`` and the cached
routes of ``models/generate.py``, ``speculative.py`` and ``t5.py``) against
the port's re-forward decoding and against the JAX package, on the same
weights (Flax's init, through ``load_flax``), fp32, on the CPU.

GPT tiny and LLaMA tiny (GQA 4/2) at 2 layers and a capacity of 16, T5 tiny
(2 layers a stack, ``max_decode_len`` 32); inputs from numpy seeds. The
port's cached routes mirror JAX's own tests (``tests/test_models.py``):

- cached greedy, sampled (one ``torch.Generator`` seed: the re-forward
  route's stream) and beam decoding, cached speculative decoding and prefix
  caching equal the port's re-forward or cold routes token for token, and
  beam scores within rtol 1e-5 (1e-4 for T5, JAX's limits); every feed of a
  cached route runs the model on s tokens against the cache;
- per-row positions, staggered, against decodes with a shared cursor, a
  chunked feed against s single feeds, and a rewound cache against one
  that never saw the rejected rows: logits within rtol 2e-5 / atol 2e-5
  (JAX's limit; the rewound one bit-equal: the stale rows' weights are
  exact zeros);
- the int8 cache's logits within 0.15 max|logit| of the fp32 cache's,
  argmax agreeing on more than 0.9 of the positions, its bytes under half
  of the fp32 cache's (JAX's test);
- every route refuses a write past the capacity with ``ValueError``.

Against JAX on the same inputs: the logits and the cache after a prefill,
both packages starting from one cache (``cache_from_flax``): logits rtol
1e-4 / atol 1e-5, K/V rtol 1e-4 / atol 1e-5; the int8 codes bit-equal for
the same K/V rows (the quantizer, jitted JAX against the port), and within
one step through the whole model, the scales rtol 1e-4; JAX's cached greedy
tokens; T5's cached decode steps (logits and cache); T5's decode-time
buckets bit-equal to ``relative_position_buckets_causal_jnp`` for every
query position, at T5 tiny's (8, 16, 32) and T5-small's (32, 128, 512).
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt as jg
from horovod_tpu.models import llama as jl
from horovod_tpu.models import t5 as jt5
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models import load_flax
from horovod_tpu_torch.models import speculative as tspec
from horovod_tpu_torch.models import t5 as tt5
from horovod_tpu_torch.models.gpt import cache_from_flax, cache_to_numpy
from horovod_tpu_torch.ops import wire as tw

jgen = importlib.import_module("horovod_tpu.models.generate")
tgen = importlib.import_module("horovod_tpu_torch.models.generate")
CAP = 16
FAMILIES = {
    "gpt": (lambda **kw: jg.GPT(jg.GPTConfig.tiny(**kw)),
            lambda **kw: tg.GPT(tg.GPTConfig.tiny(**kw)),
            dict(num_layers=2, max_position_embeddings=CAP, tp_axis=None,
                 ep_axis=None)),
    "llama": (lambda **kw: jl.Llama(jl.LlamaConfig.tiny(**kw)),
              lambda **kw: tl.Llama(tl.LlamaConfig.tiny(**kw)),
              dict(num_layers=2, max_position_embeddings=CAP, tp_axis=None,
                   num_kv_heads=2)),
}


def _ids(B, P, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, P)).astype(
        np.int32)


def _pair(family, seed=0, **extra):
    make_j, make_t, kw = FAMILIES[family]
    kw = {**kw, **extra}
    jm = make_j(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.asarray(_ids(2, 4, 9)))["params"])
    return jm, params, load_flax(make_t(**kw), params).eval()


@pytest.fixture(scope="module")
def models():
    return {f: _pair(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def t5():
    cfg = dict(tp_axis=None)
    jm = jt5.T5(jt5.T5Config.tiny(**cfg))
    src = _ids(2, 6, 11) % 48 + 2
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(src),
        jnp.asarray(src[:, :4]))["params"])
    return jm, params, load_flax(tt5.T5(tt5.T5Config.tiny(**cfg)),
                                 params).eval(), src


def _feeds(module):
    """Record the token count and cache of every forward of ``module``."""
    seen = []

    def hook(m, args, kwargs):
        if args[0] is not None:            # not T5's cross K/V projection
            seen.append((args[0].shape[1], kwargs.get("cache") is not None))
    return seen, module.register_forward_pre_hook(hook, with_kwargs=True)


# --- the cached routes against the port's re-forward ones -------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_cached_greedy_and_sampled_equal_reforward(models, family):
    """JAX's test_kv_cache_matches_full_reforward, and JAX's own cached
    greedy tokens on the same weights; every cached feed holds s tokens
    against the cache (the prefill's P - 1, then single tokens)."""
    jm, params, tm = models[family]
    prompt = _ids(3, 4, 1)
    full = tgen.generate(tm, prompt, 12)
    seen, handle = _feeds(tm)
    try:
        cached = tgen.generate(tm, prompt, 12, use_cache=True)
    finally:
        handle.remove()
    assert torch.equal(cached, full)
    assert seen == [(3, True)] + [(1, True)] * 8, seen
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(prompt), 12,
                                    use_cache=True))
    np.testing.assert_array_equal(cached.numpy(), want)
    streams = [tgen.generate(tm, prompt, 12, temperature=1.0, top_k=20,
                             rng=torch.Generator().manual_seed(3),
                             use_cache=cache) for cache in (False, True)]
    assert torch.equal(streams[1], streams[0])
    assert not torch.equal(streams[1], full)


def test_eos_cached_equals_reforward(models):
    """JAX's test_eos_cached_matches_full_reforward."""
    _, _, tm = models["gpt"]
    prompt = _ids(2, 3, 2)
    eos = int(tgen.generate(tm, prompt, 12)[0, 5])   # a token greedy emits
    full = tgen.generate(tm, prompt, 12, eos_id=eos)
    cached = tgen.generate(tm, prompt, 12, eos_id=eos, use_cache=True)
    assert torch.equal(cached, full)
    row = full[0].numpy()
    first = int(np.argmax(row[3:] == eos)) + 3
    assert (row[first:] == eos).all()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_per_row_positions_match_shared_cursor(models, family):
    """JAX's test_per_row_decode_positions_match_scalar_cursor: a (B,)
    ``pos`` tensor, row 1 two steps late and parked at position 0 while it
    waits, against each row decoded alone with a shared cursor."""
    _, _, tm = models[family]
    prompt = torch.from_numpy(_ids(2, 6, 3)).long()
    P = prompt.shape[1]

    def alone(row):
        cache = tgen.init_decode_cache(tm, 1)
        for t in range(P):
            logits = tm(row[None, t:t + 1], pos=t, cache=cache)[:, 0]
        return logits

    with torch.no_grad():
        ref = torch.cat([alone(prompt[0]), alone(prompt[1])])
        cache = tgen.init_decode_cache(tm, 2)
        for step in range(P + 2):
            t0, t1 = min(step, P - 1), max(0, min(step - 2, P - 1))
            feed = torch.stack([prompt[0, t0], prompt[1, t1]])[:, None]
            last = tm(feed, pos=torch.tensor([t0, t1]), cache=cache)[:, 0]
    np.testing.assert_allclose(last.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("kw", [{}, {"eos_id": 7, "length_penalty": 1.0}],
                         ids=["plain", "eos_lp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cached_beam_equals_reforward_beam(models, family, kw):
    """JAX's test_cached_beam_matches_reforward_beam: sequences equal,
    scores within rtol 1e-5; the prompt prefilled once at batch B, then
    one token a hypothesis a feed."""
    _, _, tm = models[family]
    prompt = _ids(2, 3, 4)
    sf, scf = tgen.beam_search(tm, prompt, 10, num_beams=3, **kw)
    seen, handle = _feeds(tm)
    try:
        sc, scc = tgen.beam_search(tm, prompt, 10, num_beams=3,
                                   use_cache=True, **kw)
    finally:
        handle.remove()
    assert torch.equal(sc, sf)
    np.testing.assert_allclose(scc.numpy(), scf.numpy(), rtol=1e-5)
    assert seen == [(2, True)] + [(1, True)] * 7, seen


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cached_speculative_equals_cached_greedy(models, family):
    """JAX's test_cached_speculative_bit_identical, with an independent
    one-layer draft: one chunked target feed of gamma + 1 tokens a block."""
    _, _, target = models[family]
    _, _, draft = _pair(family, seed=1, num_layers=1)
    prompt = _ids(3, 4, 5)
    want = tgen.generate(target, prompt, 12, use_cache=True)
    seen, handle = _feeds(target)
    try:
        got, stats = tspec.speculative_generate(
            target, draft, prompt, 12, gamma=3, use_cache=True,
            return_stats=True)
    finally:
        handle.remove()
    assert torch.equal(got, want)
    assert seen == [(3, True)] + [(4, True)] * stats["blocks"], seen
    sampled = [tspec.speculative_generate(
        target, draft, prompt, 12, gamma=3, temperature=0.8, top_k=32,
        top_p=0.9, rng=torch.Generator().manual_seed(5), use_cache=True)
        for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    assert torch.equal(sampled[0][:, :4], torch.from_numpy(prompt).long())


def test_cached_perfect_draft_full_accept_block_count(models):
    """JAX's test of the same name: the target as its own draft accepts
    every block, so ceil(generated / (gamma + 1)) blocks."""
    _, _, tm = models["gpt"]
    big = _pair("gpt", max_position_embeddings=32)[2]
    prompt = _ids(1, 3, 6)
    _, stats = tspec.speculative_generate(big, big, prompt, 27, gamma=3,
                                          use_cache=True, return_stats=True)
    assert stats["blocks"] == math.ceil((27 - 3) / 4), stats


@torch.no_grad()
def test_chunked_feed_equals_sequential(models):
    """JAX's test_chunked_cache_feed_matches_sequential: one feed of 5
    tokens against five single feeds, logits and every cache tensor."""
    _, _, tm = models["gpt"]
    toks = torch.from_numpy(_ids(2, 5, 7)).long()
    chunk = tgen.init_decode_cache(tm, 2)
    chunk_logits = tm(toks, pos=0, cache=chunk)
    seq = tgen.init_decode_cache(tm, 2)
    seq_logits = torch.stack([tm(toks[:, t:t + 1], pos=t, cache=seq)[:, 0]
                              for t in range(5)], dim=1)
    np.testing.assert_allclose(chunk_logits.numpy(), seq_logits.numpy(),
                               rtol=2e-4, atol=2e-5)
    for (ka, a), (kb, b) in zip(sorted(chunk.entries.items()),
                                sorted(seq.entries.items())):
        assert ka == kb
        if torch.is_tensor(a):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=ka)
        else:
            assert a == b == 5


@torch.no_grad()
def test_rewind_cache_resets_cursors_only(models):
    """JAX's test of the same name: every cursor moves, no K/V row
    changes."""
    _, _, tm = models["gpt"]
    cache = tgen.init_decode_cache(tm, 1)
    tm(torch.from_numpy(_ids(1, 4, 8)).long(), pos=0, cache=cache)
    before = {k: v.clone() for k, v in cache.entries.items()
              if torch.is_tensor(v)}
    assert tspec.rewind_cache(cache, 2) is cache
    idxs = [v for k, v in cache.entries.items() if k.endswith("/idx")]
    assert len(idxs) == 2 and all(v == 2 for v in idxs)
    for k, v in before.items():
        assert torch.equal(cache.entries[k], v), k


@torch.no_grad()
@pytest.mark.parametrize("per_row", [False, True], ids=["cursor", "per_row"])
def test_layers_of_one_feed_share_its_masks_and_rotations(models, monkeypatch,
                                                          per_row):
    """A model's cached forward makes the RoPE rotations (and the masks
    beside them) once for its 2 layers, with logits and cache bit-equal to
    layers that each make their own (``for_feed`` opening no scratch, as
    for an attention called alone)."""
    from horovod_tpu_torch.parallel import tp
    _, _, tm = models["llama"]
    made = []

    def counted(*args, real=tp.rope_cos_sin):
        made.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(tp, "rope_cos_sin", counted)
    toks = torch.from_numpy(_ids(2, 3, 9)).long()
    pos = torch.tensor([0, 2]) if per_row else 0
    runs = []
    for share in (True, False):
        if not share:
            monkeypatch.setattr(tp.DecodeCache, "for_feed", lambda c: c)
        made.clear()
        cache = tgen.init_decode_cache(tm, 2)
        runs.append((tm(toks, pos=pos, cache=cache), cache, len(made)))
    (a, ca, n_shared), (b, cb, n_own) = runs
    assert (n_shared, n_own) == (1, 2)
    assert torch.equal(a, b)
    for k, v in ca.entries.items():
        assert torch.equal(v, cb.entries[k]) if torch.is_tensor(v) \
            else v == cb.entries[k], k


@torch.no_grad()
@pytest.mark.parametrize("family", list(FAMILIES))
def test_rewound_cache_equals_one_that_never_saw_the_rows(models, family):
    """Feeds after a rewind over two rejected rows give the logits of a
    cache that never held them, bit for bit: the validity mask's -1e9
    weighs the stale rows at exactly zero."""
    _, _, tm = models[family]
    toks = torch.from_numpy(_ids(2, 7, 10)).long()
    wound = tgen.init_decode_cache(tm, 2)
    tm(toks[:, :5], pos=0, cache=wound)
    tspec.rewind_cache(wound, 3)
    clean = tgen.init_decode_cache(tm, 2)
    tm(toks[:, :3], pos=0, cache=clean)
    for cache in (wound, clean):
        assert all(v == 3 for k, v in cache.entries.items()
                   if k.endswith("/idx"))
    a = tm(toks[:, 5:7], pos=3, cache=wound)
    b = tm(toks[:, 5:7], pos=3, cache=clean)
    assert torch.equal(a, b)


# --- prefix caching ---------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefix_cache_bit_identical_to_cold_decode(models, family):
    """JAX's TestPrefixCache.test_bit_identical_to_cold_decode; the state
    serves a second call unchanged."""
    _, _, tm = models[family]
    prefix, user = _ids(3, 5, 12), _ids(3, 3, 13)
    prompt = np.concatenate([prefix, user], axis=1)
    cold = tgen.generate(tm, prompt, 14, use_cache=True)
    state = tgen.prefill_prefix(tm, prefix)
    for _ in range(2):
        warm = tgen.generate(tm, prompt, 14, use_cache=True,
                             prefix_state=state)
        assert torch.equal(warm, cold)
    assert all(v == 5 for k, v in state["cache"].entries.items()
               if k.endswith("/idx"))


def test_one_row_prefix_tiles_to_batch(models):
    """JAX's test of the same name: a (1, Pp) prefix serves a batch of 3."""
    _, _, tm = models["gpt"]
    prefix = _ids(1, 5, 14)
    prompt = np.concatenate([np.repeat(prefix, 3, axis=0), _ids(3, 3, 15)],
                            axis=1)
    cold = tgen.generate(tm, prompt, 14, use_cache=True)
    state = tgen.prefill_prefix(tm, prefix)
    warm = tgen.generate(tm, prompt, 14, use_cache=True, prefix_state=state)
    assert torch.equal(warm, cold)


def test_prefix_misuse_raises_as_jax(models):
    """JAX's TestPrefixCache.test_misuse."""
    _, _, tm = models["gpt"]
    prefix = _ids(1, 5, 14)
    state = tgen.prefill_prefix(tm, prefix)
    other = _ids(2, 8, 16)
    with pytest.raises(ValueError, match="begin with the prefix"):
        tgen.generate(tm, other, 14, use_cache=True, prefix_state=state)
    with pytest.raises(ValueError, match="requires use_cache"):
        tgen.generate(tm, other, 14, prefix_state=state)
    with pytest.raises(ValueError, match="SHORTER than the prompt"):
        tgen.generate(tm, prefix, 14, use_cache=True, prefix_state=state)
    two = tgen.prefill_prefix(tm, np.repeat(prefix, 2, axis=0))
    prompt3 = np.concatenate([np.repeat(prefix, 3, axis=0),
                              np.zeros((3, 2), np.int32)], axis=1)
    with pytest.raises(ValueError, match="incompatible with"):
        tgen.generate(tm, prompt3, 14, use_cache=True, prefix_state=two)
    with pytest.raises(ValueError, match="position"):
        tgen.prefill_prefix(tm, np.zeros((1, 20), np.int32))


# --- the int8 cache ---------------------------------------------------------

@torch.no_grad()
@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_cache_close_to_fp_cache(family):
    """JAX's TestInt8KVCache.test_chunked_feed_close_to_fp_cache."""
    _, params, _ = _pair(family)
    make_t, kw = FAMILIES[family][1:]
    toks = torch.from_numpy(_ids(2, 6, 17)).long()
    outs = {}
    for int8 in (False, True):
        tm = load_flax(make_t(**kw, kv_cache_int8=int8), params).eval()
        cache = tgen.init_decode_cache(tm, 2)
        outs[int8] = (tm(toks, pos=0, cache=cache).numpy(), cache)
    lf, li = outs[False][0], outs[True][0]
    assert np.abs(li - lf).max() < 0.15 * max(np.abs(lf).max(), 1.0)
    assert (li.argmax(-1) == lf.argmax(-1)).mean() > 0.9
    kv8 = [v for k, v in outs[True][1].entries.items()
           if k.endswith(("/k", "/v"))]
    assert kv8 and all(v.dtype == torch.int8 for v in kv8)
    fp_bytes = sum(v.numel() * v.element_size()
                   for k, v in outs[False][1].entries.items()
                   if k.endswith(("/k", "/v")))
    assert outs[True][1].nbytes() < fp_bytes / 2


def test_generate_with_int8_cache_runs(models):
    """JAX's test_generate_with_int8_cache_runs."""
    _, params, _ = models["gpt"]
    tm = load_flax(tg.GPT(tg.GPTConfig.tiny(**FAMILIES["gpt"][2],
                                            kv_cache_int8=True)),
                   params).eval()
    prompt = _ids(2, 4, 18)
    out = tgen.generate(tm, prompt, 12, use_cache=True)
    assert out.shape == (2, 12)
    assert torch.equal(out[:, :4], torch.from_numpy(prompt).long())
    assert int(out.min()) >= 0 and int(out.max()) < 256


# --- T5 ---------------------------------------------------------------------

def test_t5_cached_greedy_and_sampled_equal_reforward(t5):
    """JAX's test_cached_decode_matches_full and test_t5_sampling: the
    cached decode one token a feed, the cross K/V projected once."""
    _, _, tm, src = t5
    full = tt5.t5_greedy_decode(tm, src, 8)
    seen, handle = _feeds(tm.decoder)
    try:
        cached = tt5.t5_greedy_decode(tm, src, 8, use_cache=True)
    finally:
        handle.remove()
    assert torch.equal(cached, full)
    assert seen == [(1, True)] * 7, seen
    assert torch.equal(tt5.t5_generate(tm, src, 8, use_cache=True), full)
    streams = [tt5.t5_generate(tm, src, 8, temperature=1.0, top_k=8,
                               rng=torch.Generator().manual_seed(5),
                               use_cache=cache) for cache in (False, True)]
    assert torch.equal(streams[1], streams[0])


@pytest.mark.parametrize("kw", [{}, {"eos_id": 1, "length_penalty": 1.0}],
                         ids=["plain", "eos_lp"])
def test_t5_cached_beam_equals_reforward(t5, kw):
    """JAX's test_t5_cached_beam_matches_reforward: sequences equal,
    scores within rtol 1e-4."""
    _, _, tm, src = t5
    sf, scf = tt5.t5_beam_decode(tm, src, 9, num_beams=3, **kw)
    sc, scc = tt5.t5_beam_decode(tm, src, 9, num_beams=3, use_cache=True,
                                 **kw)
    assert torch.equal(sc, sf)
    np.testing.assert_allclose(scc.numpy(), scf.numpy(), rtol=1e-4)


@torch.no_grad()
def test_t5_decode_steps_match_jax(t5):
    """Three cached decoder steps from one zeroed cache in both packages:
    each step's logits and, after them, the cache."""
    jm, params, tm, src = t5
    jdec = dataclasses.replace(jm, decode_mode=True)
    memory = np.asarray(jm.apply({"params": params}, jnp.asarray(src),
                                 method=jt5.T5.encode))
    jcache = jgen.init_decode_cache(
        jdec, jnp.zeros((2, 1), jnp.int32), jnp.asarray(memory), pos=0,
        method=jt5.T5.decode)
    cache = cache_from_flax(jcache)
    assert sorted(cache.entries) == [
        f"decoder/layer_{i}/attention/{n}" for i in range(2)
        for n in ("idx", "k", "v")]
    toks = _ids(2, 3, 19)
    mem_t = torch.from_numpy(np.array(memory))
    for t in range(3):
        want, upd = jdec.apply({"params": params, "cache": jcache},
                               jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(memory), pos=t,
                               method=jt5.T5.decode, mutable=["cache"])
        jcache = upd["cache"]
        got = tm.decode(torch.from_numpy(toks[:, t:t + 1]).long(), mem_t,
                        pos=t, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")
    _assert_cache_close(cache_to_numpy(cache), jcache)


@pytest.mark.parametrize("shape", [(8, 16, 32), (32, 128, 512)],
                         ids=["t5_tiny", "t5_small"])
def test_t5_decode_buckets_bit_equal_to_jax(shape):
    """Every query position's causal buckets over the whole cache, and the
    matrix ``decode_bias`` keeps: bit-equal to JAX's traced fp32 function
    (as a decode step runs it, jitted)."""
    nb, md, L = shape
    keys = np.arange(L)
    want = np.asarray(jax.jit(jax.vmap(
        lambda q: jt5.relative_position_buckets_causal_jnp(
            q, jnp.arange(L), nb, md)))(jnp.arange(L)))
    got = np.stack([tt5.relative_position_buckets_causal_jnp(q, keys, nb, md)
                    for q in range(L)])
    np.testing.assert_array_equal(got, want)
    rel = tt5.T5RelativeBias(tt5.T5Config.tiny(
        num_buckets=nb, max_distance=md, max_decode_len=L, tp_axis=None),
        bidirectional=False)
    torch.nn.init.normal_(rel.rel_bias)
    bias = rel.decode_bias(L - 1, L)
    assert bias.shape == (4, 1, L)
    np.testing.assert_array_equal(rel._buckets[("decode", L,
                                                rel.rel_bias.device)].numpy(),
                                  want)


# --- against JAX: the cache after a prefill ---------------------------------

def _assert_cache_close(got, want, int8=False):
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        g, name = flat_g[path], path[-1].key
        if name == "idx":
            assert int(g) == int(w)
        elif int8 and name in ("k", "v"):
            assert g.dtype == np.int8 and w.dtype == np.int8
            # one quantization step: the rows differ in their last fp32 bits
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=str(path))


@torch.no_grad()
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_logits_and_cache_match_jax(models, family, int8):
    """A 6-token chunk into a zeroed cache, then a single token, in both
    packages from one cache (``cache_from_flax``): the logits, and the
    cache (``cache_to_numpy``) against JAX's tree."""
    jm, params, _ = models[family]
    make_t, kw = FAMILIES[family][1:]
    jdec = dataclasses.replace(
        FAMILIES[family][0](**kw, kv_cache_int8=int8), decode=True)
    tm = load_flax(make_t(**kw, kv_cache_int8=int8), params).eval()
    toks = _ids(2, 7, 20)
    jcache = jgen.init_decode_cache(jdec, jnp.asarray(toks[:, :1]), pos=0)
    cache = cache_from_flax(jcache)
    for start, end in ((0, 6), (6, 7)):
        want, upd = jdec.apply({"params": params, "cache": jcache},
                               jnp.asarray(toks[:, start:end]), pos=start,
                               mutable=["cache"])
        jcache = upd["cache"]
        got = tm(torch.from_numpy(toks[:, start:end]).long(), pos=start,
                 cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    _assert_cache_close(cache_to_numpy(cache), jcache, int8)


def test_int8_codes_bit_equal_to_jax_for_the_same_rows():
    """The cache's quantizer on the same (B, s, kv, d) rows: the port's
    ``wire.symmetric_int8_quantize`` and JAX's, jitted as a decode step
    runs it."""
    from horovod_tpu.parallel.strategies import symmetric_int8_quantize
    rows = np.random.default_rng(21).standard_normal((2, 6, 2, 16)).astype(
        np.float32) * np.float32(3.7)
    rows[0, 0, 0] = 0.0
    want_q, want_s = jax.jit(symmetric_int8_quantize)(jnp.asarray(rows))
    q, s = tw.symmetric_int8_quantize(torch.from_numpy(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))


# --- the capacity -----------------------------------------------------------

def _past_capacity(routes):
    return [pytest.param(call, id=name) for name, call in routes]


@pytest.mark.parametrize("call", _past_capacity([
    ("generate", lambda m, t: tgen.generate(m["gpt"][2], _ids(2, 4, 1),
                                            CAP + 1, use_cache=True)),
    ("beam", lambda m, t: tgen.beam_search(m["llama"][2], _ids(2, 4, 1),
                                           CAP + 1, use_cache=True)),
    ("speculative", lambda m, t: tspec.speculative_generate(
        m["gpt"][2], m["gpt"][2], _ids(2, 4, 1), CAP - 3, gamma=3,
        use_cache=True)),
    ("prefill_prefix", lambda m, t: tgen.prefill_prefix(
        m["gpt"][2], _ids(1, CAP + 1, 1))),
    ("feed", lambda m, t: m["gpt"][2](
        torch.zeros((2, 3), dtype=torch.long), pos=CAP - 2,
        cache=tgen.init_decode_cache(m["gpt"][2], 2))),
    ("t5_greedy", lambda m, t: tt5.t5_greedy_decode(t[2], t[3], 33,
                                                    use_cache=True)),
    ("t5_beam", lambda m, t: tt5.t5_beam_decode(t[2], t[3], 33,
                                                use_cache=True)),
]))
def test_capacity_raises_on_every_route(models, t5, call):
    """A write past the capacity raises ``ValueError``; JAX's
    ``dynamic_update_slice`` would clamp it onto the last rows."""
    with pytest.raises(ValueError, match="capacity|exceed"):
        with torch.no_grad():
            call(models, t5)


@torch.no_grad()
def test_full_cache_refuses_the_next_token(models):
    """The cursor at the capacity: the next feed raises, per row too."""
    _, _, tm = models["llama"]
    cache = tgen.init_decode_cache(tm, 2)
    tm(torch.zeros((2, CAP), dtype=torch.long), pos=0, cache=cache)
    with pytest.raises(ValueError, match="full"):
        tm(torch.zeros((2, 1), dtype=torch.long), pos=CAP, cache=cache)
    with pytest.raises(ValueError, match="capacity"):
        tm(torch.zeros((2, 1), dtype=torch.long), pos=torch.tensor([0, CAP]),
           cache=tgen.init_decode_cache(tm, 2))
