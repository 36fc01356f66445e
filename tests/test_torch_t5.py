"""The port's T5 (``horovod_tpu_torch/models/t5.py``) and
``TPCrossAttention`` (``parallel/tp.py``) against the JAX package's, on the
same weights (``load_flax_t5``; drawn with numpy into ``jax.eval_shape``'s
tree, as in ``test_torch_bert.py``).

T5 tiny (2 layers a stack, 4 heads, hidden 64, GEGLU 128, 8 buckets),
fp32, 9 source and 7 target tokens, with and without a source padding
mask: the encoder memory, the logits, the next-token loss and every
parameter's gradient; remat bit-equal; ``project_cross_kv`` + ``cached_kv``
bit-equal to the plain cross path; greedy, sampled-at-temperature-0 and
beam re-forward decoding against ``t5_greedy_decode``/``t5_beam_decode``
(the same token streams; beam scores within tolerance). Then one 2-rank
gloo world at tp = 2 (heads, the relative bias's head slice and the MLP
sharded) against the port's dense model, JAX's
``test_t5_encoder_tp_matches_dense`` for both stacks.

Tolerances. fp32: memory and logits rtol 1e-4 / atol 1e-5, the loss rtol
1e-5, each gradient within 1e-4 of its tensor's largest entry (as
``test_torch_gpt.py``); beam scores (sums of log-probabilities over 7
steps) rtol 1e-5; tp = 2 against dense rtol 2e-3 / atol 2e-4 (JAX's own
test's limits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_helpers as ph
import torch_port_helpers as helpers
from horovod_tpu.models import t5 as jt5
from horovod_tpu.parallel import tp as jtp
from horovod_tpu_torch.models import t5 as tt5
from horovod_tpu_torch.parallel import tp as ttp
from test_torch_bert import draw_params

B, LS, LT, TP = 2, 9, 7, 2


def _cfg(mod, **kw):
    return mod.T5Config.tiny(tp_axis=None, **kw)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (B, LS)).astype(np.int32)
    tgt = rng.integers(0, 256, (B, LT)).astype(np.int32)
    mask = np.ones((B, LS), bool)
    mask[1, 6:] = False
    return src, tgt, mask


def _shard_layout(params, n):
    """A dense Flax T5 tree in JAX's tp = n layout: each fused leaf (qkv,
    cross kv, gate_up) holds shard s's ``[q_s|k_s|v_s]`` side by side."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                if k in ("qkv", "kv", "gate_up"):
                    w = v["shard"]["kernel"]
                    parts = np.split(w, 3 if k == "qkv" else 2, axis=-1)
                    out[k] = {"shard": {"kernel": np.concatenate(
                        [c for s in range(n)
                         for c in (np.split(p, n, axis=-1)[s]
                                   for p in parts)], axis=-1)}}
            else:
                out[k] = v
        return out
    return walk(params)


@pytest.fixture(scope="module")
def setup():
    src, tgt, mask = _batch()
    params = draw_params(jt5.T5(_cfg(jt5)), jnp.asarray(src[:1]),
                         jnp.asarray(tgt[:1]))
    params = jax.tree_util.tree_map(np.asarray, params)
    # The tp = 2 world runs while JAX compiles its references.
    future = helpers.run_world_async(
        ph.t5_tp_world, TP, args=(_shard_layout(params, TP), src, tgt,
                                  mask))
    return params, future


@pytest.fixture(scope="module")
def flax_params(setup):
    return setup[0]


def _port(params, **kw):
    return tt5.load_flax_t5(tt5.T5(_cfg(tt5, **kw)), params)


def test_relative_position_buckets_bit_equal():
    for args in ((9, 9, 32, 128, True), (7, 7, 32, 128, False),
                 (5, 300, 8, 16, True), (300, 40, 8, 16, False),
                 (64, 64, 32, 128, True)):
        np.testing.assert_array_equal(tt5.relative_position_buckets(*args),
                                      jt5.relative_position_buckets(*args))


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_matches_jax(bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 5, 32)).astype(np.float32)
    mem = rng.standard_normal((B, 9, 32)).astype(np.float32)
    _, _, mask = _batch()
    jm = jtp.TPCrossAttention(4, 32, axis_name=None, use_bias=bias)
    params = draw_params(jm, jnp.asarray(x), jnp.asarray(mem),
                         jnp.asarray(mask), seed=6)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mem),
                    jnp.asarray(mask))
    tm = tt5.load_flax_t5(ttp.TPCrossAttention(4, 32, use_bias=bias),
                          params)
    got = tm(torch.from_numpy(x), torch.from_numpy(mem),
             torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    kv = tm(None, torch.from_numpy(mem), project_only=True)
    np.testing.assert_allclose(
        kv.detach().numpy(),
        np.asarray(jm.apply({"params": params}, None, jnp.asarray(mem),
                            project_only=True)), rtol=1e-4, atol=1e-5)
    assert torch.equal(tm(torch.from_numpy(x), None, torch.from_numpy(mask),
                          cached_kv=kv), got)


def _jax_forward(params, src, tgt, mask):
    jm = jt5.T5(_cfg(jt5))

    def loss_fn(p):
        logits = jm.apply({"params": p}, src, tgt, mask)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tgt[:, 1:]).mean()
        return loss, logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    memory = jm.apply({"params": params}, src, mask, method=jt5.T5.encode)
    return loss, logits, grads, memory


def _loss(logits, tgt):
    return F.cross_entropy(logits[:, :-1].flatten(0, 1),
                           tgt[:, 1:].flatten())


@pytest.mark.parametrize("masked", [False, True])
def test_logits_loss_and_grads_match_jax(flax_params, masked):
    src, tgt, mask = _batch()
    jmask = jnp.asarray(mask) if masked else None
    loss, logits, grads, memory = jax.jit(_jax_forward)(
        jax.tree_util.tree_map(jnp.asarray, flax_params), jnp.asarray(src),
        jnp.asarray(tgt), jmask)
    tm = _port(flax_params)
    tsrc, ttgt = (torch.from_numpy(a).long() for a in (src, tgt))
    tmask = torch.from_numpy(mask) if masked else None
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode(tsrc, tmask).numpy(),
                                   np.asarray(memory), rtol=1e-4, atol=1e-5)
    tlogits = tm(tsrc, ttgt, tmask)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    tloss = _loss(tlogits, ttgt)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    tloss.backward()
    ref = dict(_port(jax.tree_util.tree_map(np.asarray, grads))
               .named_parameters())
    named = dict(tm.named_parameters())
    assert len(named) == 38 and set(named) == set(ref)
    for name, p in named.items():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bias_builds_each_bucket_matrix_once(monkeypatch,
                                                      bidirectional):
    """The bucket matrix is built on the host once per (Lq, Lk, device) and
    kept: later forwards copy nothing from the host, give the same bias as
    a fresh build (bit-equal), and still reach the table's gradient."""
    built = []

    def counting(*a):
        built.append(a[:2])
        return jt5.relative_position_buckets(*a)
    monkeypatch.setattr(tt5, "relative_position_buckets", counting)
    cfg = _cfg(tt5)
    bias = tt5.T5RelativeBias(cfg, bidirectional)
    bias.reset_parameters(torch.Generator().manual_seed(0))
    outs = [bias(LT, LT) for _ in range(3)] + [bias(LT, LS), bias(LT, LT)]
    assert built == [(LT, LT), (LT, LS)]
    want = F.embedding(torch.from_numpy(jt5.relative_position_buckets(
        LT, LT, cfg.num_buckets, cfg.max_distance, bidirectional)).long(),
        bias.rel_bias).permute(2, 0, 1)
    for out in outs[:3] + outs[4:]:
        assert torch.equal(out, want)
    sum(o.sum() for o in outs).backward()
    assert bias.rel_bias.grad is not None
    assert bool(bias.rel_bias.grad.abs().sum() > 0)


def test_remat_matches_no_remat(flax_params):
    src, tgt, mask = (torch.from_numpy(a) for a in _batch())
    src, tgt = src.long(), tgt.long()
    grads, losses = [], []
    for remat in (False, True):
        m = _port(flax_params, remat=remat)
        loss = _loss(m(src, tgt, mask), tgt)
        loss.backward()
        losses.append(loss)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert torch.equal(losses[0], losses[1])
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_projected_cross_kv_equals_the_plain_cross_path(flax_params):
    src, tgt, mask = (torch.from_numpy(a) for a in _batch())
    m = _port(flax_params)
    with torch.no_grad():
        memory = m.encode(src.long(), mask)
        kv = m.project_cross_kv(memory)
        assert len(kv) == 2 and kv[0].shape == (B, LS, 128)
        want = m.decode(tgt.long(), memory, memory_mask=mask)
        got = m.decode(tgt.long(), memory, memory_mask=mask, cross_kv=kv)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_decodes(flax_params):
    src, _, mask = _batch()
    jm = jt5.T5(_cfg(jt5))
    p = jax.tree_util.tree_map(jnp.asarray, flax_params)
    greedy = np.asarray(jt5.t5_greedy_decode(jm, p, src, 8, bos_id=1,
                                             src_mask=jnp.asarray(mask)))
    eos = int(greedy[0, 4])             # a token row 0 emits mid-decode
    return {
        "greedy": greedy, "eos": eos,
        "greedy_eos": np.asarray(jt5.t5_greedy_decode(
            jm, p, src, 8, bos_id=1, src_mask=jnp.asarray(mask),
            eos_id=eos)),
        "beam": jt5.t5_beam_decode(jm, p, src, 8, num_beams=3, bos_id=1,
                                   src_mask=jnp.asarray(mask)),
        "beam_eos": jt5.t5_beam_decode(jm, p, src, 8, num_beams=3,
                                       bos_id=1, src_mask=jnp.asarray(mask),
                                       eos_id=eos, length_penalty=0.6)}


def test_greedy_and_sampled_t5_decode_match_jax(flax_params, jax_decodes):
    src, _, mask = _batch()
    m = _port(flax_params)
    tmask = torch.from_numpy(mask)
    got = tt5.t5_greedy_decode(m, src, 8, bos_id=1, src_mask=tmask)
    np.testing.assert_array_equal(got.numpy(), jax_decodes["greedy"])
    eos = jax_decodes["eos"]
    got = tt5.t5_greedy_decode(m, src, 8, bos_id=1, src_mask=tmask,
                               eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), jax_decodes["greedy_eos"])
    assert (got[0, 4:] == eos).all()
    np.testing.assert_array_equal(
        tt5.t5_generate(m, src, 8, bos_id=1, src_mask=tmask).numpy(),
        jax_decodes["greedy"])
    # a sampled decode: one seed, one stream
    runs = [tt5.t5_generate(m, src, 8, bos_id=1, src_mask=tmask,
                            temperature=1.0, top_k=5,
                            rng=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and (runs[0][:, 0] == 1).all()
    with pytest.raises(ValueError, match="rng"):
        tt5.t5_generate(m, src, 8, temperature=1.0)


@pytest.mark.parametrize("case", ["beam", "beam_eos"])
def test_beam_decode_matches_jax(flax_params, jax_decodes, case):
    src, _, mask = _batch()
    m = _port(flax_params)
    kw = dict(eos_id=jax_decodes["eos"], length_penalty=0.6) \
        if case == "beam_eos" else {}
    seqs, scores = tt5.t5_beam_decode(m, src, 8, num_beams=3, bos_id=1,
                                      src_mask=torch.from_numpy(mask), **kw)
    want_seqs, want_scores = jax_decodes[case]
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5)


def test_beam_of_one_is_greedy(flax_params):
    src, _, _ = _batch()
    m = _port(flax_params)
    seqs, _ = tt5.t5_beam_decode(m, src, 6, num_beams=1)
    assert torch.equal(seqs, tt5.t5_greedy_decode(m, src, 6))


def test_tp2_encoder_and_decoder_match_dense(flax_params, setup):
    src, tgt, mask = _batch()
    m = _port(flax_params)
    with torch.no_grad():
        memory = m.encode(torch.from_numpy(src).long(),
                          torch.from_numpy(mask)).numpy()
        logits = m(torch.from_numpy(src).long(), torch.from_numpy(tgt).long(),
                   torch.from_numpy(mask)).numpy()
    for rank, got in enumerate(setup[1].result()):
        assert got["qkv_rows"] == 3 * 64 // TP, got["qkv_rows"]
        np.testing.assert_allclose(got["memory"], memory, rtol=2e-3,
                                   atol=2e-4, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["logits"], logits, rtol=2e-3,
                                   atol=2e-4, err_msg=f"rank {rank}")


def _t5_cache(m, batch=1):
    import importlib
    gen = importlib.import_module("horovod_tpu_torch.models.generate")
    return gen.init_decode_cache(m, batch)


def _decode_mode(m):
    dec = tt5.T5(_cfg(tt5), decode_mode=True)
    with pytest.raises(ValueError, match="decode cache"):
        dec.decode(torch.zeros(1, 1).long(), torch.zeros(1, 3, 64))
    return dec.decode(torch.zeros(1, 1).long(), torch.zeros(1, 3, 64), pos=0,
                      cache=_t5_cache(dec)).shape == (1, 1, 256)


def _decoder(m):
    dec = tt5.T5Decoder(_cfg(tt5), decode=True)
    cache = _t5_cache(dec)
    assert sorted(cache.entries)[0] == "layer_0/attention/idx"
    return dec(torch.zeros(1, 1).long(), torch.zeros(1, 3, 64), pos=0,
               cache=cache).shape == (1, 1, 256)


def _block(m):
    blk = tt5.T5Block(_cfg(tt5), causal=True, cross=True, decode=True)
    cache = _t5_cache(blk, 2)
    bias = m.decoder.rel_bias.decode_bias(0, 32)
    out = blk(torch.zeros(2, 1, 64), bias, memory=torch.zeros(2, 3, 64),
              cache=cache)
    # JAX's refusal: a bias row feeds one token a call
    with pytest.raises(ValueError, match="ONE token"):
        blk(torch.zeros(2, 2, 64), bias, memory=torch.zeros(2, 3, 64),
            cache=cache)
    return out.shape == (2, 1, 64) and cache["attention/idx"] == 1


def _pos(m):
    # Without a cache pos is not read; with one, the decode route runs.
    ids, mem = torch.zeros(1, 1).long(), torch.zeros(1, 3, 64)
    return torch.equal(m.decode(ids, mem, pos=0), m.decode(ids, mem)) and \
        m.decode(ids, mem, pos=0, cache=_t5_cache(m)).shape == (1, 1, 256)


def _decode_bias(m):
    bias = m.decoder.rel_bias.decode_bias(0, 8)
    # query 0: every key is "in the future" or at distance 0 -> bucket 0
    return bias.shape == (4, 1, 8) and torch.equal(
        bias, m.decoder.rel_bias.rel_bias[0][:, None, None].expand(4, 1, 8))


def _causal_buckets(m):
    got = tt5.relative_position_buckets_causal_jnp(5, np.arange(8), 8, 16)
    return got.tolist() == [4, 4, 3, 2, 1, 0, 0, 0]


def _greedy_cache(m):
    src = np.ones((1, 3))
    return torch.equal(tt5.t5_greedy_decode(m, src, 4, use_cache=True),
                       tt5.t5_greedy_decode(m, src, 4))


def _generate_cache(m):
    src = np.ones((1, 3))
    return torch.equal(tt5.t5_generate(m, src, 4, use_cache=True),
                       tt5.t5_greedy_decode(m, src, 4))


def _beam_cache(m):
    src = np.ones((1, 3))
    return torch.equal(tt5.t5_beam_decode(m, src, 4, use_cache=True)[0],
                       tt5.t5_beam_decode(m, src, 4)[0])


@pytest.mark.parametrize("check", [
    _decode_mode, _decoder, _block, _pos, _decode_bias, _causal_buckets,
    _greedy_cache, _generate_cache, _beam_cache,
], ids=["decode_mode", "decoder", "block", "pos", "decode_bias",
        "causal_buckets", "greedy_cache", "generate_cache", "beam_cache"])
@torch.no_grad()
def test_cached_decode_raises_naming_a15(check):
    """Each of these once raised naming A15; the cached decode is ported
    now, and each runs (its parity with the re-forward decode and with JAX
    is ``test_torch_decode_cache.py``'s), or raises JAX's ``ValueError``
    where JAX refuses it."""
    m = tt5.T5(_cfg(tt5), generator=torch.Generator().manual_seed(0))
    assert check(m)
