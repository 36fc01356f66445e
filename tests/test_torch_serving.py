"""The port's serving engine (``horovod_tpu_torch/serving``), its trace store,
metrics series, SLO engine and ``elastic.sharded.kv_reshard``, against the
port's own cached ``generate`` and against the JAX package, on the CPU.

GPT tiny (capacity 32) and LLaMA tiny (GQA 4/2, capacity 32, the int8
cache) with Flax's init loaded through ``load_flax``; prompts and sampling
seeds from numpy seeds. Each JAX engine runs once, in the module fixture
``jax_ref``, and once for a whole xdist run (``torch_shared.shared``): a
worker that needs it while another computes it waits and loads it.

- JAX's ``tests/test_serving.py``, mirrored: the slot scheduler (FIFO,
  retire and refill, evict order, ``QueueFull``, request validation);
  greedy streams equal to cached ``generate`` exactly across staggered
  lengths (3, 5, 1, 7, 4, 2) through 3 slots with ``prefill_chunk`` 4; EOS;
  sampled determinism; a requeue reproducing the remaining stream; the
  capacity ``ValueError``; the SLO series; the health endpoint; the HTTP
  frontend end to end; ``ServingState`` commit and restore, late
  submissions, KV migration without re-prefill, the ``kv_snapshot``
  payload, re-validation after a rollback; the lock discipline; the
  launcher's knobs.
- Against JAX on the same inputs: ``sample_token`` bit-equal; the greedy
  and sampled streams of GPT and of LLaMA with the int8 cache equal to
  JAX's ``ServingEngine``'s; the scheduler's slot table and queue after
  one scripted sequence; a ``request_snapshot`` taken in one package and
  finished in the other; the cache after a prefill, an install and a
  decode step against JAX's ``kv_snapshot()["cache"]`` (fp32 K/V rtol 1e-4,
  atol 1e-5; int8 codes within one step of each other on at most 1% of the
  entries, scales rtol 1e-4: the K/V rows themselves differ by rounding);
  the serving families' ``/metrics`` text after the same record calls; a
  request's span tree after the same trace calls at explicit times; the
  SLO burn rates on a fake clock.
- The port alone: a slot that served a long request then a short one
  gives the short one a fresh engine's stream and cache row (the batch-1
  template is zeroed before each prefill); ``kv_reshard`` round-trips 8 →
  4 → 8 slots, each shard decoded in turn, with the unresized streams;
  ``hvdrun-torch --serving`` running ``python -m horovod_tpu_torch.serving
  --device cpu`` answers, stops on SIGTERM and leaves its trace shard.
"""

import importlib
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time
from urllib import error as urlerror
from urllib import request as urlrequest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt as jg
from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models import load_flax
from horovod_tpu_torch.models.gpt import cache_to_numpy
from torch_shared import shared

ROOT = pathlib.Path(__file__).resolve().parents[1]
tgen = importlib.import_module("horovod_tpu_torch.models.generate")
CAP = 32
STAGGERED = (3, 5, 1, 7, 4, 2)
SAMPLED = ((0.9, 16, 0.9, 7), (0.7, 0, 0.8, 11))   # temperature, k, p, seed
FAMILIES = {
    "gpt": (lambda **kw: jg.GPT(jg.GPTConfig.tiny(**kw)),
            lambda **kw: tg.GPT(tg.GPTConfig.tiny(**kw)),
            dict(max_position_embeddings=CAP, tp_axis=None, ep_axis=None)),
    "llama_int8": (lambda **kw: jl.Llama(jl.LlamaConfig.tiny(**kw)),
                   lambda **kw: tl.Llama(tl.LlamaConfig.tiny(**kw)),
                   dict(max_position_embeddings=CAP, tp_axis=None,
                        num_kv_heads=2, kv_cache_int8=True)),
}


def _pair(family, seed=1, params=None):
    make_j, make_t, kw = FAMILIES[family]
    jm = make_j(**kw)
    if params is None:
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"])
    return jm, params, load_flax(make_t(**kw), params).eval()


def _prompts(lengths=STAGGERED, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lengths]


def _submit_all(eng, prompts):
    """The staggered greedy prompts (max_new 6), then the sampled ones."""
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    for (temp, k, p, seed), prompt in zip(SAMPLED, prompts[:2]):
        reqs.append(eng.submit(prompt, max_new=6, temperature=temp, top_k=k,
                               top_p=p, seed=seed))
    return reqs


def _drive(eng, prompts):
    """One step (admit, prefill, install, decode) and the cache then, a
    mid-flight request snapshot, then the streams to the end."""
    reqs = _submit_all(eng, prompts)
    eng.step()
    kv = eng.kv_snapshot()
    eng.step()
    snap = eng.request_snapshot()
    eng.run_until_idle()
    return {"streams": [r.result(0) for r in reqs], "kv": kv, "snap": snap,
            "rids": [r.rid for r in reqs]}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    params = shared(tmp_path_factory, "serving_params",
                    lambda: {f: _pair(f)[1] for f in FAMILIES})
    return {f: _pair(f, params=params[f]) for f in FAMILIES}


@pytest.fixture(scope="module")
def tmodel(models):
    return models["gpt"][2]


@pytest.fixture(scope="module")
def jax_ref(hvd, models, tmp_path_factory):
    return shared(tmp_path_factory, "serving_jax_ref",
                  lambda: _jax_ref(models))


def _jax_ref(models):
    """Each JAX engine once: the staggered and sampled submissions of
    ``_drive`` through 3 slots with prefill_chunk 4 (GPT, LLaMA int8), and
    the GPT engine then finishing a snapshot the port took. The caches as
    numpy."""
    from horovod_tpu.serving import ServingEngine
    from horovod_tpu_torch.serving import ServingEngine as TEngine

    out = {}
    prompts = _prompts()
    for fam, (jm, params, tm) in models.items():
        eng = ServingEngine(jm, params, num_slots=3, prefill_chunk=4,
                            mark_steps=False)
        out[fam] = _drive(eng, prompts)
        out[fam]["engine"] = eng
    # A port snapshot, mid-flight, finished by the JAX GPT engine.
    teng = TEngine(models["gpt"][2], num_slots=3, prefill_chunk=4)
    treqs = _submit_all(teng, prompts)
    for _ in range(3):
        teng.step()
    tsnap = teng.request_snapshot()
    eng = out["gpt"]["engine"]
    eng.load_request_snapshot(tsnap)
    restored = list(eng._sched.queued())
    eng.run_until_idle()
    teng.run_until_idle()
    out["port_snap_in_jax"] = {
        "jax": {r.rid: r.result(0) for r in restored},
        "port": {r.rid: r.result(0) for r in treqs}}
    for fam in models:
        del out[fam]["engine"]
        out[fam]["kv"] = jax.tree_util.tree_map(np.asarray, out[fam]["kv"])
    return out


@pytest.fixture(scope="module")
def thvd():
    """The port initialized on the CPU (gloo, one rank) for the tests
    whose state syncs; shut down after the module. A rank contract another
    test left in this process's environment (an in-process launcher run)
    is set aside meanwhile: the module's world is one rank."""
    import horovod_tpu_torch as hvd
    mp = pytest.MonkeyPatch()
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        mp.delenv(k)
    try:
        hvd.init(device="cpu")
        yield hvd
        hvd.shutdown()
    finally:
        mp.undo()


def _engine(model, **kw):
    from horovod_tpu_torch.serving import ServingEngine
    return ServingEngine(model, **kw)


def _cached_generate(model, prompt, max_new):
    return tgen.generate(model, torch.tensor([prompt]), len(prompt) + max_new,
                         use_cache=True)[0].tolist()


# --- the slot scheduler (JAX's TestSlotScheduler) ---------------------------

def _req(**kw):
    from horovod_tpu_torch.serving import Request
    kw.setdefault("prompt", [1, 2])
    kw.setdefault("max_new", 4)
    return Request(**kw)


def test_scheduler_admission_fifo_and_retire_refill():
    from horovod_tpu_torch.serving import SlotScheduler
    s = SlotScheduler(2)
    r = [_req() for _ in range(4)]
    for x in r:
        s.submit(x)
    assert s.queue_depth() == 4 and s.n_active() == 0
    placed = s.admit()
    assert [x.rid for _, x in placed] == [r[0].rid, r[1].rid]
    assert s.fill_ratio() == 1.0 and s.queue_depth() == 2
    assert s.retire(0) is r[0]
    assert s.admit() == [(0, r[2])]
    assert s.active()[1] is r[1]


def test_scheduler_evict_requeues_ahead_of_queue_in_slot_order():
    from horovod_tpu_torch.serving import SlotScheduler
    s = SlotScheduler(2)
    r = [_req() for _ in range(3)]
    for x in r:
        s.submit(x)
    s.admit()
    evicted = s.evict_active()
    assert [x.rid for x in evicted] == [r[0].rid, r[1].rid]
    assert [x.rid for x in s.queued()] == [r[0].rid, r[1].rid, r[2].rid]
    assert all(x.requeues == 1 for x in evicted)


def test_scheduler_queue_limit_rejects_with_backpressure():
    from horovod_tpu_torch.serving import QueueFull, SlotScheduler
    s = SlotScheduler(1, queue_limit=2)
    s.submit(_req())
    s.submit(_req())
    victim = _req()
    with pytest.raises(QueueFull):
        s.submit(victim)
    assert victim.done()
    with pytest.raises(RuntimeError, match="rejected"):
        victim.result(0)


@pytest.mark.parametrize("kw", [dict(prompt=[]), dict(max_new=0),
                                dict(temperature=-1.0), dict(top_p=0.0),
                                dict(top_k=-1)])
def test_request_validation(kw):
    with pytest.raises(ValueError):
        _req(**kw)


def test_scheduler_tables_equal_jax_after_one_script():
    """The same submit/admit/retire/evict/requeue script in both packages:
    the slot table, the queue and every request's state and requeues."""
    from horovod_tpu.serving import Request as JRequest
    from horovod_tpu.serving import SlotScheduler as JSched
    from horovod_tpu_torch.serving import Request, SlotScheduler

    def script(sched_cls, req_cls):
        s = sched_cls(3, queue_limit=5)
        r = [req_cls([i + 1, 2], 4, rid=i) for i in range(6)]
        for x in r[:5]:
            s.submit(x)
        with pytest.raises(RuntimeError):
            s.submit(r[5])
        s.admit()
        s.retire(1)
        s.admit()
        s.requeue(s.retire(0))
        s.evict_active()
        s.admit()
        s.retire(2)
        return ({k: v.rid for k, v in s.active().items()},
                [x.rid for x in s.queued()],
                [(x.state, x.requeues) for x in r], s.fill_ratio())
    assert script(SlotScheduler, Request) == script(JSched, JRequest)


# --- sampling ---------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 50, 0.95), (0.7, 5, 1.0),
    (1.3, 0, 0.5), (0.9, 1, 0.9)])
def test_sample_token_bit_equal_to_jax(temperature, top_k, top_p):
    from horovod_tpu.serving.engine import sample_token as jsample
    from horovod_tpu_torch.serving import sample_token
    rng = np.random.default_rng(int(temperature * 100) + top_k)
    for row in range(40):
        logits = (rng.standard_normal(257) * 3).astype(np.float32)
        seed, pos = int(rng.integers(0, 2 ** 40)), int(rng.integers(0, 999))
        assert sample_token(logits, temperature, top_k, top_p, seed, pos) \
            == jsample(logits, temperature, top_k, top_p, seed, pos), row


# --- the engine against the port's cached generate and JAX's engine --------

def test_greedy_parity_with_generate_across_staggered_lengths(tmodel):
    """JAX's test: six prompts through 3 slots, prefill_chunk 4 — every
    stream equals the cached generate()'s exactly while slots retire and
    refill."""
    prompts = _prompts()
    eng = _engine(tmodel, num_slots=3, prefill_chunk=4)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run_until_idle()
    for p, r in zip(prompts, reqs):
        assert r.result(0) == _cached_generate(tmodel, p, 6), p
    snap = eng.snapshot()
    assert snap["served"] == len(prompts) and snap["active"] == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streams_equal_jax_engine(models, jax_ref, family):
    """Greedy and sampled streams, the same submissions through the same
    slots, equal to JAX's ServingEngine's."""
    got = _drive(_engine(models[family][2], num_slots=3, prefill_chunk=4),
                 _prompts())
    assert got["streams"] == jax_ref[family]["streams"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_after_prefill_and_install_matches_jax(models, jax_ref,
                                                     family):
    """The cache after one step (3 admissions prefilled, installed, one
    decode step) through ``cache_to_numpy`` against JAX's kv_snapshot."""
    from horovod_tpu_torch.parallel.tp import DecodeCache
    eng = _engine(models[family][2], num_slots=3, prefill_chunk=4)
    _submit_all(eng, _prompts())
    eng.step()
    kv = eng.kv_snapshot()
    ref = jax_ref[family]["kv"]
    ref_tree = ref["cache"].get("cache", ref["cache"])
    assert (kv["pos"] == ref["pos"]).all()
    assert (kv["tokens"] == ref["tokens"]).all()
    assert sorted(kv["slots"]) == sorted(ref["slots"])
    mine = jax.tree_util.tree_flatten_with_path(
        cache_to_numpy(DecodeCache(kv["cache"])))[0]
    theirs = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    assert len(mine) == len(theirs)
    for path, got in mine:
        want = np.asarray(theirs[path])
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape, name
        if "idx" in name:
            continue                       # per-row route: not read
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_snapshot_crosses_between_packages(models, jax_ref):
    """A JAX snapshot, taken mid-flight, finished by the port, and a port
    snapshot finished by JAX: each request's stream equals the undisturbed
    run's."""
    from horovod_tpu_torch.serving import Request
    ref = jax_ref["gpt"]
    expected = dict(zip(ref["rids"], ref["streams"]))
    eng = _engine(models["gpt"][2], num_slots=3, prefill_chunk=4)
    eng.load_request_snapshot(ref["snap"])
    restored = list(eng._sched.queued())
    assert restored and all(isinstance(r, Request) for r in restored)
    assert [r.rid for r in restored] == [
        rs["rid"] for rs in ref["snap"]["active"] + ref["snap"]["queued"]]
    eng.run_until_idle()
    for r in restored:
        assert r.result(0) == expected[r.rid], r.rid
    cross = jax_ref["port_snap_in_jax"]
    assert cross["jax"] and all(cross["jax"][rid] == cross["port"][rid]
                                for rid in cross["jax"])


def test_eos_finishes_early_and_frees_the_slot(tmodel):
    prompt = [5, 9, 11]
    eos = _cached_generate(tmodel, prompt, 4)[len(prompt)]
    eng = _engine(tmodel, num_slots=2)
    r = eng.submit(prompt, max_new=8, eos_id=eos)
    eng.run_until_idle()
    assert r.result(0) == prompt + [eos]
    assert eng.snapshot()["active"] == 0


def test_sampled_streams_deterministic_per_seed(tmodel):
    def run(seed):
        eng = _engine(tmodel, num_slots=2)
        r = eng.submit([3, 1, 4], max_new=6, temperature=0.9, top_k=16,
                       seed=seed)
        eng.run_until_idle()
        return r.result(0)
    assert run(7) == run(7)
    assert run(7) != run(8) or run(7) != run(9)


def test_requeue_from_committed_token_reproduces_stream(tmodel):
    """Interrupt a request mid-generation (snapshot → restore → runtime
    reset), finish it: the stream equals the uninterrupted run's."""
    prompt = [2, 7, 1, 8]
    eng = _engine(tmodel, num_slots=2)
    r0 = eng.submit(prompt, max_new=7, temperature=0.7, seed=3)
    eng.run_until_idle()
    expected = r0.result(0)
    eng2 = _engine(tmodel, num_slots=2)
    r = eng2.submit(prompt, max_new=7, temperature=0.7, seed=3)
    for _ in range(3):
        eng2.step()
    snap = eng2.request_snapshot()
    committed_at_snap = len(snap["active"][0]["committed"])
    eng2.step()
    eng2.load_request_snapshot(snap)
    eng2.reset_runtime()
    assert r.requeues == 1 and len(r.committed) == committed_at_snap
    eng2.run_until_idle()
    assert r.result(0) == expected
    assert eng2.snapshot()["served"] == 1


def test_stubbed_programs_bound_the_host_path(tmodel):
    """The test seams: with the three programs stubbed the engine keeps no
    cache, schedules, samples and retires as usual, and has no migration
    payload."""
    seen = []

    def step_fn(model, cache, toks, pos):
        seen.append((toks.tolist(), pos.tolist()))
        logits = np.zeros((2, 8), np.float32)
        logits[:, 5] = 1.0
        return logits, cache
    eng = _engine(tmodel, num_slots=2, step_fn=step_fn,
                  prefill_fn=lambda m, c, toks, t: c,
                  install_fn=lambda big, small, slot: big)
    reqs = [eng.submit([1, 2, 3], max_new=3), eng.submit([4], max_new=2)]
    eng.run_until_idle()
    assert [r.result(0) for r in reqs] == [[1, 2, 3, 5, 5, 5], [4, 5, 5]]
    assert seen[0] == ([3, 4], [2, 0]) and seen[1] == ([5, 5], [3, 1])
    assert eng._cache == {} and eng.kv_snapshot() is None


def test_submit_validates_capacity(tmodel):
    """prompt + max_new past max_len is refused at submit, which is what
    keeps every per-row write inside the cache (on the card a position
    past the capacity is a device assert)."""
    eng = _engine(tmodel, num_slots=1)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(list(range(20)), max_new=20)
    eng.submit(list(range(20)), max_new=CAP - 20)      # exactly full: fine
    eng.run_until_idle()
    assert int(eng._pos.max()) == CAP - 1
    small = _engine(tmodel, num_slots=1, max_len=8)
    with pytest.raises(ValueError, match="capacity"):
        small.submit([1, 2, 3], max_new=6)
    with pytest.raises(ValueError, match="position capacity"):
        _engine(tmodel, max_len=CAP + 1)


def test_slot_reuse_gives_a_fresh_engines_stream_and_cache(tmodel):
    """A slot that served a long request, then a short one: the short one's
    stream and its cache row after one step equal a fresh engine's (the
    batch-1 template is zeroed before each prefill)."""
    long_p, short_p = _prompts((20,), seed=4)[0], [9, 4, 7]
    eng = _engine(tmodel, num_slots=1, prefill_chunk=4)
    eng.submit(long_p, max_new=8)
    eng.run_until_idle()
    r = eng.submit(short_p, max_new=6)
    eng.step()
    reused = eng.kv_snapshot()["cache"]
    eng.run_until_idle()
    fresh = _engine(tmodel, num_slots=1, prefill_chunk=4)
    f = fresh.submit(short_p, max_new=6)
    fresh.step()
    clean = fresh.kv_snapshot()["cache"]
    fresh.run_until_idle()
    assert r.result(0) == f.result(0) == _cached_generate(tmodel, short_p, 6)
    for key, v in clean.items():
        if torch.is_tensor(v):
            assert torch.equal(reused[key], v), key


# --- metrics, SLO, trace ------------------------------------------------------

def _counter(reg, name, labels=None):
    total = 0.0
    for s in reg.snapshot().get(name, {}).get("series", ()):
        if labels is None or all(s["labels"].get(k) == v
                                 for k, v in labels.items()):
            total += s.get("value", 0)
    return total


def _hist_count(reg, name):
    return sum(s.get("count", 0)
               for s in reg.snapshot().get(name, {}).get("series", ()))


def test_slo_series_populate_and_scrape(tmodel):
    from horovod_tpu_torch.metrics import instruments as ins
    reg = ins.get_registry()
    before = {"tokens": _counter(reg, "serving_tokens_total"),
              "completed": _counter(reg, "serving_requests_total",
                                    {"event": "completed"}),
              "ttft": _hist_count(reg, "serving_ttft_seconds"),
              "lat": _hist_count(reg, "serving_token_latency_seconds"),
              "fill": _hist_count(reg, "serving_batch_fill_ratio")}
    eng = _engine(tmodel, num_slots=2)
    reqs = [eng.submit([1, 2, 3], max_new=4) for _ in range(3)]
    eng.run_until_idle()
    assert all(len(r.result(0)) == 7 for r in reqs)
    assert _counter(reg, "serving_tokens_total") >= before["tokens"] + 12
    assert _counter(reg, "serving_requests_total", {"event": "completed"}) \
        >= before["completed"] + 3
    assert _hist_count(reg, "serving_ttft_seconds") >= before["ttft"] + 3
    assert _hist_count(reg, "serving_token_latency_seconds") > before["lat"]
    assert _hist_count(reg, "serving_batch_fill_ratio") > before["fill"]
    text = reg.render_text()
    for name in ("serving_ttft_seconds", "serving_tokens_total",
                 "serving_queue_depth", "serving_batch_fill_ratio",
                 "serving_token_latency_seconds", "slo_burn_rate"):
        assert name in text, name


def _serving_block(text):
    """The serving and SLO families' lines of an exposition."""
    keep, out = False, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            keep = re.match(r"# HELP horovod_(serving|slo)_", line) is not None
        if keep:
            out.append(line)
    return out


def test_metrics_text_equals_jax_after_the_same_records():
    from horovod_tpu.metrics import instruments as jins
    from horovod_tpu_torch.metrics import instruments as tins
    families = ("SERVING_REQUESTS", "SERVING_TTFT", "SERVING_TOKEN_LATENCY",
                "SERVING_TOKENS", "SERVING_QUEUE_DEPTH", "SLO_BURN",
                "SERVING_FILL")
    for ins in (jins, tins):
        for fam in families:
            getattr(ins, fam).clear()
        for ev in ("submitted", "submitted", "admitted", "completed",
                   "requeued", "rejected"):
            ins.record_serving_request(ev)
        for s in (3e-4, 0.02, 1.7, 250.0):
            ins.record_serving_ttft(s)
        ins.record_serving_step(0.0123, 3, 4, tokens=3)
        ins.record_serving_step(2e-6, 4, 4, tokens=4)
        ins.record_serving_queue(7)
        ins.record_slo_burn("ttft_p99", 1.5)
        ins.record_slo_burn("tps", 0.0)
    mine = _serving_block(tins.REGISTRY.render_text())
    assert len(mine) > 40
    assert mine == _serving_block(jins.REGISTRY.render_text())
    assert tins.REGISTRY.snapshot()["serving_tokens_total"] == \
        jins.REGISTRY.snapshot()["serving_tokens_total"]


def test_slo_burn_rates_equal_jax_on_a_fake_clock():
    from horovod_tpu.telemetry.slo import SloEngine as JSlo
    from horovod_tpu_torch.telemetry.slo import SloEngine
    readings = []
    for cls in (SloEngine, JSlo):
        e = cls(ttft_p99_ms=50.0, tps=100.0, window_s=10.0)
        got = [e.burn_rates(now=0.0)]
        for i in range(30):
            e.observe_ttft(0.01 if i % 7 else 0.2, now=float(i) * 0.5)
            e.observe_tokens(40 + i, now=float(i) * 0.5)
            got.append(e.burn_rates(now=float(i) * 0.5 + 0.25))
        got.append(e.burn_rates(now=100.0))
        readings.append(got)
    assert readings[0] == readings[1] and readings[0][5]
    assert SloEngine().burn_rates() == {}


def _trace_script(tr):
    tr.reset()
    tid = "tabc-r1"
    tr.register(tid, rid=41, t0=100.0)
    tr.add_instant(tid, "submit", t=100.0, cat="serving")
    tr.add_span(tid, "queue", t0=100.0, dur=0.5, cat="serving",
                args={"slot": 1})
    tr.add_span(tid, "chunk", t0=100.5, dur=0.1, parent="prefill",
                cat="serving")
    tr.add_span(tid, "install", t0=100.6, dur=0.05, parent="prefill")
    for i in range(3):
        tr.add_span(tid, "decode_step", t0=101.0 + i, dur=0.5,
                    parent="decode", cat="serving")
    tr.add_instant(tid, "commit", t=103.0, cat="elastic",
                   args={"committed": 3})
    tr.add_instant(tid, "requeue", t=103.5, cat="elastic", barrier=True)
    tr.add_span(tid, "queue", t0=103.5, dur=0.2, cat="serving")
    tr.add_span(tid, "decode_step", t0=104.0, dur=0.5, parent="decode")
    tr.finish(tid, dur=5.0)
    tr.register("tabc-r2", rid=42, t0=200.0)
    return tr.tree_for_rid(41, now=300.0), tr.tree_for_rid(42, now=300.0)


def test_span_tree_equals_jax_after_the_same_calls():
    from horovod_tpu import trace as jtrace
    from horovod_tpu_torch import trace as ttrace
    try:
        mine, theirs = _trace_script(ttrace), _trace_script(jtrace)
        assert mine == theirs
        names = [c["name"] for c in mine[0]["children"]]
        assert names == ["submit", "queue", "prefill", "decode", "commit",
                         "requeue", "queue", "decode"]
    finally:
        ttrace.reset()
        jtrace.reset()


def test_trace_store_evicts_at_capacity_as_jax():
    from horovod_tpu import trace as jtrace
    from horovod_tpu_torch import trace as ttrace

    class Cfg:
        trace, trace_capacity = True, 3
    kept = []
    for tr in (ttrace, jtrace):
        cap = tr._capacity["request"]
        try:
            tr.reset()
            tr.configure(Cfg)
            for i in range(5):
                tr.register(f"t-r{i}", rid=i, t0=float(i))
            kept.append([tr.for_rid(i) for i in range(5)])
        finally:
            tr._capacity["request"] = cap
            tr.reset()
    assert kept[0] == kept[1] == [None, None, "t-r2", "t-r3", "t-r4"]


# --- the endpoints ------------------------------------------------------------

def _get(url, timeout=10):
    try:
        with urlrequest.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urlerror.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(url, body, timeout=60):
    req = urlrequest.Request(url, data=json.dumps(body).encode(),
                             headers={"Content-Type": "application/json"})
    try:
        with urlrequest.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urlerror.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_health_endpoint_saturation_and_later_routes(tmodel):
    from horovod_tpu_torch.metrics.server import MetricsServer
    from horovod_tpu_torch.serving import engine as engine_mod
    srv = MetricsServer(port=0, addr="127.0.0.1")
    srv.start()
    prev = engine_mod._current
    try:
        base = f"http://127.0.0.1:{srv.port}"
        engine_mod._current = None
        code, body, _ = _get(base + "/serving/health")
        assert code == 503 and b"no serving engine" in body
        eng = _engine(tmodel, num_slots=2, queue_limit=2)
        code, body, _ = _get(base + "/serving/health")
        snap = json.loads(body)
        assert code == 200 and snap["slots"] == 2 and not snap["saturated"]
        for _ in range(2):
            eng.submit([1, 2], max_new=2)
        snap = json.loads(_get(base + "/serving/health")[1])
        assert snap["saturated"] and snap["queue_depth"] == 2
        eng.run_until_idle()
        eng.invalidate_cache()
        assert not eng.snapshot()["cache_valid"]
        eng.reset_runtime()
        assert eng.snapshot()["cache_valid"]
        code, body, _ = _get(base + "/metrics")
        assert code == 200 and b"horovod_serving_tokens_total" in body
        # The per-rank debug routes answer, and the cluster routes serve
        # this process's local view (no telemetry agent runs here).
        code, body, _ = _get(base + "/debug/flight")
        lines = body.decode().splitlines()
        assert code == 200 and json.loads(lines[0])["kind"] == "meta"
        assert json.loads(lines[0])["reason"] == "debug_endpoint"
        code, body, _ = _get(base + "/debug/steps?last=3")
        steps = json.loads(body)
        assert code == 200 and isinstance(steps["records"], list)
        assert "steps" in steps["summary"]
        code, body, _ = _get(base + "/cluster/health")
        view = json.loads(body)
        assert code == 200 and view["local_only"] and view["world"] == 1
        code, body, _ = _get(base + "/cluster/steps")
        assert code == 200 and "ranks" in json.loads(body)
        code, body, _ = _get(base + "/cluster/metrics")
        assert code == 200 and b'slice="0"' in body
        assert _get(base + "/nope")[0] == 404
    finally:
        engine_mod._current = prev
        srv.stop()


def test_health_reference_does_not_keep_a_dropped_engine(tmodel):
    """/serving/health reads the newest engine through a weak reference:
    an engine its owner dropped frees its cache, and the endpoint then
    answers as with no engine."""
    import gc
    import weakref

    from horovod_tpu_torch.serving import get_engine, serving_snapshot
    eng = _engine(tmodel, num_slots=2)
    assert get_engine() is eng and serving_snapshot()["slots"] == 2
    cache = weakref.ref(eng._cache.entries["layer_0/attention/k"])
    del eng
    gc.collect()
    assert get_engine() is None and serving_snapshot() is None
    assert cache() is None


def test_http_frontend_end_to_end(tmodel):
    from horovod_tpu_torch.serving.server import ServingFrontend
    eng = _engine(tmodel, num_slots=2, queue_limit=1)
    fe = ServingFrontend(eng, port=0, addr="127.0.0.1", request_timeout=60)
    fe.start()
    try:
        base = f"http://127.0.0.1:{fe.port}"
        prompt = [4, 2, 9]
        code, out = _post(base + "/generate", {"prompt": prompt,
                                               "max_new": 5})
        assert code == 200 and out["tokens"] == _cached_generate(
            tmodel, prompt, 5)
        assert out["generated"] == 5 and out["ttft_s"] is not None
        code, body, _ = _get(f"{base}/debug/trace/{out['rid']}")
        tree = json.loads(body)
        assert code == 200 and tree["done"] and tree["rid"] == out["rid"]
        assert [c["name"] for c in tree["children"]][:4] == \
            ["submit", "queue", "prefill", "decode"]
        assert _get(f"{base}/debug/trace/no-such-rid")[0] == 404
        code, body, _ = _get(base + "/health")
        assert code == 200 and json.loads(body)["served"] >= 1
        assert _post(base + "/generate", {"max_new": 2})[0] == 400
        assert _post(base + "/generate", {"prompt": [1], "max_new": 2,
                                          "temperature": None})[0] == 400
        assert _post(base + "/generate", {"prompt": list(range(30)),
                                          "max_new": 5})[0] == 400
        assert _post(base + "/nope", {})[0] == 404
        assert fe.drive_errors == 0
    finally:
        fe.stop()


def test_http_frontend_answers_concurrent_posts_and_sheds_load(tmodel):
    """Concurrent POSTs through a queue limit: every accepted request gets
    its cached-generate stream; a saturated queue answers 503 with
    Retry-After on /health."""
    import threading
    from horovod_tpu_torch.serving.server import ServingFrontend
    eng = _engine(tmodel, num_slots=2, queue_limit=2)
    fe = ServingFrontend(eng, port=0, addr="127.0.0.1", request_timeout=60,
                         drive=False)
    fe.start()
    try:
        base = f"http://127.0.0.1:{fe.port}"
        prompts = _prompts((3, 4), seed=5)
        results = [None] * 2
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(base + "/generate", {"prompt": prompts[i],
                                          "max_new": 4}))) for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while eng.queue_depth() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        code, body, headers = _get(base + "/health")
        assert code == 503 and headers.get("Retry-After") == "1"
        assert _post(base + "/generate", {"prompt": [1], "max_new": 1})[0] \
            == 503
        eng.run_until_idle()
        for t in threads:
            t.join(30)
        for p, (code, out) in zip(prompts, results):
            assert code == 200 and out["tokens"] == _cached_generate(
                tmodel, p, 4)
    finally:
        fe.stop()


# --- ServingState and migration -------------------------------------------------

def test_commit_restore_rolls_requests_back(tmodel, thvd):
    from horovod_tpu_torch.serving import ServingState
    eng = _engine(tmodel, num_slots=2)
    r1 = eng.submit([1, 2, 3], max_new=6)
    r2 = eng.submit([4, 5], max_new=6)
    state = ServingState(eng, step=0)
    for _ in range(3):
        eng.step()
        state.step += 1
        state.save()
    committed = {r1.rid: list(r1.committed), r2.rid: list(r2.committed)}
    eng.step()
    assert len(r1.committed) > len(committed[r1.rid])
    state.restore()
    assert list(r1.committed) == committed[r1.rid]
    assert list(r2.committed) == committed[r2.rid]
    assert not eng.snapshot()["cache_valid"]
    state.reset()
    eng.run_until_idle()
    assert r1.result(0) == _cached_generate(tmodel, [1, 2, 3], 6)
    assert r2.result(0) == _cached_generate(tmodel, [4, 5], 6)


def test_commit_reuses_the_weight_snapshot_while_the_model_is_the_same(
        tmodel, thvd):
    from horovod_tpu_torch.serving import ServingState
    eng = _engine(tmodel, num_slots=1)
    state = ServingState(eng, step=0)
    state.save()
    first = state._saved_model_state
    state.save()
    assert state._saved_model_state is first
    other = tg.GPT(tmodel.config)
    other.load_state_dict(tmodel.state_dict())
    eng.model = other                     # a hot swap: a fresh copy
    state.save()
    assert state._saved_model_state is not first
    assert state.model is eng.model
    eng.model = tmodel


def test_late_submissions_survive_a_restore(tmodel, thvd):
    from horovod_tpu_torch.serving import ServingState
    eng = _engine(tmodel, num_slots=1)
    r1 = eng.submit([1, 2], max_new=4)
    state = ServingState(eng, step=0)
    state.save()
    late = eng.submit([7, 7, 7], max_new=3)
    state.restore()
    state.reset()
    eng.run_until_idle()
    assert r1.done() and late.done() and len(late.committed) == 3


def test_kv_migration_graceful_resize_skips_reprefill(tmodel, thvd):
    """migrate_kv: detach → reset (no restore) keeps the in-flight caches:
    no requeue, no prefill after the migration, the undisturbed stream."""
    prompt = [6, 3, 2, 9]
    expected = _cached_generate(tmodel, prompt, 6)
    eng = _engine(tmodel, num_slots=2, migrate_kv=True)
    r = eng.submit(prompt, max_new=6)
    for _ in range(3):
        eng.step()
    eng.detach_to_host()
    assert all(v.device.type == "cpu" for v in eng._cache.entries.values()
               if torch.is_tensor(v))
    eng.reset_runtime()
    prefills = []
    eng._prefill_fn = lambda *a, f=eng._prefill_fn: prefills.append(1) \
        or f(*a)
    assert r.requeues == 0
    eng.run_until_idle()
    assert r.result(0) == expected and not prefills


def test_kv_snapshot_payload_restores_runtime(tmodel):
    prompt = [5, 1, 8]
    expected = _cached_generate(tmodel, prompt, 6)
    eng = _engine(tmodel, num_slots=2)
    r = eng.submit(prompt, max_new=6)
    for _ in range(3):
        eng.step()
    kv = eng.kv_snapshot()
    assert kv is not None and r.rid in kv["slots"].values()
    assert set(kv["cache"]) == set(eng._cache.entries)
    assert all(v.device.type == "cpu" for v in kv["cache"].values()
               if torch.is_tensor(v))
    eng.reset_runtime(kv=kv)
    assert r.requeues == 0, "an explicit payload must not requeue"
    eng.run_until_idle()
    assert r.result(0) == expected


def test_prefill_revalidates_cache_after_rollback(tmodel, thvd):
    from horovod_tpu_torch.serving import ServingState
    eng = _engine(tmodel, num_slots=1)
    r = eng.submit([3, 1, 4], max_new=5)
    state = ServingState(eng, step=0)
    for _ in range(2):
        eng.step()
        state.save()
    state.restore()
    state.reset()
    state.sync()
    assert not eng.snapshot()["cache_valid"]
    eng.step()
    assert eng.snapshot()["cache_valid"]
    eng.run_until_idle()
    assert r.result(0) == _cached_generate(tmodel, [3, 1, 4], 5)


def test_commit_restore_emit_trace_outside_submit_lock(tmodel, monkeypatch):
    from horovod_tpu_torch.serving import engine as engine_mod
    eng = _engine(tmodel, num_slots=2)
    reqs = [eng.submit([1, 2, 3], max_new=4) for _ in range(3)]
    for _ in range(2):
        eng.step()
    calls = []
    real = engine_mod.trace.add_instant

    def probe(*a, **k):
        assert not eng._submit_lock.locked()
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(engine_mod.trace, "add_instant", probe)
    eng.load_request_snapshot(eng.request_snapshot())
    assert calls
    eng.run_until_idle()
    assert all(r.done() for r in reqs)


def test_snapshot_reads_slo_outside_submit_lock(tmodel, monkeypatch):
    from horovod_tpu_torch.serving import engine as engine_mod
    eng = _engine(tmodel, num_slots=2)

    def probe():
        assert not eng._submit_lock.locked()
        return {}
    monkeypatch.setattr(engine_mod._slo, "burn_rates", probe)
    assert "slo" in eng.snapshot()


# --- kv_reshard ----------------------------------------------------------------

def test_kv_reshard_round_trip_8_4_8_token_stream_equality(tmodel):
    """JAX's TestKvCacheReshardResize: 8 rows decoded into one cache, the
    host cache cut for 8, then 4, then 8 ranks, each rank's part decoded
    in turn in this process and the parts gathered back (concatenated) at
    each hop: the streams equal the unresized run's exactly."""
    from horovod_tpu_torch.elastic import kv_reshard
    from horovod_tpu_torch.parallel.tp import DecodeCache
    B, P, total = 8, 4, 14
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (B, P)))

    def feed(cache, tok, pos):
        return tmodel(tok[:, None], pos=pos, cache=cache)[:, 0].argmax(-1)

    def prefill():
        cache = tgen.init_decode_cache(tmodel, B)
        pos = torch.zeros(B, dtype=torch.long)
        for t in range(P - 1):
            feed(cache, prompt[:, t], pos)
            pos = pos + 1
        return cache.entries, pos, prompt[:, P - 1]

    def decode(entries, pos, tok, n):
        cache, out = DecodeCache(entries), []
        for _ in range(n):
            tok = feed(cache, tok, pos)
            pos = pos + 1
            out.append(tok)
        return cache.entries, pos, tok, out

    with torch.no_grad():
        _, _, _, ref = decode(*prefill(), total - P)
        entries, pos, tok = prefill()
        streams = []
        for n, steps in ((8, 4), (4, 3), (8, total - P - 7)):
            host = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in entries.items()}
            parts = []
            for rank in range(n):
                part = kv_reshard(host, (n, rank))
                assert all(v.shape[0] == B // n for v in part.values()
                           if torch.is_tensor(v))
                rows = slice(rank * B // n, (rank + 1) * B // n)
                parts.append(decode(part, pos[rows], tok[rows], steps))
            entries = {k: torch.cat([p[0][k] for p in parts])
                       if torch.is_tensor(host[k]) else host[k]
                       for k in host}
            pos = torch.cat([p[1] for p in parts])
            tok = torch.cat([p[2] for p in parts])
            streams += [torch.cat([p[3][i] for p in parts])
                        for i in range(steps)]
    assert len(streams) == len(ref) == total - P
    assert all(torch.equal(a, b) for a, b in zip(streams, ref))


def test_kv_reshard_layouts():
    """A slot count the world does not divide stays whole; cursors are
    kept; nested numpy trees (``cache_to_numpy``'s) cut along the slot
    axis; nothing is re-padded."""
    from horovod_tpu_torch.elastic import kv_reshard
    k = torch.arange(6 * 2 * 4 * 3.0).reshape(6, 2, 4, 3)
    tree = {"layer_0/attention/k": k, "layer_0/attention/idx": 5}
    part = kv_reshard(tree, (3, 1))
    assert torch.equal(part["layer_0/attention/k"], k[2:4])
    assert part["layer_0/attention/idx"] == 5
    whole = kv_reshard(tree, 4)
    assert whole["layer_0/attention/k"] is k
    nested = {"cache": {"layer_0": {"attention": {
        "v": np.ones((4, 7, 2, 3), np.float32), "idx": np.int32(3)}}}}
    cut = kv_reshard(nested, (2, 1))["cache"]["layer_0"]["attention"]
    assert cut["v"].shape == (2, 7, 2, 3) and int(cut["idx"]) == 3
    with pytest.raises(ValueError):
        kv_reshard(tree, (2, 2))


# --- the launcher, its knobs and the worker -------------------------------------

def test_serving_knobs_reach_the_workers_with_jax_defaults(monkeypatch):
    """``hvdrun-torch --serving --serving-slots 3 --serving-queue-limit 5``
    sets the env vars, ambient serving knobs ride along, and the port's
    Config reads them, with JAX's defaults for the rest (JAX's
    TestServingKnobContract, without its lint leg)."""
    import dataclasses

    from horovod_tpu.common.config import Config as JConfig
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)
    from horovod_tpu_torch.runner.launch import build_worker_env, parse_args

    fields = ("serving", "serving_port", "serving_slots", "serving_max_len",
              "serving_prefill_chunk", "serving_queue_limit",
              "serving_migrate_kv", "serving_model", "serving_commit_steps",
              "trace", "trace_capacity", "trace_dir", "slo_ttft_p99_ms",
              "slo_tps", "slo_window_s", "metrics", "metrics_port",
              "metrics_addr", "metrics_prefix")
    mine = {f.name: f.default for f in dataclasses.fields(Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert {f: mine[f] for f in fields} == {f: theirs[f] for f in fields}
    args = parse_args(["-np", "2", "--serving", "--serving-port", "9000",
                       "--serving-slots", "3", "--serving-queue-limit", "5",
                       "--trace-dir", "/tmp/traces", "python", "-m",
                       "horovod_tpu_torch.serving"])
    slot = get_host_assignments(parse_hosts("h1:1,h2:1"), 2)[1]
    monkeypatch.setenv("HOROVOD_SERVING_MODEL", "llama_tiny")
    monkeypatch.setenv("HOROVOD_SLO_TPS", "12.5")
    env = build_worker_env({}, slot, "coord", 1234, 5678, args)
    assert (env["HOROVOD_SERVING"], env["HOROVOD_SERVING_PORT"],
            env["HOROVOD_SERVING_SLOTS"], env["HOROVOD_SERVING_QUEUE_LIMIT"],
            env["HOROVOD_SERVING_MODEL"], env["HOROVOD_TRACE_DIR"]) == \
        ("1", "9000", "3", "5", "llama_tiny", "/tmp/traces")
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    c = Config.from_env()
    assert (c.serving, c.serving_port, c.serving_slots,
            c.serving_queue_limit, c.serving_model, c.slo_tps,
            c.trace_dir) == (True, 9000, 3, 5, "llama_tiny", 12.5,
                             "/tmp/traces")
    assert (c.serving_prefill_chunk, c.serving_max_len,
            c.serving_commit_steps, c.trace_capacity, c.metrics) == \
        (64, 0, 1, 256, True)
    monkeypatch.setenv("HOROVOD_TRACE_CAPACITY", "0")
    with pytest.raises(ValueError, match="trace_capacity"):
        Config.from_env()


def test_build_model_gives_the_workers_models():
    from horovod_tpu_torch.serving.__main__ import build_model
    gpt = build_model("gpt_tiny", 48)
    assert isinstance(gpt, tg.GPT) and not gpt.training
    assert gpt.config.max_position_embeddings == 48
    llama = build_model("llama_tiny", 40)
    assert isinstance(llama, tl.Llama)
    again = build_model("gpt_tiny", 48)
    assert all(torch.equal(a, b) for a, b in zip(gpt.parameters(),
                                                 again.parameters()))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hvdrun_serving_worker_answers_and_stops_on_sigterm(tmp_path):
    """``hvdrun-torch -np 1 --serving`` on ``python -m
    horovod_tpu_torch.serving --device cpu``: POST /generate answers with
    the model's cached-generate stream, /health and the metrics endpoint's
    /serving/health answer, and a SIGTERM to the worker stops it cleanly
    (the launcher exits 0) with its trace shard written."""
    from horovod_tpu_torch.serving.__main__ import build_model
    port, mport = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        CUDA_VISIBLE_DEVICES="", HOROVOD_TRACE_DIR=str(tmp_path),
        HOROVOD_METRICS_PORT=str(mport), HOROVOD_SERVING_MAX_LEN="64")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
         "-H", "localhost:1", "--serving", "--serving-port", str(port),
         "--serving-slots", "3", sys.executable, "-m",
         "horovod_tpu_torch.serving", "--device", "cpu"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        pid = None
        deadline = time.monotonic() + 90
        while pid is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"# serving gpt_tiny on :(\d+) \(slots=3.*pid=(\d+)",
                          line)
            if m:
                assert int(m.group(1)) == port
                pid = int(m.group(2))
        assert pid is not None, "".join(lines)
        prompt = [3, 14, 15, 9]
        code, out = _post(f"http://127.0.0.1:{port}/generate",
                          {"prompt": prompt, "max_new": 6})
        assert code == 200, out
        model = build_model("gpt_tiny", 64)
        assert out["tokens"] == _cached_generate(model, prompt, 6)
        code, body, _ = _get(f"http://127.0.0.1:{port}/health")
        assert code == 200 and json.loads(body)["slots"] == 3
        code, body, _ = _get(f"http://127.0.0.1:{mport}/serving/health")
        assert code == 200 and json.loads(body)["served"] == 1
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(60)
        lines += proc.stdout.readlines()
        assert rc == 0, "".join(lines)
        shard = json.loads((tmp_path / "trace_r0.json").read_text())
        # The request's trace; the engine's steps, marked for the step
        # profiler, leave step traces beside it (kind "step"), as JAX's.
        assert shard["rank"] == 0 and [t["rid"] for t in shard["traces"]
                                       if t["kind"] == "request"] \
            == [out["rid"]]
        assert {t["kind"] for t in shard["traces"]} <= {"request", "step"}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
