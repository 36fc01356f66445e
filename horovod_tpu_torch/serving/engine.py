"""Continuous-batching inference engine for the PyTorch/CUDA port.

Port of the JAX package's ``serving/engine.py``. A FIFO request queue
fronts a causal LM (the port's GPT or LLaMA); admitted requests are packed
into a FIXED-SLOT decode batch whose per-slot KV caches live in one
``DecodeCache`` of ``num_slots`` rows, allocated once, and slots retire and
refill independently: continuous batching, not static batches. Three
programs cover the whole hot path, each the decode-mode model's cached
route (``parallel/tp.py``, plain PyTorch, as JAX leaves it to XLA):

- **prefill**: a batch-1 chunked feed of ``prefill_chunk`` tokens at a (1,)
  position tensor into a zeroed batch-1 template (its logits are not
  computed: the feed runs ``features_only``, as XLA drops JAX's unused
  logits);
- **install**: copies the template's K/V (and int8 scales) into row
  ``slot`` of the big cache, in place;
- **decode step**: ONE token for every slot at its own position (a (S,)
  position tensor; each row masked by its own position), the cache written
  in place.

A step's host work is one host-to-device copy of the (S,) tokens and
positions, one forward, and one device-to-host copy of the (S, V) logits;
nothing else is read from the device. Sampling runs on the host in numpy,
float64, per request (temperature, top-k, top-p), each draw keyed on
``(seed, position)``: a request re-queued from its last committed token
after an elastic disruption reproduces its remaining stream exactly, and
the draws are JAX's. Greedy parity with ``models.generate`` is exact on
the CPU (the same argmax over the same logits).

Idle slots step too (the batch is static): an idle row writes at its
parked position every step, which is harmless because every position at or
below a live row's position is written before it is read and every
position above it is masked. :meth:`ServingEngine.submit` refuses a prompt
and budget past ``max_len``, which is what keeps every write in range: on
the card a per-row position past the capacity is a device-side assert.

Elasticity rides :class:`horovod_tpu_torch.serving.state.ServingState` (a
``TorchState``): request-level state commits per step group, in-flight
caches either migrate as host copies (``HOROVOD_SERVING_MIGRATE_KV``,
:meth:`kv_snapshot`) or re-queue from the last committed token and
re-prefill. Every lifecycle event and decode step lands in the trace store,
the serving and SLO series and the flight ring (``serving`` events:
submit, admit, complete, requeue); each step counts its token-seconds in
the serving goodput (in-SLO while every declared burn rate is <= 1) and,
with ``mark_steps``, marks a step for the step profiler.
"""

import threading
import time
import weakref

import numpy as np
import torch

from horovod_tpu_torch import trace
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.serving.request import Request
from horovod_tpu_torch.serving.scheduler import SlotScheduler
from horovod_tpu_torch.telemetry import slo as _slo

# The newest engine, for the /serving/health endpoint: a weak reference,
# so an engine its owner dropped frees its model and cache on the device
# (JAX's module holds it strongly).
_current = None


def get_engine():
    return None if _current is None else _current()


def serving_snapshot():
    """JSON-able engine state for ``/serving/health`` (None when no
    engine runs in this process)."""
    eng = get_engine()
    return None if eng is None else eng.snapshot()


def _host_filter_logits(logits, top_k, top_p):
    """numpy mirror of ``models.generate._filter_logits`` for one (V,)
    row (same keep-set semantics; host-side because per-request k/p are
    data, not static program constants)."""
    if top_k:
        k = min(top_k, logits.size)
        kth = np.partition(logits, -k)[-k]
        logits = np.where(logits >= kth, logits, -np.inf)
    if top_p < 1.0:
        srt = np.sort(logits)[::-1]
        z = srt - srt[0]
        probs = np.exp(z) / np.exp(z).sum()
        cum = np.cumsum(probs)
        keep = cum - probs < top_p
        thresh = srt[keep][-1] if keep.any() else srt[0]
        logits = np.where(logits >= thresh, logits, -np.inf)
    return logits


def sample_token(logits, temperature, top_k, top_p, seed, position):
    """Next token from one (V,) float row — greedy at temperature 0, else
    a tempered categorical over the filtered distribution, drawn from a
    generator keyed on ``(seed, position)``: position-keyed draws are
    what make a re-queued request's remaining stream identical to the
    uninterrupted one."""
    if temperature == 0.0:
        return int(np.argmax(logits))
    z = _host_filter_logits(logits.astype(np.float64) / temperature,
                            top_k, top_p)
    z = z - np.max(z)
    p = np.exp(z)
    p = p / p.sum()
    rng = np.random.default_rng((int(seed) & 0x7FFFFFFF, int(position)))
    return int(rng.choice(p.size, p=p))


def _host_entries(entries):
    """A host copy of a cache's entries (tensors copied to the CPU, the
    cursors as they are): the migration payload's ``cache``."""
    return {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v
            for k, v in entries.items()}


def _to_host(logits):
    if torch.is_tensor(logits):
        return logits.detach().float().cpu().numpy()
    return np.asarray(logits)


class ServingEngine:
    """See the module docstring. ``model`` is a causal LM of the port that
    runs the cached route with per-row positions (``model(ids, pos=<(B,)
    tensor>, cache=...)``: GPT, LLaMA; LoRA-merged weights serve
    unchanged). The engine runs on the device ``hvd.init()`` chose, else on
    the model's, and moves the model there.

    ``step_fn`` / ``prefill_fn`` / ``install_fn`` are test seams that stub
    the device programs to bound the pure host cost of enqueue → schedule
    → dispatch: ``step_fn(model, cache, toks, pos) -> (logits, cache)``,
    ``prefill_fn(model, cache, toks, t) -> cache``,
    ``install_fn(big, small, slot) -> big``. ``mark_steps``: each engine
    step is a ``step_marker`` (the step profiler's windows and the flight
    ring's step spans).
    """

    def __init__(self, model, num_slots=4, max_len=None, prefill_chunk=64,
                 queue_limit=0, migrate_kv=False, mark_steps=True,
                 step_fn=None, prefill_fn=None, install_fn=None):
        self.model = model
        cap = getattr(getattr(model, "config", None),
                      "max_position_embeddings", None)
        self.max_len = int(max_len or cap or 0)
        if self.max_len < 2:
            raise ValueError("need max_len >= 2 (model config carries none)")
        if cap is not None and self.max_len > cap:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"position capacity ({cap})")
        self.num_slots = int(num_slots)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.migrate_kv = bool(migrate_kv)
        self.mark_steps = bool(mark_steps)
        # Guards submission (HTTP handler threads) against the elastic
        # restore's scheduler swap on the serve thread: a submit must
        # land either in the old scheduler BEFORE the restore captures
        # its contents, or in the rebuilt one — never in a discarded
        # deque (a silently dropped request).
        self._submit_lock = threading.Lock()
        self._sched = SlotScheduler(self.num_slots, queue_limit=queue_limit)
        self._requests = {}          # rid -> Request (live registry)
        self._step_count = 0
        self._served = 0
        self._tokens = np.zeros((self.num_slots,), np.int32)
        self._pos = np.zeros((self.num_slots,), np.int32)
        self._cache_valid = True
        self._stub = (step_fn, prefill_fn, install_fn)
        self._cache = self._small_zero = None
        self._build_runtime()
        global _current
        _current = weakref.ref(self)

    # --- the programs -----------------------------------------------------

    def _runtime_device(self):
        """The device ``hvd.init()`` chose for this membership, else the
        model's (the CPU for a model without parameters)."""
        from horovod_tpu_torch.common import basics
        if basics.is_initialized():
            return basics.device()
        p = next(iter(self.model.parameters()), None) \
            if isinstance(self.model, torch.nn.Module) else None
        return p.device if p is not None else torch.device("cpu")

    def _build_runtime(self):
        """(Re)build the caches and the three programs on the runtime's
        device: at construction and after an elastic membership change."""
        from horovod_tpu_torch.models.generate import init_decode_cache

        step_fn, prefill_fn, install_fn = self._stub
        # Release the old caches before allocating their successors.
        self._cache = self._small_zero = None
        self.device = self._runtime_device()
        if isinstance(self.model, torch.nn.Module):
            p = next(iter(self.model.parameters()), None)
            if p is not None and p.device != self.device:
                self.model.to(self.device)

        if step_fn is None:
            def step_fn(model, cache, toks, pos):
                # One token for every slot, each row at its own position.
                return model(toks[:, None], pos=pos, cache=cache)[:, 0], cache

        if prefill_fn is None:
            def prefill_fn(model, cache, toks, t):
                # batch-1 chunked feed at explicit positions (the per-row
                # route); prefill wants the K/V rows, not the logits.
                model(toks, pos=torch.full((1,), t, dtype=torch.long,
                                           device=toks.device),
                      cache=cache, features_only=True)
                return cache

        if install_fn is None:
            def install_fn(big, small, slot):
                # Every K/V (and scale) row in one foreach copy: a copy a
                # tensor would leave the card waiting on the host's launches.
                keys = [k for k, b in big.entries.items() if torch.is_tensor(b)]
                torch._foreach_copy_([big.entries[k][slot] for k in keys],
                                     [small.entries[k][0] for k in keys])
                return big               # the host cursor is bookkeeping

        self._step_fn = step_fn
        self._prefill_fn = prefill_fn
        self._install_fn = install_fn
        if self._stub[0] is not None:
            # Stubbed runtime (host-cost probes): no device caches at all.
            self._cache = {}
            self._small_zero = {}
            return
        self._cache = init_decode_cache(self.model, self.num_slots,
                                        device=self.device)
        self._small_zero = init_decode_cache(self.model, 1,
                                             device=self.device)

    def _zeroed_template(self):
        """The batch-1 template, zeroed: the prefill writes it in place, so
        the previous admission's rows must not reach the next one (JAX's
        template is never written, its prefill not being donated)."""
        small = self._small_zero
        if self._stub[0] is None:
            torch._foreach_zero_([v for v in small.entries.values()
                                  if torch.is_tensor(v)])
            for key, v in small.entries.items():
                if not torch.is_tensor(v):
                    small.entries[key] = 0
        return small

    # --- submission ------------------------------------------------------

    def submit(self, prompt, max_new, temperature=0.0, top_k=0, top_p=1.0,
               eos_id=None, seed=0):
        """Enqueue one request; returns the :class:`Request` (its
        ``result()`` blocks until completion). Raises
        :class:`~horovod_tpu_torch.serving.scheduler.QueueFull` at the queue
        limit and ValueError when prompt + budget exceed the cache."""
        req = Request(prompt, max_new, temperature=temperature,
                      top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed)
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new ({req.max_new}) "
                f"exceeds the engine's cache capacity ({self.max_len})")
        with self._submit_lock:
            self._sched.submit(req)      # raises QueueFull after reject()
            # Registered only once actually queued: rejected requests
            # must not pin their prompt in the live registry forever.
            self._requests[req.rid] = req
        # Root of the request's span tree: admission wall time. Rejected
        # requests never register — the trace store holds queued work.
        trace.register(req.tid, rid=req.rid, t0=req.t_wall)
        trace.add_instant(req.tid, "submit", t=req.t_wall, cat="serving")
        _flight.record_event("serving", what="submit", name=f"r{req.rid}",
                             trace=req.tid)
        return req

    # --- the serve loop ---------------------------------------------------

    def _prefill_into(self, slot, req):  # hvdrace: disable=HVR203 -- _tokens/_pos/_cache_valid are serve-thread-owned; the restore path only writes them under _submit_lock while serving is quiesced
        """Teacher-force the request's effective prompt (prompt + any
        committed tokens from a previous incarnation) into its slot."""
        toks = req.full_tokens()
        P = len(toks)
        end = P - 1                       # last token is the decode input
        small = self._zeroed_template()
        c = self.prefill_chunk
        # Close the CURRENT incarnation's queue phase: t_queued restarts
        # at submit and at every requeue, so the span tree shows one
        # queue span per incarnation (before and after an elastic kill).
        now = time.time()
        trace.add_span(req.tid, "queue", t0=req.t_queued,
                       dur=max(now - req.t_queued, 0.0), cat="serving",
                       args={"slot": slot})
        t = 0
        while t < end:
            s = min(c, end - t)           # exact remainder: no pad rows
            chunk = torch.tensor([toks[t:t + s]], dtype=torch.long,
                                 device=self.device)
            with trace.span("chunk", parent="prefill", cat="serving",
                            tid=req.tid):
                small = self._prefill_fn(self.model, small, chunk, t)
            t += s
        with trace.span("install", parent="prefill", cat="serving",
                        tid=req.tid):
            self._cache = self._install_fn(self._cache, small, int(slot))
        self._tokens[slot] = toks[-1]
        self._pos[slot] = P - 1
        # A rollback always empties the slot table before invalidating,
        # so every active slot after it reaches the cache through THIS
        # prefill — the first admission makes the cache live again (the
        # readiness gate must not report a recovered engine CACHE-STALE
        # forever).
        self._cache_valid = True
        _flight.record_event("serving", what="admit", name=f"r{req.rid}",
                             seq=slot, trace=req.tid)

    @torch.no_grad()
    def step(self):  # hvdrace: disable=HVR203 -- the serve loop is the scheduler's single consumer: _sched/_step_count reads here race nothing; _submit_lock guards only the submit-vs-commit/restore swap
        """One engine iteration: admit + prefill free slots, then one
        decode step for every active slot. Returns True when any work
        happened (False = idle)."""
        for slot, req in self._sched.admit():
            self._prefill_into(slot, req)
        active = self._sched.active()
        if not active:
            return False
        t0 = time.perf_counter()
        # One host-to-device copy of the tokens and positions, one forward,
        # one device-to-host copy of the (S, V) logits (the only sync).
        feed = torch.from_numpy(np.stack([self._tokens, self._pos]).astype(
            np.int64)).to(self.device)
        logits, self._cache = self._step_fn(self.model, self._cache,
                                            feed[0], feed[1])
        logits_np = _to_host(logits)
        dt = time.perf_counter() - t0
        # One decode_step span per batched slot, sharing the step's wall
        # window — the synthesized "decode" phase of each request's tree
        # is the envelope of its decode_step children, so the phase
        # covers the whole resident-in-batch stretch, gaps included.
        t_wall = time.time() - dt
        committed = 0
        for slot, req in active.items():
            trace.add_span(req.tid, "decode_step", t0=t_wall, dur=dt,
                           parent="decode", cat="serving")
            tok = sample_token(logits_np[slot], req.temperature,
                               req.top_k, req.top_p, req.seed,
                               len(req.committed))
            first = not req.committed
            finished = req.commit_token(tok)
            if first:
                ttft = req.t_first - req.t_submit
                _metrics.record_serving_ttft(ttft)
                _slo.observe_ttft(ttft)
            self._tokens[slot] = tok
            self._pos[slot] += 1
            committed += 1
            if finished:
                self._sched.retire(slot)
                req.finish()
                # The registry holds only live (restorable) requests —
                # without the prune, a long-running server leaks every
                # prompt + token list it ever served. A restore that
                # rolls back PAST this completion re-materializes the
                # request from the snapshot; the caller's already
                # resolved future keeps the identical (deterministic)
                # stream.
                with self._submit_lock:
                    self._requests.pop(req.rid, None)
                    self._served += 1
                _metrics.record_serving_request("completed")
                # Terminal stream phase (final-token delivery: host
                # sampling + future resolution), then close the root —
                # the trace's duration is the request's true wall time.
                t_end = t_wall + dt
                trace.add_span(req.tid, "stream", t0=t_end,
                               dur=max(time.time() - t_end, 0.0),
                               cat="serving")
                trace.finish(req.tid)
                _flight.record_event("serving", what="complete",
                                     name=f"r{req.rid}",
                                     dur=req.t_done - req.t_submit,
                                     trace=req.tid)
        _metrics.record_serving_step(dt, len(active), self.num_slots,
                                     committed)
        _slo.observe_tokens(committed)
        # Serving goodput: this step's token-seconds count as goodput iff
        # every declared SLO objective is within budget now (burn <= 1);
        # with none declared all traffic is in-SLO.
        try:
            from horovod_tpu_torch.goodput import ledger as _goodput
            burns = _slo.burn_rates()
            _goodput.record_serving_step(
                dt, committed, in_slo=all(b <= 1.0 for b in burns.values()))
        except Exception:  # noqa: BLE001
            pass
        self._step_count += 1
        if self.mark_steps:
            _flight.step_marker(self._step_count)
        return True

    def run_until_idle(self, max_steps=100000, commit=None):
        """Drive :meth:`step` until queue and slots drain; ``commit`` (an
        optional callable) runs after every step — the elastic commit
        hook."""
        steps = 0
        while not self.idle():
            progressed = self.step()
            if commit is not None:
                commit()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"serving engine did not drain in {max_steps} steps "
                    f"(queue={self._sched.queue_depth()}, "
                    f"active={self._sched.n_active()})")
            if not progressed and self.idle():
                break
        return steps

    def idle(self):
        return self._sched.idle()

    def queue_depth(self):
        """Admission-queue depth — cheap (no snapshot frame): hot loops
        (bench pacing, backpressure probes) poll it per iteration."""
        return self._sched.queue_depth()

    # --- elastic integration ----------------------------------------------

    def request_snapshot(self):
        """Picklable request-level state: active slots first (they re-admit
        ahead of the queue — FIFO completion order survives), then the
        queue, oldest first."""
        # The commit runs on the elastic coordination path while HTTP
        # submit threads race it; collect a consistent frame under the
        # same lock submit() takes, emit trace markers after release (the
        # trace store has its own lock — see load_request_snapshot).
        with self._submit_lock:
            active = dict(self._sched.active())
            snap = {
                "active": [active[s].snapshot() for s in sorted(active)],
                "queued": [r.snapshot() for r in self._sched.queued()],
                "served": self._served,
            }
        for req in active.values():
            # Commit marker (NOT a barrier: it must not break the decode
            # phase chain); the span cap bounds a long decode's markers.
            trace.add_instant(req.tid, "commit", cat="elastic",
                              args={"committed": len(req.committed)})
        return snap

    def kv_snapshot(self):
        """Host copy of the live slot caches + cursors (the migration
        payload: ``cache`` the cache's entries keyed by JAX's cache paths,
        as CPU tensors in the port's layout; ``pos``, ``tokens`` and
        ``slots``). None when the runtime is stubbed or caches are
        stale."""
        if not self._cache_valid or self._stub[0] is not None:
            return None
        return {"cache": _host_entries(self._cache.entries),
                "pos": self._pos.copy(), "tokens": self._tokens.copy(),
                "slots": {s: r.rid
                          for s, r in self._sched.active().items()}}

    def load_request_snapshot(self, snap):
        """Restore request-level state from :meth:`request_snapshot`.
        Known rids keep their live Request objects (callers' futures stay
        wired); unknown rids (a worker that joined after submission)
        materialize fresh ones. Active-at-snapshot requests re-queue at
        the head — the cache that backed them is declared stale. Live
        requests submitted AFTER the snapshot was taken are merged in
        behind it (a restore must not drop work that arrived since the
        last commit)."""
        if snap is None:
            return
        with self._submit_lock:
            emissions = self._load_request_snapshot_locked(snap)
        # Trace/metrics sinks each take their own lock; emitting them
        # while holding _submit_lock would order _submit_lock before every
        # sink lock on this path while other paths (submit, step) build
        # the opposite nesting — run them after the swap publishes.
        for emit in emissions:
            emit()

    def _load_request_snapshot_locked(self, snap):
        emissions = []
        snap_rids = {rs["rid"]
                     for rs in list(snap.get("active", ()))
                     + list(snap.get("queued", ()))}
        # Requests running in THIS engine right now are the ones the
        # rollback actually re-queues (the sync that follows a restore
        # replays the same snapshot over an already-queued set — that
        # second pass must not double-count).
        was_active = {r.rid for r in self._sched.active().values()}
        later = [r for r in list(self._sched.active().values())
                 + self._sched.queued()
                 if r.rid not in snap_rids and not r.done()]
        self._sched = SlotScheduler(self.num_slots,
                                    queue_limit=self._sched.queue_limit)
        self._served = int(snap.get("served", 0))
        for rs in list(snap.get("active", ())) + list(snap.get("queued",
                                                               ())):
            req = self._requests.get(rs["rid"])
            if req is not None \
                    and req.identity() != Request.snapshot_identity(rs):
                # Cross-process rid collision: rids are process-local
                # counters, so a broadcast snapshot (scale-up sync) can
                # carry another worker's request under a rid a DIFFERENT
                # local request already owns. Never graft the foreign
                # committed tokens onto it — materialize the snapshot's
                # request separately and leave the local one's registry
                # slot (and its caller's future) alone.
                req = None
                register = False
            else:
                register = True
            if req is None:
                # The snapshot's tid keeps the trace ONE contiguous tree
                # across the kill: the restored request re-registers
                # under the id minted at original admission (idempotent —
                # spans recorded before the disruption survive).
                req = Request(rs["prompt"], rs["max_new"],
                              temperature=rs["temperature"],
                              top_k=rs["top_k"], top_p=rs["top_p"],
                              eos_id=rs["eos_id"], seed=rs["seed"],
                              rid=rs["rid"], tid=rs.get("tid"))
                if register:
                    self._requests[req.rid] = req
            req.restore_committed(rs["committed"])
            # Monotonic: the committed snapshot's count can only LAG the
            # live one (the bump below, or an eviction that preceded this
            # sync) — a replay of the same snapshot must never roll the
            # disruption accounting back.
            req.requeues = max(req.requeues, int(rs.get("requeues", 0)))
            req.t_queued = time.time()
            emissions.append(lambda req=req, rs=rs: trace.register(
                req.tid, rid=req.rid, t0=rs.get("t0")))
            if req.rid in was_active:
                req.requeues += 1
                emissions.append(
                    lambda: _metrics.record_serving_request("requeued"))
                # Barrier instant: spans after it open a FRESH incarnation
                # of their phase (queue/prefill again) instead of nesting
                # under the pre-kill one.
                emissions.append(lambda req=req: trace.add_instant(
                    req.tid, "requeue", cat="elastic", barrier=True,
                    args={"committed": len(req.committed),
                          "requeues": req.requeues}))
                emissions.append(lambda req=req: _flight.record_event(
                    "serving", what="requeue", name=f"r{req.rid}",
                    trace=req.tid))
            else:
                emissions.append(lambda req=req: trace.add_instant(
                    req.tid, "restore", cat="elastic", barrier=True))
            self._sched.enqueue_restored(req)
        for req in later:
            self._sched.enqueue_restored(req)
        self._cache_valid = False
        self._pos[:] = 0
        self._tokens[:] = 0
        return emissions

    def invalidate_cache(self):
        """Mark slot caches unusable (a restore rolled requests behind the
        cache's cursors)."""
        self._cache_valid = False

    def detach_to_host(self):
        """Move the cache to host memory before a membership change (the
        graceful-migration path): the K/V values survive as CPU tensors
        while the device's buffers are released."""
        if self._stub[0] is None and self._cache_valid:
            from horovod_tpu_torch.parallel.tp import DecodeCache
            self._cache = DecodeCache(_host_entries(self._cache.entries))
            self._small_zero = None

    def reset_runtime(self, kv=None):
        """Rebuild the caches on the device ``hvd.init()`` chose for the
        (possibly new) membership.

        Priority: an explicit ``kv`` payload (:meth:`kv_snapshot`'s) > the
        live detached cache (graceful host-update with ``migrate_kv``) >
        evict-and-requeue (in-flight requests re-enter the queue from
        their last committed token and re-prefill)."""
        live = None
        if kv is not None:
            live = kv
        elif self.migrate_kv and self._cache_valid \
                and self._stub[0] is None:
            live = {"cache": dict(self._cache.entries),
                    "pos": self._pos.copy(),
                    "tokens": self._tokens.copy(),
                    "slots": {s: r.rid
                              for s, r in self._sched.active().items()}}
        self._build_runtime()
        if live is not None and self._stub[0] is None:
            # Place the migrated K/V rows on the runtime's device. Slot
            # assignments and cursors resume exactly where the payload
            # left them — no re-prefill, zero recompute.
            entries = self._cache.entries
            for key, v in live["cache"].items():
                if key not in entries:
                    raise ValueError(f"the migration payload's {key!r} is "
                                     f"not an entry of this engine's cache")
                if torch.is_tensor(entries[key]):
                    entries[key].copy_(torch.as_tensor(v))
                else:
                    entries[key] = int(v)
            self._pos[:] = live["pos"]
            self._tokens[:] = live["tokens"]
            active = {r.rid: r for r in self._sched.active().values()}
            want = live.get("slots", {})
            if set(want.values()) != set(active):
                # Snapshot and scheduler disagree (snapshot predates a
                # load_request_snapshot eviction): fall back to requeue.
                self._evict_all()
            self._cache_valid = True
            return
        self._evict_all()
        self._cache_valid = True

    def _evict_all(self):
        for req in self._sched.evict_active():
            req.t_queued = time.time()
            trace.add_instant(req.tid, "requeue", cat="elastic",
                              barrier=True)
            _flight.record_event("serving", what="requeue",
                                 name=f"r{req.rid}", trace=req.tid)
        self._pos[:] = 0
        self._tokens[:] = 0

    # --- observability ----------------------------------------------------

    def snapshot(self):
        """One JSON-able frame for ``/serving/health`` and the readiness
        gate."""
        # HTTP threads race submit/restore here; read the scheduler frame
        # under the lock, compute the (lock-taking) SLO read outside it.
        with self._submit_lock:
            sched = self._sched
            active = dict(sched.active())
            frame = {
                "t": time.time(),
                "slots": self.num_slots,
                "active": len(active),
                "queue_depth": sched.queue_depth(),
                "queue_limit": sched.queue_limit,
                "fill_ratio": round(sched.fill_ratio(), 4),
                "served": self._served,
                "steps": self._step_count,
                "max_len": self.max_len,
                "cache_valid": self._cache_valid,
                "requests": {
                    str(s): {"rid": r.rid, "generated": len(r.committed),
                             "budget": r.max_new, "requeues": r.requeues}
                    for s, r in active.items()},
                # Saturation = queue at (or beyond) its declared limit:
                # the load balancer should stop sending here.
                "saturated": bool(sched.queue_limit
                                  and sched.queue_depth()
                                  >= sched.queue_limit),
            }
        # {} unless SLO objectives are declared (HOROVOD_SLO_*); the
        # read also refreshes the slo_burn_rate{objective} gauges.
        frame["slo"] = _slo.burn_rates()
        try:
            from horovod_tpu_torch.goodput import ledger as _goodput
            gp = _goodput.serving_snapshot()
            if gp.get("steps"):
                frame["goodput"] = gp
        except Exception:  # noqa: BLE001
            pass
        return frame
