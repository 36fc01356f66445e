"""Serving chaos soak — the acceptance leg of the serving subsystem.

Port of the JAX package's ``serving/soak.py`` over the port's
``serving/`` (``ServingEngine``, ``ServingState``) and its
``chaos/soak.py`` (the elastic launcher with CPU, gloo, workers: each is
``python -m horovod_tpu_torch.serving.soak --worker N MAX_NEW SLOTS`` and
reports its streams as JSON through the launcher's KV).

Drives an 8-process elastic SERVING cluster (every worker runs the
continuous-batching engine over a replicated tiny GPT, committing
through :class:`ServingState` with a fleet-heartbeat allreduce per step
group) through a seeded worker-kill + rolling-restart plan, and asserts
the zero-drop invariants:

1. every submitted request completes on every surviving worker
   (zero in-flight drops across two staggered worker kills),
2. every completed token stream equals the single-process clean run's
   exactly (requeue-from-committed-token + greedy determinism),
3. elastic resets stay within the plan's kill budget (no flapping),
4. the flight-recorder dumps localize each kill: the victim's rank, the
   first unmatched heartbeat-collective sequence number, and the
   causing injection (:func:`chaos.soak._assert_flight_forensics`),
5. trace continuity: every request's span tree is one contiguous trace
   id from admission through requeue-from-committed-tokens to
   completion, with the requeue/restore barrier markers present
   (``horovod_tpu_torch/trace``; the mid-flight-kill steps make this a
   real through-the-disruption check, not a clean-path one).

The heartbeat allreduce is not test scaffolding only: serving fleets
exchange load/SLO accounting the same way, and it is what makes every
survivor fail FAST into the elastic recovery path on a peer kill
instead of decoding obliviously past a dead rank.

The model is the port's tiny GPT drawn from a seeded ``torch.Generator``
(the soak holds the streams against its own clean single-process run, so
no Flax init is needed). Marked slow in tests
(``tests/test_torch_soak.py``).
"""

import json
import os
import sys

import numpy as np

from horovod_tpu_torch.chaos import soak as _base


def soak_model():
    """The fixture every process (and the clean reference) builds
    identically: tiny GPT, seeded init — replicated serving compute."""
    import torch

    from horovod_tpu_torch.models import GPT, GPTConfig

    cfg = GPTConfig.tiny(tp_axis=None, ep_axis=None,
                         max_position_embeddings=48)
    model = GPT(cfg, generator=torch.Generator().manual_seed(0)).eval()
    return model, cfg


def soak_prompts(n_requests, vocab, seed=5):
    """Deterministic request set (lengths 2..6, seeded token ids)."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in
             rng.integers(0, vocab, size=int(rng.integers(2, 7)))]
            for _ in range(n_requests)]


def expected_streams(n_requests, max_new):
    """Single-process clean run: the token streams every soak worker
    must reproduce bit-for-bit."""
    from horovod_tpu_torch.serving import ServingEngine

    model, cfg = soak_model()
    engine = ServingEngine(model, num_slots=2, mark_steps=False)
    reqs = [engine.submit(p, max_new=max_new)
            for p in soak_prompts(n_requests, cfg.vocab_size)]
    engine.run_until_idle()
    return [[int(t) for t in r.result(0)] for r in reqs]


def serving_soak_worker(n_requests, max_new, slots, device="cpu"):
    """The per-worker serve loop."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import trace as _trace
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.serving import ServingEngine, ServingState

    hvd.init(device=device)
    model, cfg = soak_model()
    engine = ServingEngine(model, num_slots=slots, mark_steps=False)
    reqs = [engine.submit(p, max_new=max_new)
            for p in soak_prompts(n_requests, cfg.vocab_size)]
    state = attach_listener(ServingState(engine, step=0, worlds=[]))

    @hvd.elastic.run
    def serve(state):
        def commit():
            # Fleet heartbeat: one tiny allreduce per step group — the
            # load-accounting exchange a real fleet runs anyway. It makes
            # every survivor fail FAST on a peer kill (collective error ->
            # elastic restore) and gives the flight forensics a collective
            # sequence stream to localize the victim with.
            hvd.allreduce(torch.ones(1), op=hvd.Average)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()

        engine.run_until_idle(commit=commit)
        snap = hvd.metrics_snapshot()
        req_traces = []
        for r in reqs:
            rec = _trace.get(r.tid) or {}
            names = [s["name"] for s in rec.get("spans", ())]
            req_traces.append({
                "rid": r.rid, "tid": r.tid,
                # one contiguous id: the rid still resolves to the tid
                # minted at original admission, across every kill.
                "same_tid": _trace.for_rid(r.rid) == r.tid,
                "done": bool(rec.get("done")),
                "requeue_marks": names.count("requeue"),
                "restore_marks": names.count("restore"),
                "queue_spans": names.count("queue"),
                "stream_spans": names.count("stream"),
                "requeues": r.requeues,
            })
        count = _base.count_series
        return {
            "streams": [[int(t) for t in r.result(0)] for r in reqs],
            "requeues": sum(r.requeues for r in reqs),
            "worlds": list(state.worlds),
            "final_world": hvd.size(),
            "cross_rank": hvd.cross_rank(),
            "resets": count(snap, "elastic_events_total",
                            {"event": "reset"}),
            "completed": count(snap, "serving_requests_total",
                               {"event": "completed"}),
            "requeued_events": count(snap, "serving_requests_total",
                                     {"event": "requeued"}),
            "ttft_count": count(snap, "serving_ttft_seconds"),
            "req_traces": req_traces,
            "cluster": _base.wait_cluster_view(),
        }

    return serve(state)


def rolling_kill_plan(procs, seed, first_step=3, second_step=8):
    """Two staggered worker kills — the rolling-restart drill: the fleet
    shrinks twice while requests are in flight, and each shrink must
    re-queue-from-committed, not drop.

    The kill steps are chosen so the survivors DETECT the failure (their
    next heartbeat allreduce, one commit later) mid-generation: with
    ``slots=2`` and ``max_new=5`` every slot pair retires on commits
    ≡ 0 (mod 5), so a kill at a step ≡ 4 (mod 5) would surface exactly
    in the retired-but-not-yet-refilled window where nothing is in
    flight and no requeue is forced — steps 3 and 8 land the detection
    on commits 4 and 9, mid-flight for both slot pairs."""
    victims = [procs - 3 if procs > 3 else procs - 1, 2 % procs]
    return victims, {
        "seed": seed,
        "note": f"serving soak: rolling kills r{victims[0]}@s{first_step}"
                f", r{victims[1]}@s{second_step}",
        "faults": [
            {"site": "elastic.commit", "kind": "crash",
             "rank": victims[0], "at_step": [first_step], "max_fires": 1},
            {"site": "elastic.commit", "kind": "crash",
             "rank": victims[1], "at_step": [second_step],
             "max_fires": 1},
        ],
    }


def run_serving_soak(procs=8, n_requests=10, max_new=5, slots=2,
                     seed=123, workdir=None):
    """Clean reference + chaos serving run; asserts the zero-drop
    invariants and returns the evidence dict."""
    import tempfile

    workdir = workdir or tempfile.mkdtemp(prefix="hvd_serving_soak_")
    os.makedirs(workdir, exist_ok=True)
    victims, plan_dict = rolling_kill_plan(procs, seed)
    budget = _base.plan_kill_budget(plan_dict)
    min_np = max(procs - budget, 1)
    plan_path = os.path.join(workdir, "plan.yaml")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)
    ledger_dir = os.path.join(workdir, "ledger")
    flight_dir = os.path.join(workdir, "flight")

    _base._progress("serving soak clean reference", procs=procs,
                    requests=n_requests)
    expected = expected_streams(n_requests, max_new)

    _base._progress("serving soak chaos run start", victims=victims)
    try:
        results = _base.elastic_run(
            "horovod_tpu_torch.serving.soak", [n_requests, max_new, slots],
            procs, min_np, workdir, {
                "HOROVOD_CHAOS_PLAN": plan_path,
                "HOROVOD_CHAOS_SEED": str(seed),
                "HOROVOD_CHAOS_LEDGER": ledger_dir,
                "HOROVOD_FLIGHT_DIR": flight_dir,
            })
    finally:
        from horovod_tpu_torch import chaos
        chaos.uninstall()
    _base._progress("serving soak chaos run done", hosts=len(results))

    evidence = {"procs": procs, "plan": plan_dict, "victims": victims,
                "kill_budget": budget, "workdir": workdir,
                "expected": expected, "results": results}
    # (1) zero drops: every worker completed every submitted request...
    for r in results:
        assert len(r["streams"]) == n_requests, r
        assert r["completed"] >= n_requests, r
        # (2) ...with token streams identical to the clean run.
        assert r["streams"] == expected, (
            f"worker r{r['cross_rank']} token streams diverged from the "
            f"clean run under chaos")
        # (3) no flapping: resets within the kill budget.
        assert r["resets"] <= budget, r
        assert r["final_world"] == procs - budget, r
        assert r["ttft_count"] >= n_requests, r
    # The disruption actually forced requeues on at least one survivor.
    assert any(r["requeued_events"] > 0 or r["requeues"] > 0
               for r in results), results
    # (5) trace continuity across the kills: every request's span tree
    # is ONE contiguous trace — the rid resolves to the id minted at
    # original admission and the root closed — and at least one
    # mid-flight victim's request shows the requeue barrier followed by
    # a fresh queue incarnation under the SAME tid, with restore
    # markers present on the replayed queued set.
    for r in results:
        for t in r["req_traces"]:
            assert t["same_tid"] and t["done"] and t["stream_spans"] >= 1, \
                (r["cross_rank"], t)
    assert any(t["requeue_marks"] > 0 and t["queue_spans"] >= 2
               for r in results for t in r["req_traces"]), \
        [r["req_traces"] for r in results]
    assert any(t["restore_marks"] > 0
               for r in results for t in r["req_traces"]), \
        [r["req_traces"] for r in results]
    # Both kills fired, exactly once each.
    from horovod_tpu_torch.chaos import injector
    entries = injector.read_ledger(ledger_dir)
    kills = [e for e in entries if e["kind"] == "crash"]
    assert len(kills) == budget, entries
    assert sorted({k["rank"] for k in kills}) == sorted(set(victims)), \
        kills
    # (4) flight forensics localize each kill.
    evidence["flight_report"] = _base._assert_flight_forensics(
        flight_dir, ledger_dir, kills, procs)
    _base._progress("serving soak done", ok=True)
    return evidence


def main(argv=None):
    """``python -m horovod_tpu_torch.serving.soak``: the whole soak (prints
    one JSON line); ``--worker N MAX_NEW SLOTS``: one worker under the
    elastic launcher."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        n_requests, max_new, slots = (int(a) for a in argv[1:4])
        _base.report_result(serving_soak_worker(n_requests, max_new,
                                                slots))
        return 0
    ev = run_serving_soak()
    print(json.dumps({"ok": True, "workdir": ev["workdir"],
                      "victims": ev["victims"],
                      "requests": len(ev["expected"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
