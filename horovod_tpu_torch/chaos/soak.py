"""Elastic-recovery soak harness.

Port of the JAX package's ``chaos/soak.py``: the same plans, runs and
invariants, over the port's elastic launcher with CPU (gloo) workers. The
driver (``runner/elastic/driver.py::run_elastic_driver``, what ``python -m
horovod_tpu_torch.runner --min-np ... --host-discovery-script ...`` runs)
runs in this process; each worker is ``python -m
horovod_tpu_torch.chaos.soak --worker STEPS``, which runs
:func:`soak_train` and reports its result as JSON through the launcher's
KV store, so no pickling library is needed. One slot per loopback "host"
(``localhost``, ``127.0.0.2``, ...), so a removed host is one rank.

It drives a multi-process elastic training run through a seeded fault plan
(worker kill + KV drop + collective straggler by default) and asserts the
recovery invariants the elastic stack promises:

1. the run reaches the target step despite the injected failures,
2. the final weights match a clean (chaos-free) run within tolerance —
   the training contribution is world-size invariant (an ``Average`` of
   identical per-rank terms), so a correct restore/re-rendezvous sequence
   is loss-neutral by construction,
3. elastic resets stay within the plan's kill budget (no flapping),
4. every recovering worker populated the ``elastic_recovery_seconds``
   histogram, and
5. re-running the same plan + seed produces an identical injection-ledger
   schedule (the determinism contract of
   :mod:`horovod_tpu_torch.chaos.plan`).

Progress goes to the JSONL file ``HVD_BENCH_PROGRESS_FILE`` names (off
when unset), so a wedged soak still leaves parseable evidence of how far
it got.
"""

import contextlib
import json
import os
import sys
import time

_PROGRESS_PATH = os.environ.get("HVD_BENCH_PROGRESS_FILE", "")
_T0 = time.perf_counter()
# The directory holding the package: the workers' PYTHONPATH.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _progress(phase, **extra):
    """One progress JSONL record."""
    if not _PROGRESS_PATH:
        return
    try:
        rec = {"ts": round(time.time(), 3),
               "elapsed_s": round(time.perf_counter() - _T0, 3),
               "model": "chaos_soak", "phase": phase}
        rec.update(extra)
        with open(_PROGRESS_PATH, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass                      # evidence must never fail the soak


def wait_cluster_view(timeout=12.0):
    """Post-loop telemetry convergence: poll the job view until it shows
    the FINAL membership fully healthy (or the timeout lapses — the last
    view is still returned as evidence). Immediate local view when no
    aggregation plane is armed, so non-telemetry soaks pay nothing."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.telemetry import aggregator
    view = aggregator.cluster_snapshot()
    if aggregator.get_agent() is None:
        return view
    world = basics.size()
    deadline = time.time() + timeout
    while time.time() < deadline:
        view = aggregator.cluster_snapshot()
        if not view.get("local_only") \
                and view.get("world") == world \
                and view.get("counts", {}).get("healthy") == world:
            break
        time.sleep(0.25)
    return view


def count_series(snap, name, labels=None):
    """The total of a metrics snapshot's series ``name`` (counts of a
    histogram, values of a counter) whose labels include ``labels``."""
    total = 0
    for s in snap.get(name, {}).get("series", ()):
        if labels is None or all(s["labels"].get(k) == v
                                 for k, v in labels.items()):
            total += s.get("count", s.get("value", 0))
    return total


def soak_train(total_steps, device="cpu"):
    """The per-worker training loop. World-size-invariant updates: each
    step adds ``Average(step + 1)`` of identical per-rank contributions,
    so the final weights are independent of membership changes — any
    deviation from the clean run is a recovery bug, not a modeling
    artifact."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.goodput import ledger as goodput_ledger

    hvd.init(device=device)
    state = attach_listener(hvd.TorchState(w=torch.zeros(4), step=0,
                                           worlds=[]))

    @hvd.elastic.run
    def loop(state):
        while state.step < total_steps:
            contrib = torch.ones(4) * float(state.step + 1)
            state.w = state.w + hvd.allreduce(contrib, op=hvd.Average)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        snap = hvd.metrics_snapshot()
        # Per-rank goodput decomposition: the wall-clock evidence the
        # driver's conservation / bracket assertions read.
        return {
            "steps": state.step,
            "w": state.w.tolist(),
            "worlds": list(state.worlds),
            "final_world": hvd.size(),
            "cross_rank": hvd.cross_rank(),
            "pid": os.getpid(),
            "resets": count_series(snap, "elastic_events_total",
                                   {"event": "reset"}),
            "recoveries": count_series(snap, "elastic_recovery_seconds"),
            "kv_retries": count_series(snap, "kv_client_retries_total"),
            "injections": count_series(snap, "chaos_injections_total"),
            # Telemetry-plane evidence: the job view after the final
            # membership converged (local-only when the plane is off).
            "cluster": wait_cluster_view(),
            "goodput": goodput_ledger.snapshot(),
        }

    return loop(state)


def default_plan(procs=8, seed=123, kill_rank=None, kill_step=3,
                 straggler_rank=2, drop_step=None):
    """The acceptance plan: one hard worker kill at a step boundary, one
    KV-RPC drop per rank at a later step (absorbed by the client's retry),
    and a collective-dispatch straggler on one rank. All triggers are
    step-keyed, so the ledger schedule is re-run deterministic."""
    if kill_rank is None:
        # A mid-fleet rank for real fleets; never rank 0 on tiny worlds
        # (killing the coordination-service host is legal but makes the
        # small validation runs needlessly noisy).
        kill_rank = procs - 3 if procs > 3 else procs - 1
    drop_step = kill_step + 3 if drop_step is None else drop_step
    return {
        "seed": seed,
        "note": f"soak: kill r{kill_rank}@s{kill_step}, kv drop @s"
                f"{drop_step}, straggler r{straggler_rank}",
        "faults": [
            {"site": "elastic.commit", "kind": "crash", "rank": kill_rank,
             "at_step": [kill_step], "max_fires": 1},
            {"site": "http_kv.request", "kind": "drop",
             "at_step": [drop_step]},
            {"site": "collective.dispatch", "kind": "delay",
             "delay_ms": 30, "rank": straggler_rank,
             "at_step": [1, drop_step]},
        ],
    }


def plan_kill_budget(plan_dict):
    """Total process-fatal firings the plan allows (crash + host_remove
    budgets; an unbounded fatal spec counts as its trigger-list length)."""
    budget = 0
    for f in plan_dict.get("faults", ()):
        if f.get("kind") in ("crash", "hang", "host_remove"):
            budget += f.get("max_fires") or \
                len(f.get("at_step") or f.get("at") or (1,))
    return budget


def _assert_flight_forensics(flight_dir, ledger_dir, kills, procs):
    """Merge the chaos leg's flight dumps and assert the analyzer localizes
    the injected kill: the victim's rank, the first unmatched collective
    sequence number, and the causing injection site. Returns a compact
    report for the evidence dict."""
    from horovod_tpu_torch.flight import analyze as flight_analyze

    kill_ranks = sorted({k["rank"] for k in kills})
    events, metas, marks = flight_analyze.load_dir(flight_dir,
                                                   ledger_dir=ledger_dir)
    assert events, f"chaos leg left no flight dumps under {flight_dir}"
    report = flight_analyze.analyze(events, metas, marks)
    # Each victim's last act was dumping its ring (chaos crash hook).
    for r in kill_ranks:
        assert r in report["crash_dump_ranks"], report["dumps"]
    assert report["killed_ranks"] == kill_ranks, report["killed_ranks"]
    # Every rank left a dump: each victim's chaos_crash plus each
    # survivor's internal-error / membership-abort / atexit dump.
    # Ledger-synthesized events (from_ledger) are NOT dump evidence — a
    # rank whose dump write failed still has ledger entries, and counting
    # those would hide exactly the missing-dump regression this catches.
    worker_ranks = {e["rank"] for e in events
                    if e.get("role") != "driver"
                    and not e.get("from_ledger")}
    missing = set(range(procs)) - worker_ranks
    assert not missing, \
        f"ranks {sorted(missing)} left no flight dump: {report['dumps']}"
    causes = []
    for k in kills:
        # Cross-rank desync: each victim lags, and the first unmatched
        # seq names the collective it never dispatched.
        lagging = [d for d in report["desync"].values()
                   if d["desynced"] and k["rank"] in d["lagging_ranks"]]
        assert lagging, \
            f"killed rank {k['rank']} not localized: {report['desync']}"
        assert isinstance(lagging[0]["first_unmatched_seq"], int)
        # Causation: each crash injection is correlated with the first
        # downstream anomaly some rank recorded.
        cause = next((c for c in report["chaos"]
                      if c["what"] == "crash" and c["rank"] == k["rank"]
                      and c["site"] == k["site"]), None)
        assert cause is not None, (k, report["chaos"])
        assert cause.get("first_anomaly"), \
            f"crash injection has no downstream anomaly: {cause}"
        causes.append(cause)
    # The driver tied the dumps to the membership changes that removed the
    # victims' hosts.
    assert report["driver_disruptions"], "driver wrote no disruption marker"
    return {
        "dumps": report["dumps"],
        "killed_ranks": report["killed_ranks"],
        "desync": report["desync"],
        "cause": causes[0],
        "causes": causes,
        "driver_disruptions": report["driver_disruptions"],
    }


@contextlib.contextmanager
def _scoped_env(overrides):
    saved = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _write_discovery(path, procs):
    """N distinct loopback 'hosts' (127.0.0.0/8 is local to
    WorkerProcess), one slot each."""
    hosts = ["localhost"] + [f"127.0.0.{i}" for i in range(2, procs + 1)]
    with open(path, "w") as f:
        f.write("#!/bin/sh\n")
        for h in hosts:
            f.write(f"echo {h}:1\n")
    os.chmod(path, 0o755)
    return hosts


def elastic_run(module, worker_args, procs, min_np, workdir, chaos_env):
    """One elastic run of ``python -m <module> --worker <worker_args>`` on
    ``procs`` loopback hosts (``--min-np min_np``), under ``chaos_env``
    scoped to this process (the driver arms its copy of a plan from it,
    and the local workers inherit it). Returns the final membership's
    results by rank; raises when the run fails."""
    from horovod_tpu_torch.runner import launch as launch_mod
    from horovod_tpu_torch.runner.elastic.driver import run_elastic_driver

    script = os.path.join(workdir, "discover.sh")
    _write_discovery(script, procs)
    env = {
        # The removed host must STAY out (determinism: exactly one shrink,
        # no timing-dependent re-add mid-run).
        "HOROVOD_BLACKLIST_COOLDOWN_RANGE": "600,600",
        # c10d's warnings of the followers' bounded store waits and the
        # aborted groups would drown the run's own lines.
        "TORCH_CPP_LOG_LEVEL": "ERROR",
        "PYTHONPATH": os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p),
    }
    env.update(chaos_env)
    argv = ["--min-np", str(min_np), "--max-np", str(procs),
            "--host-discovery-script", script, "--start-timeout", "300",
            sys.executable, "-m", module, "--worker"] + \
        [str(a) for a in worker_args]
    harvested = {}

    def harvest(kv):
        # Results are keyed by the version a worker last initialized
        # under: only the final membership's count.
        version = (kv.get("elastic", "version") or b"0").decode()
        harvested["size"] = int(kv.get("elastic", "nslots") or b"0")
        for rank in range(harvested["size"]):
            v = kv.get("results", f"{version}/{rank}")
            if v is not None:
                harvested[rank] = json.loads(v)

    with _scoped_env(env):
        rc = run_elastic_driver(launch_mod.parse_args(argv),
                                harvest=harvest)
    if rc != 0:
        raise RuntimeError(f"elastic soak run failed with exit code {rc}")
    size = harvested.pop("size", 0)
    missing = [r for r in range(size) if r not in harvested]
    if missing or not size:
        raise RuntimeError(f"elastic soak run completed but ranks {missing} "
                           f"of the final {size} reported no result")
    return [harvested[r] for r in range(size)]


def report_result(result):
    """A worker's end: its result into the launcher's KV under the
    version it last initialized under and its rank, the job marked
    finished, the goodput ledger finalized, ``hvd.shutdown()``
    (``runner/task.py``'s order, with JSON for the pickle)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.goodput import ledger as goodput_ledger
    from horovod_tpu_torch.runner.http_kv import KVStoreClient

    config = Config.from_env()
    client = KVStoreClient(os.environ["HOROVOD_KV_ADDR"],
                           int(os.environ["HOROVOD_KV_PORT"]))
    client.put("results", f"{config.elastic_init_version}/{hvd.rank()}",
               json.dumps(result, default=str).encode())
    client.put("elastic", "finished", b"1")
    goodput_ledger.shutdown()
    hvd.shutdown()


def _elastic_run(steps, procs, min_np, workdir, chaos_env):
    return elastic_run("horovod_tpu_torch.chaos.soak", [steps], procs,
                       min_np, workdir, chaos_env)


def leader_kill_plan(procs, slices, seed, kill_step=3):
    """One hard kill of a TELEMETRY SLICE LEADER at a step boundary — the
    aggregation plane's own failure drill: its slice must re-elect, and
    the job view must record the lost host."""
    from horovod_tpu_torch.telemetry.aggregator import slice_members
    victim = slice_members(1, procs, slices)[0] if slices > 1 \
        else procs - 1
    return victim, {
        "seed": seed,
        "note": f"telemetry soak: kill slice-1 leader r{victim}"
                f"@s{kill_step} ({slices} slices over {procs} procs)",
        "faults": [
            {"site": "elastic.commit", "kind": "crash", "rank": victim,
             "at_step": [kill_step], "max_fires": 1},
        ],
    }


def run_leader_kill_soak(procs=8, slices=2, steps=8, seed=321,
                         workdir=None, kill_step=3):
    """Kill a telemetry slice leader mid-elastic-run and assert the
    aggregation plane's recovery invariants on top of the elastic ones:

    1. the run still reaches the target step at the shrunk world,
    2. the post-recovery job view is FRESH, covers the new membership,
       and reports every surviving rank healthy,
    3. re-election converged: every slice (including the victim's) has a
       live leader among the survivors and a full digest count,
    4. the job view's event log names the killed host as dead
       (``membership_removed`` — the generation diff), and
    5. no surviving worker's aggregator crashed (they all produced the
       converged view — the "never a crashed aggregator" contract).
    """
    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="hvd_leader_kill_")
    os.makedirs(workdir, exist_ok=True)
    victim, plan_dict = leader_kill_plan(procs, slices, seed,
                                         kill_step=kill_step)
    plan_path = os.path.join(workdir, "plan.yaml")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)
    # Host naming mirrors _write_discovery: rank r lives on
    # localhost/127.0.0.<r+1>.
    victim_host = "localhost" if victim == 0 else f"127.0.0.{victim + 1}"
    _progress("leader-kill soak start", procs=procs, slices=slices,
              victim=victim)
    try:
        results = _elastic_run(steps, procs, procs - 1, workdir, {
            "HOROVOD_CHAOS_PLAN": plan_path,
            "HOROVOD_CHAOS_SEED": str(seed),
            "HOROVOD_CHAOS_LEDGER": os.path.join(workdir, "ledger"),
            "HOROVOD_FLIGHT_DIR": os.path.join(workdir, "flight"),
            "HOROVOD_MESH_SLICES": str(slices),
            # The HIERARCHICAL control plane rides the same leader-kill
            # transition: the victim is a slice's lowest rank — its
            # negotiation leadership and fusion-boundary re-publish role
            # die with it, and the post-shrink world (procs-1, usually
            # undivisible) must degrade to the flat strategy on every
            # survivor identically. A short boundary lease keeps the
            # takeover window inside the kill-to-rendezvous gap.
            "HOROVOD_CONTROL_PLANE": "hier",
            "HOROVOD_CONTROL_LEASE_MS": "500",
            # Tight beacon cadence: the old generation's job view must
            # exist before the kill, and the new generation must converge
            # within the post-loop wait.
            "HOROVOD_TELEMETRY_INTERVAL": "0.1",
        })
    finally:
        # The driver armed the plan in THIS process from the scoped env.
        from horovod_tpu_torch import chaos
        chaos.uninstall()
    survivors = procs - 1
    # (1) elastic recovery held.
    assert all(r["steps"] == steps for r in results), \
        f"leader-kill run fell short of {steps} steps: {results}"
    assert all(r["final_world"] == survivors for r in results), results
    views = [r["cluster"] for r in results]
    # (5) every survivor's plane produced a real (non-fallback) view.
    assert all(v and not v.get("local_only") for v in views), views
    view = views[0]
    # (2) fresh, full coverage, all healthy.
    assert view["world"] == survivors, view
    assert view["counts"]["healthy"] == survivors, view["health"]
    assert view["num_slices"] == slices, view
    # (3) re-election: every slice has a leader among the survivors and
    # saw every member's digest.
    for sid, meta in view["slices"].items():
        assert meta["leader"] is not None, (sid, meta)
        assert meta["digests"] == len(meta["members"]), (sid, meta)
    # (4) the lost host is named dead in the event log.
    removed = [e for e in view.get("events", ())
               if e.get("why") == "membership_removed"]
    assert removed, f"no membership_removed event: {view.get('events')}"
    assert any(e.get("host") == victim_host for e in removed), \
        (victim_host, removed)
    _progress("leader-kill soak done", ok=True)
    return {"procs": procs, "slices": slices, "victim": victim,
            "victim_host": victim_host, "view": view,
            "results": results, "workdir": workdir}


def autopilot_straggler_plan(procs, seed, delay_ms=120):
    """A PERMANENT straggler: every collective dispatch on the LAST rank
    is delayed. The last rank so that after the autopilot removes its
    host and the survivors renumber 0..procs-2, no process inherits the
    victim's rank and the fault dies with the host."""
    victim = procs - 1
    return victim, {
        "seed": seed,
        "note": f"autopilot soak: permanent {delay_ms}ms straggler "
                f"r{victim}",
        "faults": [
            {"site": "collective.dispatch", "kind": "delay",
             "delay_ms": delay_ms, "rank": victim, "every": 1},
        ],
    }


def run_autopilot_soak(procs=8, steps=56, seed=777, workdir=None,
                       delay_ms=120):
    """The autopilot's acceptance soak: an elastic run with a seeded
    permanent straggler is recovered by the AUTOPILOT — the step-profiler
    watchdog names the delayed rank online, the controller's remediation
    policy passes hysteresis/rate/floor and publishes the removal, the
    driver arm blacklists the host through the cooldown path, and the
    job re-rendezvouses and reaches the target step — with zero human or
    harness intervention (this harness only starts the run). Asserted:

    1. every survivor reaches the target step at world ``procs - 1``;
    2. the removal really was controller-initiated: the flight analyzer
       (`report["autopilot"]`) names the removed rank and the causing
       decision (cause ``straggler``), correlated with the driver's
       disruption marker;
    3. the straggler is actually GONE: the post-shrink worlds in every
       survivor's step log are ``procs - 1``.
    """
    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="hvd_autopilot_soak_")
    os.makedirs(workdir, exist_ok=True)
    victim, plan_dict = autopilot_straggler_plan(procs, seed,
                                                 delay_ms=delay_ms)
    plan_path = os.path.join(workdir, "plan.yaml")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)
    flight_dir = os.path.join(workdir, "flight")
    ledger_dir = os.path.join(workdir, "ledger")
    victim_host = "localhost" if victim == 0 else f"127.0.0.{victim + 1}"
    _progress("autopilot soak start", procs=procs, steps=steps,
              victim=victim)
    try:
        results = _elastic_run(steps, procs, procs - 1, workdir, {
            "HOROVOD_CHAOS_PLAN": plan_path,
            "HOROVOD_CHAOS_SEED": str(seed),
            "HOROVOD_CHAOS_LEDGER": ledger_dir,
            "HOROVOD_FLIGHT_DIR": flight_dir,
            # The autopilot, tuned for a short soak: 1 s decision epochs,
            # 2-epoch hysteresis, one removal, floor at the survivor
            # count (the job must never shrink past one straggler).
            "HOROVOD_AUTOPILOT": "1",
            "HOROVOD_AUTOPILOT_INTERVAL": "1.0",
            "HOROVOD_AUTOPILOT_HYSTERESIS": "2",
            "HOROVOD_AUTOPILOT_MAX_REMOVALS": "1",
            "HOROVOD_AUTOPILOT_MIN_WORLD": str(procs - 1),
            # Fast naming + fresh host mapping: watchdog publish round
            # every 2 steps, telemetry beacons at 0.5 s.
            "HOROVOD_PROFILE_PUBLISH_STEPS": "2",
            "HOROVOD_TELEMETRY_INTERVAL": "0.5",
        })
    finally:
        from horovod_tpu_torch import chaos
        chaos.uninstall()
    survivors = procs - 1
    # (1) recovered with no human/harness help.
    assert all(r["steps"] == steps for r in results), \
        f"autopilot soak fell short of {steps} steps: {results}"
    assert all(r["final_world"] == survivors for r in results), results
    # (3) the straggler's host really left: the tail of every step log
    # ran at the shrunk world.
    assert all(r["worlds"][-1] == survivors for r in results), \
        [r["worlds"][-5:] for r in results]
    # (2) the forensics name the removal and its cause.
    from horovod_tpu_torch.flight import analyze as flight_analyze
    events, metas, marks = flight_analyze.load_dir(flight_dir,
                                                   ledger_dir=ledger_dir)
    assert events, f"soak left no flight dumps under {flight_dir}"
    report = flight_analyze.analyze(events, metas, marks)
    ap = report["autopilot"]
    rem = [r for r in ap["remediations"] if r.get("cause") == "straggler"]
    assert rem, f"no straggler remediation in the flight trail: {ap}"
    assert any(r.get("rank") == victim for r in rem), (victim, rem)
    assert any(r.get("host") == victim_host for r in rem), \
        (victim_host, rem)
    # ...and the driver executed it: a disruption marker removed the host.
    assert report["driver_disruptions"], "driver left no disruption marker"
    assert any(victim_host in (m.get("removed") or ())
               for m in report["driver_disruptions"]), \
        (victim_host, report["driver_disruptions"])
    _progress("autopilot soak done", ok=True,
              remediation=rem[0])
    return {"procs": procs, "steps": steps, "victim": victim,
            "victim_host": victim_host, "remediations": rem,
            "report_autopilot": ap, "results": results,
            "workdir": workdir}


def goodput_badput_plan(procs, seed, steps, kill_step=3,
                        straggler_rank=2, delay_ms=120,
                        straggler_from=12):
    """Seeded badput schedule for the goodput acceptance soak: one hard
    kill early (rendezvous_recovery badput on every survivor) plus a
    WINDOWED collective-dispatch straggler on a rank that survives the
    kill. The straggler window starts only after the survivors have
    rebuilt a clean >= 8-step comm baseline post-reset — a delay injected
    from step 0 is absorbed into the victim's own rolling median and
    books no excess — and runs to the end so the watchdog's published
    median actually goes outlier-high."""
    kill_rank = procs - 3 if procs > 3 else procs - 1
    assert straggler_rank != kill_rank
    return kill_rank, {
        "seed": seed,
        "note": f"goodput soak: kill r{kill_rank}@s{kill_step}, "
                f"{delay_ms}ms straggler r{straggler_rank}"
                f"@s{straggler_from}..{steps - 1}",
        "faults": [
            {"site": "elastic.commit", "kind": "crash", "rank": kill_rank,
             "at_step": [kill_step], "max_fires": 1},
            {"site": "collective.dispatch", "kind": "delay",
             "delay_ms": delay_ms, "rank": straggler_rank,
             "at_step": list(range(straggler_from, steps))},
        ],
    }


def run_goodput_soak(procs=8, steps=32, seed=555, workdir=None,
                     delay_ms=120, straggler_rank=2):
    """The goodput ledger's acceptance soak: an elastic run with a seeded
    kill and a windowed straggler must come back with a decomposition
    that (a) CONSERVES wall time on every rank, (b) BRACKETS the injected
    badput — ``rendezvous_recovery`` on every reset rank,
    ``straggler_wait`` on the victim against the chaos ledger's exact
    fire count — and (c) leaves a durable journal from which the report
    CLI names the victim rank. Asserted:

    1. every survivor reaches the target step at world ``procs - 1``;
    2. ``conservation_error <= 1%`` on EVERY rank's decomposition;
    3. every rank that reset booked ``rendezvous_recovery`` in
       ``(0, wall)``;
    4. the victim's ``straggler_wait`` brackets the injected delay total
       (loose CPU-box bounds; the exact total comes from the injection
       ledger, not the plan);
    5. the step watchdog's cross-rank naming reached the goodput ledger:
       some survivor's snapshot carries ``straggler_named == victim``;
    6. the run journal is durable and complete (``run_end`` present) and
       ``python -m horovod_tpu_torch.goodput.report`` renders it, naming
       ``victim: rank <straggler_rank>``.
    """
    import io
    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="hvd_goodput_soak_")
    os.makedirs(workdir, exist_ok=True)
    kill_rank, plan_dict = goodput_badput_plan(
        procs, seed, steps, straggler_rank=straggler_rank,
        delay_ms=delay_ms)
    plan_path = os.path.join(workdir, "plan.yaml")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)
    ledger_dir = os.path.join(workdir, "ledger")
    history_dir = os.path.join(workdir, "run_history")
    goodput_dir = os.path.join(workdir, "goodput")
    _progress("goodput soak start", procs=procs, steps=steps,
              kill_rank=kill_rank, straggler_rank=straggler_rank)
    try:
        results = _elastic_run(steps, procs, procs - 1, workdir, {
            "HOROVOD_CHAOS_PLAN": plan_path,
            "HOROVOD_CHAOS_SEED": str(seed),
            "HOROVOD_CHAOS_LEDGER": ledger_dir,
            "HOROVOD_FLIGHT_DIR": os.path.join(workdir, "flight"),
            "HOROVOD_GOODPUT": "1",
            "HOROVOD_GOODPUT_DIR": goodput_dir,
            "HOROVOD_RUN_HISTORY_DIR": history_dir,
            "HOROVOD_GOODPUT_JOURNAL_S": "2",
            # Watchdog publish rounds every 2 steps (cross-rank straggler
            # naming) + live telemetry beacons (per-rank goodput rows in
            # the journaled cluster view).
            "HOROVOD_PROFILE_PUBLISH_STEPS": "2",
            "HOROVOD_TELEMETRY_INTERVAL": "0.5",
        })
    finally:
        from horovod_tpu_torch import chaos
        chaos.uninstall()
    survivors = procs - 1
    # (1) elastic recovery held.
    assert all(r["steps"] == steps for r in results), \
        f"goodput soak fell short of {steps} steps: {results}"
    assert all(r["final_world"] == survivors for r in results), results
    by_rank = {r["cross_rank"]: r for r in results}
    # The injected straggler total from the injection ledger — the exact
    # count of delay fires, not the plan's intent (a fire suppressed by
    # the recovery window would silently shrink the bracket's target).
    from horovod_tpu_torch.chaos import injector
    entries = injector.read_ledger(ledger_dir)
    delays = [e for e in entries if e["kind"] == "delay"]
    assert delays, f"straggler never fired: {entries}"
    injected_s = len(delays) * delay_ms / 1e3
    # (2) conservation on every rank.
    for r in results:
        gp = r["goodput"]
        assert gp.get("enabled"), f"goodput off on r{r['cross_rank']}"
        assert gp["conservation_error"] <= 0.01, \
            f"conservation violated on r{r['cross_rank']}: {gp}"
    # (3) recovery badput on every reset rank.
    for r in results:
        if r["resets"]:
            rr = r["goodput"]["categories"]["rendezvous_recovery"]
            assert 0.0 < rr < r["goodput"]["wall_s"], \
                (r["cross_rank"], r["goodput"])
    # (4) the victim's straggler_wait brackets the injected total. Lower
    # bound: at least 3 full-delay steps booked before the victim's own
    # rolling median adapts to the elevated window. Upper: generous
    # CPU-contention slack — the wait must still be the same order as
    # the injection, not the whole run.
    wait = by_rank[straggler_rank]["goodput"]["categories"][
        "straggler_wait"]
    lower = 3 * delay_ms / 1e3
    upper = 3.0 * injected_s + 2.0
    assert lower <= wait <= upper, \
        f"victim straggler_wait {wait:.3f}s outside " \
        f"[{lower:.3f}, {upper:.3f}] for {injected_s:.3f}s injected"
    # (5) the comparative (watchdog) naming reached the ledger.
    named = {r["cross_rank"]: r["goodput"].get("straggler_named")
             for r in results}
    assert any(v == straggler_rank for v in named.values()), \
        f"no survivor's watchdog named r{straggler_rank}: {named}"
    # (6) durable journal + report CLI naming.
    from horovod_tpu_torch.goodput import report as goodput_report
    from horovod_tpu_torch.goodput.history import read_runs
    runs = read_runs(history_dir)
    assert runs, f"no run journal under {history_dir}"
    rid = sorted(runs, key=lambda r: runs[r].get("t0") or 0)[-1]
    summary = runs[rid]
    assert summary.get("ended"), \
        f"journal {rid} has no run_end marker: {summary['records']} recs"
    victim = goodput_report.find_victim(summary)
    assert victim is not None and int(victim[0]) == straggler_rank, \
        f"report blamed {victim}, expected rank {straggler_rank}"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = goodput_report.main(["--dir", history_dir])
    rendered = buf.getvalue()
    assert rc == 0 and f"victim: rank {straggler_rank}" in rendered, \
        rendered
    _progress("goodput soak done", ok=True, injected_s=injected_s,
              straggler_wait=round(wait, 3), named=named)
    return {"procs": procs, "steps": steps, "kill_rank": kill_rank,
            "straggler_rank": straggler_rank, "injected_s": injected_s,
            "straggler_wait_s": wait, "named": named, "run_id": rid,
            "report": rendered, "results": results, "workdir": workdir}


def run_soak(procs=8, steps=8, seed=123, workdir=None, plan_dict=None,
             loss_tol=1e-5, reruns=1):
    """Run clean + chaos (+ ``reruns`` same-seed repeats), assert the
    invariants, and return the evidence dict. Raises AssertionError with
    the failing invariant."""
    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="hvd_chaos_soak_")
    os.makedirs(workdir, exist_ok=True)
    plan_dict = plan_dict or default_plan(procs=procs, seed=seed)
    plan_dict["seed"] = seed
    plan_path = os.path.join(workdir, "plan.yaml")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)    # JSON is valid YAML
    budget = plan_kill_budget(plan_dict)
    evidence = {"procs": procs, "steps": steps, "seed": seed,
                "plan": plan_dict, "kill_budget": budget,
                "workdir": workdir}

    min_np = max(procs - budget, 1)

    try:
        return _run_soak_inner(procs, steps, seed, workdir, plan_dict,
                               plan_path, budget, min_np, loss_tol,
                               reruns, evidence)
    finally:
        # The elastic DRIVER runs in this process and armed the plan from
        # the scoped env — the caller (a pytest process, a notebook) must
        # not inherit a live injector.
        from horovod_tpu_torch import chaos
        chaos.uninstall()


def _run_soak_inner(procs, steps, seed, workdir, plan_dict, plan_path,
                    budget, min_np, loss_tol, reruns, evidence):
    _progress("soak clean run start", procs=procs, steps=steps)
    clean = _elastic_run(steps, procs, min_np, workdir, {})
    _progress("soak clean run done", hosts=len(clean))
    assert all(r["steps"] == steps for r in clean), \
        f"clean run fell short of {steps} steps: {clean}"
    clean_w = clean[0]["w"]
    evidence["clean_w"] = clean_w

    schedules = []
    for attempt in range(1 + reruns):
        ledger_dir = os.path.join(workdir, f"ledger_{attempt}")
        flight_dir = os.path.join(workdir, f"flight_{attempt}")
        _progress("soak chaos run start", attempt=attempt)
        results = _elastic_run(steps, procs, min_np, workdir, {
            "HOROVOD_CHAOS_PLAN": plan_path,
            "HOROVOD_CHAOS_SEED": str(seed),
            "HOROVOD_CHAOS_LEDGER": ledger_dir,
            # Archive the chaos leg's flight dumps under the workdir: the
            # victim's chaos_crash dump, every survivor's internal-error /
            # membership-abort dump, and the driver's disruption marker
            # land in one analyzable directory.
            "HOROVOD_FLIGHT_DIR": flight_dir,
        })
        from horovod_tpu_torch.chaos import injector
        entries = injector.read_ledger(ledger_dir)
        schedules.append(injector.ledger_schedule(entries))
        _progress("soak chaos run done", attempt=attempt,
                  hosts=len(results), injections=len(entries))
        if attempt == 0:
            evidence["chaos_results"] = results
            evidence["ledger"] = entries
            # (1) the run survived to the target step
            assert all(r["steps"] == steps for r in results), \
                f"chaos run fell short of {steps} steps: {results}"
            # (2) loss/weight parity with the clean run
            import numpy as np
            np.testing.assert_allclose(
                [r["w"] for r in results],
                [clean_w] * len(results), atol=loss_tol,
                err_msg="recovery was not loss-neutral vs the clean run")
            # (3) resets within the kill budget, and the membership
            # actually shrank by the killed workers
            for r in results:
                assert r["resets"] <= budget, \
                    f"worker r{r['cross_rank']} reset {r['resets']}x " \
                    f"(> kill budget {budget}): flapping recovery"
            assert all(r["final_world"] == procs - budget
                       for r in results), results
            # (4) recovering workers populated the recovery histogram
            recovered = [r for r in results if r["resets"]]
            assert recovered and all(r["recoveries"] >= 1
                                     for r in recovered), \
                f"elastic_recovery_seconds not populated: {results}"
            # (4b) goodput conservation on every rank, clean AND chaos
            # legs — the decomposition must account the full wall within
            # 1% no matter how the run was disrupted — and every
            # recovering worker booked rendezvous_recovery badput.
            for r in clean + results:
                gp = r.get("goodput") or {}
                if not gp.get("enabled"):
                    continue
                assert gp["conservation_error"] <= 0.01, \
                    f"goodput conservation violated on " \
                    f"r{r['cross_rank']}: {gp}"
            for r in recovered:
                gp = r.get("goodput") or {}
                if not gp.get("enabled"):
                    continue
                assert gp["categories"]["rendezvous_recovery"] > 0.0, \
                    f"r{r['cross_rank']} reset {r['resets']}x but booked " \
                    f"no rendezvous_recovery: {gp['categories']}"
            # the injected kill actually fired (exactly once)
            kills = [e for e in entries if e["kind"] == "crash"]
            assert len(kills) == budget, entries
            # (6) the flight forensics localize the kill: merge the per-
            # rank dumps the failure left behind and check the analyzer
            # names the killed rank, the first unmatched collective seq,
            # and the injection that caused it — "it recovered" AND "the
            # forensics say why".
            evidence["flight_report"] = _assert_flight_forensics(
                flight_dir, ledger_dir, kills, procs)
    # (5) same seed ⇒ identical ledger schedule
    for i, sched in enumerate(schedules[1:], 1):
        assert sched == schedules[0], (
            f"ledger schedule diverged between same-seed runs 0 and {i}:\n"
            f"{schedules[0]}\nvs\n{sched}")
    evidence["ledger_deterministic"] = len(schedules) > 1
    _progress("soak done", ok=True)
    return evidence


def main(argv=None):
    """``python -m horovod_tpu_torch.chaos.soak --worker STEPS``: one soak
    worker under the elastic launcher (CPU, gloo)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] != "--worker":
        print("usage: python -m horovod_tpu_torch.chaos.soak --worker STEPS",
              file=sys.stderr)
        return 2
    report_result(soak_train(int(argv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
