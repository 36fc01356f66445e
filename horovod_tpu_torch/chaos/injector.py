"""Process-local fault-injection runtime.

Port of the JAX package's ``chaos/injector.py``. Instrumented modules guard
each named site with one module-attribute check, ``if _chaos.armed:
_chaos.fire("site.name")``, so the disabled path costs one bool read. When a
plan is armed, ``fire`` evaluates the plan's triggers for the site (a pure
function of seed, spec, call count, step clock and rank, see
:mod:`horovod_tpu_torch.chaos.plan`), and on a match records the injection
(``chaos_injections_total{site,kind}``, a ``chaos`` event in the flight
ring, a line of the per-rank JSONL ledger) before applying the effect:

- ``delay``    sleep ``delay_ms`` (straggler, stall)
- ``drop``     raise ``URLError(ConnectionResetError)`` (KV transport)
- ``http_5xx`` raise ``HTTPError(500)`` (KV server fault)
- ``crash``    ``os._exit(exit_code)`` (hard worker death, no cleanup)
- ``hang``     sleep ``hang_s`` (a wedged worker)
- ``host_remove`` applied by :func:`filter_hosts` on the elastic driver's
  discovery poll (a simulated host preemption)

The ledger is the reproducibility artifact: one JSON line per injection
(role, rank, site, kind, spec index, per-spec fire index, step, call count,
timestamp), in ``HOROVOD_CHAOS_LEDGER`` (default ``./chaos_ledgers``).
Running the same plan and seed over the same workload again gives the same
schedule: :func:`ledger_schedule` strips the fields that vary (timestamp,
pid, the raw call count).

Installation is idempotent per process and survives ``hvd.shutdown()`` /
``hvd.init()`` cycles (an elastic re-init must not reset the site counters
mid-plan); a changed ``HOROVOD_CHAOS_PLAN`` installs anew. A process's rank
is ``HOROVOD_RANK`` (one process per device in the port).
"""

import json
import os
import threading
import time

from horovod_tpu_torch.chaos.plan import ChaosPlan
from horovod_tpu_torch.flight import recorder as _flight

# The one-word hot-path gate. Module attribute, not a function call: sites
# read ``injector.armed`` and skip everything else when False.
armed = False

_plan = None
_installed_env = None          # the env string install_from_env consumed
_lock = threading.RLock()
_site_counts = {}
_spec_fires = {}               # spec idx -> fire count
_step_fired = set()            # (spec idx, step) pairs already fired
_remove_started = set()        # host_remove spec idxs already ledgered
_step = None                   # step clock (last committed step)
_role = "worker"
_ledger_fh = None
_ledger_path = None

DEFAULT_LEDGER_DIR = "chaos_ledgers"


def plan():
    return _plan


def set_role(role):
    """Tag this process's ledger entries (``worker`` / ``driver``)."""
    global _role
    _role = role


def set_step(step):
    """Advance the step clock used by ``at_step`` triggers. Wired to
    ``State.commit`` (the elastic step boundary); a training loop may also
    set it explicitly."""
    global _step
    if step is not None:
        _step = int(step)


def install(plan_obj):
    """Arm ``plan_obj`` in this process, resetting all counters/ledger
    state (a fresh schedule)."""
    global armed, _plan, _ledger_fh, _ledger_path, _step
    with _lock:
        _close_ledger()
        _plan = plan_obj
        _site_counts.clear()
        _spec_fires.clear()
        _step_fired.clear()
        _remove_started.clear()
        _step = None
        armed = _plan is not None and len(_plan) > 0


def uninstall():
    global armed, _plan, _installed_env, _role
    with _lock:
        armed = False
        _plan = None
        _installed_env = None
        # Role reverts to the default with the plan: an in-process elastic
        # driver run set "driver", and leaving it would mislabel every later
        # same-process workload's ledger entries.
        _role = "worker"
        _ledger_dir_override[0] = None
        _close_ledger()


def install_from_env(env=None):
    """Arm the plan named by ``HOROVOD_CHAOS_PLAN`` in ``env`` (default the
    process environment), if any. Idempotent: an unchanged env string is a
    no-op (elastic re-init calls ``hvd.init`` again in the same process and
    must not reset mid-plan counters); a changed one re-installs. Never
    touches a plan armed directly via :func:`install`."""
    global _installed_env
    env = os.environ if env is None else env
    raw = env.get("HOROVOD_CHAOS_PLAN", "")
    with _lock:
        if not raw:
            if _installed_env is not None:
                # A plan previously armed FROM THE ENV whose env was since
                # cleared: the operator's next run believes it is
                # chaos-free, so disarm — a stale crash spec with budget
                # left must not fire into it. Plans armed directly via
                # install() have no _installed_env and are untouched.
                uninstall()
            return
        # The ledger dir is part of the key: a worker's in-place elastic
        # re-init sees an unchanged env (no reset — counters must
        # survive), but a long-lived DRIVER process hosting several runs
        # of the same plan+seed (the soak's same-seed re-run) gets a new
        # ledger dir per run and must start a fresh schedule — otherwise
        # its site counters run on past trigger windows and its ledger
        # file handle keeps pointing at the previous run's directory.
        key = "\x00".join((raw, env.get("HOROVOD_CHAOS_SEED", ""),
                           env.get("HOROVOD_CHAOS_LEDGER", "")))
        if key == _installed_env:
            return
        plan_obj = ChaosPlan.from_env(env)
        install(plan_obj)
        _installed_env = key
        _ledger_dir_override[0] = env.get("HOROVOD_CHAOS_LEDGER") or None


def _rank():
    try:
        return int(os.environ.get("HOROVOD_RANK", "0") or 0)
    except ValueError:
        return 0


def _decide(site, step):
    """Evaluate the site's specs for this call; returns the matched spec
    (first match wins) after recording it, or None. Runs under _lock."""
    p = _plan
    if p is None:
        return None
    n = _site_counts.get(site, 0)
    _site_counts[site] = n + 1
    eff_step = step if step is not None else _step
    rank = _rank()
    for idx, spec in p.by_site.get(site, ()):
        fires = _spec_fires.get(idx, 0)
        if spec.matches(n, eff_step, rank, p.seed, idx, fires, _step_fired):
            _spec_fires[idx] = fires + 1
            if spec.at_step is not None:
                _step_fired.add((idx, eff_step))
            _record(site, spec, idx, fires, n, eff_step, rank)
            return spec
    return None


def fire(site, step=None, url=None):
    """Evaluate and apply this site call's injection, if any. The effect
    (sleep / raise / exit) runs OUTSIDE the lock so a long stall on one
    thread never blocks another thread's trigger evaluation."""
    if step is not None:
        set_step(step)
    with _lock:
        spec = _decide(site, step)
    if spec is not None:
        _apply(spec, url=url)


def filter_hosts(site, hosts):
    """Driver-side ``host_remove`` application: every discovery poll is one
    site call; a spec whose window ``[at, at + duration)`` covers the call
    drops its victim from the returned host dict (simulated preemption —
    the elastic driver then reassigns exactly as for a real removal). The
    ledger records one entry per window, at entry."""
    if _plan is None:
        return hosts
    with _lock:
        n = _site_counts.get(site, 0)
        _site_counts[site] = n + 1
        out = hosts
        for idx, spec in _plan.by_site.get(site, ()):
            if spec.kind != "host_remove":
                continue
            start = spec.at[0] if spec.at else 0
            if not (start <= n < start + spec.duration):
                continue
            victim = spec.host
            if victim is None:
                names = sorted(hosts)
                if not (0 <= spec.host_index < len(names)):
                    continue
                victim = names[spec.host_index]
            if victim not in out:
                continue
            if out is hosts:
                out = dict(hosts)
            out.pop(victim, None)
            if idx not in _remove_started:
                _remove_started.add(idx)
                fires = _spec_fires.get(idx, 0)
                _spec_fires[idx] = fires + 1
                _record(site, spec, idx, fires, n, _step, _rank(),
                        host=victim)
        return out


def _apply(spec, url=None):
    kind = spec.kind
    if kind == "delay":
        time.sleep(spec.delay_ms / 1000.0)
    elif kind == "drop":
        from urllib import error as urlerror
        raise urlerror.URLError(ConnectionResetError(
            "chaos: injected KV connection reset"))
    elif kind == "http_5xx":
        import io
        from urllib import error as urlerror
        raise urlerror.HTTPError(url or "chaos://injected", 500,
                                 "chaos: injected server error", None,
                                 io.BytesIO(b""))
    elif kind == "crash":
        # Hard death with no interpreter cleanup, the way a preempted or
        # OOM-killed process vanishes. Last words: the victim's ring (which
        # already holds this injection: _record ran under _decide) reaches
        # disk before os._exit skips every atexit.
        _flight.dump("chaos_crash", force=True)
        os._exit(spec.exit_code)
    elif kind == "hang":
        time.sleep(spec.hang_s)
    # host_remove is applied by filter_hosts, never as a call effect.


# --- ledger ---------------------------------------------------------------

# The ledger directory of a plan installed from an env mapping other than
# the process's (the elastic driver's flags).
_ledger_dir_override = [None]


def _ledger_dir():
    return _ledger_dir_override[0] \
        or os.environ.get("HOROVOD_CHAOS_LEDGER") or DEFAULT_LEDGER_DIR


def _ledger_file():
    global _ledger_fh, _ledger_path
    if _ledger_fh is not None:
        return _ledger_fh
    d = _ledger_dir()
    os.makedirs(d, exist_ok=True)
    _ledger_path = os.path.join(
        d, f"{_role}_r{_rank()}_p{os.getpid()}.jsonl")
    _ledger_fh = open(_ledger_path, "a")
    return _ledger_fh


def _close_ledger():
    global _ledger_fh, _ledger_path
    if _ledger_fh is not None:
        try:
            _ledger_fh.close()
        except OSError:
            pass
    _ledger_fh = None
    _ledger_path = None


def ledger_path():
    return _ledger_path


def _record(site, spec, idx, fire_idx, n, step, rank, **extra):
    from horovod_tpu_torch.metrics import instruments as _metrics
    _metrics.record_chaos(site, spec.kind)
    if _flight.armed:
        # Mirrored into the flight ring so a single per-rank dump carries
        # the injection AND its downstream anomaly in one timeline (the
        # analyzer's causation pass works from either source).
        _flight.record_event("chaos", name=site, what=spec.kind, seq=step)
    entry = {"role": _role, "rank": rank, "site": site, "kind": spec.kind,
             "spec": idx, "fire": fire_idx, "n": n, "step": step,
             "ts": round(time.time(), 3)}
    entry.update(extra)
    try:
        fh = _ledger_file()
        fh.write(json.dumps(entry) + "\n")
        fh.flush()
    except OSError:
        pass                    # the ledger must never fail the workload


def read_ledger(directory=None):
    """All injection entries under ``directory`` (every process's file),
    in stable (rank, site, spec, fire) order."""
    d = directory or _ledger_dir()
    entries = []
    if not os.path.isdir(d):
        return entries
    for name in sorted(os.listdir(d)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(d, name)) as f:
            for line in f:
                line = line.strip()
                if line:
                    entries.append(json.loads(line))
    entries.sort(key=lambda e: (e.get("rank", 0), e.get("site", ""),
                                e.get("spec", 0), e.get("fire", 0)))
    return entries


def ledger_schedule(entries):
    """The deterministic projection of a ledger: what fired, where, for
    whom, at which step/fire index, with timestamps and the raw call count
    (which varies with KV polling cadence) stripped. Two runs of the same
    plan and seed over the same workload give equal schedules."""
    sched = []
    for e in entries:
        sched.append((e.get("role"), e.get("rank"), e.get("site"),
                      e.get("kind"), e.get("spec"), e.get("fire"),
                      e.get("step"), e.get("host")))
    return sched


def stats():
    """Per-spec fire counts + per-site call counts (this process)."""
    with _lock:
        return {"fires": dict(_spec_fires), "sites": dict(_site_counts),
                "armed": armed}
