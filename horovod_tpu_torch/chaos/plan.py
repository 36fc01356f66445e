"""Declarative, seeded fault plans.

Port of the JAX package's ``chaos/plan.py``: the same ``FaultSpec`` fields,
trigger rules, ``TriggerCursor`` and ``ChaosPlan`` (de)serialization, so the
same plan and seed fire the same faults in both packages. A
:class:`ChaosPlan` is a list of :class:`FaultSpec` entries (a ``kind`` of
fault at a ``site`` of the stack under a trigger) plus a seed that makes the
probabilistic triggers reproducible. Plans come from JSON text, a file path,
or the ``HOROVOD_CHAOS_PLAN`` / ``HOROVOD_CHAOS_SEED`` environment (the
launcher's ``hvdrun-torch --chaos-plan`` sets them on every worker). JSON is
parsed with the standard library; a YAML plan needs PyYAML, and a machine
without it refuses one with a message that says to write the plan as JSON.

Determinism: every trigger decision is a pure function of ``(seed, spec
index, site call count, step clock, rank)``, never of wall-clock time or of
a sequential RNG stream, so two runs that make the same site calls fire the
same faults.

Plan format (JSON; YAML with PyYAML)::

    {"seed": 42,
     "faults": [
       {"site": "http_kv.request", "kind": "drop", "at": [0, 1]},
       {"site": "elastic.commit", "kind": "crash", "rank": 5,
        "at_step": [3], "max_fires": 1}]}

Triggers (AND-combined; at least one required):

- ``at``:      fire when the site's call count is in the list
- ``every``:   fire when ``count % every == 0``
- ``after``:   gate, only counts >= after are eligible
- ``p``:       fire with probability p, decided by a counter-hash of
               ``(seed, spec, count)`` (deterministic, order-free)
- ``at_step``: fire when the step clock is in the list, at most once per
               (spec, step), so a step that makes many site calls yields
               exactly one injection

Scoping and budget: ``rank`` (the process's rank, ``HOROVOD_RANK``: one
process drives one device in the port), ``max_fires``.

Kind parameters: ``delay_ms`` (delay), ``exit_code`` (crash), ``hang_s``
(hang), ``duration`` with ``host``/``host_index`` (host_remove, on the
elastic driver's discovery polls).
"""

import dataclasses
import hashlib
import json
import os

# What can go wrong. ``drop``/``http_5xx`` model KV transport faults and
# only make sense on the HTTP-KV site; ``host_remove`` is a driver-side
# membership fault (simulated preemption); the rest apply anywhere.
KINDS = ("drop", "delay", "http_5xx", "crash", "hang", "host_remove")

# Named injection sites wired through the stack.
SITES = (
    "http_kv.request",        # runner/http_kv.py KVStoreClient, per attempt
    "negotiation.exchange",   # common/negotiation.py exchange()
    "collective.dispatch",    # ops/collective_ops.py _dispatch_op
    "fusion.flush",           # ops/fusion.py bucket flush
    "elastic.commit",         # elastic/state.py State.commit (step boundary)
    "elastic.rendezvous",     # elastic/worker.py scale-up barrier
    "driver.discovery",       # runner/elastic/driver.py discovery poll
    "telemetry.tick",         # telemetry/aggregator.py aggregation round
)

_SITE_ONLY = {
    "drop": ("http_kv.request",),
    "http_5xx": ("http_kv.request",),
    "host_remove": ("driver.discovery",),
}


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str
    # --- triggers (AND-combined; at least one required) ---
    at: tuple = None            # site-call indices (0-based)
    every: int = None           # count % every == 0
    after: int = 0              # eligibility gate on the count
    p: float = None             # counter-hash probability
    at_step: tuple = None       # step-clock values (once per spec+step)
    # --- scoping / budget ---
    rank: int = None            # cross-rank scope (None = every rank)
    max_fires: int = None       # total firing budget for this spec
    # --- kind parameters ---
    delay_ms: float = 10.0
    exit_code: int = 1
    hang_s: float = 3600.0
    duration: int = 1           # host_remove: window length in polls
    host: str = None            # host_remove: victim hostname...
    host_index: int = None      # ...or index into the sorted host list
    note: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown chaos site {self.site!r} (sites: {SITES})")
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r} (kinds: {KINDS})")
        only = _SITE_ONLY.get(self.kind)
        if only and self.site not in only:
            raise ValueError(
                f"kind {self.kind!r} applies only at site(s) {only}, "
                f"not {self.site!r}")
        if self.at is not None:
            self.at = tuple(int(x) for x in self.at)
        if self.at_step is not None:
            self.at_step = tuple(int(x) for x in self.at_step)
        if self.p is not None and not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"p={self.p} must be a probability")
        if self.kind == "host_remove":
            if self.at is None:
                raise ValueError("host_remove needs an `at` poll index")
            if self.host is None and self.host_index is None:
                raise ValueError(
                    "host_remove needs `host` or `host_index`")
        elif self.at is None and self.every is None and self.p is None \
                and self.at_step is None:
            raise ValueError(
                f"spec {self.kind}@{self.site} has no trigger "
                "(one of at/every/p/at_step is required)")

    def matches(self, n, step, rank, seed, spec_idx, fires, step_fired):
        """Pure trigger decision for site call ``n`` (see the module
        docstring's determinism contract). ``step_fired`` is the set of
        (spec_idx, step) pairs already fired — at_step specs fire at most
        once per step."""
        if self.rank is not None and rank != self.rank:
            return False
        if self.max_fires is not None and fires >= self.max_fires:
            return False
        if n < self.after:
            return False
        if self.at_step is not None:
            if step is None or step not in self.at_step:
                return False
            if (spec_idx, step) in step_fired:
                return False
        if self.at is not None and n not in self.at:
            return False
        if self.every is not None and n % self.every != 0:
            return False
        if self.p is not None and _unit(seed, spec_idx, n) >= self.p:
            return False
        return True


def _unit(seed, spec_idx, n):
    """Deterministic uniform [0, 1) from (seed, spec, count): a keyed hash,
    not a sequential RNG draw, so the decision for call ``n`` is the same
    regardless of thread interleaving or what other sites fired."""
    h = hashlib.blake2b(f"{seed}:{spec_idx}:{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


class TriggerCursor:
    """The bookkeeping half of the determinism contract, reusable outside
    the process-level injector: per-(site, rank) call counters, per-spec
    firing budgets and the (spec, step) once-per-step set, driving
    :meth:`FaultSpec.matches` — which stays the single trigger decision.
    The in-process :mod:`~horovod_tpu_torch.chaos.injector` keeps its own
    per-process counters (one process is one rank); a host of many virtual
    ranks in one process needs rank-keyed counters, which this class
    keeps. Purely deterministic: the same plan and call sequence give the
    same verdicts, with no wall clock and no RNG stream."""

    def __init__(self, plan):
        self.plan = plan
        self._counts = {}       # (site, rank) -> site call count
        self._fires = {}        # spec idx -> total fires
        self._step_fired = set()
        self.log = []           # (site, rank, step, n, kind) fired log

    def decide(self, site, rank, step=None):
        """Advance the (site, rank) call counter and return the list of
        :class:`FaultSpec` entries that fire for this call."""
        if self.plan is None:
            return []
        specs = self.plan.by_site.get(site)
        n = self._counts.get((site, rank), 0)
        self._counts[(site, rank)] = n + 1
        if not specs:
            return []
        fired = []
        for idx, spec in specs:
            if not spec.matches(n, step, rank, self.plan.seed, idx,
                                self._fires.get(idx, 0),
                                self._step_fired):
                continue
            self._fires[idx] = self._fires.get(idx, 0) + 1
            if spec.at_step is not None and step is not None:
                self._step_fired.add((idx, step))
            fired.append(spec)
            self.log.append((site, rank, step, n, spec.kind))
        return fired


class ChaosPlan:
    def __init__(self, faults, seed=0, note=""):
        self.faults = list(faults)
        self.seed = int(seed)
        self.note = note
        self.by_site = {}
        for i, spec in enumerate(self.faults):
            self.by_site.setdefault(spec.site, []).append((i, spec))

    def __len__(self):
        return len(self.faults)

    def to_dict(self):
        # Omit only fields still at their DEFAULT — a plain falsy test
        # would silently strip meaningful zeros (rank: 0 would un-scope a
        # coordinator-targeted fault to every rank; host_index: 0 would
        # make a host_remove spec unparseable).
        defaults = {f.name: f.default for f in dataclasses.fields(FaultSpec)}
        return {"seed": self.seed, "note": self.note,
                "faults": [
                    {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in dataclasses.asdict(s).items()
                     if v != defaults[k] or k in ("site", "kind")}
                    for s in self.faults]}

    @classmethod
    def from_dict(cls, d):
        if not isinstance(d, dict) or "faults" not in d:
            raise ValueError(
                "chaos plan must be a mapping with a `faults` list")
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        faults = []
        for entry in d["faults"] or []:
            unknown = set(entry) - known
            if unknown:
                raise ValueError(
                    f"unknown chaos spec field(s) {sorted(unknown)} "
                    f"(known: {sorted(known)})")
            faults.append(FaultSpec(**entry))
        return cls(faults, seed=d.get("seed", 0), note=d.get("note", ""))

    @classmethod
    def from_json(cls, text):
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_yaml(cls, text):
        """A plan from JSON or YAML text. JSON needs nothing beyond the
        standard library; YAML needs PyYAML, and without it the error says
        to write the plan as JSON."""
        try:
            return cls.from_json(text)
        except json.JSONDecodeError:
            pass
        try:
            import yaml
        except ImportError:
            raise ValueError(
                "chaos plan is not JSON, and PyYAML is not installed on this "
                "machine to read it as YAML: write the plan as JSON "
                "(HOROVOD_CHAOS_PLAN / --chaos-plan)") from None
        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def from_env(cls, env=None):
        """Plan from ``HOROVOD_CHAOS_PLAN`` (a file path or inline JSON or
        YAML) with ``HOROVOD_CHAOS_SEED`` overriding the plan's seed.
        Returns None when no plan is configured."""
        env = env if env is not None else os.environ
        raw = env.get("HOROVOD_CHAOS_PLAN", "")
        if not raw:
            return None
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        plan = cls.from_yaml(raw)
        seed = env.get("HOROVOD_CHAOS_SEED")
        if seed is not None:
            plan.seed = int(seed)
        return plan
