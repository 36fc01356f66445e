"""Serving request: the unit the continuous-batching engine schedules.

Port of the JAX package's ``serving/request.py``, line for line: the same
states, the same ``snapshot``/``identity`` dicts, so a snapshot taken in
one package loads in the other.

A request is host-side bookkeeping only — prompt token ids in, generated
token ids out — so the scheduler and the elastic requeue story stay pure
python (fast tier-1 testable, picklable into an elastic commit). The
engine owns every device interaction.

The elastic contract rides on ``committed``: tokens the engine has
sampled AND the caller's elastic state has committed. After a disruption
the request re-enters the queue with ``prompt + committed`` as its
effective prompt (:meth:`full_tokens`) — decoding resumes from the last
committed token, never from scratch and never skipping ahead, which is
what makes a rolling restart drop zero in-flight requests (greedy
decoding then reproduces the exact token stream of an undisturbed run;
sampled decoding reproduces it too because draws are keyed on
``(seed, position)``, see :meth:`draw`).
"""

import itertools
import threading
import time

from horovod_tpu_torch import trace

QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
REJECTED = "rejected"

_rid_counter = itertools.count()


class Request:
    """One generation request.

    ``prompt``: list/array of int token ids (at least one).
    ``max_new``: generation budget AFTER the prompt.
    ``temperature`` 0 = greedy; otherwise a categorical draw keyed on
    ``(seed, position)`` so a requeued request re-draws the same tokens.
    ``eos_id``: generation stops when the engine samples it (the EOS
    itself is committed, matching ``models.generate``'s semantics).
    """

    def __init__(self, prompt, max_new, temperature=0.0, top_k=0,
                 top_p=1.0, eos_id=None, seed=0, rid=None, tid=None):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError(f"need top_k >= 0 and 0 < top_p <= 1, got "
                             f"top_k={top_k}, top_p={top_p}")
        self.rid = rid if rid is not None else next(_rid_counter)
        # Trace id: minted at admission, carried through every elastic
        # snapshot/restore so the span tree stays ONE trace across
        # disruptions (horovod_tpu_torch/trace).
        self.tid = tid if tid is not None else trace.mint("request")
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.seed = int(seed)
        self.committed = []          # generated tokens, oldest first
        self.state = QUEUED
        self.requeues = 0
        self.t_submit = time.monotonic()
        self.t_first = None          # first generated token commit
        self.t_done = None
        # Wall-clock twins for the trace layer: monotonic stamps cannot
        # cross processes, and the span tree is wall-time based. t_queued
        # restarts at every (re)entry into the admission queue — it is
        # the start of the CURRENT incarnation's queue span.
        self.t_wall = time.time()
        self.t_queued = self.t_wall
        self._done = threading.Event()

    # --- engine-side transitions ---------------------------------------

    def full_tokens(self):
        """prompt + committed — the effective prompt after a requeue."""
        return self.prompt + self.committed

    def remaining(self):
        return self.max_new - len(self.committed)

    def commit_token(self, tok):
        """Record one generated token; returns True when the request is
        finished (EOS sampled or budget exhausted)."""
        self.committed.append(int(tok))
        if self.t_first is None:
            self.t_first = time.monotonic()
        return (self.eos_id is not None and int(tok) == self.eos_id) \
            or len(self.committed) >= self.max_new

    def finish(self):
        self.state = DONE
        self.t_done = time.monotonic()
        self._done.set()

    def reject(self):
        self.state = REJECTED
        self._done.set()

    # --- caller-side API ------------------------------------------------

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until finished; returns prompt + generated tokens.
        Raises on rejection (queue full) or timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done "
                               f"after {timeout}s")
        if self.state == REJECTED:
            raise RuntimeError(f"request {self.rid} rejected (queue full)")
        return self.full_tokens()

    # --- elastic snapshot ------------------------------------------------

    def identity(self):
        """Everything that determines the request's token stream — the
        rid-collision check must compare ALL of it: rids are
        process-local counters, and two workers' unrelated requests can
        share a rid AND a prompt while differing in budget or sampling
        params."""
        return (tuple(self.prompt), self.max_new, self.temperature,
                self.top_k, self.top_p, self.eos_id, self.seed)

    @staticmethod
    def snapshot_identity(rs):
        """:meth:`identity` of a :meth:`snapshot` dict."""
        return (tuple(int(t) for t in rs["prompt"]), int(rs["max_new"]),
                float(rs["temperature"]), int(rs["top_k"]),
                float(rs["top_p"]),
                None if rs["eos_id"] is None else int(rs["eos_id"]),
                int(rs["seed"]))

    def snapshot(self):
        """Picklable state for an elastic commit (threading.Event and
        timestamps stay process-local)."""
        return {"rid": self.rid, "tid": self.tid, "t0": self.t_wall,
                "prompt": list(self.prompt),
                "max_new": self.max_new, "temperature": self.temperature,
                "top_k": self.top_k, "top_p": self.top_p,
                "eos_id": self.eos_id, "seed": self.seed,
                "committed": list(self.committed),
                "requeues": self.requeues}

    def restore_committed(self, committed):
        """Roll generated tokens back/forward to an elastic snapshot's
        committed list (restore after a failed step group)."""
        self.committed = [int(t) for t in committed]
        if not self.committed:
            # Rolled back past the first generated token: the next first
            # commit is the user-visible first token again, so TTFT must
            # re-measure through the disruption — a stale pre-rollback
            # timestamp would understate the post-disruption SLO.
            self.t_first = None
