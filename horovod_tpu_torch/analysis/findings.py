"""Finding model shared by the program analyzer and the codebase linter.

Port of the JAX package's ``analysis/findings.py``, the same dataclass and
codes. The port has the linter (:mod:`horovod_tpu_torch.analysis.lint`)
and the lock-graph analyzer (:mod:`horovod_tpu_torch.analysis.race`); the
``HVP1xx`` codes below are the program checker's, which the port does not
have yet.

Every program-analysis finding carries the same ``(op, ps, seq, sig)``
identity the flight recorder stamps on each dispatch event
(:mod:`horovod_tpu_torch.flight.recorder`), so a runtime desync from
``flight.analyze`` can be matched against the static prediction (and vice
versa) without any joining heuristics.

Program-analysis codes (``HVP1xx``):

- ``HVP101`` rank_gated_collective — a collective dispatched by a strict
  subset of ranks (count mismatch per process set); the deadlock class.
- ``HVP102`` order_mismatch — same collectives, different cross-rank order.
- ``HVP103`` signature_mismatch — same op position, differing shape/dtype.
- ``HVP104`` degenerate_collective — collective over a 1-member process
  set / mesh axis (all cost, no exchange).
- ``HVP105`` fusion_fill — advisory: estimated bytes-on-wire vs the fusion
  threshold fill ratio (tiny sync collectives that would fuse, or tensors
  that overflow every bucket).
- ``HVP106`` wire_dtype — advisory: fp32 on the wire inside jit while a
  compressed wire dtype is configured. Suppressed when the jaxpr shows
  the block-scaled quantized exchange (int8/float8 collectives from
  ops/wire.py) — that program is already quantizing in jit.
- ``HVP107`` buffer_reuse — advisory: one input buffer dispatched to more
  than one collective (a hazard when eager donation is armed, a missed
  donation opportunity otherwise).
- ``HVP108`` cond_collective — advisory: collective under a ``lax.cond``
  branch (subset participation deadlocks the rendezvous if the predicate
  varies across the mesh).
- ``HVP109`` stale_residual — advisory: wire error feedback is configured
  but the program runs in-jit quantized exchanges outside the runtime
  residual store — residuals threaded through optimizer state must be
  zeroed on elastic reset (a resized mesh must not replay stale
  residuals), and residual-less in-jit exchanges get no feedback at all.
- ``HVP110`` world_dependent_signature — error (``check_elastic``): a
  collective whose stream position, order, dtype, repeat count or payload
  is a function of WORLD SIZE, so a resized mesh replays the step against
  mismatched peers. Payloads that are an even reshard of one logical
  buffer (ZeRO ``ceil(B/n)`` shards) or fully replicated pass clean.
- ``HVP111`` tier_budget_exceeded — error (``analysis/cost.py``): the
  predicted per-step DCN bytes exceed the declared budget
  (``HOROVOD_DCN_BYTES_BUDGET`` / ``dcn_budget_bytes=``).
- ``HVP112`` unbounded_repeat — advisory: a collective under a ``while``
  whose trip count the walker cannot bound — cost totals and the elastic
  generation diff are LOWER BOUNDS for it, not exact.
- ``HVP113`` hierarchical_one_slice — advisory: a hierarchical 2-level
  allreduce (local RS -> cross -> local AG, ``hier_triads``) — or the
  armed ``HOROVOD_HIERARCHICAL_DISPATCH`` tier — over a 1-slice layout:
  two extra ICI legs for no DCN saving.

Lint codes (``HVL0xx``) are documented in :mod:`horovod_tpu.analysis.lint`.
"""

import dataclasses

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result. ``rank``/``op``/``ps``/``seq``/``sig`` are the
    flight-recorder-aligned identity fields (None where not applicable)."""

    code: str
    severity: str
    message: str
    rank: int = None
    op: str = None
    ps: str = None
    seq: int = None
    sig: str = None

    def identity(self):
        """The flight-recorder event identity this finding points at."""
        return (self.op, self.ps, self.seq, self.sig)

    def render(self):
        where = ""
        if self.rank is not None:
            where += f" rank={self.rank}"
        if self.op is not None:
            where += f" op={self.op}"
        if self.ps is not None:
            where += f" ps={self.ps}"
        if self.seq is not None:
            where += f" seq={self.seq}"
        if self.sig is not None:
            where += f" sig={self.sig}"
        return f"{self.code} [{self.severity}]{where}: {self.message}"

    def to_dict(self):
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


def sort_findings(findings):
    """Errors first, then warnings, then advisories; stable within a
    severity."""
    return sorted(findings,
                  key=lambda f: (_SEVERITY_ORDER.get(f.severity, 3),))
