"""Declarative serving SLOs and rolling-window burn rates.

Port of the JAX package's ``telemetry/slo.py``, whole.

Two objectives, both env-declared (docs/observability.md):

- ``HOROVOD_SLO_TTFT_P99_MS`` — p99 time-to-first-token target. Budget
  is the p99's own 1%: over the rolling window, ``burn = (fraction of
  requests whose TTFT exceeded the target) / 0.01``.
- ``HOROVOD_SLO_TPS`` — generated-tokens/sec floor. A 1% shortfall
  consumes the whole budget: ``burn = max(0, target - observed) /
  (0.01 * target)``.

Either way the reading is the SRE convention: 0 = inside the SLO,
1.0 = consuming the error budget exactly, > 1 = burning it (alert);
the window is ``HOROVOD_SLO_WINDOW_S`` (default 60 s). The serving
engine feeds observations inline (one deque append per request /
decode step); :func:`burn_rates` prunes the window and exports
``slo_burn_rate{objective}`` to the metrics registry, which the serving
engine's ``/serving/health`` frame carries.
"""

import threading
import time
from collections import deque

from horovod_tpu_torch.common.config import _env_float

# p99 objectives budget 1% of requests; the tps floor budgets a 1%
# shortfall — one shared constant so both burn scales read the same way.
_BUDGET = 0.01


class SloEngine:
    """Rolling-window burn-rate computation (pure; fake-clock testable:
    every method takes ``now``)."""

    def __init__(self, ttft_p99_ms=0.0, tps=0.0, window_s=60.0):
        self.ttft_p99_ms = float(ttft_p99_ms)
        self.tps = float(tps)
        self.window_s = max(float(window_s), 1e-3)
        self._ttft = deque()          # (t, ttft_seconds)
        self._tokens = deque()        # (t, n)
        self._lock = threading.Lock()

    def configured(self):
        return self.ttft_p99_ms > 0.0 or self.tps > 0.0

    def observe_ttft(self, seconds, now=None):
        if not self.configured():
            return
        with self._lock:
            self._ttft.append((time.time() if now is None else now,
                               float(seconds)))

    def observe_tokens(self, n, now=None):
        if not self.configured() or not n:
            return
        with self._lock:
            self._tokens.append((time.time() if now is None else now,
                                 int(n)))

    def _prune_locked(self, now):
        cut = now - self.window_s
        while self._ttft and self._ttft[0][0] < cut:
            self._ttft.popleft()
        while self._tokens and self._tokens[0][0] < cut:
            self._tokens.popleft()

    def burn_rates(self, now=None):
        """{objective: burn} for every configured objective ({} when
        none are, or nothing was observed in the window yet)."""
        if not self.configured():
            return {}
        now = time.time() if now is None else now
        out = {}
        with self._lock:
            self._prune_locked(now)
            if self.ttft_p99_ms > 0.0 and self._ttft:
                target = self.ttft_p99_ms / 1000.0
                bad = sum(1 for _, s in self._ttft if s > target)
                out["ttft_p99"] = round(
                    bad / len(self._ttft) / _BUDGET, 4)
            if self.tps > 0.0 and self._tokens:
                # Rate over the span the window actually saw — a young
                # window measures its own elapsed time, not the full
                # period (one early token must not read as a huge tps,
                # nor a near-empty window as a violation).
                span = max(now - self._tokens[0][0], 1e-6)
                observed = sum(n for _, n in self._tokens) / span
                out["tps"] = round(
                    max(0.0, self.tps - observed) / (_BUDGET * self.tps),
                    4)
        return out


_engine = None
_lock = threading.Lock()
_last_export = 0.0


def configure(config):
    """(Re)build the singleton from a Config (init path; tests call it
    directly)."""
    global _engine
    with _lock:
        _engine = SloEngine(
            ttft_p99_ms=getattr(config, "slo_ttft_p99_ms", 0.0),
            tps=getattr(config, "slo_tps", 0.0),
            window_s=getattr(config, "slo_window_s", 60.0))
    return _engine


def _get():
    global _engine
    if _engine is None:
        with _lock:
            if _engine is None:
                _engine = SloEngine(
                    ttft_p99_ms=_env_float("HOROVOD_SLO_TTFT_P99_MS", 0.0),
                    tps=_env_float("HOROVOD_SLO_TPS", 0.0),
                    window_s=_env_float("HOROVOD_SLO_WINDOW_S", 60.0))
    return _engine


def observe_ttft(seconds):
    """One request's TTFT (the serving engine's first-token commit)."""
    _get().observe_ttft(seconds)
    _export(throttled=True)


def observe_tokens(n):
    """Tokens committed by one decode step."""
    _get().observe_tokens(n)
    _export(throttled=True)


def burn_rates():
    """Current burn per objective; also refreshes the
    ``slo_burn_rate{objective}`` gauges so a scrape that follows reads
    the same numbers."""
    rates = _get().burn_rates()
    _export(rates=rates)
    return rates


def _export(rates=None, throttled=False):
    """Push burn rates into the metrics registry (fail-soft; lazy import
    keeps metrics -> telemetry import order acyclic)."""
    global _last_export
    if not _get().configured():
        return
    now = time.time()
    if throttled and now - _last_export < 1.0:
        return
    _last_export = now
    try:
        from horovod_tpu_torch.metrics import instruments as _metrics
        for objective, burn in (rates if rates is not None
                                else _get().burn_rates()).items():
            _metrics.record_slo_burn(objective, burn)
    except Exception:  # noqa: BLE001 — metrics off/mid-reset
        pass


def reset():
    """Tests: drop the singleton (next use re-reads the env)."""
    global _engine
    with _lock:
        _engine = None
