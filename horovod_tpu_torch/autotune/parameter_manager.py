"""Online autotuning of runtime knobs.

Port of the JAX package's ``autotune/parameter_manager.py``. Reference:
horovod/common/parameter_manager.cc/.h (544+257 LoC) — tunes the fusion
threshold and cycle time with Bayesian optimization (log2-scaled
NumericParameter, scored by bytes-reduced-per-second), PLUS categorical
knobs (CategoricalParameter: hierarchical allreduce/allgather, cache
toggles) swept per category, over warmup/sample windows; winning parameters
are logged and frozen after ``bayes_opt_max_samples``.

The numeric knobs are the fusion runtime's ``fusion_threshold`` (bucket
bytes) and its debounced ``cycle_time_ms`` (flush quiescence window),
tuned JOINTLY, like the reference's threshold+cycle pair. The categorical
knobs are the allreduce STRATEGY (flat | hierarchical | torus, the 2-level
schemes of ``parallel/strategies.py`` over the slice or node layout) and,
when the user already opted into a 16-bit or quantized wire, the WIRE
DTYPE. Categories are swept round-robin for ``CAT_PASSES`` windows each
after warmup (the reference's categorical phase), the best mean score
wins, then the numeric BO runs. Scoring is identical throughout: bytes per
second of reduced data over a sample window. The manager lives inside
:class:`horovod_tpu_torch.ops.fusion.FusionRuntime` on process 0, which
reports each flush and applies returned knob updates from its next flush;
the boundary stream carries them to the other processes.

The state machine, the candidate sampler's seed and the prior artifact
(``export_observations``/``import_observations``) are JAX's, so a prior
written by either package loads in the other: ``sweep_categoricals``
names the wires as JAX does (``int8``, ``float8_e4m3fn``, ``bfloat16``,
``float16``).
"""

import itertools
import time

import numpy as np

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.autotune.bayesian_optimization import (
    BayesianOptimization)


def sweep_categoricals(current_strategy, config_wire_dtype, has_slices,
                       a2a_strategy=None, a2a_cross_dtype=""):
    """THE categorical knob set of the strategy/wire sweep — one
    definition for the flush-window tuner (FusionRuntime) and the
    autopilot controller, so the two can never sweep different spaces.
    ``current_strategy`` goes first (the tie-break winner);
    ``torus_qcross`` joins only when a slice hierarchy exists (on a
    1-slice layout it is pure overhead, as the fusion runtime's refusal
    says). The wire
    categorical exists only when the user already opted into a 16-bit or
    quantized wire, and sweeps UP in precision only (precision policy is
    never a speed knob).

    ``a2a_strategy`` (the hierarchical-alltoall tier's current strategy,
    None = tier disarmed / no alltoalls to steer) adds the expert-
    dispatch levers: the a2a strategy sweeps flat | hier | hier_qcross —
    again only over a real slice hierarchy — and, when the user already
    opted into a QUANTIZED expert cross wire (``a2a_cross_dtype``), the
    cross-leg dtype sweeps up to the exact leg (``""``). The sweep never
    quantizes activations on its own — that is the autopilot's guarded
    one-epoch trial (revert unless DCN collapses), not a category.

    The names are JAX's, the quantized wire's by its dtype
    (``float8_e4m3fn`` for fp8), so a prior from either package matches
    the other's space."""
    from horovod_tpu_torch.ops import wire as _wire

    choices = ("flat", "hierarchical", "torus") + (
        ("torus_qcross",) if has_slices else ())
    cats = {"strategy": [current_strategy] + [
        s for s in choices if s != current_strategy]}
    resolved = _wire.resolve_wire_dtype(config_wire_dtype)
    if _wire.is_quantized(resolved):
        first = str(_wire.wire_torch_type(resolved)).replace("torch.", "")
        cats["wire_dtype"] = [first, "bfloat16", "float16"]
    elif resolved:
        cats["wire_dtype"] = [
            resolved, "bfloat16" if resolved == "float16" else "float16"]
    if a2a_strategy and has_slices:
        cats["a2a_strategy"] = [a2a_strategy] + [
            s for s in ("flat", "hier", "hier_qcross")
            if s != a2a_strategy]
        resolved_a2a = _wire.resolve_wire_dtype(a2a_cross_dtype)
        if _wire.is_quantized(resolved_a2a):
            cats["a2a_cross_dtype"] = [resolved_a2a, ""]
    return cats


class ParameterManager:
    """reference: parameter_manager.h:42-252 ParameterManager."""

    # log2 bounds: fusion threshold 1 MB .. 256 MB (reference:
    # NumericParameter fusion threshold log-scaled), cycle/debounce window
    # 0.25 ms .. 32 ms (reference: cycle time 1..25 ms).
    _LOG2_THR = (20.0, 28.0)
    _LOG2_CYC = (-2.0, 5.0)
    # sample windows per categorical combo (reference sweeps each category
    # value across its warmup/sample machinery)
    CAT_PASSES = 2

    def __init__(self, warmup_samples=3, steps_per_sample=10,
                 bayes_opt_max_samples=20, gaussian_process_noise=0.8,
                 log_file=None, initial_threshold=64 * 1024 * 1024,
                 initial_cycle_ms=1.0, categorical_knobs=None,
                 max_move_log2=None):
        self._warmup_remaining = warmup_samples
        self._steps_per_sample = steps_per_sample
        self._max_samples = bayes_opt_max_samples
        # Bounded move per sample (the autopilot's per-epoch guardrail):
        # the BO proposal is clamped to within +-max_move_log2 of the
        # knobs ACTUALLY in effect, and _current always records the
        # applied point — the GP is fed what really ran, never an
        # unapplied proposal. None = unbounded (the offline default).
        # `is not None`, not truthiness: an explicit 0 means FROZEN
        # numerics (clamp every move to zero), not unbounded.
        self._max_move = None if max_move_log2 is None \
            else float(max_move_log2)
        self._bo = BayesianOptimization(
            bounds=[list(self._LOG2_THR), list(self._LOG2_CYC)],
            alpha=gaussian_process_noise)
        self._log_file = log_file
        # clamp into tuning bounds (threshold 0 = "fusion disabled" would
        # otherwise poison the GP with -inf)
        self._current = np.array([
            np.clip(np.log2(max(initial_threshold, 1)), *self._LOG2_THR),
            np.clip(np.log2(max(initial_cycle_ms, 1e-3)), *self._LOG2_CYC),
        ])
        # categorical phase state: knob name -> ordered choices (first =
        # the configured/initial value, which is also the tie-break winner)
        self._cat_knobs = {k: list(v)
                           for k, v in (categorical_knobs or {}).items()
                           if len(v) > 1}
        names = sorted(self._cat_knobs)
        combos = list(itertools.product(*(self._cat_knobs[n]
                                          for n in names))) if names else []
        self._cat_names = names
        self._cat_queue = [c for c in combos
                           for _ in range(self.CAT_PASSES)][1:]
        self._cat_current = combos[0] if combos else ()
        self._cat_scores = {c: [] for c in combos}
        self._cat_done = not combos
        # First window on a new combo pays the combo's first buckets (new
        # signatures to verify, the tier's buffers and subgroups) — its
        # score would bury every non-incumbent combo. Discard it.
        self._cat_warmed = None
        self._window_invalid = False
        self._invalid_streak = 0
        self._samples = 0
        self._tuning = True
        self._window_bytes = 0
        self._window_steps = 0
        self._window_start = time.perf_counter()
        self._best = (None, -np.inf)
        if self._log_file:
            with open(self._log_file, "w") as f:
                f.write("sample,fusion_threshold,cycle_time_ms,"
                        "categoricals,score_bytes_per_sec\n")

    @property
    def fusion_threshold(self):
        return int(2 ** self._current[0])

    @property
    def cycle_time_ms(self):
        return float(2 ** self._current[1])

    @property
    def categoricals(self):
        """Current categorical knob values as ``{name: choice}``."""
        return dict(zip(self._cat_names, self._cat_current))

    @property
    def tuning(self):
        return self._tuning

    def invalidate_window(self):
        """The runtime could not apply the configured knobs to the current
        window (e.g. a join mask or non-linear op forced the flat
        strategy): its score would misattribute flat timings to the
        configured combo — discard it when the window closes."""
        self._window_invalid = True

    def record(self, nbytes):
        """Report one flush of ``nbytes`` reduced bytes
        (reference: ParameterManager::Update per-tensor byte accounting).
        Returns ``(fusion_threshold, cycle_time_ms, categoricals)`` when a
        sample window closed (the caller applies all three), else None."""
        if not self._tuning:
            return None
        self._window_bytes += nbytes
        self._window_steps += 1
        if self._window_steps < self._steps_per_sample:
            return None
        elapsed = max(time.perf_counter() - self._window_start, 1e-9)
        score = self._window_bytes / elapsed
        self._window_bytes = 0
        self._window_steps = 0
        self._window_start = time.perf_counter()
        return self._end_sample(score)

    def suggest(self):
        """The knobs currently proposed/in effect, WITHOUT advancing the
        tuner: ``(fusion_threshold, cycle_time_ms, categoricals)``. The
        autopilot applies these for one decision epoch and feeds the
        measured result back through :meth:`observe`."""
        return self._knobs()

    def observe(self, score):
        """Online increment decoupled from the tensor-byte ``update``/
        ``record`` path: feed one externally-computed sample score (the
        autopilot's signal-plane bytes/sec for a whole decision epoch)
        and advance the same warmup → categorical sweep → BO → freeze
        machinery. Non-finite scores (a partially-observed first epoch:
        zero elapsed time, missing counters → NaN/inf) are clamped to
        0.0 so they can never poison the GP or win the sweep. Returns
        the next knobs like :meth:`record`, or None once frozen."""
        if not self._tuning:
            return None
        try:
            score = float(score)
        except (TypeError, ValueError):
            score = 0.0
        if not np.isfinite(score):
            score = 0.0
        return self._end_sample(score)

    # --- twin-prior serialization seam --------------------------------

    def export_observations(self):
        """JSON-serializable record of everything this manager observed —
        the sweep space it ran over, per-combo categorical scores, the
        numeric BO samples, and the best point seen. This is the twin
        prior artifact (``horovod_tpu.sim.autopilot`` writes it, a live
        controller loads it through ``HOROVOD_AUTOPILOT_PRIOR``)."""
        best_point, best_score = self._best
        if best_point is None:
            best_point = self._current
        return {
            "version": 1,
            "bounds": [list(self._LOG2_THR), list(self._LOG2_CYC)],
            "categoricals": {n: list(self._cat_knobs[n])
                             for n in self._cat_names},
            "cat_scores": [
                {"combo": dict(zip(self._cat_names, combo)),
                 "scores": [float(s) for s in scores]}
                for combo, scores in self._cat_scores.items()],
            "samples": [
                {"point": [float(v) for v in x], "score": float(y)}
                for x, y in zip(self._bo.x_samples, self._bo.y_samples)],
            "best": {
                "point": [float(v) for v in best_point],
                "score": (float(best_score)
                          if np.isfinite(best_score) else 0.0),
                "categoricals": self.categoricals,
            },
        }

    def import_observations(self, data, adopt_best=True):
        """Warm-start this manager from an :meth:`export_observations`
        artifact: the categorical sweep is SKIPPED (the prior's winning
        combo is adopted directly) and the numeric search starts at the
        prior's best point instead of the configured initials. Returns
        the number of prior observations consumed.

        The prior's scores are deliberately NOT fed to the live GP: twin
        scores are modeled bytes/sec, live scores are measured — mixing
        the two scales would distort expected improvement and could let
        a modeled score win ``_best`` at freeze time. What transfers is
        the sweep OUTCOME (combo + starting point); the prior's raw
        ``cat_scores`` are kept for forensics/tie context only.

        Raises ``ValueError`` when the artifact does not match this
        manager's sweep space (different bounds, categorical knob names,
        or choice sets) — a prior from a different layout or build must
        be rejected loudly, not silently misapplied."""
        if not isinstance(data, dict) or data.get("version") != 1:
            raise ValueError(
                "autopilot prior: expected an export_observations dict "
                f"with version=1, got {type(data).__name__}")
        bounds = [list(self._LOG2_THR), list(self._LOG2_CYC)]
        got_bounds = [[float(v) for v in b] for b in data.get("bounds", [])]
        if got_bounds != bounds:
            raise ValueError(
                f"autopilot prior: numeric bounds {got_bounds} do not "
                f"match this build's {bounds}")
        prior_cats = {n: list(v)
                      for n, v in (data.get("categoricals") or {}).items()}
        if sorted(prior_cats) != self._cat_names or any(
                set(prior_cats[n]) != set(self._cat_knobs[n])
                for n in self._cat_names):
            raise ValueError(
                "autopilot prior: categorical space "
                f"{ {n: sorted(v) for n, v in prior_cats.items()} } does "
                "not match this manager's "
                f"{ {n: sorted(v) for n, v in self._cat_knobs.items()} }")
        best = data.get("best") or {}
        best_cats = best.get("categoricals") or {}
        if self._cat_names:
            combo = tuple(best_cats.get(n) for n in self._cat_names)
            if any(c not in self._cat_knobs[n]
                   for n, c in zip(self._cat_names, combo)):
                raise ValueError(
                    f"autopilot prior: best categoricals {best_cats} not "
                    "in this manager's sweep space")
            self._cat_current = combo
            self._cat_done = True
            self._cat_queue = []
            self._cat_warmed = combo  # already ran in the twin
            for entry in data.get("cat_scores") or []:
                key = tuple(entry["combo"].get(n) for n in self._cat_names)
                if key in self._cat_scores:
                    self._cat_scores[key] = [float(s)
                                             for s in entry["scores"]]
        consumed = len(data.get("samples") or []) + sum(
            len(e.get("scores") or [])
            for e in data.get("cat_scores") or [])
        if adopt_best and best.get("point") is not None:
            point = np.asarray([float(v) for v in best["point"]], float)
            if point.shape != self._current.shape:
                raise ValueError(
                    f"autopilot prior: best point {best['point']} has "
                    f"wrong dimensionality (want {len(self._current)})")
            point[0] = np.clip(point[0], *self._LOG2_THR)
            point[1] = np.clip(point[1], *self._LOG2_CYC)
            self._current = point
        return consumed

    def _knobs(self):
        return self.fusion_threshold, self.cycle_time_ms, self.categoricals

    def _end_sample(self, score):
        if not np.isfinite(score):
            score = 0.0
        invalid, self._window_invalid = self._window_invalid, False

        if self._warmup_remaining > 0:
            # discard warmup windows (reference: warmup_samples)
            self._warmup_remaining -= 1
            return self._knobs()
        if invalid:
            self._invalid_streak += 1
            if self._invalid_streak < 3:
                # knobs weren't actually in effect for this window —
                # measuring it would poison whichever phase is active
                return self._knobs()
            # PERSISTENTLY unmeasurable (e.g. every flush downgrades the
            # 2-level strategy under a join mask): discarding forever
            # would deadlock the whole tuner. In the sweep, zero-score the
            # combo so it can never win (ties go to the configured
            # default); in the numeric phase, score the window as-is —
            # all windows are equally downgraded, so they stay comparable.
            self._invalid_streak = 0
            if not self._cat_done:
                score = 0.0
        else:
            self._invalid_streak = 0

        if not self._cat_done:
            # Categorical sweep phase (reference: CategoricalParameter
            # round-robin before the numeric tuner). Numerics stay at their
            # initial values so category scores aren't confounded.
            if self._cat_warmed != self._cat_current:
                # per-combo warmup: discard the first window after
                # a switch, stay on the combo for its measured passes
                self._cat_warmed = self._cat_current
                return self._knobs()
            self._cat_scores[self._cat_current].append(score)
            if self._log_file:
                with open(self._log_file, "a") as f:
                    f.write(f"cat,{self.fusion_threshold},"
                            f"{self.cycle_time_ms:.3f},"
                            f"{'|'.join(map(str, self._cat_current))},"
                            f"{score:.1f}\n")
            if self._cat_queue:
                self._cat_current = self._cat_queue.pop(0)
            else:
                # every combo measured CAT_PASSES times: best mean wins
                # (ties: earliest combo, i.e. the configured default)
                self._cat_current = max(
                    self._cat_scores,
                    key=lambda c: (float(np.mean(self._cat_scores[c])),
                                   -list(self._cat_scores).index(c)))
                self._cat_done = True
                hvd_logging.info(
                    "autotune categorical phase done: %s",
                    self.categoricals)
            return self._knobs()

        self._samples += 1
        self._bo.add_sample(self._current, score)
        if score > self._best[1]:
            self._best = (self._current.copy(), score)
        if self._log_file:
            with open(self._log_file, "a") as f:
                f.write(f"{self._samples},{self.fusion_threshold},"
                        f"{self.cycle_time_ms:.3f},"
                        f"{'|'.join(map(str, self._cat_current))},"
                        f"{score:.1f}\n")

        if self._samples >= self._max_samples:
            # freeze at the best observed configuration
            self._current = self._best[0]
            self._tuning = False
            hvd_logging.info(
                "autotune converged: fusion_threshold=%d cycle=%.2fms "
                "categoricals=%s (%.1f MB/s)", self.fusion_threshold,
                self.cycle_time_ms, self.categoricals, self._best[1] / 1e6)
        else:
            prop = np.asarray(self._bo.next_sample(), float)
            if self._max_move is not None:
                prop = np.clip(prop, self._current - self._max_move,
                               self._current + self._max_move)
                prop[0] = np.clip(prop[0], *self._LOG2_THR)
                prop[1] = np.clip(prop[1], *self._LOG2_CYC)
            self._current = prop
        return self._knobs()
