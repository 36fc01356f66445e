"""The autopilot controller: one closed loop from signals to knobs.

Port of the JAX package's ``autopilot/controller.py``: every lever, the
guardrails, the prior loader, the decision records and the bounded deque
are JAX's; the knobs are the port's fusion runtime's (``threshold``,
``_cycle_s``, ``strategy``, ``wire_dtype``, the wire and strategy
registries of ``ops/wire.py`` and their sync, ``ops/fusion.py::
_sync_policy``), its cross wire (``cross_wire``) among them. The
overlap lever keeps JAX's records and pin, and the pin changes nothing:
the port's buckets run on the fusion stream, so the overlap is there with
``HOROVOD_CROSS_OVERLAP`` on or off (``ops/fusion.py``). The trial window
books ``autopilot_trial`` through ``goodput/ledger.py::set_trial``.

Every decision epoch (``HOROVOD_AUTOPILOT_INTERVAL`` seconds, or an
explicit :meth:`AutopilotController.tick` from tests/benches) the
controller:

1. diffs the signal plane into a :class:`~horovod_tpu_torch.autopilot.signals.
   SignalFrame` (step-profiler attribution + ``cross_wait``, fusion
   fill/defer, dispatch-plan hit deltas, per-tier wire bytes, telemetry
   health, watchdog findings);
2. scores the epoch (reduced payload bytes per second — the same unit the
   reference ParameterManager optimizes) and feeds the
   :class:`~horovod_tpu_torch.autotune.parameter_manager.ParameterManager` BO
   online through its ``observe``/``suggest`` increments;
3. applies the proposal through the fusion runtime's knobs — fusion
   threshold + cycle time, allreduce strategy (flat/torus/torus_qcross),
   and (when the user opted into one) the 16-bit/quantized flat wire —
   with the flush-boundary discipline doing the multi-process half:
   the controller runs ONLY on the coordinator, its knob writes ride the
   next flush boundary to every follower, so eager and fused programs
   flip everywhere at one boundary;
4. steers the two levers the ParameterManager does not own: the
   cross-slice (DCN) wire of the hierarchical tier (adopt the quantized
   cross leg when a real hierarchy exists, keep it only if DCN bytes
   actually collapse and the step wall does not regress) and the
   cross-leg overlap point (compute-dominant epochs widen the await to
   the step boundary, comm-dominant ones collapse it to the next flush);
5. enforces the guardrails: **bounded move** per epoch (the BO proposal
   is clamped to one octave — ``max_move_log2=1`` — per epoch),
   **revert-on-regression** (an adopted cross-wire/overlap move whose
   next epoch regresses the step wall by the step profiler's robust-z is
   rolled back), and **converge-then-freeze** (after
   ``bayes_opt_max_samples`` scored epochs the best observed config is
   frozen, like the reference's offline tuner — the loop then only
   watches health);
6. feeds the remediation arm: dead/stalled telemetry verdicts and
   watchdog straggler namings go through the
   :class:`~horovod_tpu_torch.autopilot.remediate.RemediationPolicy`
   (hysteresis / rate limit / floor), surviving actions are published to
   the elastic driver's KV for blacklist + re-rendezvous.

Every decision is forensics: a bounded in-memory record, an
``autopilot_decision`` flight-ring event and an
``autopilot_decisions_total{lever,outcome}`` metric — ``python -m
horovod_tpu_torch.flight.analyze`` renders the trail post-mortem.
"""

import collections
import threading
import time

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.autopilot import remediate as _remediate
from horovod_tpu_torch.autopilot import signals as _signals
from horovod_tpu_torch.profile.ledger import robust_z as _robust_z

_MAX_DECISIONS = 256

# Revert-on-regression judges with the step profiler's OWN robust-z
# (profile.ledger.robust_z — one definition, threshold from
# config.profile_z_threshold); this many accepted epochs make a baseline.
_MIN_HISTORY = 3


class AutopilotController:
    """One per job, coordinator rank only (followers adopt knob flips at
    flush boundaries). Tests construct it directly and drive ``tick()``;
    production wires a daemon thread via :func:`start_from_config`."""

    def __init__(self, config, time_fn=time.monotonic):
        self._config = config
        self._time = time_fn
        self.interval = max(float(getattr(config, "autopilot_interval",
                                          10.0)), 0.1)
        self.epoch = 0
        self.frozen = False
        self._decisions = collections.deque(maxlen=_MAX_DECISIONS)
        self._tick_records = []    # records emitted by the CURRENT tick
        self._prev_snapshot = None
        self._walls = collections.deque(maxlen=32)   # accepted epoch walls
        self._z_threshold = float(getattr(config, "profile_z_threshold",
                                          4.0) or 4.0)
        self._pm = None
        self._dcn_peak_bps = None  # resolved lazily from the roofline
        # The previous DCN-tier wire when the controller armed int8 for
        # a torus_qcross sweep sample (None = nothing armed): restored
        # when the sweep moves off the strategy, so the arming can never
        # outlive the sample that needed it.
        self._qcross_armed = None
        # Cross-wire lever state: None = not tried yet; otherwise the
        # (previous cross wire, dcn bytes baseline) to revert to.
        self._cross_trial = None
        self._cross_adopted = False
        # The a2a (expert-dispatch) twins of the two states above: the
        # previous expert cross wire when the sweep armed int8 for a
        # hier_qcross sample, and the guarded one-epoch trial of the
        # quantized expert leg after freeze.
        self._a2a_qcross_armed = None
        self._a2a_cross_trial = None
        self._a2a_cross_adopted = False
        self._pending_acks = {}    # req_id -> action awaiting driver ack
        self._stop = threading.Event()
        self._thread = None
        min_world = int(getattr(config, "autopilot_min_world", 0) or 0)
        if min_world <= 0:
            min_world = 1
        self.policy = _remediate.RemediationPolicy(
            hysteresis=getattr(config, "autopilot_hysteresis", 3),
            max_removals=getattr(config, "autopilot_max_removals", 1),
            min_world=min_world, time_fn=time_fn)

    # --- plumbing -------------------------------------------------------

    def _runtime(self):
        """The fusion runtime (created on demand — the autopilot is an
        explicit opt-in, and its levers live there)."""
        from horovod_tpu_torch.ops import fusion
        return fusion.get_runtime()

    def _slices(self):
        try:
            from horovod_tpu_torch.common import basics
            return basics._get_state().topology.num_slices
        except Exception:  # noqa: BLE001
            return 1

    def _build_pm(self, runtime):
        """The proposal engine: the same ParameterManager the fusion
        runtime's offline autotuner uses, over the SAME categorical
        space (autotune.sweep_categoricals — one definition), but with
        epoch-granular samples, zero warmup (the baseline tick and the
        no-signal guard play that role — a warmup here would just burn
        scored epochs) and the bounded-move guardrail armed."""
        from horovod_tpu_torch.autotune import (ParameterManager,
                                          sweep_categoricals)

        from horovod_tpu_torch.ops import wire as _wire

        # The hierarchical-alltoall tier joins the sweep only when it is
        # armed (knob or registry pin): a job with no expert dispatch
        # must not spend scored epochs on a lever it cannot move.
        a2a_default = "hier_qcross" \
            if getattr(self._config, "hierarchical_alltoall", False) else ""
        a2a_cur = _wire.alltoall_strategy_for("global", a2a_default)
        cats = sweep_categoricals(
            runtime.strategy, self._config.wire_dtype,
            self._slices() > 1, a2a_strategy=a2a_cur or None,
            a2a_cross_dtype=getattr(self._config, "alltoall_cross_dtype",
                                    ""))
        pm = ParameterManager(
            warmup_samples=0,
            steps_per_sample=1,
            bayes_opt_max_samples=int(
                self._config.autotune_bayes_opt_max_samples),
            gaussian_process_noise=float(
                self._config.autotune_gaussian_process_noise),
            log_file=self._config.autotune_log_file or None,
            initial_threshold=runtime.threshold,
            initial_cycle_ms=runtime._cycle_s * 1000.0,
            categorical_knobs=cats,
            max_move_log2=1.0)
        self._load_prior(pm)
        return pm

    def _load_prior(self, pm):
        """Warm-start ``pm`` from a twin-pretrained prior artifact
        (``HOROVOD_AUTOPILOT_PRIOR`` — an ``export_observations`` JSON
        file written by ``horovod_tpu_torch.sim.autopilot``, or JAX's):
        the categorical sweep is skipped and the numeric search starts at
        the twin's best point. Fail-soft by design — a missing, malformed,
        or space-mismatched prior logs and leaves the cold start intact
        (a bad artifact must never take the autopilot down with it)."""
        path = str(getattr(self._config, "autopilot_prior", "") or "")
        if not path:
            return
        try:
            import json
            with open(path) as f:
                data = json.load(f)
            consumed = pm.import_observations(data)
        except Exception as e:  # noqa: BLE001 — cold start still valid
            hvd_logging.warning(
                "autopilot prior %s not loaded (%s); starting cold",
                path, e)
            self._record("tuner", "prior_rejected", path=path,
                         error=str(e)[:200])
            return
        hvd_logging.info(
            "autopilot warm-started from twin prior %s: %d observations,"
            " categoricals=%s", path, consumed, pm.categoricals)
        self._record("tuner", "prior_loaded", path=path,
                     observations=consumed, categoricals=pm.categoricals)

    def _score(self, frame):
        """The epoch's objective: reduced payload bytes per second (the
        reference ParameterManager's unit), with the epoch's DCN bytes
        priced at the roofline's cross-slice peak and added to the
        denominator. On silicon the DCN wall is already inside
        ``elapsed_s`` and the term is a small monotone bias toward
        DCN-frugal configs; on the CPU tier — where a DCN "hop" costs
        the same memcpy as an ICI one and wall clock cannot separate
        them — it is what makes the hierarchy/wire levers converge to
        the same winners the hardware would pick
        (``HOROVOD_PEAK_DCN_GBS`` scales it)."""
        dcn_s = 0.0
        if frame.get("dcn_bytes"):
            if self._dcn_peak_bps is None:
                try:
                    from horovod_tpu_torch.profile import roofline
                    self._dcn_peak_bps = max(
                        float(roofline.chip_peaks()["dcn_gbs"]), 1e-3) * 1e9
                except Exception:  # noqa: BLE001
                    self._dcn_peak_bps = 1e12
            dcn_s = frame["dcn_bytes"] / self._dcn_peak_bps
        return frame["reduced_bytes"] / (frame["elapsed_s"] + dcn_s)

    def _record(self, lever, outcome, frame=None, **extra):
        rec = {"epoch": self.epoch, "lever": lever, "outcome": outcome,
               "t": round(time.time(), 3)}
        rec.update(extra)
        if frame is not None:
            rec["signal"] = {k: frame.get(k) for k in
                            ("wall_mean_s", "steps", "reduced_bytes",
                             "dcn_bytes", "fill_ratio_mean")}
        self._decisions.append(rec)
        self._tick_records.append(rec)
        try:
            from horovod_tpu_torch.metrics import instruments as _metrics
            _metrics.record_autopilot_decision(lever, outcome)
        except Exception:  # noqa: BLE001
            pass
        try:
            from horovod_tpu_torch.flight import recorder as _flight
            if _flight.armed:
                # `is not None`, not truthiness: a legitimate 0.0 score
                # must not fall through to the wall mean (two units in
                # one field would skew any post-mortem reading scores).
                dur = extra.get("score")
                if dur is None and frame is not None:
                    dur = frame.get("wall_mean_s")
                _flight.record_event(
                    "autopilot_decision", name=lever, what=outcome,
                    seq=self.epoch, dur=dur)
        except Exception:  # noqa: BLE001
            pass
        return rec

    def decisions(self, last=None):
        out = list(self._decisions)
        return out if last is None else out[-last:]

    # --- the decision epoch --------------------------------------------

    def tick(self):
        """One decision epoch. Never raises (the loop must outlive any
        one bad signal read); returns the epoch's decision records."""
        # Collected as they are recorded, not sliced off the bounded
        # deque afterwards — once the deque is full, a length-based
        # slice would return [] forever.
        self._tick_records = []
        try:
            self._tick_inner()
        except Exception as e:  # noqa: BLE001
            hvd_logging.warning("autopilot tick failed: %s", e)
        return list(self._tick_records)

    def _tick_inner(self):
        cur = _signals.snapshot()
        view = _signals.cluster_view()
        if self._prev_snapshot is None:
            # First tick: baseline only — there is no epoch to score yet
            # (scoring a half-open window is exactly the NaN/garbage the
            # observe() clamp guards; skipping it is cleaner still).
            self._prev_snapshot = cur
            self._record("tuner", "baseline")
            return
        frame = _signals.frame(self._prev_snapshot, cur, view)
        self._prev_snapshot = cur
        self.epoch += 1

        self._remediate(frame, view)

        if not self.frozen:
            self._tune(frame)
        else:
            # Frozen: the loop narrows to guardrail duty — judge a still-
            # pending cross-wire trial, keep the overlap point steered,
            # and watch for drift (a sustained regression is surfaced and
            # post-mortem-able, never silently absorbed).
            runtime = self._runtime()
            self._judge_cross_trial(frame, runtime)
            self._judge_a2a_cross_trial(frame, runtime)
            self._steer_overlap(frame, runtime)
            if frame["wall_mean_s"] is not None:
                if len(self._walls) >= _MIN_HISTORY:
                    z, med = _robust_z(frame["wall_mean_s"],
                                       list(self._walls))
                    if z >= self._z_threshold:
                        self._record("tuner", "drift_detected", frame,
                                     z=round(z, 2),
                                     median_s=round(med, 6))
                    else:
                        self._walls.append(frame["wall_mean_s"])
                else:
                    self._walls.append(frame["wall_mean_s"])
        # Tell the goodput ledger whether a guarded trial window is open:
        # steps measured under a trial book to autopilot_trial (the trial
        # pays for itself in the decomposition), not productive_compute.
        try:
            from horovod_tpu_torch.goodput import ledger as _goodput
            _goodput.set_trial(self._cross_trial is not None
                               or self._a2a_cross_trial is not None)
        except Exception:  # noqa: BLE001
            pass

    # --- tuning arm -----------------------------------------------------

    def _tune(self, frame):
        runtime = self._runtime()
        if self._pm is None:
            self._pm = self._build_pm(runtime)
            # The flush-path tuner and the autopilot must not fight over
            # the same knobs: the autopilot supersedes it.
            if runtime._parameter_manager is not None:
                hvd_logging.info(
                    "autopilot supersedes the flush-window autotuner")
                runtime._parameter_manager = None

        if not frame["steps"] and not frame["flushes"]:
            # Nothing dispatched this epoch: no score to attribute to the
            # current knobs (feeding 0 would bury them unfairly).
            self._record("tuner", "no_signal", frame)
            return

        score = self._score(frame)
        update = self._pm.observe(score)
        if frame["wall_mean_s"] is not None:
            self._walls.append(frame["wall_mean_s"])
        if update is None or not self._pm.tuning:
            self.frozen = True
            thr, cyc, cats = self._pm.suggest()
            self._apply(runtime, thr, cyc, cats)
            self._record("tuner", "frozen", frame, score=round(score, 1),
                         threshold=thr, cycle_ms=round(cyc, 3),
                         categoricals=dict(cats))
            self._maybe_try_cross(frame, runtime)
            self._maybe_try_a2a_cross(frame, runtime)
            return
        thr, cyc, cats = update
        changed = self._apply(runtime, thr, cyc, cats)
        self._record("tuner", "adopt" if changed else "hold", frame,
                     score=round(score, 1), threshold=thr,
                     cycle_ms=round(cyc, 3), categoricals=dict(cats))
        self._steer_overlap(frame, runtime)

    def _apply(self, runtime, threshold, cycle_ms, cats):
        """Apply a proposal to the runtime's knobs (coordinator-side; the
        next flush boundary carries program-shaping knobs to followers).
        Returns whether anything changed."""
        changed = False
        if threshold != runtime.threshold:
            runtime.threshold = int(threshold)
            changed = True
        new_cycle = max(float(cycle_ms), 1e-3) / 1000.0
        if abs(new_cycle - runtime._cycle_s) > 1e-9:
            runtime._cycle_s = new_cycle
            changed = True
        strategy = cats.get("strategy")
        if strategy and strategy != runtime.strategy:
            runtime.strategy = strategy
            changed = True
        from horovod_tpu_torch.ops import wire as _wire
        if strategy == "torus_qcross":
            # torus_qcross MEANS a quantized cross leg: when the per-tier
            # policy chain resolves to full precision (the detuned /
            # unconfigured case), sweeping the strategy must sweep the
            # wire that defines it — otherwise qcross measures as plain
            # torus and the lever can never win. The ICI legs stay exact
            # either way; a bad epoch under it simply scores low and the
            # sweep moves on (the guardrail).
            cw = _wire.cross_wire_for("global", self._config)
            label = _wire.quantized_label("int8")
            if not _wire.is_quantized(cw) and label \
                    and self._qcross_armed is None:
                self._qcross_armed = cw or ""
                _wire.runtime_sync_wire_dtype(label, "global", tier="dcn")
                runtime.cross_wire = label
                changed = True
        elif strategy and self._qcross_armed is not None:
            # The sweep moved OFF torus_qcross: the wire the controller
            # armed FOR it must leave with it — a leftover int8 registry
            # entry would read as a user opt-in later (_maybe_try_cross
            # would skip its guarded trial) and price a lossy DCN leg
            # the runtime never moves.
            prev = self._qcross_armed
            self._qcross_armed = None
            _wire.runtime_sync_wire_dtype(prev, "global", tier="dcn")
            runtime.cross_wire = prev
            changed = True
        wire = cats.get("wire_dtype")
        if wire:
            # JAX's names (float8_e4m3fn) as the runtime's ("fp8").
            new_wire = _wire._normalize(wire)
            if new_wire != runtime.wire_dtype:
                runtime.wire_dtype = new_wire
                changed = True
        a2a = cats.get("a2a_strategy")
        if a2a:
            if _wire.alltoall_strategy_for("global") != a2a:
                _wire.runtime_sync_alltoall_strategy(a2a, "global")
                changed = True
            if a2a == "hier_qcross":
                # hier_qcross MEANS a quantized expert cross leg — same
                # rule as torus_qcross above: when the a2a cross chain
                # resolves to full precision the sweep must arm the wire
                # that defines the strategy, and restore it the moment
                # the sweep moves off (a leftover int8 pin would read as
                # a user opt-in and lossy-quantize activations the user
                # never asked to quantize).
                acw = _wire.alltoall_cross_wire_for("global", self._config)
                label = _wire.quantized_label("int8")
                if not _wire.is_quantized(acw) and label \
                        and self._a2a_qcross_armed is None:
                    self._a2a_qcross_armed = acw or ""
                    _wire.runtime_sync_alltoall_cross_dtype(label,
                                                            "global")
                    changed = True
            elif self._a2a_qcross_armed is not None:
                prev = self._a2a_qcross_armed
                self._a2a_qcross_armed = None
                _wire.runtime_sync_alltoall_cross_dtype(prev, "global")
                changed = True
        a2a_cw = cats.get("a2a_cross_dtype")
        if a2a_cw is not None and self._a2a_qcross_armed is None:
            cur = _wire.alltoall_cross_wire_for("global", self._config)
            if cur != _wire.resolve_wire_dtype(a2a_cw):
                _wire.runtime_sync_alltoall_cross_dtype(a2a_cw, "global")
                changed = True
        if changed:
            # Mirror the flush-snapshot adoption into the eager
            # registries now (sync dispatches between flushes must see
            # the same policy; runtime sync defers to explicit user
            # pins). Multi-process followers adopt the same values from
            # the next published boundary.
            if runtime.wire_dtype:
                _wire.runtime_sync_wire_dtype(runtime.wire_dtype, "global")
            _sync_eager_policy(runtime)
        return changed

    def _steer_overlap(self, frame, runtime):
        """The cross-leg overlap point lever, at epoch granularity: the
        per-flush steering already follows the last step's attribution;
        the controller pins the MODE when an epoch's attribution is
        one-sided, so a single outlier step cannot flap the await point
        mid-epoch. Records only actual changes."""
        att = frame.get("attribution_mean_s") or {}
        if not att or not runtime._overlap:
            return
        comm = att.get("collective", 0.0) + att.get("cross_wait", 0.0)
        mode = "next_flush" if comm > att.get("compute", 0.0) else "step"
        changed = mode != runtime._overlap_mode
        runtime._overlap_mode = mode
        # Pinning is what makes this a lever: the runtime's per-flush
        # steering defers while pinned, so the mode holds for the whole
        # epoch instead of being recomputed from the single last step at
        # the next flush.
        runtime._overlap_pinned = True
        if changed:
            self._record("overlap", mode, frame)

    # --- cross-wire lever ----------------------------------------------

    def _maybe_try_cross(self, frame, runtime):
        """After the tuner froze: if the winning strategy is the
        hierarchical tier and the cross leg still runs full precision,
        trial the quantized cross wire for one epoch. Kept only if DCN
        bytes actually collapse and the wall does not regress
        (:meth:`_judge_cross_trial`); reverted otherwise. One trial per
        freeze — this is a policy move with a guardrail, not a sweep."""
        from horovod_tpu_torch.ops import wire as _wire
        if self._cross_adopted or self._cross_trial is not None:
            return
        if runtime.strategy not in ("torus", "torus_qcross") \
                or self._slices() <= 1:
            return
        current = _wire.cross_wire_for("global", self._config)
        if _wire.is_quantized(current):
            self._cross_adopted = True
            return                     # already quantized by config/user
        label = _wire.quantized_label("int8")
        if label is None:
            return
        prev = current or ""
        prev_strategy = runtime.strategy
        runtime.strategy = "torus_qcross"
        _wire.runtime_sync_wire_dtype(label, "global", tier="dcn")
        runtime.cross_wire = label
        _sync_eager_policy(runtime)
        self._cross_trial = (prev, frame.get("dcn_bytes") or 0.0,
                             prev_strategy)
        self._record("cross_wire", "trial", frame, wire=label)

    def _judge_cross_trial(self, frame, runtime):
        """Revert-on-regression for the cross-wire trial, judged on the
        first measured epoch AFTER the trial armed. Trials only start at
        the freeze transition, so the judging call site is the frozen
        branch of the tick."""
        from horovod_tpu_torch.ops import wire as _wire
        if self._cross_trial is None:
            return
        if not frame["flushes"] and not frame["steps"]:
            return                      # nothing measured yet; keep waiting
        prev_wire, prev_dcn, prev_strategy = self._cross_trial
        self._cross_trial = None
        wall = frame.get("wall_mean_s")
        regressed = False
        if wall is not None and len(self._walls) >= _MIN_HISTORY:
            z, _ = _robust_z(wall, list(self._walls))
            regressed = z >= self._z_threshold
        dcn_now = frame.get("dcn_bytes") or 0.0
        # A zero-DCN baseline is ABSENT evidence, not a collapse: without
        # a measured before/after the lossy cross wire is not kept.
        shrunk = prev_dcn > 0.0 and dcn_now < 0.75 * prev_dcn
        if regressed or not shrunk:
            # Revert BOTH halves to their saved pre-trial values —
            # inferring the strategy from the wire would leave
            # torus_qcross behind whenever the pre-trial cross wire was
            # a non-empty cast (e.g. bfloat16).
            _wire.runtime_sync_wire_dtype(prev_wire, "global", tier="dcn")
            runtime.cross_wire = prev_wire
            runtime.strategy = prev_strategy
            _sync_eager_policy(runtime)
            self._record("cross_wire", "reverted", frame,
                         dcn_bytes=dcn_now, regressed=regressed)
            return
        self._cross_adopted = True
        self._record("cross_wire", "adopted", frame, dcn_bytes=dcn_now)

    def _maybe_try_a2a_cross(self, frame, runtime):
        """The expert-dispatch twin of :meth:`_maybe_try_cross`: after
        the tuner froze, if the hierarchical alltoall tier won (or is
        pinned) and its cross leg still runs full precision, trial the
        quantized expert cross wire for one epoch. Activations carry no
        error feedback, so the guardrail is strict: kept only if DCN
        bytes actually collapse and the wall does not regress."""
        from horovod_tpu_torch.ops import wire as _wire
        if self._a2a_cross_adopted or self._a2a_cross_trial is not None:
            return
        default = "hier_qcross" \
            if getattr(self._config, "hierarchical_alltoall", False) else ""
        strategy = _wire.alltoall_strategy_for("global", default)
        if strategy not in ("hier", "hier_qcross") or self._slices() <= 1:
            return
        current = _wire.alltoall_cross_wire_for("global", self._config)
        if _wire.is_quantized(current):
            self._a2a_cross_adopted = True
            return                     # already quantized by config/user
        label = _wire.quantized_label("int8")
        if label is None:
            return
        prev = current or ""
        _wire.runtime_sync_alltoall_strategy("hier_qcross", "global")
        _wire.runtime_sync_alltoall_cross_dtype(label, "global")
        self._a2a_cross_trial = (prev, frame.get("dcn_bytes") or 0.0,
                                 strategy)
        self._record("a2a_cross_wire", "trial", frame, wire=label)

    def _judge_a2a_cross_trial(self, frame, runtime):
        """Revert-on-regression for the expert cross-wire trial — same
        judge as :meth:`_judge_cross_trial` (robust-z on the wall,
        DCN-bytes collapse below 0.75x the pre-trial baseline), reverting
        BOTH the wire and the strategy to their saved pre-trial
        values."""
        from horovod_tpu_torch.ops import wire as _wire
        if self._a2a_cross_trial is None:
            return
        if not frame["flushes"] and not frame["steps"]:
            return                      # nothing measured yet; keep waiting
        prev_wire, prev_dcn, prev_strategy = self._a2a_cross_trial
        self._a2a_cross_trial = None
        wall = frame.get("wall_mean_s")
        regressed = False
        if wall is not None and len(self._walls) >= _MIN_HISTORY:
            z, _ = _robust_z(wall, list(self._walls))
            regressed = z >= self._z_threshold
        dcn_now = frame.get("dcn_bytes") or 0.0
        shrunk = prev_dcn > 0.0 and dcn_now < 0.75 * prev_dcn
        if regressed or not shrunk:
            _wire.runtime_sync_alltoall_cross_dtype(prev_wire, "global")
            _wire.runtime_sync_alltoall_strategy(prev_strategy, "global")
            self._record("a2a_cross_wire", "reverted", frame,
                         dcn_bytes=dcn_now, regressed=regressed)
            return
        self._a2a_cross_adopted = True
        self._record("a2a_cross_wire", "adopted", frame,
                     dcn_bytes=dcn_now)

    # --- remediation arm ------------------------------------------------

    def _verdicts(self, frame, view):
        """Merge telemetry dead/stalled states and watchdog straggler
        namings into this epoch's verdict dict."""
        verdicts = {}
        for rank, count in (frame.get("straggler_namings") or {}).items():
            verdicts[int(rank)] = {"cause": "straggler",
                                   "host": _remediate.host_of_rank(
                                       rank, view)}
        for rank, st in (frame.get("unhealthy") or {}).items():
            state = st.get("state")
            if state in ("dead", "stalled"):
                verdicts[int(rank)] = {
                    "cause": state,
                    "host": st.get("host")
                    or _remediate.host_of_rank(rank, view)}
            elif state == "straggling" and st.get("why") \
                    == "watchdog_named" and int(rank) not in verdicts:
                verdicts[int(rank)] = {"cause": "straggler",
                                       "host": st.get("host")}
        return verdicts

    def _world(self, view):
        if view and not view.get("local_only") and view.get("world"):
            return int(view["world"])
        try:
            from horovod_tpu_torch.common import basics
            return basics.size()
        except Exception:  # noqa: BLE001
            return 1

    def _check_acks(self):
        """Consume driver-arm outcomes for outstanding requests: a
        rejection (the driver's floor/rate are authoritative and may
        veto what the coordinator's view allowed) refunds the policy's
        rate-budget slot and host cooldown so the arm isn't starved for
        a whole window by a request that executed nothing."""
        if not self._pending_acks:
            return
        client = _remediate._launcher_kv()
        if client is None:
            return
        for req_id, action in list(self._pending_acks.items()):
            try:
                raw = client.get("autopilot", f"ack/{req_id}")
            except Exception:  # noqa: BLE001 — retry next epoch
                continue
            if raw is None:
                continue
            outcome = raw.decode() if isinstance(raw, bytes) else str(raw)
            del self._pending_acks[req_id]
            if outcome.startswith("rejected"):
                self.policy.refund(action.get("host"))
            self._record("remediate", outcome, rank=action.get("rank"),
                         host=action.get("host"), cause=action["cause"],
                         request=req_id)

    @staticmethod
    def _host_sizes(view):
        """{host: ranks-on-it} from the telemetry view (the policy's
        per-host floor debit); empty when no view exists."""
        sizes = {}
        for st in (view.get("health") or {}).values() if view else ():
            h = st.get("host")
            if h:
                sizes[h] = sizes.get(h, 0) + 1
        return sizes

    def _remediate(self, frame, view):
        # Keep the policy's host protection pointed at OUR host: the
        # controller runs on the coordinator, and a verdict on a rank
        # colocated with it must never evict this host.
        import os
        my_host = os.environ.get("HOROVOD_HOST_KEY") \
            or _remediate.host_of_rank(0, view)
        if my_host:
            self.policy.protected_hosts = {my_host}
        self._check_acks()
        verdicts = self._verdicts(frame, view)
        if not verdicts:
            self.policy.observe({}, self._world(view))
            return
        actions = self.policy.observe(verdicts, self._world(view),
                                      host_sizes=self._host_sizes(view))
        for action in actions:
            req = _remediate.publish_request(action, epoch=self.epoch)
            if req:
                self._pending_acks[req] = action
            self._record("remediate",
                         "requested" if req else "unreachable", frame,
                         rank=action["rank"], host=action.get("host"),
                         cause=action["cause"], request=req)

    # --- thread ---------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvd-autopilot")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # Hand overlap steering back to the per-flush path: a pin must
        # not outlive the loop that maintains it.
        try:
            from horovod_tpu_torch.common import basics
            rt = basics._get_state().fusion
            if rt is not None:
                rt._overlap_pinned = False
        except Exception:  # noqa: BLE001 — already torn down
            pass


def _sync_eager_policy(runtime):
    """The runtime's strategy and cross wire into the registries (JAX's
    ``FusionRuntime._sync_eager_policy``)."""
    from horovod_tpu_torch.ops import fusion as _fusion
    _fusion._sync_policy(runtime.strategy, runtime.cross_wire)


# --- module singleton (basics.init / shutdown wiring) ----------------------

_controller = None


def get_controller():
    return _controller


def start_from_config(config):
    """Arm the autopilot when ``HOROVOD_AUTOPILOT`` asks for it. The
    control thread runs ONLY on the coordinator (process 0) — knob flips
    reach followers through the flush-boundary stream, and two deciders
    would publish conflicting boundaries. Returns the controller or
    None."""
    global _controller
    if not getattr(config, "autopilot", False):
        return None
    if _controller is not None:
        return _controller
    try:
        from horovod_tpu_torch.common import basics
        if basics.size() > 1 and basics.rank() != 0:
            return None
    except Exception:  # noqa: BLE001
        return None
    _controller = AutopilotController(config)
    _controller.start()
    hvd_logging.info(
        "autopilot armed: interval=%.1fs hysteresis=%d max_removals=%d "
        "min_world=%d", _controller.interval,
        _controller.policy.hysteresis, _controller.policy.max_removals,
        _controller.policy.min_world)
    return _controller


def stop():
    global _controller
    if _controller is not None:
        _controller.stop()
        _controller = None
