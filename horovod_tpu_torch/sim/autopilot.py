"""Twin-pretrained autopilot: run the REAL tuner loop on priced epochs.

Port of the JAX package's ``sim/autopilot.py``. The live autopilot
(:mod:`horovod_tpu_torch.autopilot.controller`) spends its first ~dozen
decision epochs cold: a categorical sweep over the strategy/wire space,
then Bayesian optimization over the numeric fusion knobs — every sample a
real training epoch at a possibly-bad configuration. This module runs the
SAME machinery — the real :class:`~horovod_tpu_torch.autotune.
parameter_manager.ParameterManager` ``suggest()/observe()`` loop over the
SAME :func:`~horovod_tpu_torch.autotune.parameter_manager.
sweep_categoricals` space — against *simulated* epoch scores, then exports
the observation history through the manager's serialization seam
(``export_observations``). A live controller pointed at the artifact via
``HOROVOD_AUTOPILOT_PRIOR`` skips the sweep and starts the numeric search
at the twin's best point.

The epoch model composes pieces that are already exact rather than
re-modeling them: collective bytes come from :func:`collective_step_tiers`
(the same ``wire.hierarchical_wire_bytes`` integers the runtime records),
the per-tier walls from :func:`profile.roofline.tier_time_estimate`
against :func:`~horovod_tpu_torch.profile.roofline.chip_peaks` (on an
H100 its row; the ``HOROVOD_PEAK_*`` overrides shape the twin), and the
epoch SCORE is the controller's own ``_score`` formula: reduced bytes per
second with the epoch's DCN bytes priced at the DCN roof and added to the
denominator. Deterministic end to end — the only stochastic piece is the
BO's candidate sampler, which is seeded.
"""

import json

from horovod_tpu_torch.common.topology import slice_layout
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.profile import roofline

# Fixed per-flush dispatch overhead (virtual seconds): what makes the
# fusion-threshold knob a real trade-off in the twin — more buckets per
# step cost more dispatches — instead of a flat direction.
FLUSH_OVERHEAD_S = 200e-6


def collective_step_tiers(per_rank_elems, world, num_slices, *,
                          strategy="flat", width=4, cross_wire=""):
    """Per-tier wire bytes of ONE allreduce of ``per_rank_elems``
    elements under ``strategy`` (the JAX package's
    ``analysis/cost.py::collective_step_tiers``, kept here until the
    port's ``analysis/cost.py`` takes it over): the
    ``wire.hierarchical_wire_bytes`` / ``ring_dcn_fraction`` integers the
    runtime books, so the twin and the runtime never disagree on a
    step's bytes.

    Returns ``{"ici": int, "dcn": int}``. Hierarchical strategies book
    tier-explicit legs (local RS+AG within a slice, slice-reduced shards
    on the cross wire between slices; ``torus_qcross`` forces the int8
    cross leg); flat books the full ring volume split on the
    slice-boundary fraction of a rank-major contiguous group."""
    e = max(int(per_rank_elems), 0)
    n = max(int(world), 1)
    k, slice_size = slice_layout(n, num_slices or None)
    if strategy in ("hierarchical", "torus", "torus_qcross") and k > 1:
        h = _wire.hierarchical_wire_bytes(
            e, n, k, width,
            cross_wire=("int8" if strategy == "torus_qcross"
                        else cross_wire or ""))
        return {"ici": int(h["ici"]), "dcn": int(h["dcn"])}
    total = 2 * n * e * width
    frac = _wire.ring_dcn_fraction(list(range(n)), slice_size) \
        if k > 1 else 0.0
    dcn = int(round(total * frac))
    return {"ici": total - dcn, "dcn": dcn}


def _wire_width(name):
    return 2 if name in ("float16", "bfloat16") else 4


def epoch_frame(knobs, world, num_slices, *, per_rank_elems,
                steps_per_epoch, compute_s_per_step, peaks):
    """Price one decision epoch at ``knobs`` (a ``ParameterManager``
    ``suggest()`` triple). Returns the controller's signal-frame shape:
    ``reduced_bytes`` / ``elapsed_s`` / ``dcn_bytes``."""
    threshold, cycle_ms, cats = knobs
    strategy = cats.get("strategy", "flat")
    wire = cats.get("wire_dtype", "")
    if strategy == "torus_qcross":
        # int8 cross leg is the strategy's own; ICI stays payload dtype.
        width, cross = 4, ""
    elif strategy in ("hierarchical", "torus"):
        # a 16-bit cast wire moves every leg of the exact strategies
        width, cross = (_wire_width(wire) if wire else 4), (wire or "")
    else:
        width, cross = (_wire_width(wire) if wire else 4), ""
    tiers = collective_step_tiers(per_rank_elems, world, num_slices,
                                  strategy=strategy, width=width,
                                  cross_wire=cross)
    t = roofline.tier_time_estimate(tiers, world, num_slices, peaks=peaks)
    coll_s = (t["ici_s"] or 0.0) + (t["dcn_s"] or 0.0)
    step_bytes = per_rank_elems * width
    flushes = max(1, -(-step_bytes // max(int(threshold), 1)))
    step_s = compute_s_per_step + coll_s \
        + flushes * FLUSH_OVERHEAD_S + float(cycle_ms) * 1e-3
    return {
        "reduced_bytes": per_rank_elems * 4 * steps_per_epoch,
        "elapsed_s": step_s * steps_per_epoch,
        "dcn_bytes": tiers["dcn"] * steps_per_epoch,
    }


def score_frame(frame, peaks):
    """``controller._score`` verbatim: bytes/sec with the DCN bytes
    priced at the DCN roof in the denominator — the term that makes the
    hierarchy/wire levers separable when wall clock alone cannot."""
    dcn_peak_bps = max(float(peaks.get("dcn_gbs") or 0.0), 1e-3) * 1e9
    dcn_s = frame["dcn_bytes"] / dcn_peak_bps
    return frame["reduced_bytes"] / (frame["elapsed_s"] + dcn_s)


def pretrain(world, num_slices, *, strategy="flat", wire_dtype="",
             per_rank_elems=1 << 20, steps_per_epoch=10,
             compute_s_per_step=1e-3, initial_threshold=64 * 1024,
             initial_cycle_ms=1.0, bayes_opt_max_samples=4,
             max_move_log2=1.0, max_epochs=200, peaks=None):
    """Run the real tuner to convergence on twin-priced epochs and
    return ``{"prior": <export_observations artifact>, ...}``.

    Arguments mirror the live controller's ``_build_pm`` construction
    (zero warmup, one step per sample, bounded moves) so the exported
    prior validates against the space a live manager on the same layout
    builds. ``strategy``/``wire_dtype`` are the job's CONFIGURED values
    (the sweep's tie-break incumbents), not the expected winners."""
    from horovod_tpu_torch.autotune import (ParameterManager,
                                      sweep_categoricals)
    peaks = peaks or roofline.chip_peaks()
    cats = sweep_categoricals(strategy, wire_dtype, int(num_slices) > 1)
    pm = ParameterManager(
        warmup_samples=0, steps_per_sample=1,
        bayes_opt_max_samples=int(bayes_opt_max_samples),
        initial_threshold=int(initial_threshold),
        initial_cycle_ms=float(initial_cycle_ms),
        categorical_knobs=cats, max_move_log2=float(max_move_log2))
    history = []
    epochs = 0
    while pm.tuning and epochs < int(max_epochs):
        knobs = pm.suggest()
        frame = epoch_frame(knobs, world, num_slices,
                            per_rank_elems=per_rank_elems,
                            steps_per_epoch=steps_per_epoch,
                            compute_s_per_step=compute_s_per_step,
                            peaks=peaks)
        score = score_frame(frame, peaks)
        history.append({"epoch": epochs, "categoricals": knobs[2],
                        "fusion_threshold": knobs[0],
                        "cycle_time_ms": round(knobs[1], 4),
                        "score": round(score, 3)})
        pm.observe(score)
        epochs += 1
    return {
        "prior": pm.export_observations(),
        "epochs": epochs,
        "frozen": not pm.tuning,
        "winner": {"categoricals": pm.categoricals,
                   "fusion_threshold": pm.fusion_threshold,
                   "cycle_time_ms": pm.cycle_time_ms},
        "history": history,
        "layout": {"world": int(world), "num_slices": int(num_slices),
                   "per_rank_elems": int(per_rank_elems),
                   "chip": peaks.get("chip")},
    }


def write_prior(path, result):
    """Write a :func:`pretrain` result's prior artifact where
    ``HOROVOD_AUTOPILOT_PRIOR`` / ``hvdrun-torch --autopilot-prior``
    point."""
    with open(path, "w") as f:
        json.dump(result["prior"], f, indent=1, sort_keys=True)
        f.write("\n")
