"""hvdgoodput: job-level goodput/badput accounting + durable run history.

Port of the JAX package's ``goodput/`` package. It answers the two
questions that survive the run:

1. **What fraction of this job's wall-clock was productive training, and
   where did the rest go?** — :mod:`horovod_tpu_torch.goodput.ledger`, a
   per-rank state machine that decomposes total wall time into
   ``productive_compute`` plus seven named badput categories, with the
   conservation guarantee: the categories sum to the measured wall within
   1%.

2. **How does this run compare to every run before it?** —
   :mod:`horovod_tpu_torch.goodput.history`, an append-only per-run JSONL
   journal flushed line by line, so a SIGKILLed run still leaves
   evidence, and :mod:`horovod_tpu_torch.goodput.report` (``python -m
   horovod_tpu_torch.goodput``) to render one run and diff/regress across
   runs with the same robust-z the step profiler uses for straggler
   naming.

Knobs: ``HOROVOD_GOODPUT`` (default on), ``HOROVOD_GOODPUT_DIR``
(per-rank shutdown summaries), ``HOROVOD_RUN_HISTORY_DIR`` (the durable
journal; empty = off), ``HOROVOD_GOODPUT_JOURNAL_S``. Goodput must never
fail the job: all module-level entry points are armed-gated and
fail-soft.
"""

from horovod_tpu_torch.goodput.ledger import (BADPUT_CATEGORIES, CATEGORIES,
                                        PRODUCTIVE, GoodputLedger,
                                        ServingGoodput, armed, configure,
                                        get_ledger, note_commit,
                                        note_recovery, note_reset,
                                        note_straggler, note_unwedged,
                                        note_wedge, on_step_boundary,
                                        reset, serving_snapshot, set_trial,
                                        shutdown, snapshot, wedge_from_rows)
from horovod_tpu_torch.goodput.history import (RunJournal, config_fingerprint,
                                         get_journal, journal_append,
                                         journal_configure, read_journal,
                                         read_runs)

__all__ = [
    "BADPUT_CATEGORIES", "CATEGORIES", "PRODUCTIVE", "GoodputLedger",
    "ServingGoodput", "RunJournal", "armed", "configure",
    "config_fingerprint", "get_journal", "get_ledger", "journal_append",
    "journal_configure", "note_commit", "note_recovery", "note_reset",
    "note_straggler", "note_unwedged", "note_wedge", "on_step_boundary",
    "read_journal", "read_runs", "reset", "serving_snapshot", "set_trial",
    "shutdown", "snapshot", "wedge_from_rows",
]
