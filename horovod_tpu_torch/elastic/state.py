"""Elastic training state: commit, restore, sync, and the retry loop.

Port of the JAX package's ``elastic/state.py`` (reference:
horovod/common/elastic.py State:29, ObjectState:127, run_fn:168): state is
committed in memory each step or epoch; on a collective failure
(``HorovodInternalError``) the last commit is restored and the process
group comes back; on a membership change (``HostsUpdatedInterrupt``) the
current state is kept. ``sync()`` broadcasts rank 0's state after a
rendezvous.

A commit is a deep copy on the tensors' own device: CUDA tensors outlive
the process group, so where the JAX package detaches its commits to the
host before it rebuilds its backend, this one leaves them on the card.
``TpuState`` (JAX trees) has no counterpart here; ``torch/elastic.py``'s
``TorchState`` takes its place. The JAX module's flight, goodput and
metrics hooks are here: a commit books its seconds to goodput's
``checkpoint_commit`` and marks the step (a state with a ``step``
attribute); the run loop records the elastic events (``sync``,
``restore``, ``host_update``, ``reset``), books the recovery to
``elastic_recovery_seconds`` and goodput, flips goodput to
``rendezvous_recovery`` at a failure or a membership change, and dumps the
flight ring at a collective failure and at a removal. Its chaos hooks are
ROADMAP A17.
"""

import copy
import time

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.goodput import ledger as _goodput
from horovod_tpu_torch.metrics import instruments as _metrics


class State:
    """Base elastic state (reference: common/elastic.py:29-126)."""

    def __init__(self, **kwargs):
        self._host_messages = None  # set by worker.attach_listener
        self._reset_callbacks = []
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks):
        """Callbacks run after a reset (LR re-scaling etc., reference:
        elastic.py:44-52)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def commit(self):
        """Save, then check for a new membership (reference:
        elastic.py:54)."""
        t_save = time.monotonic()
        self.save()
        _goodput.note_commit(time.monotonic() - t_save)
        step = getattr(self, "step", None)
        if step is not None:
            # Only with a real step attribute: a step-less State must not
            # burn the auto counter the optimizer wrapper may be driving.
            _flight.step_marker(step)
        self.check_host_updates()

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def detach_to_host(self):
        """Move live device state that must outlive the process group to
        the host. Called by the elastic re-init before the group comes
        down (the serving engine's K/V migration payload). Default: no-op;
        a commit's tensors stay on their device."""

    def reset(self):
        pass

    def check_host_updates(self):
        """Raise ``HostsUpdatedInterrupt`` when the driver published a new
        membership (reference: elastic.py:75-100, here a KV version
        poll)."""
        if self._host_messages is None:
            return
        observed = self._host_messages.poll()
        if observed is not None:
            # Decided before acknowledging: the walk over the versions'
            # kinds reads the KV, and an error after the acknowledge would
            # swallow the interrupt for good. Only the observed version is
            # acknowledged, so a later bump still raises.
            skip = self._host_messages.removal_only(observed)
            self._host_messages.acknowledge(observed)
            raise HostsUpdatedInterrupt(skip_sync=skip)


class ObjectState(State):
    """State of Python attributes, synced by object broadcast (reference:
    common/elastic.py:127-170). A commit deep-copies each attribute; tensors
    stay on their device."""

    def __init__(self, bcast_object=None, **kwargs):
        from horovod_tpu_torch.ops.collective_ops import broadcast_object
        self._bcast_object = bcast_object or broadcast_object
        self._saved_state = dict(kwargs)
        super().__init__(**kwargs)

    def save(self):
        self._saved_state = {attr: copy.deepcopy(getattr(self, attr))
                             for attr in self._saved_state}

    def restore(self):
        for attr, value in self._saved_state.items():
            setattr(self, attr, copy.deepcopy(value))

    def sync(self):
        if self._saved_state:
            synced = self._bcast_object(self._saved_state, root_rank=0)
            for attr, value in synced.items():
                setattr(self, attr, value)
            self._saved_state = synced


def _elastic_launch():
    return basics._get_state().config.elastic


def _sync_vote(want_sync):
    """Whether to sync, decided by every member of the new group: one MAX
    all-reduce of a flag. Members may disagree locally (a new worker or a
    failure's survivor needs rank 0's state, a survivor of a removal does
    not), and ``sync()`` is a collective that every member must enter.
    Outside an elastic launch of more than one process the local flag
    decides."""
    if not _elastic_launch() or basics.size() <= 1:
        return want_sync
    import torch

    from horovod_tpu_torch.ops.collective_ops import Max, allreduce
    flag = torch.tensor([int(bool(want_sync))], dtype=torch.int64,
                        device=basics.device())
    return bool(allreduce(flag, op=Max).item())


def _reset(state):
    """Re-initialize in place at the current membership: the group comes
    down (aborted: peers may be dead), this slot's row of the new version
    sets the rank env, and ``init`` builds a new group on the same device
    (reference: common/elastic.py:168 run_fn's shutdown, re-rendezvous,
    re-init)."""
    from horovod_tpu_torch.elastic.worker import refresh_assignment_env
    _metrics.record_elastic_event("reset")
    state.detach_to_host()
    basics.shutdown(abort=True)
    consumed_version = refresh_assignment_env()
    if consumed_version is None:
        hvd_logging.info("slot removed from the membership; exiting")
        # Last words: no atexit dump runs after this exit.
        _flight.dump("membership_removed")
        raise SystemExit(0)
    basics.init(device=basics.asked_device())
    if state._host_messages is not None:
        # Exactly the version this init consumed: a bump published since
        # must still raise at the next commit.
        state._host_messages.acknowledge(consumed_version)
    state.on_reset()


def run(func):
    """Elastic run decorator (reference: common/elastic.py:168 run_fn).

    ``@hvd.elastic.run`` wraps ``train(state, ...)``: it syncs the state on
    entry, and retries ``func`` on ``HorovodInternalError`` (the group is
    aborted at once and the last commit restored) and on
    ``HostsUpdatedInterrupt`` (the state is kept), re-initializing between
    attempts.
    """

    def wrapper(state, *args, **kwargs):
        from horovod_tpu_torch.elastic.worker import (
            arm_collective_abort, configured_version,
            disarm_collective_abort, mark_new_rank_ready, read_new_rank_ready,
            wait_for_version_change)
        reset_required = False
        skip_sync = False
        # (cause, monotonic start) of the recovery in progress: booked once
        # the function is re-entered at the new membership.
        recovering = None
        while True:
            known_version = configured_version()
            try:
                if reset_required:
                    _reset(state)
                    reset_required = False
                # The scale-up barrier: announce this worker, wait until
                # the whole membership is up before the state broadcast
                # (reference: horovod_mark_new_rank_ready,
                # operations.cc:1264-1305). No-op outside elastic launches.
                mark_new_rank_ready()
                read_new_rank_ready()
                if _sync_vote(want_sync=not skip_sync):
                    _metrics.record_elastic_event("sync")
                    state.sync()
                skip_sync = False
                known_version = configured_version()
                if recovering is not None:
                    dt = time.monotonic() - recovering[1]
                    _goodput.note_recovery(recovering[0], dt)
                    _metrics.record_elastic_recovery(recovering[0], dt)
                    recovering = None
                arm_collective_abort(known_version)
                try:
                    return func(state, *args, **kwargs)
                finally:
                    disarm_collective_abort()
            except HorovodInternalError:
                if recovering is None:
                    recovering = ("failure", time.monotonic())
                # Everything from here to the first step boundary after the
                # restore (the destroyed open window included) is
                # rendezvous_recovery badput.
                _goodput.note_reset()
                _metrics.record_elastic_event("restore")
                # The ring's tail is the failed collective and what led to
                # it: dumped before recovery traffic overwrites any of it.
                _flight.dump("horovod_internal_error")
                hvd_logging.warning(
                    "collective failure; restoring the last commit")
                # The group comes down now, not after the wait: peers may
                # be dead, and a collective error leaves the group unusable.
                basics.shutdown(abort=True)
                state.restore()
                # A peer likely died: give the driver time to publish the
                # shrunk membership before re-initializing, or the new
                # group would wait on the dead rank (reference: the driver
                # notices the exit and republishes, elastic/driver.py:304+).
                wait_for_version_change(known_version)
                reset_required = True
            except HostsUpdatedInterrupt as e:
                if recovering is None:
                    recovering = ("host_update", time.monotonic())
                _goodput.note_reset()
                _metrics.record_elastic_event("host_update")
                hvd_logging.info("membership changed; re-initializing")
                reset_required = True
                skip_sync = e.skip_sync

    return wrapper
