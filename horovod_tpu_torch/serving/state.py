"""ServingState: elastic commit/restore/sync for a live serving engine.

Port of the JAX package's ``serving/state.py``. It extends the port's
:class:`~horovod_tpu_torch.torch.elastic.TorchState`, with the engine's
model as its ``model``, so the serving fleet rides the same rendezvous
machinery as training: ``commit()`` snapshots the request-level state
(queue order and every in-flight request's committed tokens, a picklable
attribute that ``sync()`` broadcasts to workers joining at scale-up) and
the weights; on a collective failure ``restore()`` rolls requests back to
the last commit and marks the slot caches stale; on a membership change
``reset()`` rebuilds the engine's caches on the new membership's device,
either migrating the in-flight K/V caches (``detach_to_host`` first,
``HOROVOD_SERVING_MIGRATE_KV``) or re-queuing every in-flight request from
its last committed token for re-prefill.

Either way a request is never lost and never skips ahead: its remaining
tokens are reproduced exactly (position-keyed sampling).

A serving commit runs every step group (by default every token), so it
keeps JAX's rule: the weights' snapshot is reused while ``engine.model``
is the same object (serving never changes the weights; a hot swap replaces
the object and forces a fresh copy), where ``TorchState.save`` would
deep-copy the whole ``state_dict()`` at every commit.

Usage::

    engine = ServingEngine(model, num_slots=4)
    reqs = [engine.submit(p, max_new=8) for p in prompts]
    state = ServingState(engine, step=0)
    elastic.attach_listener(state)

    @hvd.elastic.run
    def serve(state):
        def commit():
            state.step += 1
            state.commit()
        engine.run_until_idle(commit=commit)
        return [r.result(0) for r in reqs]
"""

from horovod_tpu_torch.torch.elastic import TorchState


class ServingState(TorchState):
    def __init__(self, engine, **kwargs):
        self._engine = engine
        self._model_src = None       # identity of the last-saved model
        kwargs.setdefault("reqs", engine.request_snapshot())
        super().__init__(model=engine.model, optimizer=None, **kwargs)

    def save(self):
        reqs = self.reqs = self._engine.request_snapshot()
        # Keep the tracked model pointed at the engine's live one (a hot
        # swap replaces engine.model between commits).
        self.model = self._engine.model
        # The request snapshot is built fresh and nothing changes it, so
        # the commit keeps it as it is (ObjectState.save would deep-copy
        # it again, most of a per-token commit's host time).
        others = self._saved_state
        self._saved_state = {k: v for k, v in others.items() if k != "reqs"}
        kept = None
        if self._model_src is self._engine.model \
                and self._saved_model_state is not None:
            kept = self._saved_model_state
            self.model = None            # TorchState.save skips the copy
        try:
            super().save()
        finally:
            self.model = self._engine.model
            self._saved_state["reqs"] = reqs
        if kept is not None:
            self._saved_model_state = kept
        self._model_src = self._engine.model

    def restore(self):
        super().restore()
        self._engine.model = self.model
        self._model_src = None       # restored copy: re-snapshot next save
        # Requests roll back to the last commit; the device caches are now
        # AHEAD of the committed streams, so they are stale by definition.
        self._engine.load_request_snapshot(self.reqs)
        self._engine.invalidate_cache()

    def sync(self):
        super().sync()
        self._engine.model = self.model
        self._model_src = None       # broadcast copy: re-snapshot next save
        # Joining workers materialize the broadcast request set; existing
        # workers merge (known rids keep their caller futures). A worker
        # whose live request state ALREADY equals the broadcast snapshot
        # — the graceful-migration boundary: commit, membership change,
        # sync — skips the merge: rolling back to an identical snapshot
        # would evict the freshly migrated slot caches for nothing.
        if self._engine.request_snapshot() != self.reqs:
            self._engine.load_request_snapshot(self.reqs)

    def detach_to_host(self):
        # Engine first: the K/V migration payload leaves the device before
        # the process group comes down.
        self._engine.detach_to_host()
        super().detach_to_host()

    def reset(self):
        # New membership, maybe a new device: rebuild the caches there.
        # The engine migrates its detached live cache when armed for it
        # and the slot table survived; otherwise it evicts-and-requeues.
        self._engine.reset_runtime()
        super().reset()
