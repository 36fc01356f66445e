"""Process sets: collectives over subsets of ranks.

Port of the JAX package's ``common/process_sets.py`` (reference semantics:
horovod/common/process_set.h:26-180 + horovod/common/process_sets.py:18-190).
Where the JAX package maps a set onto a device sub-mesh, the port maps it
onto a ``torch.distributed`` group. ``dist.new_group`` is collective over the
whole world, so every rank registers every set, in the same order — the
reference's rule for ``add_process_set`` too.
"""

import threading

import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import ProcessSetError

_lock = threading.RLock()


class ProcessSet:
    """An ordered subset of Horovod ranks (reference: process_sets.py:18-77).

    Instantiate with a list of ranks and register via
    ``hvd.init(process_sets=...)`` or ``hvd.add_process_set``.
    """

    def __init__(self, ranks_or_comm=None):
        if ranks_or_comm is not None:
            ranks_or_comm = list(ranks_or_comm)
        self.ranks = ranks_or_comm  # None = global set
        self.process_set_id = None
        # torch.distributed group; None is the default (world) group.
        self.group = None
        # Ranks that called hvd.join(process_set=self), as the set's last
        # join round showed them; the global set keeps its own in basics.
        self.joined_ranks = set()

    def size(self):
        if self.process_set_id is None:
            raise ProcessSetError("Process set is not yet registered.")
        if self.ranks is None:
            return basics.size()
        return len(self.ranks)

    def rank(self):
        """This process's rank within the set, or -1 if not included
        (reference: process_sets.py:60-70)."""
        if self.process_set_id is None:
            raise ProcessSetError("Process set is not yet registered.")
        try:
            return self.rank_list().index(basics.rank())
        except ValueError:
            return -1

    def included(self):
        return self.rank() >= 0

    def rank_list(self):
        if self.ranks is None:
            return list(range(basics.size()))
        return list(self.ranks)

    def __eq__(self, other):
        return isinstance(other, ProcessSet) and self.ranks == other.ranks

    def __hash__(self):
        return hash(tuple(self.ranks) if self.ranks is not None else None)

    def __str__(self):
        return (f"ProcessSet(process_set_id={self.process_set_id}, "
                f"ranks={self.ranks})")


global_process_set = ProcessSet(None)
global_process_set.process_set_id = 0


class _ProcessSetTable:
    """reference: ProcessSetTable (process_set.h:89-180)."""

    def __init__(self):
        self.by_id = {0: global_process_set}
        self.next_id = 1

    def register(self, ps):
        for existing in self.by_id.values():
            if existing == ps:
                ps.process_set_id = existing.process_set_id
                return existing
        world = basics.size()
        if ps.ranks is not None:
            if len(set(ps.ranks)) != len(ps.ranks):
                raise ProcessSetError(
                    f"Duplicate ranks in process set: {ps.ranks}")
            if any(r < 0 or r >= world for r in ps.ranks):
                raise ProcessSetError(
                    f"Process set ranks out of range [0,{world}): {ps.ranks}")
            ps.group = dist.new_group(ps.ranks)
        ps.process_set_id = self.next_id
        self.next_id += 1
        self.by_id[ps.process_set_id] = ps
        return ps

    def remove(self, ps):
        if ps.process_set_id in (None, 0):
            raise ProcessSetError("Cannot remove the global process set.")
        if self.by_id.get(ps.process_set_id) is not ps:
            raise ProcessSetError(f"{ps} is not registered")
        del self.by_id[ps.process_set_id]
        ps.process_set_id = None
        self._destroy(ps)

    def destroy_groups(self):
        for ps in list(self.by_id.values()):
            if ps.ranks is not None:
                ps.process_set_id = None
                self._destroy(ps)
        self.by_id = {0: global_process_set}

    @staticmethod
    def _destroy(ps):
        group, ps.group = ps.group, None
        # A rank outside the set holds a non-member placeholder group.
        if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER:
            dist.destroy_process_group(group)


def _init_table(state, process_sets):
    table = _ProcessSetTable()
    state.process_set_table = table
    for ps in process_sets or ():
        table.register(ps)


def _table():
    return basics._get_state().process_set_table


def add_process_set(process_set):
    """Register a new process set (reference: process_sets.py:101-133).
    Collective: every rank calls it with the same ranks, in the same order
    as every other registration."""
    with _lock:
        if not isinstance(process_set, ProcessSet):
            process_set = ProcessSet(process_set)
        return _table().register(process_set)


def remove_process_set(process_set):
    """reference: process_sets.py:136-155."""
    with _lock:
        _table().remove(process_set)


def process_set_by_id(process_set_id):
    try:
        return _table().by_id[process_set_id]
    except KeyError:
        raise ProcessSetError(f"Unknown process_set_id {process_set_id}")
