"""The world's (cross, local) layouts and the subgroups of their tiers.

Port of the JAX package's ``common/topology.py``: ``forced_slices``,
``slice_layout``, ``slice_of_rank`` and the (cross, local) factorization of
``build_topology``. Where the JAX package factors its devices by TPU host
and by slice, the port factors its ranks by node: ranks are host-major, as
the launcher assigns them (rank = cross_rank * local_size + local_rank), so
a node plays a TPU host, and

- the *node layout* is ``cross_size`` x ``local_size`` (JAX's ``mesh2d``),
  as ``hvd.init`` read them;
- the *slice layout* is ``HOROVOD_MESH_SLICES=k`` slices of ``size / k``
  ranks (JAX's forced slice count, with its divisibility rules), or,
  unforced, one slice per node; fewer than two slices, or a count that
  does not divide the world, is the one-slice layout.

``forced`` is ``HOROVOD_MESH_SLICES`` as ``hvd.init`` read it. A layout of
``rows`` x ``cols`` ranks gives each rank two subgroups: its
*local* group, the ranks of its row (same cross index), and its *cross*
group, the ranks of its column (same local index). ``dist.new_group`` is
collective over the whole world, so every rank creates every row's and
every column's group, in the same order, even those it is not in: at
``hvd.init`` when a knob arms a tier, else at the first use, which SPMD
makes the same call on every rank. ``hvd.shutdown`` destroys them, and an
elastic reset builds them anew with the next world.

The mesh axis names are the JAX package's: ``HVD_AXIS`` (the flat world
axis, the default of the in-step collectives and of sequence parallelism),
``CROSS_AXIS``/``LOCAL_AXIS`` (the node layout) and the parallel
strategies' ``DP_AXIS``, ``PP_AXIS``, ``TP_AXIS``, ``SP_AXIS`` and
``EP_AXIS``. ``ops/in_step.py`` binds them to a ``DeviceMesh``'s dims.
"""

import os

import torch.distributed as dist

HVD_AXIS = "hvd"
CROSS_AXIS = "cross"
LOCAL_AXIS = "local"
DP_AXIS, PP_AXIS, TP_AXIS, SP_AXIS, EP_AXIS = "dp", "pp", "tp", "sp", "ep"


def parse_slices(value):
    """A ``HOROVOD_MESH_SLICES`` value as an int, 0 when unset or not a
    number (JAX's ``_env_int``)."""
    try:
        return int(value or 0)
    except ValueError:
        return 0


def forced_slices():
    """The ``HOROVOD_MESH_SLICES`` override, or 0 when unset (read live, as
    the JAX package reads it)."""
    return parse_slices(os.environ.get("HOROVOD_MESH_SLICES"))


def slice_layout(size, num_slices=None):
    """``(num_slices, slice_size)`` for a ``size``-rank world: an explicit
    ``num_slices`` wins over the forced knob; an undivisible or < 2 slice
    count is the one-slice layout."""
    size = max(int(size), 1)
    k = int(num_slices) if num_slices else forced_slices()
    if k <= 1 or size % k != 0:
        return 1, size
    return k, size // k


def slice_of_rank(rank, slice_size):
    """Slice of a rank under the rank-major (slice, ranks-in-slice)
    layout."""
    return int(rank) // max(int(slice_size), 1)


def tier_members(rows, cols, rank):
    """This rank's local group (its row) and cross group (its column) of a
    ``rows`` x ``cols`` rank-major layout, as lists of global ranks."""
    row, col = divmod(int(rank), int(cols))
    return ([row * cols + c for c in range(cols)],
            [r * cols + col for r in range(rows)])


class Tiers:
    """A ``rows`` x ``cols`` layout of the world, rank-major, with this
    rank's local group (its row) and cross group (its column)."""

    def __init__(self, rows, cols, rank):
        self.rows, self.cols = int(rows), int(cols)
        self.local_ranks, self.cross_ranks = tier_members(rows, cols, rank)
        self.local_group = self.cross_group = None
        self._groups = []
        for r in range(self.rows):
            ranks = [r * self.cols + c for c in range(self.cols)]
            self._groups.append(dist.new_group(ranks))
            if ranks == self.local_ranks:
                self.local_group = self._groups[-1]
        for c in range(self.cols):
            ranks = [r * self.cols + c for r in range(self.rows)]
            self._groups.append(dist.new_group(ranks))
            if ranks == self.cross_ranks:
                self.cross_group = self._groups[-1]

    def destroy(self, aborted=False):
        """Destroy the groups (``aborted``: they went with the world's
        abort; only forget them)."""
        groups, self._groups = self._groups, []
        self.local_group = self.cross_group = None
        if aborted:
            return
        for g in groups:
            if g is not None and g != dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(g)


class Topology:
    """The node and slice layouts of one initialized world, and their
    tiers, built once each."""

    def __init__(self, size, rank, local_size, cross_size, forced=0):
        self.size, self.rank = int(size), int(rank)
        homogeneous = local_size * cross_size == size
        # A world whose nodes differ in size has no node layout: one node.
        self.cross_size = int(cross_size) if homogeneous else 1
        self.local_size = int(local_size) if homogeneous else self.size
        self.num_slices, self.slice_size = slice_layout(
            self.size, forced or self.cross_size)
        self._tiers = {}

    def node_shape(self):
        return self.cross_size, self.local_size

    def strategy_shape(self):
        """The decomposition of the hierarchical strategies: the slice
        layout when there are slices, else the node layout (JAX's
        ``_hier_mesh`` or ``mesh2d``)."""
        if self.num_slices > 1:
            return self.num_slices, self.slice_size
        return self.node_shape()

    def tiers(self, shape):
        """The :class:`Tiers` of a ``(rows, cols)`` layout, created on first
        use (collectively: every rank asks for the same layouts in the same
        order)."""
        t = self._tiers.get(shape)
        if t is None:
            t = self._tiers[shape] = Tiers(shape[0], shape[1], self.rank)
        return t

    def destroy(self, aborted=False):
        for t in self._tiers.values():
            t.destroy(aborted)
        self._tiers = {}
