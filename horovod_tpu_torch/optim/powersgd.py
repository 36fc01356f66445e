"""PowerSGD: low-rank gradient compression with error feedback.

Port of the JAX package's ``optim/powersgd.py`` (Vogels et al., NeurIPS
2019; torch.distributed's ``powerSGD_hook``). Each gradient matrix M (n, m)
crosses the wire as two rank-r factors instead of n * m elements:

1. M = the gradient (prescaled, in fp32) plus this rank's residual e;
   P = M Q with the previous step's Q (warm start);
2. every leaf's P in ONE grouped Average allreduce; P orthonormalized (a
   reduced QR of identical inputs, so identical on every rank);
3. Q = Mᵀ P; every leaf's Q in ONE grouped Average allreduce;
4. M̂ = P Qᵀ (times the set's size for Sum, then the postscale); the local
   residual M - M̂ becomes the next step's e.

Leaves that do not pay for compression (1-D leaves, and matrices where
``r (n + m) min_compression_rate > n m``) reduce as they are, with the op
and the scales, in the same grouped call. The factor exchanges ride the
fusion runtime, so each is one bucket of the scale kernels' pack and
unpack.

A leaf is matrixized as ``leaf.reshape(shape[0], -1)`` in the JAX
package's layout: the port's Flax-named modules keep their kernels as
``parallel.tp.FlaxKernel``, whose Flax view (:func:`parallel.tp.flax_view`)
the optimizer hands this module. In torch's own layout QR would
orthonormalize the other factor, and the compress-or-not decision could
differ. The products run at JAX's DEFAULT precision (TF32 on the card,
``parallel.tp.at_precision``).

:class:`PowerSGD` is the functional core, (gradient list, state) -> (reduced
list, new state), in stages the optimizer can overlap with the backward;
``horovod_tpu_torch.torch.DistributedOptimizer`` drives it. The state is
JAX's: per leaf a Q (m, r) in fp32 and a residual of the leaf's shape in
``ef_dtype`` (the leaf's dtype by default), empty for an uncompressed leaf.
Q starts from ``torch.Generator`` seeded ``17 + i`` for leaf ``i``: the
same on every rank, never rank-dependent (JAX draws from
``PRNGKey(17 + i)``; the values differ, the rule is the same).
"""

import torch

from horovod_tpu_torch.ops.collective_ops import Average, ReduceOp, Sum
from horovod_tpu_torch.parallel.tp import at_precision


class PowerSGDCompressor:
    """The marker ``Compression.powersgd(rank)`` builds for
    ``DistributedOptimizer(compression=...)``. Stateful (warm-start factors
    and error feedback), so a stateless path, an allreduce called with it,
    raises."""

    def __init__(self, rank=4, min_compression_rate=2.0, ef_dtype=None):
        if rank < 1:
            raise ValueError(f"PowerSGD rank must be >= 1, got {rank}")
        self.rank = int(rank)
        self.min_compression_rate = float(min_compression_rate)
        # None: error feedback in the leaf dtype; torch.float32 keeps a bf16
        # model's residual in full precision.
        self.ef_dtype = ef_dtype

    def compress(self, tensor):
        raise ValueError(
            "Compression.powersgd is stateful (warm-start factors + error "
            "feedback) and only works through DistributedOptimizer / "
            "powersgd_gradients_transform — the stateless eager/fused "
            "compression path cannot run it")

    def decompress(self, tensor, ctx):
        raise ValueError(
            "Compression.powersgd only works through DistributedOptimizer")


def as_matrix(leaf):
    """(n, m): dim 0 against everything else (powerSGD_hook's rule)."""
    return leaf.reshape(leaf.shape[0], -1)


def _dims(shape):
    n = shape[0] if shape else 1
    m = 1
    for s in shape[1:]:
        m *= s
    return n, m


def use_powersgd(shape, rank, min_rate):
    """Whether a leaf of ``shape`` is compressed."""
    if len(shape) < 2:
        return False
    n, m = _dims(shape)
    r = min(rank, n, m)
    return r * (n + m) * min_rate <= n * m


def init_q(shape, rank, i, device=None):
    """Leaf ``i``'s first Q, (m, r) fp32: a standard normal from a
    generator seeded ``17 + i``, the same on every rank."""
    n, m = _dims(shape)
    r = min(rank, n, m)
    gen = torch.Generator().manual_seed(17 + i)
    return torch.randn((m, r), generator=gen).to(device)


def powersgd_wire_numbers(shapes, rank, min_compression_rate=2.0):
    """(compressed bytes, uncompressed bytes) a step for fp32 leaves of
    ``shapes``: a compressed leaf moves r (n + m) elements, the others
    their size, either way."""
    wire = full = 0
    for shape in shapes:
        n, m = _dims(tuple(shape))
        full += n * m * 4
        if use_powersgd(tuple(shape), rank, min_compression_rate):
            wire += min(rank, n, m) * (n + m) * 4
        else:
            wire += n * m * 4
    return wire, full


def _mm(a, b):
    return at_precision(None, torch.matmul, a, b)


class PowerSGD:
    """The functional core of ``powersgd_gradients_transform``.

    ``op`` is ``Sum`` or ``Average``; the factors are averaged over
    ``process_set`` (None: the world) either way, and Sum scales the
    decompressed mean by the set's size. ``prescale_factor`` multiplies the
    gradient before the residual is added; ``postscale_factor`` the
    result."""

    def __init__(self, rank=4, op=Average, process_set=None,
                 min_compression_rate=2.0, prescale_factor=1.0,
                 postscale_factor=1.0, ef_dtype=None):
        op = ReduceOp(op)
        if op not in (Sum, Average):
            raise ValueError(
                f"PowerSGD supports Sum/Average only, got {op!r} (Min/Max/"
                f"Product/Adasum have no low-rank-factor semantics)")
        self.rank = int(rank)
        self.op = op
        self.process_set = process_set
        self.min_compression_rate = float(min_compression_rate)
        self.prescale_factor = float(prescale_factor)
        self.postscale_factor = float(postscale_factor)
        self.ef_dtype = ef_dtype

    def compressed(self, shape):
        return use_powersgd(tuple(shape), self.rank,
                            self.min_compression_rate)

    def init_leaf(self, leaf, i):
        """Leaf ``i``'s state: (Q, residual), both empty when it is not
        compressed."""
        e_dt = self.ef_dtype or leaf.dtype
        if self.compressed(leaf.shape):
            return (init_q(leaf.shape, self.rank, i, leaf.device),
                    torch.zeros(leaf.shape, dtype=e_dt, device=leaf.device))
        return (torch.zeros(0, device=leaf.device),
                torch.zeros(0, dtype=e_dt, device=leaf.device))

    def init(self, leaves):
        """JAX's ``init_fn``: ``{"q": (...), "err": (...)}`` over
        ``leaves``."""
        qs, errs = zip(*(self.init_leaf(p, i) for i, p in enumerate(leaves)))
        return {"q": tuple(qs), "err": tuple(errs)}

    # ---- the stages (the optimizer overlaps phase 1 with the backward) ----

    def error_fed(self, grad, err, scale=1.0):
        """M: the gradient as a matrix in fp32, times the prescale (and an
        extra ``scale``), plus the residual."""
        m = as_matrix(grad).float()
        s = self.prescale_factor * scale
        if s != 1.0:
            m = m * s
        return m + as_matrix(err).float()

    def phase1(self, m, q):
        """P = M Q, to be averaged."""
        return _mm(m, q)

    def phase2(self, m, p_avg):
        """The averaged P orthonormalized, and Q = Mᵀ P, to be averaged."""
        p = torch.linalg.qr(p_avg)[0]
        return p, _mm(m.t(), p)

    def finish(self, leaf_shape, leaf_dtype, m, p, q_avg, err_dtype):
        """The reduced leaf and its new residual."""
        m_hat = _mm(p, q_avg.t())
        err = (m - m_hat).to(err_dtype).reshape(leaf_shape)
        if self.op == Sum:
            # The factors were averaged (the stable exchange): Sum scales
            # the decompressed mean back up.
            m_hat = m_hat * self._participants()
        if self.postscale_factor != 1.0:
            m_hat = m_hat * self.postscale_factor
        return m_hat.reshape(leaf_shape).to(leaf_dtype), err

    def _participants(self):
        from horovod_tpu_torch.common import basics
        ps = self.process_set
        return ps.size() if ps is not None and ps.ranks is not None \
            else basics.size()

    # ---- the whole transform, synchronously ----

    def reduce(self, grads, state):
        """(gradient list, state) -> (reduced list, new state): JAX's
        ``update_fn`` on this rank's gradients, the three grouped
        allreduces launched here."""
        from horovod_tpu_torch.ops.collective_ops import grouped_allreduce
        grads = list(grads)
        comp = [i for i, g in enumerate(grads) if self.compressed(g.shape)]
        plain = [i for i in range(len(grads)) if i not in set(comp)]
        out = [None] * len(grads)
        if plain:
            reduced = grouped_allreduce(
                [grads[i] for i in plain], op=self.op,
                prescale_factor=self.prescale_factor,
                postscale_factor=self.postscale_factor,
                process_set=self.process_set)
            for i, r in zip(plain, reduced):
                out[i] = r
        new_q, new_err = list(state["q"]), list(state["err"])
        if comp:
            mats = [self.error_fed(grads[i], state["err"][i]) for i in comp]
            ps = grouped_allreduce(
                [self.phase1(m, state["q"][i]) for m, i in zip(mats, comp)],
                op=Average, process_set=self.process_set)
            ps, qs = zip(*(self.phase2(m, p) for m, p in zip(mats, ps)))
            qs = grouped_allreduce(list(qs), op=Average,
                                   process_set=self.process_set)
            for m, p, q, i in zip(mats, ps, qs, comp):
                out[i], new_err[i] = self.finish(
                    grads[i].shape, grads[i].dtype, m, p, q,
                    state["err"][i].dtype)
                new_q[i] = q
        return out, {"q": tuple(new_q), "err": tuple(new_err)}
