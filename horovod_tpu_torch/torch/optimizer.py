"""DistributedOptimizer for torch.optim optimizers.

Port of the JAX package's ``torch/optimizer.py`` (reference:
horovod/torch/optimizer.py:132-344): a post-accumulate-grad hook on every
parameter queues an async allreduce of its gradient as soon as backward has
produced it, so communication overlaps the rest of the backward pass;
``synchronize()`` drains the handles before ``step()``;
``backward_passes_per_step`` accumulates locally before reducing.

The gradients ride the fusion runtime (``ops/fusion.py``): a bucket's pack
kernel reads them, one allreduce reduces the bucket, and its unpack kernel
writes each reduced gradient back into ``p.grad`` in place — so, unlike the
JAX frontend, ``synchronize()`` has no result to copy into ``p.grad``.

``compression=hvd.Compression.int8`` arms the quantized wire for each
gradient's allreduce: on a runtime whose own wire is not quantized, each
gradient of at least n×1024 elements rides the block-scaled exchange as a
bucket of its own, its error-feedback residual kept per call signature, as
the JAX frontend's per-gradient ``allreduce_async`` calls do; under
``HOROVOD_WIRE_DTYPE=int8`` the whole fused bucket rides it instead.

``compression=hvd.Compression.powersgd(rank)`` drives PowerSGD's core
(``optim/powersgd.py``; the JAX optax optimizer's PowerSGD route): a
parameter that is not compressed reduces as above; a compressed one's hook
queues its P = M Q (M: the gradient in its Flax view, scaled, plus the
residual) as an async Average, so phase 1 overlaps the backward.
``synchronize()`` drains, orthonormalizes each P, queues the Q's as one
group, drains again, writes M̂ back into ``p.grad`` in torch's layout and
keeps Q and the residual for ``step()`` to store in ``state[p]`` under
``powersgd_q`` and ``powersgd_err`` (kept out of the wrapped optimizer's
step, whose lazy init wants a state without them), where
``state_dict()``, ``broadcast_optimizer_state`` and the elastic
``TorchState`` carry them.
``backward_passes_per_step`` aggregates first, as JAX's local aggregation
wraps the whole chain.

Each parameter's hook holds the wrapper weakly. A strong reference would
close a cycle (parameter -> hook -> optimizer -> parameter) that Python's
collector cannot break, since it does not traverse a tensor that autograd
also holds: the model, its gradients and the optimizer state would outlive
the caller's last reference. A hook whose wrapper is gone does nothing.
"""

import weakref

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.optim.powersgd import PowerSGD, PowerSGDCompressor
from horovod_tpu_torch.parallel.tp import flax_view, from_flax_view
from horovod_tpu_torch.torch import mpi_ops
from horovod_tpu_torch.torch.compression import Compression
from horovod_tpu_torch.torch.mpi_ops import Average, Sum

# Keys of PowerSGD's per-parameter state (Q, the residual; Flax view).
POWERSGD_Q, POWERSGD_ERR = "powersgd_q", "powersgd_err"


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, op, process_set,
                 gradient_predivide_factor):
        super(self.__class__, self).__init__(params)
        self._compression = compression or Compression.none
        self._op = op
        self._process_set = process_set
        self._backward_passes_per_step = backward_passes_per_step
        self._gradient_predivide_factor = gradient_predivide_factor

        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = []
            for gi, group in enumerate(self.param_groups):
                for pi, p in enumerate(group["params"]):
                    named.append((f"group{gi}.param{pi}", p))
        self._param_names = {p: name for name, p in named}

        self._handles = {}
        self._grad_accs = []
        self._passes = {}
        self._synchronized = False
        self._should_synchronize = True
        self._powersgd = None
        if isinstance(self._compression, PowerSGDCompressor):
            c = self._compression
            op, pre, post = self._op_and_scales()
            self._powersgd = PowerSGD(
                rank=c.rank, op=op, process_set=process_set,
                min_compression_rate=c.min_compression_rate,
                prescale_factor=pre, postscale_factor=post,
                ef_dtype=c.ef_dtype)
            self._compression = Compression.none
            # Leaf i of the core (Q's seed), its phase-1 (M, P) until
            # synchronize(), and the (Q, residual) step() stores.
            self._leaf_index = {p: i for i, p in enumerate(
                p for g in self.param_groups for p in g["params"])}
            self._phase1 = {}
            self._new_state = {}
        self._register_hooks()

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._passes[p] = 0
                    acc = p.register_post_accumulate_grad_hook(
                        self._make_hook())
                    self._grad_accs.append(acc)

    def _remove_hooks(self):
        """Deregister the gradient hooks — retire this wrapper before
        wrapping a new optimizer over the same parameters."""
        for acc in self._grad_accs:
            acc.remove()
        self._grad_accs = []
        self._handles.clear()

    def _make_hook(self):
        ref = weakref.ref(self)

        def hook(p):
            self = ref()
            if self is None:
                return   # the wrapper is gone (see the module docstring)
            self._passes[p] += 1
            if self._passes[p] < self._backward_passes_per_step:
                return  # local aggregation; reduce on the final pass
            self._passes[p] = 0
            if p in self._handles:
                raise AssertionError(
                    "gradient reduced twice before step(); call "
                    "synchronize() between backward passes or raise "
                    "backward_passes_per_step "
                    "(matches reference optimizer.py duplicate-hook check)")
            self._handles[p] = self._allreduce_grad_async(p)
        return hook

    def _op_and_scales(self):
        op, prescale, postscale = self._op, 1.0, 1.0
        if self._gradient_predivide_factor != 1.0 and op == Average:
            # reference: gradient_predivide_factor splits the averaging
            # between pre- and post-scale (optimizer.py:188-200).
            prescale = 1.0 / self._gradient_predivide_factor
            postscale = self._gradient_predivide_factor / \
                self._process_size()
            op = Sum
        return op, prescale, postscale

    def _allreduce_grad_async(self, p):
        name = self._param_names.get(p, "param")
        core = self._powersgd
        if core is not None and core.compressed(flax_view(p, p).shape):
            return self._powersgd_phase1(p, name)
        op, prescale, postscale = self._op_and_scales()
        if self._backward_passes_per_step > 1:
            prescale = prescale / self._backward_passes_per_step
        # In place: the unpack kernel writes the reduced gradient into
        # p.grad itself, which saves the copy the JAX frontend makes in
        # synchronize().
        return mpi_ops.allreduce_async_(
            p.grad, op=op, name=f"allreduce.{name}",
            compression=self._compression, prescale_factor=prescale,
            postscale_factor=postscale, process_set=self._process_set)

    def _powersgd_state(self, p):
        st = self.state.get(p, {})
        if POWERSGD_Q in st:
            return st[POWERSGD_Q], st[POWERSGD_ERR]
        return self._powersgd.init_leaf(flax_view(p, p.detach()),
                                        self._leaf_index[p])

    def _powersgd_phase1(self, p, name):
        """Queue P = M Q of a compressed parameter (its Flax view)."""
        core = self._powersgd
        q, err = self._powersgd_state(p)
        m = core.error_fed(flax_view(p, p.grad), err,
                           1.0 / self._backward_passes_per_step)
        pm = core.phase1(m, q)
        self._phase1[p] = (m, pm, err.dtype)
        return mpi_ops.allreduce_async_(pm, op=Average,
                                        name=f"powersgd.p.{name}",
                                        process_set=self._process_set)

    def _powersgd_phase2(self):
        """Orthonormalize the averaged P's, average the Q's as one group,
        write each M̂ into ``p.grad`` and keep Q and the residual."""
        core = self._powersgd
        params = list(self._phase1)
        phase1, self._phase1 = self._phase1, {}
        if not params:
            return
        ps, qs = zip(*(core.phase2(phase1[p][0], phase1[p][1])
                       for p in params))
        handles = mpi_ops.grouped_allreduce_async_(
            list(qs), op=Average, name="powersgd.q",
            process_set=self._process_set)
        for p, pq, h in zip(params, ps, handles):
            q = h.synchronize()
            m, _, err_dtype = phase1[p]
            view = flax_view(p, p.grad)
            out, err = core.finish(view.shape, p.grad.dtype, m, pq, q,
                                   err_dtype)
            p.grad.copy_(from_flax_view(p, out))
            self._new_state[p] = (q, err)

    def _process_size(self):
        ps = self._process_set
        return basics.size() if ps is None else ps.size()

    def synchronize(self):
        """Drain outstanding reductions; the results are in ``p.grad``
        (reference: optimizer.py:256-304). The handles are dropped even
        when one raises (a failed collective): the elastic loop restores the
        last commit and steps again, which must not find them in flight."""
        try:
            for handle in self._handles.values():
                handle.synchronize()
            if self._powersgd is not None:
                self._powersgd_phase2()
        finally:
            self._handles.clear()
            if self._powersgd is not None:
                self._phase1.clear()
        self._synchronized = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        self._synchronized = False
        # The host-side step boundary: the flight ring's step spans, the
        # step profiler's windows and the goodput ledger's steps need no
        # user instrumentation on this frontend (step_marker applies each
        # plane's gate itself).
        _flight.step_marker()
        if self._powersgd is None:
            return super(self.__class__, self).step(closure)
        # The wrapped optimizer's lazy init (AdamW's) wants a state without
        # PowerSGD's keys: they step aside and come back, renewed.
        kept = {p: (st.pop(POWERSGD_Q), st.pop(POWERSGD_ERR))
                for p, st in self.state.items() if POWERSGD_Q in st}
        try:
            return super(self.__class__, self).step(closure)
        finally:
            kept.update(self._new_state)
            self._new_state = {}
            for p, (q, err) in kept.items():
                self.state[p][POWERSGD_Q] = q
                self.state[p][POWERSGD_ERR] = err

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "zero_grad() with reductions in flight would race the "
                "gradient writeback; call step() or synchronize() first "
                "(matches reference optimizer.py:306-315)")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0, process_set=None):
    """Wrap a torch optimizer so gradients are averaged across ranks before
    each step (reference: hvd.DistributedOptimizer torch/optimizer.py:517).

    The returned object is a dynamically-created subclass of the wrapped
    optimizer's class (same trick as the reference) so isinstance checks and
    LR schedulers keep working.
    """
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    dist_opt = cls(optimizer.param_groups, named_parameters, compression,
                   backward_passes_per_step, op, process_set,
                   gradient_predivide_factor)
    # Keep the wrapped optimizer's per-parameter state (momentum buffers,
    # e.g. restored from a checkpoint): param_groups share the parameters.
    for p, s in optimizer.state.items():
        dist_opt.state[p] = s
    return dist_opt
