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
"""

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.torch import mpi_ops
from horovod_tpu_torch.torch.compression import Compression
from horovod_tpu_torch.torch.mpi_ops import Average, Sum


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
        def hook(p):
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

    def _allreduce_grad_async(self, p):
        name = self._param_names.get(p, "param")
        prescale = 1.0
        postscale = 1.0
        op = self._op
        if self._gradient_predivide_factor != 1.0 and op == Average:
            # reference: gradient_predivide_factor splits the averaging
            # between pre- and post-scale (optimizer.py:188-200).
            prescale = 1.0 / self._gradient_predivide_factor
            postscale = self._gradient_predivide_factor / \
                self._process_size()
            op = Sum
        if self._backward_passes_per_step > 1:
            prescale = prescale / self._backward_passes_per_step
        # In place: the unpack kernel writes the reduced gradient into
        # p.grad itself, which saves the copy the JAX frontend makes in
        # synchronize().
        return mpi_ops.allreduce_async_(
            p.grad, op=op, name=f"allreduce.{name}",
            compression=self._compression, prescale_factor=prescale,
            postscale_factor=postscale, process_set=self._process_set)

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
        finally:
            self._handles.clear()
        self._synchronized = True

    def step(self, closure=None):
        if self._should_synchronize:
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

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
