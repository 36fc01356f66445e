"""Pipeline parallelism: the GPipe and 1F1B schedules over an in-step axis.

Port of the JAX package's ``parallel/pp.py``. Position p of the ``pp``
axis (``ops/in_step.py``) holds stage p's layers; every microbatch enters at
stage 0 and leaves at the last stage, and a stage hands each output to the
next over one ``ppermute`` hop. JAX runs the schedule as one ``lax.scan``
in which every rank computes every tick, masked; here the schedule is eager
code over ticks, and a stage skips the compute of a tick that holds none of
its microbatches. Every rank still takes part in every tick's hops, in the
same order (a forward hop each tick; under 1F1B a backward hop after it),
or the point-to-point transfers of a process group would pair up wrongly.

- Stage parameters (``stage_params``) are a stage's layers: a list (an
  ``nn.ModuleList``) of per-layer parameters, or a dict of tensors stacked
  on dim 0 over the stage's layers, as JAX stacks them;
  ``layer_fn(layer_params, x) -> y`` runs one shape-invariant layer.
- :func:`pipeline` (GPipe): the forward ticks, then, in the backward, the
  ticks in reverse with the inverse hops, each microbatch's stage graph
  kept from its forward (a ``torch.autograd.Function`` around the whole
  schedule, so autograd never spans ranks). ``n_micro + S - 1`` ticks.
  The last stage's outputs are replicated over the axis
  (:func:`_bcast_from_last`: its backward hands the cotangent to the last
  stage once, not summed over the S ranks' copies of the loss).
- :func:`pipeline_1f1b`: JAX's one-forward-one-backward tick lattice, the
  forward of microbatch m at stage s at tick ``s + m`` (no graph kept:
  only the stage's input is stashed, in ``min(M, 2S - 1)`` slots), its
  backward at tick ``2(S - 1) - s + m``, recomputing the stage from the
  stash and differentiating it with ``torch.autograd.grad``;
  ``M + 2S - 2`` ticks. The last stage turns a microbatch around in the
  tick its forward ends: the head's loss and its gradient.
- Where the head runs: JAX asks its jaxpr whether the head holds a
  collective, and gates a collective-free head to the last stage. Eager
  code has no jaxpr to ask, so the caller says it (``head_collective``):
  by default the last stage alone runs the head; with ``head_collective``
  (the composite's sp-global token mean under a bound ``sp`` axis of more
  than one rank) every stage runs it at each of its backward ticks, as
  JAX runs it, and only the last stage's result is kept.

Each tick's work for one stage is a method of :class:`StageRun` that takes
that stage's inputs, and the schedules (:func:`gpipe_forward`,
:func:`gpipe_backward`, :func:`run_1f1b`) take the stages they drive and a
``hop``: :func:`axis_hop` for this rank's one stage over the axis,
:func:`virtual_hop` for S stages in one process, each output handed to the
next stage where the ``ppermute`` would hand it.
"""

import torch
from torch import nn

from horovod_tpu_torch.common.topology import PP_AXIS
from horovod_tpu_torch.ops import in_step


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts, lists and tuples of tensors, or modules
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """The tensors of ``tree`` in order: a module's parameters, a dict's
    values in key order, a list's items."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_like(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s structure;
    a module's come back as a list."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, nn.Module):
            return [next(it) for _ in t.parameters()]
        if isinstance(t, dict):
            return {k: build(t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def _map(fn, tree):
    return tree_like(tree, [fn(t) for t in tree_leaves(tree)])


def _layers(stage_params):
    """A stage's per-layer parameters: a list's items, or a dict of
    stacked tensors cut on dim 0."""
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        return list(stage_params)
    n = tree_leaves(stage_params)[0].shape[0]
    return [_map(lambda t, i=i: t[i], stage_params) for i in range(n)]


def stage_apply(layer_fn, stage_params, x):
    """This stage's layers in order: ``layer_fn(p_i, x)`` for each
    layer's parameters ``p_i`` (JAX's ``lax.scan`` over the stacked
    layers)."""
    for p in _layers(stage_params):
        x = layer_fn(p, x)
    return x


def _weights(tree):
    return [t for t in tree_leaves(tree) if t.requires_grad]


def _acc(into, grads):
    for i, g in enumerate(grads):
        if g is not None:
            into[i] = g if into[i] is None else into[i] + g


# ---------------------------------------------------------------------------
# Hops
# ---------------------------------------------------------------------------

def axis_hop(axis_name):
    """``hop(sends, step)`` for this rank's one stage over ``axis_name``:
    each position sends its tensor ``step`` positions on around the ring
    (``in_step.ppermute``; +1 forward, -1 backward) and gets its
    neighbour's. Every rank calls it every tick, in the same order."""
    def hop(sends, step):
        (x,) = sends
        n = in_step.axis_size_or_1(axis_name)
        if n == 1:
            return [x]
        with torch.no_grad():
            return [in_step.ppermute(x, [(i, (i + step) % n)
                                         for i in range(n)], axis_name)]
    return hop


def virtual_hop(sends, step):
    """The hop of S stages in one process: stage i gets stage
    ``i - step``'s tensor, around the ring."""
    S = len(sends)
    return [sends[(i - step) % S] for i in range(S)]


# ---------------------------------------------------------------------------
# One stage's side of the schedules
# ---------------------------------------------------------------------------

class StageRun:
    """Stage ``stage`` of ``n_stages`` over ``n_micro`` microbatches: its
    layers (``layer_fn``, ``stage_params``), the microbatches (read at
    stage 0 only), and what its ticks leave behind: ``grads`` (one per
    parameter needing a gradient, None where none arrived), ``outputs``
    (the last stage's, by microbatch), ``d_mb`` (stage 0's input
    gradients, by microbatch)."""

    def __init__(self, layer_fn, stage_params, stage, n_stages,
                 microbatches):
        self.fn, self.params = layer_fn, stage_params
        self.stage, self.S = stage, n_stages
        self.mbs = microbatches
        self.M = microbatches.shape[0]
        self.template = microbatches[0]
        self.first, self.last = stage == 0, stage == n_stages - 1
        self.weights = _weights(stage_params)
        self.grads = [None] * len(self.weights)
        self.graphs, self.outputs, self.d_mb = {}, {}, {}
        self.ssize = min(self.M, 2 * n_stages - 1)
        self.stash = [None] * self.ssize
        self.y_tick = None

    def _zeros(self):
        return torch.zeros_like(self.template)

    def _input(self, m, recv):
        x = self.mbs[m] if self.first else recv
        want = self.mbs.requires_grad if self.first else True
        return x.detach().requires_grad_(want)

    def _vjp(self, x, y, g):
        """Parameter gradients of ``y`` under ``g`` into ``grads``;
        returns the input's, or None when it needs none."""
        inputs = ([x] if x.requires_grad else []) + self.weights
        got = torch.autograd.grad(y, inputs, g, allow_unused=True)
        dx = got[0] if x.requires_grad else None
        _acc(self.grads, got[1:] if x.requires_grad else got)
        return dx

    def _take_dx(self, m, dx):
        """Stage 0 keeps its input gradient; another stage sends it on."""
        if self.first:
            if dx is not None:
                self.d_mb[m] = dx
            return self._zeros()
        return dx

    # --- GPipe ---

    def gpipe_forward(self, t, recv):
        """Tick ``t``'s forward: microbatch ``t - stage`` through the
        stage, its graph kept; returns the tensor to hop on."""
        m = t - self.stage
        if not 0 <= m < self.M:
            return self._zeros()
        x = self._input(m, recv)
        with torch.enable_grad():
            y = stage_apply(self.fn, self.params, x)
        self.graphs[m] = (x, y)
        if self.last:
            self.outputs[m] = y.detach()
        return y.detach()

    def gpipe_backward(self, t, recv, g_outputs):
        """Tick ``t``'s backward: ``recv`` the gradient of the tensor this
        stage sent at tick ``t`` (the last stage takes microbatch m's of
        ``g_outputs`` instead); returns the gradient of its input, to hop
        back."""
        m = t - self.stage
        if not 0 <= m < self.M:
            return self._zeros()
        x, y = self.graphs.pop(m)
        g = g_outputs[m] if self.last else recv
        return self._take_dx(m, self._vjp(x, y, g))

    # --- 1F1B ---

    def f1b_forward(self, t, recv):
        """Tick ``t``'s forward slot: microbatch ``t - stage`` through the
        stage with no graph, its input stashed; returns the output to hop
        on (kept for the last stage's turnaround)."""
        m = t - self.stage
        if not 0 <= m < self.M:
            self.y_tick = self._zeros()
            return self.y_tick
        x = (self.mbs[m] if self.first else recv).detach()
        with torch.no_grad():
            self.y_tick = stage_apply(self.fn, self.params, x)
        self.stash[m % self.ssize] = x
        return self.y_tick

    def f1b_backward(self, t, recv, head=None):
        """Tick ``t``'s backward slot: microbatch
        ``t - 2(S - 1) + stage``, recomputed from the stash and
        differentiated under ``recv`` (the last stage: under its head's
        gradient, ``head(y, m)``); returns the input's gradient, to hop
        back. A stage that runs the head without being the last
        (``head.everywhere``) runs it for its collectives and drops it."""
        m = t - (2 * (self.S - 1) - self.stage)
        if not 0 <= m < self.M:
            return self._zeros()
        dy = recv
        if head is not None and (self.last or head.everywhere):
            dy_head = head(self.y_tick, m, keep=self.last)
            if self.last:
                dy = dy_head
        x = self.stash[m % self.ssize].requires_grad_(
            self.mbs.requires_grad if self.first else True)
        with torch.enable_grad():
            y = stage_apply(self.fn, self.params, x)
        return self._take_dx(m, self._vjp(x, y, dy))


class Head:
    """The last stage's head and loss under 1F1B: ``fn(head_params, y,
    target) -> scalar`` for one microbatch; each call runs it with its
    gradient (the cotangent ``1 / n_micro``, for the mean over
    microbatches), keeps ``loss_sum`` and the head's ``grads`` when
    ``keep``, and returns the gradient of ``y``. ``everywhere``: every
    stage runs it (it holds a collective)."""

    def __init__(self, fn, head_params, targets, n_micro, everywhere=False):
        self.fn, self.params, self.targets = fn, head_params, targets
        self.M, self.everywhere = n_micro, everywhere
        self.weights = _weights(head_params)
        self.grads = [None] * len(self.weights)
        self.loss_sum = None

    def __call__(self, y, m, keep=True):
        y = y.detach().requires_grad_()
        with torch.enable_grad():
            loss = self.fn(self.params, y, self.targets[m])
        ct = torch.full_like(loss, 1.0 / self.M)
        got = torch.autograd.grad(loss, [y] + self.weights, ct,
                                  allow_unused=True)
        if keep:
            _acc(self.grads, got[1:])
            part = loss.detach().float() / self.M
            self.loss_sum = part if self.loss_sum is None \
                else self.loss_sum + part
        return got[0]


# ---------------------------------------------------------------------------
# Schedules over a hop
# ---------------------------------------------------------------------------

def gpipe_forward(stages, hop):
    """GPipe's forward ticks over ``stages`` (each a :class:`StageRun`):
    ``n_micro + S - 1`` ticks, each one forward per stage and one forward
    hop. Returns the number of ticks."""
    st0 = stages[0]
    ticks = st0.M + st0.S - 1
    recv = [st._zeros() for st in stages]
    for t in range(ticks):
        recv = hop([st.gpipe_forward(t, r) for st, r in zip(stages, recv)],
                   1)
    return ticks


def gpipe_backward(stages, hop, g_outputs):
    """GPipe's backward: the ticks in reverse, each the inverse hop of the
    tick's forward one, then each stage's backward. ``g_outputs``: the
    last stage's output gradients by microbatch (one per stage of
    ``stages``, read by the last). Returns the number of ticks."""
    st0 = stages[0]
    ticks = st0.M + st0.S - 1
    g = [st._zeros() for st in stages]
    for t in reversed(range(ticks)):
        g = hop(g, -1)
        g = [st.gpipe_backward(t, r, go)
             for st, r, go in zip(stages, g, g_outputs)]
    return ticks


def run_1f1b(stages, hop, heads):
    """The 1F1B ticks over ``stages``: ``n_micro + 2S - 2`` ticks, each a
    forward slot, its hop, a backward slot (the head's turnaround on the
    last stage) and its hop back. ``heads``: one :class:`Head` (or None)
    per stage. Returns the number of ticks."""
    st0 = stages[0]
    ticks = st0.M + 2 * st0.S - 2
    recv_f = [st._zeros() for st in stages]
    recv_b = [st._zeros() for st in stages]
    for t in range(ticks):
        recv_f = hop([st.f1b_forward(t, r) for st, r in zip(stages, recv_f)],
                     1)
        recv_b = hop([st.f1b_backward(t, r, h)
                      for st, r, h in zip(stages, recv_b, heads)], -1)
    return ticks


# ---------------------------------------------------------------------------
# Over an in-step axis
# ---------------------------------------------------------------------------

def _place(axis_name):
    """``(stage, n_stages)`` of this rank on ``axis_name``; one stage
    when the axis is unbound."""
    if not in_step.axis_bound(axis_name):
        return 0, 1
    return in_step.axis_index(axis_name), in_step.axis_size(axis_name)


def _from_stage(x, src, axis_name):
    """``x`` of position ``src`` on every position of the axis (one
    all-reduce of it beside zeros); ``x`` itself on an axis of one."""
    stage, n = _place(axis_name)
    if n == 1:
        return x
    keep = x if stage == src else torch.zeros_like(x)
    return in_step.reduce_from_axis(keep.detach(), axis_name)


class _BcastFromLast(torch.autograd.Function):
    """The last stage's ``x`` on every stage; backward: the cotangent to
    the last stage once, zeros elsewhere (JAX's custom VJP: the
    all-reduce's own transpose would hand the last stage the sum of the S
    ranks' copies of a replicated loss's cotangent)."""

    @staticmethod
    def forward(ctx, x, axis_name):
        stage, n = _place(axis_name)
        ctx.last = stage == n - 1
        return _from_stage(x, n - 1, axis_name)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def _bcast_from_last(x, axis_name=PP_AXIS):
    return _BcastFromLast.apply(x, axis_name)


class _GPipe(torch.autograd.Function):
    """GPipe over this rank's stage: the forward ticks in ``forward``, the
    reverse ticks in ``backward``. Inputs: the :class:`StageRun` and its
    hop, the microbatches and the stage's parameters needing gradients.
    Output: the last stage's outputs (zeros on another stage)."""

    @staticmethod
    def forward(ctx, run, hop, microbatches, *weights):
        ctx.run, ctx.hop = run, hop
        gpipe_forward([run], hop)
        if not run.last:
            return torch.zeros_like(microbatches)
        return torch.stack([run.outputs[m] for m in range(run.M)])

    @staticmethod
    def backward(ctx, g):
        run = ctx.run
        gpipe_backward([run], ctx.hop, [g])
        d_mb = None
        if run.first and run.d_mb:
            d_mb = torch.stack([run.d_mb[m] for m in range(run.M)])
        ctx.run = None
        return (None, None, d_mb, *run.grads)


def gpipe_outputs(layer_fn, stage_params, microbatches, axis_name=PP_AXIS):
    """The GPipe schedule over ``axis_name`` without the broadcast: the
    last stage's outputs ``(n_micro, mb, ...)``, zeros on another stage;
    differentiable (:class:`_GPipe`)."""
    stage, n = _place(axis_name)
    run = StageRun(layer_fn, stage_params, stage, n, microbatches)
    return _GPipe.apply(run, axis_hop(axis_name), microbatches,
                        *run.weights)


def pipeline(layer_fn, stage_params, microbatches, axis_name=PP_AXIS):
    """Run ``microbatches`` ``(n_micro, mb, ...)`` (the same on every pp
    rank) through the pipeline (GPipe): returns the last stage's outputs
    ``(n_micro, mb, ...)``, replicated on every pp rank, differentiable
    with respect to this rank's ``stage_params`` and the microbatches.
    Tick t computes microbatch ``t - stage`` at ``stage``, then hops the
    activations one stage on; ``n_micro + S - 1`` ticks; bubble fraction
    ``(S - 1) / (n_micro + S - 1)``."""
    return _bcast_from_last(
        gpipe_outputs(layer_fn, stage_params, microbatches, axis_name),
        axis_name)


def run_1f1b_over_axis(layer_fn, head_loss_fn, stage_params, head_params,
                       microbatches, targets, axis_name=PP_AXIS,
                       head_collective=False):
    """The 1F1B ticks for this rank's stage over ``axis_name``: returns
    its :class:`StageRun` and :class:`Head`, with nothing replicated
    (the composite trainer's form of :func:`pipeline_1f1b`)."""
    stage, n = _place(axis_name)
    run = StageRun(layer_fn, stage_params, stage, n, microbatches)
    head = Head(head_loss_fn, head_params, targets, run.M,
                everywhere=head_collective)
    run_1f1b([run], axis_hop(axis_name), [head])
    return run, head


def pipeline_1f1b(layer_fn, head_loss_fn, stage_params, head_params,
                  microbatches, targets, axis_name=PP_AXIS,
                  head_collective=False):
    """One 1F1B pipeline TRAINING step (JAX's ``pipeline_1f1b``).

    ``head_loss_fn(head_params, y, target) -> scalar``: the head and loss
    of one microbatch; ``targets`` ``(n_micro, ...)``. The activation
    memory is the stash of stage inputs, O(S), not O(n_micro).
    ``head_collective``: the head holds a collective, so every stage runs
    it (module docstring).

    Returns ``(loss, (d_stage_params, d_head_params, d_microbatches))``:
    the mean microbatch loss and the head and input gradients, replicated
    over the axis; this rank's stage gradients (in ``stage_params``'s
    structure, a module's as a list; None where none arrived); all for the
    MEAN loss over microbatches."""
    run, head = run_1f1b_over_axis(layer_fn, head_loss_fn, stage_params,
                                   head_params, microbatches, targets,
                                   axis_name, head_collective)
    n = run.S
    loss = head.loss_sum if run.last else torch.zeros(
        (), device=microbatches.device)
    loss = _from_stage(loss, n - 1, axis_name)
    d_head = [_from_stage(g if g is not None else torch.zeros_like(w),
                          n - 1, axis_name)
              for g, w in zip(head.grads, head.weights)]
    d_mb = torch.stack([run.d_mb[m] for m in range(run.M)]) \
        if run.first and run.d_mb else torch.zeros_like(microbatches)
    d_mb = _from_stage(d_mb, 0, axis_name)
    return loss, (_weights_like(stage_params, run.grads),
                  _weights_like(head_params, d_head), d_mb)


def _weights_like(tree, grads):
    """``grads`` (one per leaf needing a gradient) in ``tree``'s
    structure, None at a leaf that needs none."""
    it = iter(grads)
    return tree_like(tree, [next(it) if t.requires_grad else None
                            for t in tree_leaves(tree)])


def split_microbatches(batch, n_micro):
    """``(B, ...) -> (n_micro, B / n_micro, ...)`` on every tensor of a
    dict, list or tensor."""
    def split(x):
        if x.shape[0] % n_micro:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
        return x.reshape((n_micro, x.shape[0] // n_micro)
                         + tuple(x.shape[1:]))
    return _map(split, batch)


def stack_stage_params(per_layer_params, n_stages, axis_name=PP_AXIS):
    """Stack a list of per-layer parameter dicts into the global
    ``(n_layers, ...)`` tensors that the pp axis shards on dim 0 (a
    carrier cuts stage p's ``(lps, ...)`` block out of them)."""
    n_layers = len(per_layer_params)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} stages")
    cols = zip(*[tree_leaves(p) for p in per_layer_params])
    return tree_like(per_layer_params[0], [torch.stack(c) for c in cols])


__all__ = ["PP_AXIS", "stage_apply", "pipeline", "pipeline_1f1b",
           "split_microbatches", "stack_stage_params", "StageRun", "Head",
           "gpipe_forward", "gpipe_backward", "run_1f1b", "axis_hop",
           "virtual_hop"]
