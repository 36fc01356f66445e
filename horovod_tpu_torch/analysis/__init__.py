"""Static analysis of the port: hvdlint and hvdrace.

Port of the JAX package's ``analysis/`` for the two codebase tools:

- :mod:`horovod_tpu_torch.analysis.lint` (hvdlint): AST lint for the bug
  classes earlier fixes found by hand, among them a declared knob that the
  launcher never carries to a worker (HVL007)
  (``python -m horovod_tpu_torch.analysis.lint``);
- :mod:`horovod_tpu_torch.analysis.race` (hvdrace): the whole-package
  lock-order graph, its rules HVR201-HVR205, and the runtime acquisition
  witness that ``HVD_LOCK_WITNESS=1`` installs at ``import
  horovod_tpu_torch`` (``python -m horovod_tpu_torch.analysis.race``).

The event and finding models the program checker shares are here too; the
program checker and the cost model are not ported yet.
"""

from horovod_tpu_torch.analysis.events import (  # noqa: F401
    CollectiveEvent, sequence_hash,
)
from horovod_tpu_torch.analysis.findings import Finding  # noqa: F401

_LINT_EXPORTS = ("LintFinding", "declared_knobs", "lint_paths",
                 "lint_source")


def __getattr__(name):
    # Lazy: `python -m horovod_tpu_torch.analysis.lint` imports this
    # package first, and an eager `from .lint import ...` would
    # double-import the module it is about to execute (runpy
    # RuntimeWarning).
    if name in _LINT_EXPORTS:
        from horovod_tpu_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
