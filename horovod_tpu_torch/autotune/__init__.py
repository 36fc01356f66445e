"""Online autotuning of the fusion runtime's knobs (port of the JAX
package's ``autotune/``): the Gaussian process, the Bayesian optimizer and
the :class:`ParameterManager` with its categorical sweep."""

from horovod_tpu_torch.autotune.parameter_manager import (  # noqa: F401
    ParameterManager, sweep_categoricals,
)
