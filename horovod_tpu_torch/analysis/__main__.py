"""``python -m horovod_tpu_torch.analysis``: run the codebase lint
(``python -m horovod_tpu_torch.analysis.race`` runs the lock-graph
analyzer)."""

import sys

from horovod_tpu_torch.analysis.lint import main

sys.exit(main())
