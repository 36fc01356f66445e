"""``python -m horovod_tpu_torch.goodput`` == ``... goodput.report``."""

from horovod_tpu_torch.goodput.report import main

raise SystemExit(main())
