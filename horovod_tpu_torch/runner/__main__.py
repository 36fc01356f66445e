"""``python -m horovod_tpu_torch.runner``: the ``hvdrun-torch`` CLI."""

from horovod_tpu_torch.runner.launch import main

if __name__ == "__main__":
    main()
