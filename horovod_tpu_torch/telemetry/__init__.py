"""Telemetry for the PyTorch/CUDA port: the declared serving SLOs and their
burn rates (:mod:`horovod_tpu_torch.telemetry.slo`). The JAX package's
cluster telemetry plane (digests, aggregator, health, ``top``) comes with
A16's second half (ROADMAP)."""
