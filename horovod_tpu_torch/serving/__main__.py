"""``python -m horovod_tpu_torch.serving`` — the reference serving worker.

Port of the JAX package's ``serving/__main__.py``, what ``hvdrun-torch
--serving`` launches when you have no app of your own::

    hvdrun-torch --serving --serving-port 9000 -np 8 \\
        python -m horovod_tpu_torch.serving

Each worker initializes the runtime on the GPU ``hvd.init()`` picks (on the
CPU only when asked: ``--device cpu``), builds the configured model
(``HOROVOD_SERVING_MODEL``: ``gpt_tiny`` [default], ``gpt2`` or
``llama_tiny``, with weights from a fixed generator seed — a smoke and
load-test target; point real deployments at a checkpoint with your own
script), and serves ``POST /generate`` on ``HOROVOD_SERVING_PORT +
local_rank``. The metrics endpoint (``HOROVOD_METRICS_PORT``) carries
``/serving/health`` and the serving and SLO series; under
``HOROVOD_ELASTIC`` the engine state rides a
:class:`~horovod_tpu_torch.serving.state.ServingState`, so membership
changes drop no in-flight request. SIGTERM unwinds like Ctrl-C: the
frontend stops and writes its trace shard to ``HOROVOD_TRACE_DIR``.
"""

import argparse
import os
import signal
import sys
import time

WEIGHT_SEED = 0


def build_model(name, max_len, device=None):
    """The worker's model at ``max_len`` positions, weights from a fixed
    generator seed, in eval mode on ``device``."""
    import torch

    from horovod_tpu_torch import models

    gen = torch.Generator().manual_seed(WEIGHT_SEED)
    if name == "gpt2":
        model = models.GPT(models.GPTConfig(max_position_embeddings=max_len),
                           generator=gen)
    elif name == "llama_tiny":
        model = models.Llama(models.LlamaConfig.tiny(
            max_position_embeddings=max_len), generator=gen)
    else:
        model = models.GPT(models.GPTConfig.tiny(
            max_position_embeddings=max_len), generator=gen)
    if device is not None:
        model = model.to(device)
    return model.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.serving",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU (gloo); default: the "
                         "GPU hvd.init() picks")
    args = ap.parse_args(argv)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.serving import ServingEngine, ServingState
    from horovod_tpu_torch.serving.server import ServingFrontend

    hvd.init(device=args.device)

    # SIGTERM (how an orchestrator or the elastic driver stops a worker)
    # must unwind like Ctrl-C: only fe.stop() writes the HOROVOD_TRACE_DIR
    # shard, and the default disposition skips it. The launcher's 5 s
    # terminate-then-kill bounds the drain.
    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    cfg = Config.from_env()
    name = cfg.serving_model
    max_len = cfg.serving_max_len or 256
    model = build_model(name, max_len, hvd.device())
    engine = ServingEngine(
        model, num_slots=cfg.serving_slots, max_len=max_len,
        prefill_chunk=cfg.serving_prefill_chunk,
        queue_limit=cfg.serving_queue_limit,
        migrate_kv=cfg.serving_migrate_kv)
    port = cfg.serving_port + hvd.local_rank() if cfg.serving_port else 0
    fe = ServingFrontend(engine, port=port, addr=cfg.metrics_addr,
                         drive=not cfg.elastic)
    bound = fe.start()
    print(f"# serving {name} on :{bound} (slots={engine.num_slots}, "
          f"max_len={engine.max_len}, device={engine.device}, "
          f"pid={os.getpid()})", file=sys.stderr, flush=True)

    try:
        if cfg.elastic:
            from horovod_tpu_torch.elastic import attach_listener

            state = ServingState(engine, step=0)
            attach_listener(state)

            @hvd.elastic.run
            def serve(state):
                # One thread owns stepping AND committing (the frontend
                # only enqueues): a commit must never race a half-applied
                # step.
                cadence = max(cfg.serving_commit_steps, 1)
                idle_commit_s = 0.25
                last_commit = time.monotonic()
                while True:
                    if engine.step():
                        state.step += 1
                        if state.step % cadence == 0:
                            state.commit()
                            last_commit = time.monotonic()
                    else:
                        # Idle: nothing new to snapshot — but commit() is
                        # also the membership poll (check_host_updates), so
                        # keep a low-rate heartbeat instead of spinning
                        # full-cadence snapshots at ~500/s.
                        time.sleep(0.002)
                        now = time.monotonic()
                        if now - last_commit >= idle_commit_s:
                            state.commit()
                            last_commit = now

            serve(state)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        fe.stop()
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
