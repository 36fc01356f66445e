"""The PyTorch port stands alone: it imports without JAX (the launcher and
the elastic modules too), no source of it (or chip_smoke.py) imports JAX or
the JAX package, and ``hvd.init()`` refuses to carry on without a GPU
unless ``device="cpu"`` is asked for."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r'''
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import horovod_tpu_torch as hvd
import horovod_tpu_torch.models
import horovod_tpu_torch.runner
import horovod_tpu_torch.runner.launch
import horovod_tpu_torch.runner.task
import horovod_tpu_torch.runner.mpi_run
import horovod_tpu_torch.runner.js_run
import horovod_tpu_torch.runner.elastic.driver
import horovod_tpu_torch.runner.elastic.discovery
from horovod_tpu_torch.elastic import state, worker
import horovod_tpu_torch.torch.elastic
import horovod_tpu_torch.ops.wire
import horovod_tpu_torch.ops.sync_batch_norm
import horovod_tpu_torch.torch.sync_batch_norm
import horovod_tpu_torch.parallel.sequence
import horovod_tpu_torch.optim.losses
import horovod_tpu_torch.optim.powersgd
import horovod_tpu_torch.common.topology
import horovod_tpu_torch.parallel.strategies
import horovod_tpu_torch.ops.in_step
import horovod_tpu_torch.parallel.tp
import horovod_tpu_torch.parallel.dp
import horovod_tpu_torch.parallel.fsdp
from horovod_tpu_torch.elastic import sharded
import horovod_tpu_torch.parallel.moe
import horovod_tpu_torch.parallel.pp
import horovod_tpu_torch.parallel.composite
from horovod_tpu_torch.parallel import (pipeline, pipeline_1f1b,
    split_microbatches, stack_stage_params, MoEMlp, CompositeGPT,
    CompositeLlama, build_mesh3d, build_mesh4d)
from horovod_tpu_torch.parallel.strategies import (alltoall_tiered,
    alltoall_tiered_groups, a2a_hierarchy_for)
assert hvd.set_alltoall_strategy is horovod_tpu_torch.ops.wire.set_alltoall_strategy
assert hvd.set_alltoall_cross_dtype is horovod_tpu_torch.ops.wire.set_alltoall_cross_dtype
assert horovod_tpu_torch.models.gpt.GPTMoEBlock
assert sharded.gather_to_host and sharded.zero_reshard and sharded.fsdp_reshard
assert horovod_tpu_torch.parallel.sequence.ring_hop_forward
assert horovod_tpu_torch.common.topology.TP_AXIS == "tp"
assert hvd.wire is horovod_tpu_torch.ops.wire and hvd.Compression.int8
assert hvd.set_dispatch_strategy is horovod_tpu_torch.ops.wire.set_dispatch_strategy
assert isinstance(hvd.Compression.powersgd(2),
                  horovod_tpu_torch.optim.powersgd.PowerSGDCompressor)
assert horovod_tpu_torch.optim.next_token_xent_chunked
assert hvd.SyncBatchNorm is horovod_tpu_torch.torch.sync_batch_norm.SyncBatchNorm
assert hvd.elastic is horovod_tpu_torch.torch.elastic
assert hvd.elastic.run is state.run and hvd.TorchState and hvd.ElasticSampler
from horovod_tpu_torch.models import (T5, T5Config, VGG, VGG11, VGG13,
    VGG16, VGG19, InceptionV3, beam_search, generate, prefill_prefix,
    lora_init, lora_apply, lora_merge, lora_wire_numbers, adapter_loss_fn,
    adapter_loss_fn_via_extra, speculative_accept, speculative_generate,
    t5_greedy_decode, t5_generate, t5_beam_decode, load_flax_t5,
    load_flax_vgg, load_flax_inception, init_decode_cache,
    beam_reorder_cache, rewind_cache, cache_from_flax, cache_to_numpy)
from horovod_tpu_torch.parallel.tp import DecodeCache
assert init_decode_cache(horovod_tpu_torch.models.GPT(
    horovod_tpu_torch.models.GPTConfig.tiny(num_layers=1)), 1).entries
assert horovod_tpu_torch.models.t5.relative_position_buckets_causal_jnp(
    3, [0, 1, 2, 3], 8, 16).tolist() == [3, 2, 1, 0]
import horovod_tpu_torch.models.t5
import horovod_tpu_torch.models.vgg
import horovod_tpu_torch.models.inception
import horovod_tpu_torch.models.lora
import horovod_tpu_torch.models.speculative
gen = sys.modules["horovod_tpu_torch.models.generate"]
assert gen.generate is generate and gen.beam_reorder_cache
assert horovod_tpu_torch.parallel.tp.TPCrossAttention
assert horovod_tpu_torch.models.t5.T5RelativeBias
assert horovod_tpu_torch.models.inception.InceptionAux
assert horovod_tpu_torch.models.speculative.rewind_cache
import horovod_tpu_torch.trace
import horovod_tpu_torch.metrics
import horovod_tpu_torch.metrics.server
import horovod_tpu_torch.telemetry.slo
import horovod_tpu_torch.serving.server
import horovod_tpu_torch.serving.__main__
from horovod_tpu_torch.serving import (ServingEngine, ServingState, Request,
    SlotScheduler, QueueFull, get_engine, sample_token, serving_snapshot)
from horovod_tpu_torch.elastic import kv_reshard
import horovod_tpu_torch.timeline
import horovod_tpu_torch.metrics.merge
import horovod_tpu_torch.trace.analyze
import horovod_tpu_torch.flight.recorder
import horovod_tpu_torch.flight.analyze
import horovod_tpu_torch.profile.ledger
import horovod_tpu_torch.profile.roofline
import horovod_tpu_torch.profile.watchdog
import horovod_tpu_torch.profile.capture
import horovod_tpu_torch.profile.report
import horovod_tpu_torch.goodput.ledger
import horovod_tpu_torch.goodput.history
import horovod_tpu_torch.goodput.report
import horovod_tpu_torch.telemetry.aggregator
import horovod_tpu_torch.telemetry.digest
import horovod_tpu_torch.telemetry.health
import horovod_tpu_torch.telemetry.top
import horovod_tpu_torch.chaos.plan
import horovod_tpu_torch.chaos.injector
import horovod_tpu_torch.common.control_plane
import horovod_tpu_torch.common.negotiation
import horovod_tpu_torch.ops.stall_inspector
assert hvd.telemetry.TelemetryAgent and hvd.cluster_snapshot()["local_only"]
assert hvd.chaos.armed() is False and hvd.chaos.ChaosPlan
from horovod_tpu_torch.ops.fusion import reset_runtime
assert hvd.start_timeline and hvd.stop_timeline and hvd.step_marker
assert hvd.step_report and hvd.set_flops_per_step and hvd.flight_summary
assert hvd.flight is horovod_tpu_torch.flight and hvd.goodput.snapshot
assert horovod_tpu_torch.profile.roofline.PEAKS["h100"]["bf16_tflops"] == 989.0
assert sample_token(__import__("numpy").arange(4.0), 0.0, 0, 1.0, 0, 0) == 3
assert horovod_tpu_torch.metrics.REGISTRY.render_text().count(
    "# TYPE horovod_serving_") == 6
import horovod_tpu_torch.autotune
import horovod_tpu_torch.autotune.gaussian_process
import horovod_tpu_torch.autotune.bayesian_optimization
from horovod_tpu_torch.autotune import ParameterManager, sweep_categoricals
import horovod_tpu_torch.autopilot
from horovod_tpu_torch.autopilot import (AutopilotController, DriverArm,
    RemediationPolicy, SignalFrame, get_controller)
import horovod_tpu_torch.sim
import horovod_tpu_torch.sim.__main__
from horovod_tpu_torch.sim import TwinJob, Simulator, autopilot as sap
import horovod_tpu_torch.chaos.soak
import horovod_tpu_torch.serving.soak
from horovod_tpu_torch.ops.fusion import build_parameter_manager
assert get_controller() is None and sap.collective_step_tiers
print("A17_SECOND_HALF")
assert "cloudpickle" not in sys.modules, "the CLI path imports cloudpickle"
jax_pkg = [m for m in sys.modules
           if m == "horovod_tpu" or m.startswith("horovod_tpu.")]
assert not jax_pkg, jax_pkg
assert not [m for m in sys.modules
            if m.split(".")[0] in ("flax", "optax")], "flax/optax imported"
print("IMPORTED")
try:
    hvd.init()
except hvd.HorovodInternalError as e:
    assert 'device="cpu"' in str(e), str(e)
    print("RAISED")
else:
    print("CARRIED ON")
'''

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax)\b"
    r"|^\s*import\s+horovod_tpu(?:\.|\s|,|$)"
    r"|^\s*from\s+horovod_tpu(?:\.|\s)", re.M)


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT))


def test_imports_with_jax_blocked(child):
    assert child.returncode == 0, child.stderr[-3000:]
    assert "IMPORTED" in child.stdout


def test_controllers_twin_and_soaks_import_with_jax_blocked(child):
    """``autotune``, ``autopilot``, ``sim``, ``chaos.soak`` and
    ``serving.soak`` import with ``jax`` blocked and leave no module of
    the JAX package loaded."""
    assert child.returncode == 0, child.stderr[-3000:]
    assert "A17_SECOND_HALF" in child.stdout


def test_init_without_gpu_raises_named_error(child):
    assert "RAISED" in child.stdout, child.stdout + child.stderr[-3000:]


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "horovod_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.search("from horovod_tpu.ops import fusion")
    assert _FORBIDDEN.search("import horovod_tpu as hvd")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
    assert not _FORBIDDEN.search("import horovod_tpu_torch as hvd")
    assert not _FORBIDDEN.search("from horovod_tpu_torch.ops import fusion")


def test_port_modules_mirror_the_jax_package():
    port = ROOT / "horovod_tpu_torch"
    mirrored = [p.relative_to(port) for p in port.rglob("*.py")
                if p.name not in ("__init__.py", "__main__.py")
                and "kernels" not in p.parts]
    assert len(mirrored) >= 12
    # A counterpart renamed for what it is in PyTorch: collectives inside an
    # eager step, not inside jit.
    renamed = {"ops/in_step.py": "ops/in_jit.py"}
    missing = [str(p) for p in mirrored
               if not (ROOT / "horovod_tpu"
                       / renamed.get(str(p), str(p))).exists()]
    assert not missing, missing
