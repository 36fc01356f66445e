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
assert hvd.elastic is horovod_tpu_torch.torch.elastic
assert hvd.elastic.run is state.run and hvd.TorchState and hvd.ElasticSampler
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
    missing = [str(p) for p in mirrored
               if not (ROOT / "horovod_tpu" / p).exists()]
    assert not missing, missing
