"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>.<digest>.so`` at the
root of the checkout, where ``digest`` hashes the sources and the flags, so an
edited source never loads a stale library. :func:`build` compiles several
sources at once, one nvcc process per source, all started together; a
failed build raises. nvcc runs with ``-Xptxas -v``: each kernel's
registers, shared memory and spills go to ``lib<name>.<digest>.log`` beside
the library (:func:`ptxas_report`).

Compiling and loading are apart. :func:`load` never compiles: it returns a
library already loaded or built, and raises for one that is not. The fusion
runtime launches the scale and Adasum kernels under its flush lock, so
``hvd.init`` on CUDA builds every source before it takes any lock (a no-op
once they are built); every collective then only looks its library up.
The entry points a user may call before ``hvd.init`` and
outside any lock, a flash forward and ``ops.adasum.adasum_combine``, build
their own source first.

Nothing here runs at import: the CPU tier imports every module and has no
nvcc.
"""

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("scale_buffers", "flash_attention", "adasum")

_lock = threading.Lock()
_libs = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        nvcc = os.path.join(home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise KernelBuildError(
                "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
                "kernels are compiled on first use")
    return nvcc


def library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every source in ``names`` that has no library yet, in
    parallel. Returns {name: seconds spent compiling it} (0.0 when its
    library was already there)."""
    jobs, seconds = [], {}
    for name in names:
        if name in _libs:     # loaded: built, and cheap to ask again
            seconds[name] = 0.0
            continue
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Per process and thread: two callers may compile one source at
        # once, and each renames its own file into place.
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):"
                          f"\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    if errors:
        raise KernelBuildError("\n".join(errors))
    return seconds


_PTXAS_FIELDS = {"registers": "registers", "bytes smem": "smem_bytes",
                 "bytes stack frame": "stack_bytes",
                 "bytes spill stores": "spill_stores",
                 "bytes spill loads": "spill_loads"}


def ptxas_report(name):
    """{mangled kernel name: {"registers", "smem_bytes", "stack_bytes",
    "spill_stores", "spill_loads"}} from the build log of
    ``csrc/<name>.cu``; ptxas counts static shared memory only."""
    log = library_path(name).with_suffix(".log").read_text()
    numbers = re.compile(r"(\d+) (" + "|".join(_PTXAS_FIELDS) + ")")
    report, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            kernel = report.setdefault(m.group(1), {})
        elif kernel is not None:
            kernel.update((_PTXAS_FIELDS[k], int(v))
                          for v, k in numbers.findall(line))
    return report


def load(name):
    """The ctypes library of ``csrc/<name>.cu``: the one already loaded, or
    the built library on disk, loaded now. Never compiles (kernels launch
    under the fusion runtime's lock): a source with no library raises,
    naming :func:`build`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                raise KernelBuildError(
                    f"csrc/{name}.cu is not built: hvd.init() on CUDA, or "
                    f"ops.kernels._build.build(({name!r},)), compiles it")
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
