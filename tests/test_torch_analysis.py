"""hvdlint and hvdrace over the port, held against the JAX package's.

The rule corpus is the synthetic sources of the JAX package's
``tests/test_analysis.py`` (``TestLintRules``, ``TestRaceRules``,
``TestWitnessCrossCheck``) with the package name swapped: each source goes
through JAX's analyzer as written and through the port's with
``horovod_tpu_torch`` in its place, and both must give the same codes,
lines and lock-order edges (one case per source). Then the port's own gates:
its tree and ``chip_smoke.py`` lint clean, its package analyzes clean with
a real lock graph, each within the 30 s budget; the two CLIs' exit codes;
the analysis package imports nothing of JAX; and the live witness:
``chip_smoke.py --witness-worker`` at GPT tiny on the CPU (gloo) in a
process of its own under ``HVD_LOCK_WITNESS=1``, whose edges must all be in
the port's static graph (``cross_check`` gives no finding).
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG, JAX_PKG = "horovod_tpu_torch", "horovod_tpu"


def _port(text):
    return text.replace("{pkg}", PKG)


def _jax(text):
    return text.replace("{pkg}", JAX_PKG)


# --- the lint corpus: (id, source, rel path, propagated knobs or None) -----

_CFG = "{pkg}/common/config.py"
_RANK_GATED = ("def main():\n"
               "    if hvd.rank() == 0:\n"
               "        hvd.broadcast_object(state)\n")
LINT_CASES = [
    ("hvl001_retired_blocking",
     "def flush(self):\n    with self._lock:\n        self.client.allreduce(x)\n",
     "{pkg}/ops/x.py", None),
    ("hvl006_retired_sleep",
     "import time\nwith self._lock:\n    time.sleep(0.1)\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_undeclared",
     "import os\nv = os.environ.get('HOROVOD_NOT_A_KNOB')\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_declared",
     "import os\nv = os.environ.get('HOROVOD_FUSION_THRESHOLD')\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_bootstrap", "import os\nv = os.environ.get('HOROVOD_KV_ADDR')\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_helper", "v = _env_int('HOROVOD_ALSO_NOT_A_KNOB', 3)\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_subscript", "import os\nv = os.environ['HOROVOD_SOME_KNOB']\n",
     "{pkg}/ops/x.py", None),
    ("hvl002_subscript_bootstrap",
     "import os\nv = os.environ['HOROVOD_KV_PORT']\n", "{pkg}/ops/x.py",
     None),
    ("hvl003_write",
     "import os\nos.environ['HOROVOD_FUSION_THRESHOLD'] = '1'\n",
     "{pkg}/ops/x.py", None),
    ("hvl003_launcher_writes",
     "import os\nos.environ['HOROVOD_FUSION_THRESHOLD'] = '1'\n",
     "{pkg}/runner/launch.py", None),
    ("hvl003_not_a_knob", "import os\nos.environ['PATH'] = 'x'\n",
     "{pkg}/ops/x.py", None),
    ("hvl004_rank_gated", _RANK_GATED, "examples/train.py", None),
    ("hvl004_ungated",
     "def main():\n"
     "    if hvd.rank() == 0:\n"
     "        print('saving checkpoint')\n"
     "    hvd.broadcast_object(state)\n", "examples/train.py", None),
    ("hvl004_library_internal", _RANK_GATED,
     "{pkg}/ops/collective_ops.py", None),
    ("hvl005_non_daemon",
     "import threading\nt = threading.Thread(target=loop)\nt.start()\n",
     "{pkg}/ops/x.py", None),
    ("hvl005_daemon_kw",
     "import threading\n"
     "t = threading.Thread(target=loop, daemon=True)\nt.start()\n",
     "{pkg}/ops/x.py", None),
    ("hvl005_daemon_attr",
     "import threading\nt = threading.Thread(target=loop)\n"
     "t.daemon = True\nt.start()\n", "{pkg}/ops/x.py", None),
    ("hvl007_orphan",
     "KNOBS = {\n"
     "    'HOROVOD_PROPAGATED_KNOB': 1,\n"
     "    'HOROVOD_ORPHANED_KNOB': 2,\n"
     "}\n", _CFG, ("HOROVOD_PROPAGATED_KNOB",)),
    ("hvl007_exemptions",
     "A = 'HOROVOD_KV_ADDR'\nB = 'HVD_BENCH_SOMETHING'\n"
     "C = 'HVD_LOCK_WITNESS'\n", _CFG, ()),
    ("hvl007_config_module_only", "K = 'HOROVOD_ORPHANED_KNOB'\n",
     "{pkg}/ops/x.py", None),
    ("hvl007_suppressed",
     "K = 'HOROVOD_ORPHANED_KNOB'  "
     "# hvdlint: disable=HVL007 -- driver-side only\n", _CFG, ()),
    ("suppression_with_reason",
     "import os\nv = os.environ.get('HOROVOD_BOGUS')"
     "  # hvdlint: disable=HVL002 -- probe for a foreign build\n",
     "{pkg}/ops/x.py", None),
    ("suppression_without_reason",
     "import os\nv = os.environ.get('HOROVOD_BOGUS')"
     "  # hvdlint: disable=HVL002\n", "{pkg}/ops/x.py", None),
    ("suppression_on_enclosing_def",
     "import threading\n"
     "def arm():  # hvdlint: disable=HVL005 -- joined in stop()\n"
     "    t = threading.Thread(target=loop)\n    t.start()\n",
     "{pkg}/ops/x.py", None),
    ("skip_file",
     "# hvdlint: skip-file -- generated code\nimport os\n"
     "v = os.environ.get('HOROVOD_BOGUS')\n", "{pkg}/ops/x.py", None),
    ("skip_file_without_reason", "# hvdlint: skip-file\nx = 1\n",
     "{pkg}/ops/x.py", None),
]


def _lint_result(lint_mod, src, rel, propagated, convert):
    findings = lint_mod.lint_source(
        convert(src), rel_path=convert(rel),
        declared=lint_mod.declared_knobs(),
        propagated=None if propagated is None else frozenset(propagated))
    return sorted((f.code, f.line) for f in findings)


# --- the race corpus: (id, {path: source}) ---------------------------------

_INVERSION = ("import threading\n"
              "_a = threading.Lock()\n"
              "_b = threading.Lock()\n"
              "def f():\n"
              "    with _a:\n"
              "        with _b:\n"
              "            pass\n"
              "def g():\n"
              "    with _b:\n"
              "        with _a:\n"
              "            pass\n")
_GUARDED = ("import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._n = 0\n"
            "    def inc(self):\n"
            "        with self._lock:\n"
            "            self._n += 1\n"
            "    def peek(self):\n"
            "        return self._n\n")
_HANDLER = ("import signal\n"
            "import threading\n"
            "_l = threading.Lock()\n"
            "def dump():\n"
            "    with _l:\n"
            "        pass\n"
            "def handler(signum, frame):\n"
            "    dump()\n"
            "signal.signal(signal.SIGTERM, handler)\n")
_HELD_SLEEP = ("import threading\n"
               "import time\n"
               "_l = threading.Lock()\n"
               "def f():\n"
               "    with _l:\n"
               "        time.sleep(0.1){}\n")
_CROSS_SRC = {
    "{pkg}/alpha.py": ("import threading\n"
                       "from {pkg} import beta\n"
                       "_outer = threading.Lock()\n"
                       "def work():\n"
                       "    with _outer:\n"
                       "        beta.record()\n"),
    "{pkg}/beta.py": ("import threading\n"
                      "_inner = threading.Lock()\n"
                      "def record():\n"
                      "    with _inner:\n"
                      "        pass\n"),
}
RACE_CASES = [
    ("hvr201_inversion", _INVERSION),
    ("hvr201_consistent_order",
     _INVERSION.replace("    with _b:\n        with _a:",
                        "    with _a:\n        with _b:")),
    ("hvr201_through_call_graph",
     "import threading\n"
     "_a = threading.Lock()\n"
     "_b = threading.Lock()\n"
     "def h():\n"
     "    with _b:\n"
     "        pass\n"
     "def f():\n"
     "    with _a:\n"
     "        h()\n"
     "def g():\n"
     "    with _b:\n"
     "        with _a:\n"
     "            pass\n"),
    ("hvr202_sleep_under_lock", _HELD_SLEEP.format("")),
    ("hvr202_sleep_after_lock",
     "import threading\n"
     "import time\n"
     "_l = threading.Lock()\n"
     "def f():\n"
     "    with _l:\n"
     "        n = 1\n"
     "    time.sleep(0.1)\n"),
    ("hvr202_anchored_at_root_call",
     "import threading\n"
     "import time\n"
     "_l = threading.Lock()\n"
     "def g():\n"
     "    time.sleep(0.5)\n"
     "def f():\n"
     "    with _l:\n"
     "        g()\n"),
    ("hvr203_escape", _GUARDED),
    ("hvr203_guarded_read",
     _GUARDED.replace("        return self._n",
                      "        with self._lock:\n"
                      "            return self._n")),
    ("hvr203_init_writes_exempt",
     "import threading\n"
     "class C:\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "        self._n = 0\n"
     "    def inc(self):\n"
     "        with self._lock:\n"
     "            self._n += 1\n"),
    ("hvr203_module_global",
     "import threading\n"
     "_lock = threading.Lock()\n"
     "_table = {}\n"
     "def put(k, v):\n"
     "    with _lock:\n"
     "        _table[k] = v\n"
     "def drop(k):\n"
     "    _table.pop(k, None)\n"),
    ("hvr204_handler_unbounded", _HANDLER),
    ("hvr204_handler_bounded",
     _HANDLER.replace("    with _l:\n        pass",
                      "    if _l.acquire(timeout=0.5):\n"
                      "        _l.release()")),
    ("hvr205_thread_leak",
     "import threading\n"
     "def arm_watch():\n"
     "    t = threading.Thread(target=_loop, daemon=True)\n"
     "    t.start()\n"
     "def _loop():\n"
     "    pass\n"),
    ("hvr205_stopped_at_exit",
     "import atexit\n"
     "import threading\n"
     "_stop = threading.Event()\n"
     "def arm_watch():\n"
     "    t = threading.Thread(target=_loop, daemon=True)\n"
     "    t.start()\n"
     "def stop_watch():\n"
     "    _stop.set()\n"
     "def _loop():\n"
     "    pass\n"
     "def _cleanup():\n"
     "    stop_watch()\n"
     "atexit.register(_cleanup)\n"),
    ("suppression_with_reason", _HELD_SLEEP.format(
        "  # hvdrace: disable=HVR202 -- bounded poll, test-only")),
    ("suppression_without_reason",
     _HELD_SLEEP.format("  # hvdrace: disable=HVR202")),
    ("suppression_on_def", _HELD_SLEEP.format("").replace(
        "def f():",
        "def f():  # hvdrace: disable=HVR202 -- whole-function waiver")),
    ("skip_file",
     "# hvdrace: skip-file -- vendored\n"
     "import threading\n"
     "import time\n"
     "_l = threading.Lock()\n"
     "def f():\n"
     "    with _l:\n"
     "        time.sleep(1)\n"),
    ("syntax_error", "def f(:\n"),
    ("cross_check_sources", _CROSS_SRC),
]

# The witness cross-check corpus: observed edges against _CROSS_SRC's graph.
CROSS_CASES = [
    ("predicted_edge", {("alpha:_outer", "beta:_inner"): 3}),
    ("unpredicted_edge", {("beta:_inner", "alpha:_outer"): 1}),
    ("unknown_lock", {("gamma:_mystery", "beta:_inner"): 1}),
    ("allocation_sites", {("{pkg}/alpha.py:3", "{pkg}/beta.py:2"): 2}),
]


def _race_report(race_mod, sources, convert):
    if isinstance(sources, str):
        sources = {"{pkg}/ops/x.py": sources}
    return race_mod.analyze_sources(
        {convert(p): convert(s) for p, s in sources.items()})


def _race_result(report, convert):
    return (sorted((f.code, f.path.replace(convert("{pkg}"), "PKG"), f.line)
                   for f in report.findings), sorted(report.edges))


CORPUS = ([("lint", *c) for c in LINT_CASES]
          + [("race", name, src, None, None) for name, src in RACE_CASES]
          + [("cross", name, edges, None, None)
             for name, edges in CROSS_CASES])


@pytest.mark.parametrize("kind,name,src,rel,propagated", CORPUS,
                         ids=[f"{c[0]}-{c[1]}" for c in CORPUS])
def test_corpus_matches_jax(kind, name, src, rel, propagated):
    """The same source through JAX's analyzer and the port's: the same
    codes at the same lines; for hvdrace the same edges too; for a witness
    log, the same cross-check codes."""
    from horovod_tpu.analysis import lint as jlint
    from horovod_tpu.analysis import race as jrace
    from horovod_tpu_torch.analysis import lint as plint
    from horovod_tpu_torch.analysis import race as prace
    if kind == "lint":
        want = _lint_result(jlint, src, rel, propagated, _jax)
        got = _lint_result(plint, src, rel, propagated, _port)
    elif kind == "race":
        want = _race_result(_race_report(jrace, src, _jax), _jax)
        got = _race_result(_race_report(prace, src, _port), _port)
    else:
        jrep = _race_report(jrace, _CROSS_SRC, _jax)
        prep = _race_report(prace, _CROSS_SRC, _port)
        want = [f.code for f in jrace.cross_check(
            jrep, {tuple(_jax(e) for e in k): n for k, n in src.items()})]
        got = [f.code for f in prace.cross_check(
            prep, {tuple(_port(e) for e in k): n for k, n in src.items()})]
    assert got == want


def test_corpus_cases_fire():
    """The corpus is not vacuous: the positive cases find what they
    name."""
    from horovod_tpu_torch.analysis import lint, race
    codes = {name: {code for code, _ in _lint_result(lint, src, rel, prop,
                                                      _port)}
             for name, src, rel, prop in LINT_CASES}
    for rule in ("HVL002", "HVL003", "HVL004", "HVL005", "HVL007"):
        assert any(rule in c for c in codes.values()), rule
    assert "HVL000" in codes["suppression_without_reason"]
    found = {name: {f[0] for f in _race_result(
        _race_report(race, src, _port), _port)[0]}
        for name, src in RACE_CASES}
    for rule in ("HVR200", "HVR201", "HVR202", "HVR203", "HVR204",
                 "HVR205", "HVR999"):
        assert any(rule in c for c in found.values()), rule


def test_package_membership_is_exact():
    """A module of the package is ``horovod_tpu_torch`` or one under it:
    a name that only shares the prefix is not (the JAX analyzer tests the
    prefix ``horovod_tpu``)."""
    from horovod_tpu_torch.analysis import race
    assert race._in_pkg("horovod_tpu_torch")
    assert race._in_pkg("horovod_tpu_torch.ops.fusion")
    assert not race._in_pkg("horovod_tpu_torch_extra.ops")
    assert not race._in_pkg("horovod_tpu.ops.fusion")
    assert race._strip_pkg("horovod_tpu_torch.ops.fusion") == "ops.fusion"
    rep = race.analyze_sources({
        "horovod_tpu_torch/a.py": (
            "import threading\n"
            "import horovod_tpu_torch_extra.b as b\n"
            "from horovod_tpu import c\n"
            "_x = threading.Lock()\n"
            "def f():\n"
            "    with _x:\n"
            "        b.g()\n"
            "        c.h()\n")})
    assert rep.modules["a"].imports == {}


def test_typed_receivers_resolve():
    """The port's resolver follows annotations and module globals a call
    assigned (its live witness takes locks through both)."""
    from horovod_tpu_torch.analysis import race
    rep = race.analyze_sources({
        "horovod_tpu_torch/rt.py": (
            "import threading\n"
            "class Runtime:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def shutdown(self):\n"
            "        with self._lock:\n"
            "            pass\n"),
        "horovod_tpu_torch/fam.py": (
            "import threading\n"
            "class Family:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def labels(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "def make():\n"
            "    return Family()\n"
            "FAMILY = make()\n"),
        "horovod_tpu_torch/core.py": (
            "import threading\n"
            "from horovod_tpu_torch import fam\n"
            "_lock = threading.Lock()\n"
            "class State:\n"
            "    def __init__(self):\n"
            "        self.runtime: \"Runtime | None\" = None\n"
            "def down(st: \"State\"):\n"
            "    with _lock:\n"
            "        st.runtime.shutdown()\n"
            "        fam.FAMILY.labels()\n")})
    assert ("core:_lock", "rt:Runtime._lock") in rep.edges
    assert ("core:_lock", "fam:Family._lock") in rep.edges


def test_self_lint_is_clean_and_fast():
    """hvdlint over the port's package and chip_smoke.py: no finding, more
    than 100 files, within the 30 s budget."""
    from horovod_tpu_torch.analysis import lint
    paths, base = lint.default_paths()
    assert [os.path.relpath(p, base) for p in paths] == [PKG, "chip_smoke.py"]
    t0 = time.monotonic()
    findings, n_files = lint.lint_paths(paths, base=base)
    dt = time.monotonic() - t0
    assert n_files > 100
    assert not findings, "\n".join(f.render() for f in findings)
    assert dt < 30.0, f"hvdlint took {dt:.1f}s (budget 30s)"


@pytest.mark.parametrize("paths", [[PKG], [PKG, "chip_smoke.py"]],
                         ids=["package", "package_and_chip_smoke"])
def test_self_race_is_clean_and_fast(paths):
    """hvdrace over the port's package (and with chip_smoke.py): no
    finding, more than 100 files and 20 lock-order edges, within the 30 s
    budget."""
    from horovod_tpu_torch.analysis import race
    t0 = time.monotonic()
    rep = race.analyze_paths([str(ROOT / p) for p in paths], base=str(ROOT))
    dt = time.monotonic() - t0
    assert rep.n_files > 100
    assert len(rep.edges) > 20
    assert not rep.findings, "\n".join(f.render() for f in rep.findings)
    assert dt < 30.0, f"hvdrace took {dt:.1f}s (budget 30s)"


def test_init_builds_the_kernels_before_its_lock(monkeypatch):
    """The dynamic half of the fusion flush's HVR202 repair: hvd.init on
    CUDA compiles every kernel source while ``basics._lock`` is free, and
    before any collective can launch (a flush and a reduce-scatter only
    load a library). The card's side is ``test_torch_cuda_kernels.py::
    test_first_kernel_use_builds_a_cold_cache``."""
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops.kernels import _build

    seen = {}

    class Stop(Exception):
        pass

    def build(names=_build.SOURCES):
        seen.update(names=tuple(names), locked=basics._lock.locked())
        raise Stop()

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(Stop):
        basics.init()
    assert seen == {"names": _build.SOURCES, "locked": False}


_BAD_LINT = "import os\nv = os.environ.get('HOROVOD_BOGUS_KNOB')\n"
_NO_JAX = r'''
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import horovod_tpu_torch.analysis as a
from horovod_tpu_torch.analysis import events, findings, lint, race
assert a.lint_source is lint.lint_source and a.Finding is findings.Finding
bad = sorted(m for m in sys.modules
             if m == "horovod_tpu" or m.startswith("horovod_tpu."))
print("JAX_FREE" if not bad else bad)
'''


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The two CLIs on a clean and a bad file, and the analysis package
    imported with jax blocked: all at once, each in a process of its own."""
    d = tmp_path_factory.mktemp("cli")
    (d / "good.py").write_text("x = 1\n")
    (d / "bad_lint.py").write_text(_BAD_LINT)
    (d / "bad_race.py").write_text(_INVERSION)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "HVD_"))}
    env["PYTHONPATH"] = str(ROOT)
    runs = {
        "lint_good": ["-m", f"{PKG}.analysis.lint", str(d / "good.py")],
        "lint_bad": ["-m", f"{PKG}.analysis.lint", str(d / "bad_lint.py")],
        "race_good": ["-m", f"{PKG}.analysis.race", str(d / "good.py")],
        "race_bad": ["-m", f"{PKG}.analysis.race", str(d / "bad_race.py")],
        "lint_json": ["-m", f"{PKG}.analysis", "--format", "json",
                      str(d / "bad_lint.py")],
        "no_jax": ["-c", _NO_JAX],
    }
    procs = {k: subprocess.Popen([sys.executable, *argv], cwd=str(ROOT),
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, argv in runs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        out[k] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("run,rc,rule", [
    ("lint_good", 0, None), ("lint_bad", 1, "HVL002"),
    ("race_good", 0, None), ("race_bad", 1, "HVR201")])
def test_cli_exit_codes(cli, run, rc, rule):
    code, stdout, stderr = cli[run]
    assert code == rc, stdout + stderr
    if rule:
        assert rule in stdout
    else:
        assert not stdout.strip()


def test_cli_json_output(cli):
    code, stdout, stderr = cli["lint_json"]
    assert code == 1, stderr
    doc = json.loads(stdout)
    assert doc["files"] == 1
    assert [f["code"] for f in doc["findings"]] == ["HVL002"]


def test_analysis_imports_nothing_of_jax(cli):
    code, stdout, stderr = cli["no_jax"]
    assert code == 0, stderr[-3000:]
    assert "JAX_FREE" in stdout, stdout


def test_live_witness_cross_checks_clean():
    """chip_smoke.py's race_witness child at GPT tiny on the CPU (gloo), in
    a process of its own under HVD_LOCK_WITNESS=1: it trains through the
    fusion runtime and its cycle thread, serves from two submitter threads
    through a commit and a restore, ticks a telemetry agent and the
    autopilot, shuts down and re-inits; every edge it saw is in the port's
    static lock graph (no HVR210, no HVR211) and both lint gates stay
    clean."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.witness_gates("tiny", "cpu")
    child = out["child"]
    assert out["edges_observed"] > 5
    assert out["locks_wrapped"] > 20
    assert child["served_requests"] == 2 * chip_smoke.WITNESS_REQUESTS
    assert child["losses"][-1] < child["losses"][0]
    assert set(child["fusion_locks"].values()) == {"_WitnessProxy"}
