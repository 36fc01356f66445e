"""hvdlint: AST-based codebase lint for distributed-runtime hazards.

Port of the JAX package's ``analysis/lint.py``, the same rules, pragmas
and output. ``python -m horovod_tpu_torch.analysis.lint [paths...]``
(default: the ``horovod_tpu_torch`` package and the ``chip_smoke.py``
beside it) checks Python sources for the bug classes earlier fixes found
by hand:

- **HVL002 undeclared env knob**: an ``os.environ`` /
  ``_env_bool/int/float`` read of a ``HOROVOD_*``/``HVD_*`` name that
  ``common/config.py::Config`` does not declare. An undeclared knob is
  missing from the launcher's worker env. The declared set is parsed from
  config.py's AST, so declaring the knob fixes the finding with no lint
  change.
- **HVL003 ambient env write**: mutating ``HOROVOD_*``/``HVD_*`` env
  outside the launcher / config / test layers: invisible config drift.
- **HVL004 rank-conditional collective**: an eager collective inside an
  ``if`` gated on ``rank()``/``local_rank()``/``cross_rank()``/
  ``process_index()`` in example/test code: the other ranks never enter
  the dispatch (library internals legitimately rank-branch around
  *mirror* dispatches, so the rule applies to user-code roots only).
- **HVL005 non-daemon thread**: ``threading.Thread(...)`` without
  ``daemon=True``: a forgotten thread blocks interpreter exit.
- **HVL007 unpropagated knob**: a knob declared in
  ``common/config.py::Config`` whose env spelling never appears in the
  launcher's worker-env plumbing (``runner/launch.py`` +
  ``runner/config_parser.py``): set on the launcher, silently absent on
  every worker on another host. The inverse of HVL002.

HVL001 (lock-held blocking call) and HVL006 (lock-held sleep) are
retired, as in the JAX package: hvdrace's HVR202
(``python -m horovod_tpu_torch.analysis.race``) follows a held lock
across function and module boundaries.

Suppression: ``# hvdlint: disable=HVL002 -- <reason>`` on the offending
line or its enclosing ``with``/``def`` line; the reason is REQUIRED (a
bare disable is itself reported). ``# hvdlint: skip-file -- <reason>``
at the top of a file skips it entirely.
"""

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
import time

_COLLECTIVE_CALLS = frozenset({
    "allreduce", "grouped_allreduce", "allgather", "grouped_allgather",
    "allgather_ragged", "broadcast", "grouped_broadcast", "reducescatter",
    "grouped_reducescatter", "alltoall", "barrier", "join",
    "allreduce_async", "grouped_allreduce_async", "allgather_async",
    "broadcast_async", "alltoall_async", "reducescatter_async",
    "broadcast_object", "allgather_object", "broadcast_parameters",
    "broadcast_object_tree",
})
_RANK_CALLS = frozenset({"rank", "local_rank", "cross_rank",
                         "process_index"})

_KNOB_RE = re.compile(r"^(HOROVOD|HVD)_[A-Z0-9_]+$")

# Launcher/bootstrap plumbing: set by hvdrun / cluster managers per
# worker, read back by the core — not user-facing knobs, so not declared
# as Config fields (rank/size ARE fields, listed here for their env
# spellings' sake in non-config modules).
_BOOTSTRAP_VARS = frozenset({
    "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
    "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
    "HOROVOD_COORDINATOR_ADDR", "HOROVOD_COORDINATOR_PORT",
    "HOROVOD_KV_ADDR", "HOROVOD_KV_PORT", "HOROVOD_KV_SHARD_PORTS",
    "HOROVOD_SECRET_KEY",
    "HOROVOD_HOSTNAME", "HOROVOD_HOST_KEY",
    "HOROVOD_ELASTIC_INIT_VERSION",
    # test-harness only
    "HVD_TEST_TIMEOUT",
})

# Recognized non-Config namespaces: bench-harness sweep parameters are
# set per invocation by a bench driver on the one process it runs
# (nothing to propagate or document in the runtime knob catalogue).
# HOROVOD_FUSION_THRESHOLD-style runtime knobs must NOT move here.
# HVD_LOCK_* is the hvdrace runtime-witness namespace (HVD_LOCK_WITNESS,
# HVD_LOCK_WITNESS_FILE): diagnostic instrumentation toggled per-process
# by the person debugging, never launcher-propagated config.
_HARNESS_PREFIXES = ("HVD_BENCH_", "HVD_SENTINEL_", "HVD_LOCK_")

# HVL001/HVL006 (lock-held blocking call / sleep) are retired: hvdrace's
# HVR202 subsumes both with call-graph-aware hold propagation
# (analysis/race.py).
_DEFAULT_RULES = frozenset(
    {"HVL002", "HVL003", "HVL004", "HVL005", "HVL007"})

# Modules allowed to WRITE ambient HOROVOD_*/HVD_* env (HVL003): the
# launcher stack (its whole job is exporting worker env), config
# plumbing, and harnesses that save/restore around subprocesses.
_ENV_WRITER_PATHS = ("runner/", "chaos/soak", "elastic/worker",
                     "flight/recorder", "tests/", "scripts/")

# Paths where HVL004 (rank-conditional collective) applies: user-facing
# code (and tests). Library internals legitimately rank-branch around
# mirror dispatch / driver logic.
_USER_CODE_PATHS = ("examples/", "docs/")

_DISABLE_RE = re.compile(
    r"#\s*hvdlint:\s*disable=([A-Z0-9, ]+?)\s*(?:--\s*(.*))?$")
_SKIP_FILE_RE = re.compile(r"#\s*hvdlint:\s*skip-file\s*(?:--\s*(.*))?$")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    code: str
    path: str
    line: int
    message: str

    def render(self):
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_dict(self):
        return dataclasses.asdict(self)


def declared_knobs(config_path=None):
    """Parse ``common/config.py`` (AST only, no import) and return every
    env-var name it declares: string literals matching ``HOROVOD_*`` /
    ``HVD_*`` anywhere in the module (the ``from_env`` reads plus
    documented aliases)."""
    if config_path is None:
        config_path = os.path.join(os.path.dirname(__file__), os.pardir,
                                   "common", "config.py")
    try:
        with open(config_path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return frozenset()
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _KNOB_RE.match(node.value):
            names.add(node.value)
    return frozenset(names)


def propagated_knobs(launch_path=None, parser_path=None):
    """Every ``HOROVOD_*``/``HVD_*`` literal in the launcher's worker-env
    plumbing — ``runner/launch.py`` (build_worker_env's propagation
    tuple) plus ``runner/config_parser.py`` (the CLI arg → env map).
    That union is exactly the set of knobs a worker process can actually
    receive; HVL007 diffs the declared set against it."""
    here = os.path.dirname(__file__)
    if launch_path is None:
        launch_path = os.path.join(here, os.pardir, "runner", "launch.py")
    if parser_path is None:
        parser_path = os.path.join(here, os.pardir, "runner",
                                   "config_parser.py")
    names = set()
    for path in (launch_path, parser_path):
        try:
            with open(path) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and _KNOB_RE.match(node.value):
                names.add(node.value)
    return frozenset(names)


def _call_name(node):
    """Terminal name of a call: ``f(...)`` -> f, ``a.b.c(...)`` -> c."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _env_read_name(node):
    """The env-var name a Call reads, or None: ``os.environ.get(K)``,
    ``os.environ[K]`` handled separately, ``os.getenv(K)``,
    ``_env_bool/int/float(K, ...)``."""
    name = _call_name(node)
    args = node.args
    if name in ("get", "pop") and args:
        # os.environ.get / environ.pop — require the receiver to mention
        # environ to avoid flagging dict.get("HOROVOD_X") on metrics maps
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        if recv is not None and "environ" in ast.dump(recv):
            return _const_str(args[0])
        return None
    if name == "getenv" and args:
        return _const_str(args[0])
    if name in ("_env_bool", "_env_int", "_env_float") and args:
        return _const_str(args[0])
    return None


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path, rel, source, declared, rules):
        self.path = path
        self.rel = rel
        self.lines = source.splitlines()
        self.declared = declared
        self.rules = rules
        self.findings = []
        self.suppressions = {}      # line -> (codes or None=all, reason)
        self.bad_suppressions = []
        self._def_lines = []        # enclosing def/with lines (suppression)
        self._collect_suppressions()

    # --- suppression bookkeeping ---------------------------------------

    def _collect_suppressions(self):
        for i, line in enumerate(self.lines, 1):
            m = _DISABLE_RE.search(line)
            if m:
                codes = frozenset(
                    c.strip() for c in m.group(1).split(",") if c.strip())
                reason = (m.group(2) or "").strip()
                if not reason:
                    self.bad_suppressions.append(i)
                self.suppressions[i] = (codes, reason)

    def _suppressed(self, code, line):
        for ln in (line, *self._def_lines):
            entry = self.suppressions.get(ln)
            if entry and (not entry[0] or code in entry[0]) and entry[1]:
                return True
        return False

    def _emit(self, code, node, message):
        if code not in self.rules:
            return
        line = getattr(node, "lineno", 1)
        if self._suppressed(code, line):
            return
        self.findings.append(
            LintFinding(code=code, path=self.rel, line=line,
                        message=message))

    # --- visitors -------------------------------------------------------

    def visit_FunctionDef(self, node):
        self._def_lines.append(node.lineno)
        self.generic_visit(node)
        self._def_lines.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        self._def_lines.append(node.lineno)
        self.generic_visit(node)
        self._def_lines.pop()

    def visit_Call(self, node):
        name = _call_name(node)
        env_name = _env_read_name(node)
        if env_name and _KNOB_RE.match(env_name) \
                and env_name not in self.declared \
                and env_name not in _BOOTSTRAP_VARS \
                and not env_name.startswith(_HARNESS_PREFIXES):
            self._emit("HVL002", node,
                       f"undeclared env knob {env_name}: declare it in "
                       "common/config.py::Config (launcher propagation + "
                       "docs catalogue) or it silently stays "
                       "single-process")
        if name == "Thread":
            kw = {k.arg for k in node.keywords}
            if "daemon" not in kw and not self._daemon_set_nearby(node):
                self._emit("HVL005", node,
                           "threading.Thread without daemon=True: a "
                           "forgotten non-daemon thread blocks "
                           "interpreter exit (register an explicit "
                           "shutdown path or mark it daemon)")
        self.generic_visit(node)

    def _daemon_set_nearby(self, node):
        """``t = Thread(...); t.daemon = True`` within a few lines."""
        window = range(node.lineno, min(node.lineno + 6,
                                        len(self.lines) + 1))
        return any(".daemon" in self.lines[i - 1] for i in window
                   if 0 < i <= len(self.lines))

    def visit_Subscript(self, node):
        # os.environ["K"] direct read (writes are Assign targets, handled
        # there under HVL003; Del is launcher cleanup)
        if isinstance(node.ctx, ast.Load) \
                and "environ" in ast.dump(node.value):
            key = _const_str(node.slice)
            if key and _KNOB_RE.match(key) \
                    and key not in self.declared \
                    and key not in _BOOTSTRAP_VARS \
                    and not key.startswith(_HARNESS_PREFIXES):
                self._emit("HVL002", node,
                           f"undeclared env knob {key}: declare it in "
                           "common/config.py::Config (launcher "
                           "propagation + docs catalogue) or it silently "
                           "stays single-process")
        self.generic_visit(node)

    def visit_Assign(self, node):
        for tgt in node.targets:
            self._check_env_write(tgt, node)
        self.generic_visit(node)

    def _check_env_write(self, tgt, node):
        if not isinstance(tgt, ast.Subscript):
            return
        if "environ" not in ast.dump(tgt.value):
            return
        key = _const_str(tgt.slice) if not isinstance(tgt.slice, ast.Tuple) \
            else None
        if key and _KNOB_RE.match(key) and not self._env_writer_allowed():
            self._emit("HVL003", node,
                       f"ambient env write of {key} outside the launcher/"
                       "config layer: exported config must flow through "
                       "Config / build_worker_env")

    def _env_writer_allowed(self):
        rel = self.rel.replace(os.sep, "/")
        return any(p in rel for p in _ENV_WRITER_PATHS) \
            or rel.endswith("common/config.py")

    def visit_If(self, node):
        if self._rank_conditional(node.test) and self._user_code():
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and _call_name(sub) in _COLLECTIVE_CALLS:
                    self._emit(
                        "HVL004", sub,
                        f"rank-conditional collective "
                        f"{_call_name(sub)}() (if-gated on rank at line "
                        f"{node.lineno}): other ranks never enter the "
                        "dispatch and the job deadlocks")
                    break
        self.generic_visit(node)

    def _user_code(self):
        rel = self.rel.replace(os.sep, "/")
        return any(p in rel for p in _USER_CODE_PATHS) \
            or rel.startswith("tests/") or "/tests/" in rel

    def _rank_conditional(self, test):
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) \
                    and _call_name(sub) in _RANK_CALLS:
                return True
        return False


def lint_source(source, rel_path="<string>", declared=None, rules=None,
                path=None, propagated=None):
    """Lint one source string; returns a list of :class:`LintFinding`.

    ``propagated`` is the launcher-exported knob set for HVL007 (parsed
    from the real launch/config_parser files when None); it is only
    consulted when ``rel_path`` is the Config module itself."""
    declared = declared if declared is not None else declared_knobs()
    rules = frozenset(rules) if rules else _DEFAULT_RULES
    first = source.split("\n", 2)[:2]
    for line in first:
        m = _SKIP_FILE_RE.search(line)
        if m:
            if (m.group(1) or "").strip():
                return []
            return [LintFinding(code="HVL000", path=rel_path, line=1,
                                message="skip-file without a reason "
                                        "(append `-- <why>`)")]
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [LintFinding(code="HVL999", path=rel_path,
                            line=e.lineno or 1,
                            message=f"syntax error: {e.msg}")]
    linter = _FileLinter(path or rel_path, rel_path, source, declared,
                         rules)
    linter.visit(tree)
    if "HVL007" in rules \
            and rel_path.replace(os.sep, "/").endswith("common/config.py"):
        if propagated is None:
            propagated = propagated_knobs()
        # First declaring line per knob: the anchor the fix lands on.
        decl_lines = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and _KNOB_RE.match(node.value):
                decl_lines.setdefault(node.value, node.lineno)
        for knob in sorted(decl_lines):
            if knob in propagated or knob in _BOOTSTRAP_VARS \
                    or knob.startswith(_HARNESS_PREFIXES):
                continue
            line = decl_lines[knob]
            if linter._suppressed("HVL007", line):
                continue
            linter.findings.append(LintFinding(
                code="HVL007", path=rel_path, line=line,
                message=f"knob {knob} is declared in Config but never "
                        "exported by build_worker_env / the CLI arg map: "
                        "set on the driver, it silently stays unset on "
                        "every worker (add it to launch.py's propagation "
                        "tuple)"))
    for ln in linter.bad_suppressions:
        linter.findings.append(LintFinding(
            code="HVL000", path=rel_path, line=ln,
            message="hvdlint disable without a reason (append "
                    "`-- <why>`)"))
    return linter.findings


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths, declared=None, rules=None, base=None):
    """Lint files/trees; returns (findings, n_files)."""
    declared = declared if declared is not None else declared_knobs()
    findings, n = [], 0
    base = base or os.getcwd()
    for path in iter_py_files(paths):
        n += 1
        rel = os.path.relpath(path, base)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(LintFinding(code="HVL999", path=rel, line=1,
                                        message=str(e)))
            continue
        findings.extend(
            lint_source(source, rel_path=rel, declared=declared,
                        rules=rules, path=path))
    return findings, n


def default_paths():
    """The package and the ``chip_smoke.py`` beside it, with their root."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    paths = [pkg]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.isfile(smoke):
        paths.append(smoke)
    return paths, root


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.lint",
        description="hvdlint: static lint for distributed-runtime "
                    "hazards")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories (default: the "
                             "horovod_tpu_torch package and chip_smoke.py)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule codes to enable")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--config", default=None,
                        help="path to the Config module to parse for "
                             "declared knobs")
    args = parser.parse_args(argv)
    paths, base = (args.paths, None) if args.paths else default_paths()
    rules = frozenset(args.rules.split(",")) if args.rules else None
    t0 = time.monotonic()
    findings, n_files = lint_paths(
        paths, declared=declared_knobs(args.config), rules=rules, base=base)
    dt = time.monotonic() - t0
    if args.format == "json":
        print(json.dumps({"files": n_files, "seconds": round(dt, 3),
                          "findings": [f.to_dict() for f in findings]},
                         indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"hvdlint: {len(findings)} finding(s) in {n_files} files "
              f"({dt:.2f}s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
