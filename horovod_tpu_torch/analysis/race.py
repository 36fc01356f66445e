"""hvdrace -- whole-package lock-graph analyzer with a runtime acquisition witness.

Port of the JAX package's ``analysis/race.py``: the same passes, rules,
blocking-call sets, pragmas and witness, over ``horovod_tpu_torch``.
``python -m horovod_tpu_torch.analysis.race [paths...]`` (default: the
package). A module belongs to the package only when its dotted name is
``horovod_tpu_torch`` or starts with ``horovod_tpu_torch.``
(:func:`_in_pkg`), never by a bare prefix.

The port resolves two more kinds of call than the JAX package's analyzer,
since its live witness (a training step through the fusion runtime) takes
locks through both, and an edge the graph misses is an analyzer gap
(HVR210):

* a method call on a module global that a non-constructor call assigned
  (``FAMILY = REGISTRY.counter(...)``; ``FAMILY.labels(...)``, also as
  ``mod.FAMILY.labels(...)`` from another module) resolves as one on a
  call result does: to the same-named methods of the classes in the
  global's module and its direct imports;
* type annotations are breadcrumbs beside constructor calls: a parameter's
  or a local's (``st: "_State"``) and a ``self`` attribute's
  (``self.fusion: "FusionRuntime" = None``), and a local typed either way
  resolves ``x.m()`` and ``x.attr.m()`` as ``self`` does.

Static side
-----------
Two AST passes over every module in the package:

* pass A collects lock *definitions* (``threading.Lock/RLock/Condition``
  allocations bound to module globals or ``self`` attributes), class layouts,
  import aliases (including function-local imports, which ``basics`` uses
  heavily), and enough type breadcrumbs (``self.x = ClassName(...)``,
  ``g = ClassName(...)``) to resolve attribute calls across modules.
* pass B walks every function body tracking which locks are held at each
  statement (``with lock:`` scopes plus *sticky* ``lock.acquire()`` calls that
  stay held until a matching ``.release()``), and records call sites, blocking
  calls, guarded-field accesses, ``Thread(...)`` creations, ``signal.signal``
  registrations and stop/join evidence.

Holds are then propagated over the resolvable call graph to a fixed point, so
"function f runs while lock L is held" is known even when the ``with`` sits
three frames up in another module.  The propagated graph feeds the rules:

========  ====================================================================
HVR201    lock-order inversion: a cycle in the may-hold-before graph; the
          finding carries a witness path for both directions.
HVR202    blocking call (KV/HTTP RPC, sockets, subprocess, ``Thread.join``,
          ``sleep``, unbounded ``wait``, trace/flight ``dump``) reachable
          while an unbounded lock is held.  Subsumes and retires
          hvdlint HVL001/HVL006.
HVR203    guarded-field escape: an attribute written under its class's lock in
          some methods and read or written without it in others (lockset
          style).  Also applied to module-level mutable-container globals.
HVR204    signal-handler-unsafe call: a handler registered via
          ``signal.signal`` reaches an *unbounded* lock acquire.
HVR205    thread-lifecycle leak: a ``Thread`` started from an init/arm path
          whose owner has no stop/join evidence reachable from
          ``basics.shutdown`` (or an ``atexit`` root).
HVR200    bare ``# hvdrace: disable=...`` without a ``-- reason``.
HVR210    (cross-check only) runtime acquisition edge not predicted
          statically -- an analyzer gap, never suppressible.
HVR211    (cross-check only) runtime witness saw a package lock the static
          pass never resolved.
HVR999    file does not parse.
==========================================================================

Suppression follows hvdlint conventions exactly: ``# hvdrace:
disable=HVR203 -- reason`` on the offending line or on an enclosing
``def``/``with`` line, and ``# hvdrace: skip-file`` in the first two lines.

Runtime witness
---------------
``install_witness()`` (or ``HVD_LOCK_WITNESS=1`` at import) swaps
``threading.Lock``/``threading.RLock`` for factories that hand instrumented
proxies to *package* allocation sites only (callers outside the package --
including ``threading.py`` itself building a ``Condition`` -- get real locks),
and sweeps already-imported ``horovod_tpu_torch`` modules for module-global locks,
wrapping the existing object so mutual exclusion is preserved.  Each proxy
records, per thread, the edge (held-lock -> acquired-lock) on every successful
acquisition.  ``cross_check(report, edges)`` then asserts every observed edge
exists in the static may-hold-before graph -- a missed edge is a bug in *this
analyzer*, reported as HVR210.  With ``HVD_LOCK_WITNESS_FILE`` set as well,
the edges are dumped there (:func:`dump_witness`) when the process exits.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

_DISABLE_RE = re.compile(r"#\s*hvdrace:\s*disable=([A-Z0-9, ]+?)\s*(?:--\s*(.*))?$")
_SKIP_FILE_RE = re.compile(r"#\s*hvdrace:\s*skip-file")

ALL_RULES = frozenset({"HVR201", "HVR202", "HVR203", "HVR204", "HVR205"})

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# Calls that can block indefinitely.  Grouped for the finding message.
_BLOCKING_RPC = {
    "urlopen", "kv_get", "kv_put", "kv_delete", "wait_for_key", "negotiate",
    "getresponse", "request", "read_response",
}
_BLOCKING_SOCKET = {"connect", "accept", "recv", "recvfrom", "sendall", "makefile"}
_BLOCKING_SUBPROC = {"Popen", "check_call", "check_output", "run", "communicate"}
_BLOCKING_COLLECTIVE = {
    "allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
    "barrier", "grouped_allreduce",
}
_BLOCKING_MISC = {"sleep", "dump", "join", "wait", "get", "put", "select"}

# Receiver-name hints: `join` only blocks interestingly on threads/processes/
# queues; `get`/`put` only on queues; `wait` on events/conditions.
_JOIN_RECV_HINT = ("thread", "proc", "worker", "agent")
_QUEUE_RECV_HINT = ("queue", "q", "inbox", "outbox")
_WAIT_RECV_HINT = ("event", "cond", "cv", "stop", "done", "ready", "_stop")

_STOP_EVIDENCE_CALLS = {"join", "set", "stop", "close", "shutdown", "terminate", "cancel"}

_INIT_PATH_NAMES = ("init", "arm", "start", "configure", "install", "__init__")

_PKG = "horovod_tpu_torch"


def _in_pkg(dotted: str) -> bool:
    """Whether a dotted module name is the package or one of its modules."""
    return dotted == _PKG or dotted.startswith(_PKG + ".")


# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RaceFinding:
    code: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_dict(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "message": self.message}


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _recv_name(node: ast.Call) -> str:
    """Best-effort textual receiver of an attribute call: `a.b.c()` -> 'a.b'."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return ""
    parts: List[str] = []
    cur = fn.value
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call) and not parts:
        return "()"      # method on a call result: f(...).m()
    return ".".join(reversed(parts))


def _is_lock_ctor(node: ast.Call) -> Optional[str]:
    """Return the ctor name if `node` allocates a threading lock."""
    fn = node.func
    name = None
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        name = fn.id
    elif isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS:
        base = fn.value
        if isinstance(base, ast.Name) and base.id in ("threading", "_threading"):
            name = fn.attr
        elif isinstance(base, ast.Name):
            # `t.Lock()` style aliases are rare; accept module-ish names.
            name = fn.attr if base.id.islower() else None
    return name


def _has_timeout_arg(node: ast.Call) -> bool:
    if node.args:
        return True
    return any(kw.arg == "timeout" and not (
        isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in node.keywords)


def _lockish_name(text: str) -> bool:
    low = text.lower()
    return "lock" in low or low.endswith(("_cv", "_cond")) or "condition" in low


def _annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    """The class an annotation names: ``C``, ``"C"``, ``mod.C``,
    ``Optional[C]``, ``C | None``; None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        sides = [n for n in (node.left, node.right)
                 if not (isinstance(n, ast.Constant) and n.value is None)]
        return _annotation_class(sides[0]) if len(sides) == 1 else None
    if isinstance(node, ast.Subscript) and isinstance(
            node.value, (ast.Name, ast.Attribute)):
        outer = node.value.id if isinstance(node.value, ast.Name) \
            else node.value.attr
        return _annotation_class(node.slice) if outer == "Optional" else None
    name = node.attr if isinstance(node, ast.Attribute) else \
        node.id if isinstance(node, ast.Name) else ""
    return name if name.lstrip("_")[:1].isupper() else None


# --------------------------------------------------------------------------
# pass A: module-level collection
# --------------------------------------------------------------------------


@dataclass
class _ClassInfo:
    name: str
    line: int
    # attr -> lock ident for self.<attr> = threading.Lock()
    lock_attrs: Dict[str, str] = field(default_factory=dict)
    # attr -> class name for self.<attr> = SomeClass(...)
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, "_FuncInfo"] = field(default_factory=dict)


@dataclass
class _FuncInfo:
    qual: str                      # "mod:func" or "mod:Class.func"
    module: str
    cls: Optional[str]
    name: str
    line: int
    # locks acquired locally: ident -> (line, bounded)
    acquires: List[Tuple[str, int, bool]] = field(default_factory=list)
    # call sites: (callee-token, receiver-text, line, frozenset(held idents), node)
    calls: List[Tuple[str, str, int, FrozenSet[str]]] = field(default_factory=list)
    # blocking calls noticed locally: (kind, name, line, frozenset(held))
    blocking: List[Tuple[str, str, int, FrozenSet[str]]] = field(default_factory=list)
    # self-field accesses: (attr, line, is_write, frozenset(held))
    fields: List[Tuple[str, int, bool, FrozenSet[str]]] = field(default_factory=list)
    # module-global accesses: (name, line, is_write, frozenset(held))
    globals_acc: List[Tuple[str, int, bool, FrozenSet[str]]] = field(default_factory=list)
    # Thread(...) creations: (line, target-name-if-known)
    thread_creates: List[Tuple[int, str]] = field(default_factory=list)
    # stop evidence (calls like x.join()/stop()/set())
    has_stop_evidence: bool = False
    # ordered pairs (held -> acquired) with the acquire line, for HVR201
    order_edges: List[Tuple[str, str, int]] = field(default_factory=list)
    # propagated entry holds: ident -> chain of "qual@line" strings
    entry_holds: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # local name -> class token (constructor calls and annotations)
    local_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class _ModuleInfo:
    rel: str                       # repo-relative path
    modname: str                   # dotted module name within the package
    tree: Optional[ast.AST]
    source_lines: List[str]
    suppressions: Dict[int, Tuple[Set[str], str]] = field(default_factory=dict)
    def_lines: Dict[int, List[int]] = field(default_factory=dict)  # line -> enclosing def/with lines
    # module-global lock idents: varname -> ident
    locks: Dict[str, str] = field(default_factory=dict)
    # lock allocation sites: (line) -> ident, for witness site mapping
    lock_sites: Dict[int, str] = field(default_factory=dict)
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    funcs: Dict[str, _FuncInfo] = field(default_factory=dict)  # qual -> info
    # import aliases: local name -> dotted module (package-internal only)
    imports: Dict[str, str] = field(default_factory=dict)
    # from-import symbols: local name -> (module, symbol)
    symbol_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # module globals holding class instances: name -> class token
    global_types: Dict[str, str] = field(default_factory=dict)
    # module globals a non-constructor call assigned (type unknown)
    opaque_globals: Set[str] = field(default_factory=set)
    # module-level mutable container globals (dict/list/set literals or ctors)
    mutable_globals: Set[str] = field(default_factory=set)
    signal_handlers: List[Tuple[str, int]] = field(default_factory=list)  # (handler token, line)
    atexit_roots: List[str] = field(default_factory=list)  # handler tokens


class Report:
    """Result of a static analysis run."""

    def __init__(self) -> None:
        self.findings: List[RaceFinding] = []
        self.modules: Dict[str, _ModuleInfo] = {}
        self.funcs: Dict[str, _FuncInfo] = {}
        self.edges: Set[Tuple[str, str]] = set()      # may-hold-before
        # edge -> (rel, line, holder-function qual): the witness site
        self.edge_witness: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.lock_table: Dict[Tuple[str, int], str] = {}  # (rel, line) -> ident
        self.lock_idents: Set[str] = set()
        self.n_files = 0
        self.seconds = 0.0

    def to_dict(self) -> dict:
        return {
            "files": self.n_files,
            "seconds": round(self.seconds, 3),
            "locks": sorted(self.lock_idents),
            "edges": sorted(["%s->%s" % e for e in self.edges]),
            "findings": [f.to_dict() for f in self.findings],
        }


def _collect_suppressions(source_lines: List[str], mi: _ModuleInfo) -> List[RaceFinding]:
    bare: List[RaceFinding] = []
    for i, line in enumerate(source_lines, start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        reason = (m.group(2) or "").strip()
        if not reason:
            bare.append(RaceFinding(
                "HVR200", mi.rel, i,
                "bare 'hvdrace: disable' without '-- reason'; suppressions "
                "must explain themselves"))
            continue
        mi.suppressions[i] = (codes, reason)
    return bare


def _index_def_lines(mi: _ModuleInfo) -> None:
    """Map every line to the def/with header lines that enclose it."""
    if mi.tree is None:
        return

    stack: List[int] = []

    def walk(node: ast.AST) -> None:
        push = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.With))
        if push:
            stack.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child)
        if push:
            stack.pop()
        if hasattr(node, "lineno"):
            lineno = node.lineno
            if stack and lineno not in mi.def_lines:
                mi.def_lines[lineno] = list(stack)
            elif stack:
                mi.def_lines[lineno] = list(stack)

    walk(mi.tree)


def _suppressed(mi: _ModuleInfo, code: str, line: int) -> bool:
    candidates = [line] + mi.def_lines.get(line, [])
    for ln in candidates:
        entry = mi.suppressions.get(ln)
        if entry and code in entry[0]:
            return True
    return False


def _pass_a(mi: _ModuleInfo) -> None:
    """Collect locks, classes, imports, type breadcrumbs."""
    tree = mi.tree
    assert tree is not None
    mod = mi.modname

    def record_import(node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _in_pkg(alias.name):
                    mi.imports[alias.asname or alias.name.split(".")[-1]] = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                # relative import: resolve against this module's package
                parts = (_PKG + "." + mod).split(".")
                parts = parts[: len(parts) - node.level]
                base = ".".join(parts + ([node.module] if node.module else []))
            if not _in_pkg(base):
                return
            for alias in node.names:
                local = alias.asname or alias.name
                mi.symbol_imports[local] = (base, alias.name)
                # `from pkg import mod` -- also usable as a module alias
                mi.imports.setdefault(local, base + "." + alias.name)

    for node in ast.walk(tree):
        record_import(node)

    def lock_ident_module(var: str) -> str:
        return f"{mod}:{var}"

    # module-level statements
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and isinstance(node.value, ast.Call):
                ctor = _is_lock_ctor(node.value)
                if ctor:
                    ident = lock_ident_module(tgt.id)
                    mi.locks[tgt.id] = ident
                    mi.lock_sites[node.value.lineno] = ident
                else:
                    cn = _call_name(node.value)
                    if cn and cn[:1].isupper():
                        mi.global_types[tgt.id] = cn
                    elif cn:
                        mi.opaque_globals.add(tgt.id)
                    if cn in ("dict", "list", "set", "deque", "defaultdict",
                              "OrderedDict", "Counter"):
                        mi.mutable_globals.add(tgt.id)
            elif isinstance(tgt, ast.Name) and isinstance(
                    node.value, (ast.Dict, ast.List, ast.Set)):
                mi.mutable_globals.add(tgt.id)

    # classes
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        ci = _ClassInfo(name=node.name, line=node.lineno)
        mi.classes[node.name] = ci
        for item in node.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(item):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Attribute)
                        and isinstance(sub.targets[0].value, ast.Name)
                        and sub.targets[0].value.id == "self"
                        and isinstance(sub.value, ast.Call)):
                    attr = sub.targets[0].attr
                    ctor = _is_lock_ctor(sub.value)
                    if ctor:
                        ident = f"{mod}:{node.name}.{attr}"
                        ci.lock_attrs[attr] = ident
                        mi.lock_sites[sub.value.lineno] = ident
                    else:
                        cn = _call_name(sub.value)
                        if cn and cn[:1].isupper():
                            ci.attr_types[attr] = cn
                elif (isinstance(sub, ast.AnnAssign)
                        and isinstance(sub.target, ast.Attribute)
                        and isinstance(sub.target.value, ast.Name)
                        and sub.target.value.id == "self"):
                    tcls = _annotation_class(sub.annotation)
                    if tcls:
                        ci.attr_types[sub.target.attr] = tcls

    # anonymous / dict-valued lock allocations anywhere else in the module
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            ctor = _is_lock_ctor(node)
            if ctor and node.lineno not in mi.lock_sites:
                ident = f"{mod}:L{node.lineno}"
                mi.lock_sites[node.lineno] = ident

    # signal handlers + atexit roots
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            recv = _recv_name(node)
            if name == "signal" and (recv == "signal" or recv.endswith("signal")):
                if len(node.args) >= 2:
                    h = node.args[1]
                    tok = h.id if isinstance(h, ast.Name) else (
                        h.attr if isinstance(h, ast.Attribute) else "")
                    if tok:
                        mi.signal_handlers.append((tok, node.lineno))
            elif name == "register" and recv == "atexit" and node.args:
                h = node.args[0]
                tok = h.id if isinstance(h, ast.Name) else (
                    h.attr if isinstance(h, ast.Attribute) else "")
                if tok:
                    mi.atexit_roots.append(tok)


# --------------------------------------------------------------------------
# pass B: per-function walker
# --------------------------------------------------------------------------


class _FuncWalker(ast.NodeVisitor):
    """Track held locks through a single function body."""

    def __init__(self, mi: _ModuleInfo, fi: _FuncInfo, ci: Optional[_ClassInfo],
                 local_imports: Dict[str, str],
                 local_symbols: Dict[str, Tuple[str, str]]) -> None:
        self.mi = mi
        self.fi = fi
        self.ci = ci
        self.local_imports = local_imports
        self.local_symbols = local_symbols
        self.with_stack: List[str] = []
        self.sticky: List[str] = []
        self.local_types: Dict[str, str] = fi.local_types
        # local names bound to locks (e.g. `lk = self._lock`)
        self.local_locks: Dict[str, str] = {}

    # -- lock expression resolution ------------------------------------

    def _resolve_lock_expr(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            if node.id in self.local_locks:
                return self.local_locks[node.id]
            if node.id in self.mi.locks:
                return self.mi.locks[node.id]
            if _lockish_name(node.id):
                return f"{self.fi.module}:~{node.id}"
            return None
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self" and self.ci:
                if node.attr in self.ci.lock_attrs:
                    return self.ci.lock_attrs[node.attr]
                if _lockish_name(node.attr):
                    return f"{self.fi.module}:{self.ci.name}.{node.attr}"
                return None
            if isinstance(base, ast.Name):
                # module alias: other_mod._lock — but only lock-ish attrs;
                # `with mod.scoped_thing():` is a contextmanager, not an
                # acquisition
                target_mod = self.local_imports.get(base.id) or self.mi.imports.get(base.id)
                if target_mod:
                    if _lockish_name(node.attr):
                        return f"{_strip_pkg(target_mod)}:{node.attr}"
                    return None
                if _lockish_name(node.attr):
                    return f"{self.fi.module}:~{base.id}.{node.attr}"
            if isinstance(base, ast.Subscript) and _lockish_name(
                    getattr(node, "attr", "")):
                return f"{self.fi.module}:~subscript.{node.attr}"
            return None
        if isinstance(node, ast.Subscript):
            # state["lock"] style
            if isinstance(node.slice, ast.Constant) and isinstance(
                    node.slice.value, str) and _lockish_name(node.slice.value):
                return f"{self.fi.module}:~[{node.slice.value}]"
        return None

    def _held(self) -> FrozenSet[str]:
        return frozenset(self.with_stack + self.sticky)

    def _note_acquire(self, ident: str, line: int, bounded: bool) -> None:
        for h in self._held():
            if h != ident:
                self.fi.order_edges.append((h, ident, line))
        self.fi.acquires.append((ident, line, bounded))

    # -- nested defs ---------------------------------------------------
    # A nested def's body does NOT run where it is defined — it runs when
    # the closure is called, usually on another thread (Thread targets)
    # or after the enclosing locks are released (deferred emissions).
    # _pass_b analyzes each nested def as its own _FuncInfo; attributing
    # its calls/acquires to the parent would fabricate held-lock chains.

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    # -- with ----------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            ctx = item.context_expr
            target = ctx
            if isinstance(ctx, ast.Call):
                # `with lock.acquire_timeout(...)` etc -- treat receiver
                target = ctx.func if not isinstance(ctx.func, ast.Attribute) else ctx.func.value
                if isinstance(ctx.func, ast.Attribute) and ctx.func.attr in (
                        "acquire", "acquire_timeout"):
                    target = ctx.func.value
                else:
                    target = ctx
            ident = self._resolve_lock_expr(target if not isinstance(target, ast.Call) else target.func if isinstance(target, ast.Call) else target)
            if ident is None and not isinstance(ctx, ast.Call):
                ident = self._resolve_lock_expr(ctx)
            if ident:
                self._note_acquire(ident, node.lineno, bounded=False)
                self.with_stack.append(ident)
                pushed += 1
            if item.optional_vars is not None and isinstance(
                    item.optional_vars, ast.Name) and ident:
                self.local_locks[item.optional_vars.id] = ident
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.with_stack.pop()

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    # -- assignments ---------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1:
            tgt = node.targets[0]
            val = node.value
            if isinstance(tgt, ast.Name):
                ident = self._resolve_lock_expr(val) if isinstance(
                    val, (ast.Name, ast.Attribute)) else None
                if ident:
                    self.local_locks[tgt.id] = ident
                elif isinstance(val, ast.Call):
                    cn = _call_name(val)
                    if cn and cn[:1].isupper():
                        self.local_types[tgt.id] = cn
            if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self.fi.fields.append((tgt.attr, node.lineno, True, self._held()))
            elif isinstance(tgt, ast.Name) and tgt.id in self.mi.mutable_globals:
                self.fi.globals_acc.append((tgt.id, node.lineno, True, self._held()))
            elif isinstance(tgt, ast.Subscript):
                base = tgt.value
                if (isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"):
                    self.fi.fields.append((base.attr, node.lineno, True, self._held()))
                elif isinstance(base, ast.Name) and base.id in self.mi.mutable_globals:
                    self.fi.globals_acc.append((base.id, node.lineno, True, self._held()))
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            tcls = _annotation_class(node.annotation)
            if tcls:
                self.local_types[node.target.id] = tcls
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            self.fi.fields.append((tgt.attr, node.lineno, True, self._held()))
        elif isinstance(tgt, ast.Name) and tgt.id in self.mi.mutable_globals:
            self.fi.globals_acc.append((tgt.id, node.lineno, True, self._held()))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)):
            self.fi.fields.append((node.attr, node.lineno, False, self._held()))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if (isinstance(node.ctx, ast.Load)
                and node.id in self.mi.mutable_globals):
            self.fi.globals_acc.append((node.id, node.lineno, False, self._held()))

    def visit_Global(self, node: ast.Global) -> None:
        pass

    # -- function-local imports ----------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if _in_pkg(alias.name):
                local = alias.asname or alias.name.split(".")[-1]
                self.local_imports[local] = alias.name
                # call resolution runs after all walks; make the alias
                # visible module-wide (distinctive local names in practice)
                self.mi.imports.setdefault(local, alias.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            anchor = (_PKG + "." + self.fi.module).split(".")
            anchor = anchor[: len(anchor) - node.level]
            base = ".".join(anchor + ([node.module] if node.module else []))
        if _in_pkg(base):
            for alias in node.names:
                local = alias.asname or alias.name
                self.local_symbols[local] = (base, alias.name)
                # `from x import mod` where mod is a submodule
                self.local_imports.setdefault(local, base + "." + alias.name)
                self.mi.imports.setdefault(local, base + "." + alias.name)
                self.mi.symbol_imports.setdefault(local, (base, alias.name))

    # -- calls ---------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        recv = _recv_name(node)
        held = self._held()
        line = node.lineno

        # lock protocol calls
        if name == "acquire":
            ident = self._resolve_lock_expr(node.func.value) if isinstance(
                node.func, ast.Attribute) else None
            if ident:
                bounded = _has_timeout_arg(node)
                self._note_acquire(ident, line, bounded)
                # held is held regardless of boundedness; the bounded flag
                # only matters for HVR204 (handler deadlock) analysis
                self.sticky.append(ident)
            self.generic_visit(node)
            return
        if name == "release":
            ident = self._resolve_lock_expr(node.func.value) if isinstance(
                node.func, ast.Attribute) else None
            if ident and ident in self.sticky:
                self.sticky.remove(ident)
            self.generic_visit(node)
            return

        # Thread creation
        if name == "Thread":
            target = ""
            for kw in node.keywords:
                if kw.arg == "target":
                    v = kw.value
                    target = v.id if isinstance(v, ast.Name) else (
                        v.attr if isinstance(v, ast.Attribute) else "")
            self.fi.thread_creates.append((line, target))

        # stop evidence
        if name in _STOP_EVIDENCE_CALLS and isinstance(node.func, ast.Attribute):
            if name == "set":
                low = recv.lower()
                if any(h in low for h in _WAIT_RECV_HINT):
                    self.fi.has_stop_evidence = True
            else:
                self.fi.has_stop_evidence = True

        # blocking classification
        kind = self._blocking_kind(name, recv, node)
        if kind:
            self.fi.blocking.append((kind, name, line, held))

        # record call site for propagation
        if name:
            self.fi.calls.append((name, recv, line, held))
        self.generic_visit(node)

    def _blocking_kind(self, name: str, recv: str, node: ast.Call) -> Optional[str]:
        low_recv = recv.lower()
        if name in _BLOCKING_RPC:
            return "rpc"
        if name in _BLOCKING_SUBPROC and (recv in ("subprocess", "sp") or name == "Popen"):
            return "subprocess"
        if name in _BLOCKING_SOCKET and ("sock" in low_recv or "conn" in low_recv
                                         or recv == "s"):
            return "socket"
        if name in _BLOCKING_COLLECTIVE:
            return "collective"
        if name == "sleep":
            return "sleep"
        if name == "dump" and ("trace" in low_recv or "flight" in low_recv
                               or "recorder" in low_recv or "json" not in low_recv
                               and "pickle" not in low_recv and recv != ""):
            # json.dump/pickle.dump to an open file is fast; trace/flight dump
            # does real I/O + snapshotting.
            if "json" in low_recv or "pickle" in low_recv or "yaml" in low_recv:
                return None
            return "dump"
        if name == "join" and any(h in low_recv for h in _JOIN_RECV_HINT):
            if not _has_timeout_arg(node):
                return "join"
        if name == "wait" and not _has_timeout_arg(node):
            if any(h in low_recv for h in _WAIT_RECV_HINT) or self._resolve_lock_expr(
                    node.func.value if isinstance(node.func, ast.Attribute) else node):
                return "wait"
        if name in ("get", "put") and any(h == low_recv or low_recv.endswith("." + h)
                                          for h in _QUEUE_RECV_HINT):
            if not _has_timeout_arg(node):
                return "queue"
        return None


def _strip_pkg(dotted: str) -> str:
    prefix = _PKG + "."
    return dotted[len(prefix):] if dotted.startswith(prefix) else dotted


def _note_param_types(fn: ast.AST, fi: _FuncInfo) -> None:
    """Annotated parameters are typed locals (``st: "_State"``)."""
    a = fn.args
    for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
        tcls = _annotation_class(arg.annotation)
        if tcls:
            fi.local_types[arg.arg] = tcls


def _pass_b(mi: _ModuleInfo) -> None:
    assert mi.tree is not None
    mod = mi.modname

    def walk_func(fn: ast.AST, cls: Optional[_ClassInfo]) -> None:
        assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        qual = f"{mod}:{cls.name + '.' if cls else ''}{fn.name}"
        fi = _FuncInfo(qual=qual, module=mod, cls=cls.name if cls else None,
                       name=fn.name, line=fn.lineno)
        mi.funcs[qual] = fi
        if cls:
            cls.methods[fn.name] = fi
        _note_param_types(fn, fi)
        walker = _FuncWalker(mi, fi, cls, dict(), dict())
        for stmt in fn.body:
            walker.visit(stmt)
        # nested defs: analyze as separate anonymous-ish functions under the
        # same qual namespace so thread targets like closures get coverage.
        for stmt in ast.walk(fn):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt is not fn:
                nested_qual = f"{mod}:{cls.name + '.' if cls else ''}{fn.name}.{stmt.name}"
                if nested_qual in mi.funcs:
                    continue
                nfi = _FuncInfo(qual=nested_qual, module=mod,
                                cls=cls.name if cls else None,
                                name=stmt.name, line=stmt.lineno)
                mi.funcs[nested_qual] = nfi
                _note_param_types(stmt, nfi)
                nwalker = _FuncWalker(mi, nfi, cls, dict(walker.local_imports),
                                      dict(walker.local_symbols))
                for s in stmt.body:
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    nwalker.visit(s)

    for node in mi.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_func(node, None)
        elif isinstance(node, ast.ClassDef):
            ci = mi.classes.get(node.name)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk_func(item, ci)


# --------------------------------------------------------------------------
# call resolution + hold propagation
# --------------------------------------------------------------------------


def _resolve_call(report: Report, mi: _ModuleInfo, fi: _FuncInfo,
                  name: str, recv: str) -> List[str]:
    """Return candidate callee quals for a call site."""
    out: List[str] = []
    mod = mi.modname

    if not recv:
        # bare call: same module function, from-imported symbol, or class ctor
        q = f"{mod}:{name}"
        if q in report.funcs:
            out.append(q)
        sym = mi.symbol_imports.get(name)
        if sym:
            target_mod = _strip_pkg(sym[0])
            q2 = f"{target_mod}:{sym[1]}"
            if q2 in report.funcs:
                out.append(q2)
            # from-imported class: route to its __init__
            q3 = f"{target_mod}:{sym[1]}.__init__"
            if q3 in report.funcs:
                out.append(q3)
            if not out:
                out.extend(_follow_reexport(report, target_mod, sym[1]))
        if name in mi.classes:
            q4 = f"{mod}:{name}.__init__"
            if q4 in report.funcs:
                out.append(q4)
        return out

    if recv == "()":
        # method on a call result (e.g. FAMILY.labels(...).inc()): the
        # result type is unknown — resolve generously to same-named
        # methods of classes in this module and its direct imports.
        return _generous(report, mi, name)

    head = recv.split(".")[0]

    if head == "self" and fi.cls:
        ci = mi.classes.get(fi.cls)
        if recv == "self":
            q = f"{mod}:{fi.cls}.{name}"
            if q in report.funcs:
                out.append(q)
            return out
        # self.attr.method() via attr type inference
        if ci and "." in recv:
            attr = recv.split(".")[1]
            tcls = ci.attr_types.get(attr)
            if tcls:
                out.extend(_methods_named(report, tcls, name))
        return out

    # module alias call: mod_alias.func()
    target = mi.imports.get(head)
    if target:
        tmod = _strip_pkg(target)
        if "." in recv:
            # alias.sub.attr unsupported beyond one hop, but for a global
            # of the target module: alias.GLOBAL.method()
            parts = recv.split(".")
            tmi = report.modules.get(tmod)
            if tmi is not None and len(parts) == 2:
                if parts[1] in tmi.opaque_globals:
                    out.extend(_generous(report, tmi, name))
                elif parts[1] in tmi.global_types:
                    out.extend(_methods_named(
                        report, tmi.global_types[parts[1]], name))
        q = f"{tmod}:{name}"
        if q in report.funcs:
            out.append(q)
        # alias.Class() ctor
        q2 = f"{tmod}:{name}.__init__"
        if q2 in report.funcs:
            out.append(q2)
        if not out:
            # package __init__ re-export: alias.func defined elsewhere
            out.extend(_follow_reexport(report, tmod, name))
        return out

    # local/global variable of known class type
    tcls = mi.global_types.get(head)
    if tcls:
        out.extend(_methods_named(report, tcls, name))
        return out

    # a typed local (constructor call or annotation): x.m(), x.attr.m()
    tcls = fi.local_types.get(head)
    if tcls:
        parts = recv.split(".")
        if len(parts) == 1:
            out.extend(_methods_named(report, tcls, name))
        elif len(parts) == 2:
            for cmi in report.modules.values():
                ci = cmi.classes.get(tcls)
                attr_t = ci.attr_types.get(parts[1]) if ci else None
                if attr_t:
                    out.extend(_methods_named(report, attr_t, name))
        return out

    # a module global of unknown type: resolved as a call result is
    if head in mi.opaque_globals and recv == head:
        return _generous(report, mi, name)

    return out


def _generous(report: Report, mi: _ModuleInfo, name: str) -> List[str]:
    """Same-named methods of the classes in ``mi`` and its direct imports:
    the candidates for a method of an object whose type is unknown."""
    out: List[str] = []
    mods = {mi.modname}
    mods.update(_strip_pkg(v) for v in mi.imports.values())
    mods.update(_strip_pkg(s[0]) for s in mi.symbol_imports.values())
    for tm in sorted(mods):
        tmi = report.modules.get(tm)
        if tmi is None:
            continue
        for cls in tmi.classes:
            q = f"{tm}:{cls}.{name}"
            if q in report.funcs:
                out.append(q)
    return out


def _follow_reexport(report: Report, tmod: str, name: str) -> List[str]:
    """One extra hop through a module's own `from X import name`:
    resolves `pkg/__init__.py` re-exports to the defining module."""
    out: List[str] = []
    tmi = report.modules.get(tmod)
    sym = tmi.symbol_imports.get(name) if tmi else None
    if sym:
        smod = _strip_pkg(sym[0])
        for cand in (f"{smod}:{sym[1]}", f"{smod}:{sym[1]}.__init__"):
            if cand in report.funcs:
                out.append(cand)
    return out


def _methods_named(report: Report, cls_token: str, method: str) -> List[str]:
    out = []
    for mi in report.modules.values():
        if cls_token in mi.classes:
            q = f"{mi.modname}:{cls_token}.{method}"
            if q in report.funcs:
                out.append(q)
    return out


def _propagate_holds(report: Report) -> None:
    """Fixed-point: push held-lock sets across resolvable call edges."""
    # Pre-resolve call edges once.
    call_edges: List[Tuple[_FuncInfo, FrozenSet[str], int, _FuncInfo]] = []
    for mi in report.modules.values():
        for fi in mi.funcs.values():
            for name, recv, line, held in fi.calls:
                for callee_q in _resolve_call(report, mi, fi, name, recv):
                    callee = report.funcs.get(callee_q)
                    if callee is not None and callee is not fi:
                        call_edges.append((fi, held, line, callee))

    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for caller, held_at_site, line, callee in call_edges:
            # effective holds at the call site = local holds + caller entry holds
            eff: Dict[str, Tuple[str, ...]] = {}
            for h in held_at_site:
                eff[h] = (f"{caller.qual}@{line}",)
            for h, chain in caller.entry_holds.items():
                if h not in eff:
                    eff[h] = chain + (f"{caller.qual}@{line}",)
            for h, chain in eff.items():
                if h not in callee.entry_holds:
                    if len(chain) <= 12:
                        callee.entry_holds[h] = chain
                        changed = True


def _build_order_graph(report: Report) -> None:
    for mi in report.modules.values():
        for fi in mi.funcs.values():
            entry = set(fi.entry_holds)
            for a, b, line in fi.order_edges:
                _add_edge(report, a, b, mi.rel, line, fi.qual)
            for ident, line, bounded in fi.acquires:
                for h in entry:
                    if h != ident:
                        _add_edge(report, h, ident, mi.rel, line, fi.qual)


def _add_edge(report: Report, a: str, b: str, rel: str, line: int,
              qual: str) -> None:
    if a == b:
        return
    key = (a, b)
    if key not in report.edges:
        report.edges.add(key)
        report.edge_witness[key] = (rel, line, qual)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


def _real_lock(ident: str) -> bool:
    """Pseudo idents (`mod:~x`) come from unresolvable lock-ish names."""
    return ":~" not in ident


def _rule_hvr201(report: Report) -> List[RaceFinding]:
    findings = []
    edges = {e for e in report.edges if _real_lock(e[0]) and _real_lock(e[1])}
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    seen_pairs: Set[FrozenSet[str]] = set()
    for a, b in sorted(edges):
        if (b, a) in edges:
            pair = frozenset((a, b))
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
            w1 = report.edge_witness[(a, b)]
            w2 = report.edge_witness[(b, a)]
            findings.append(RaceFinding(
                "HVR201", w1[0], w1[1],
                f"lock-order inversion: {a} -> {b} in {w1[2]} here, but "
                f"{b} -> {a} in {w2[2]} at {w2[0]}:{w2[1]}; one consistent "
                f"order is required"))
    # longer cycles via DFS (rare; bounded)
    return findings


def _rule_hvr202(report: Report) -> List[RaceFinding]:
    findings = []
    for mi in report.modules.values():
        for fi in mi.funcs.values():
            entry = {h: c for h, c in fi.entry_holds.items() if _real_lock(h)}
            for kind, name, line, held in fi.blocking:
                local = {h for h in held if _real_lock(h)}
                if local:
                    locks = ", ".join(sorted(local))
                    findings.append(RaceFinding(
                        "HVR202", mi.rel, line,
                        f"blocking {kind} call '{name}()' while holding "
                        f"{locks}; move it outside the critical section"))
                elif entry and not held:
                    # blame the chain root: the function that acquired the lock
                    h, chain = sorted(entry.items())[0]
                    root = chain[0]
                    root_qual, _, root_line = root.partition("@")
                    root_fi = report.funcs.get(root_qual)
                    root_rel = mi.rel
                    for m2 in report.modules.values():
                        if root_fi and root_fi.module == m2.modname:
                            root_rel = m2.rel
                            break
                    findings.append(RaceFinding(
                        "HVR202", root_rel, int(root_line or 0),
                        f"call chain reaches blocking {kind} call '{name}()' "
                        f"({mi.rel}:{line}) while {h} is held "
                        f"(via {' -> '.join(c.split('@')[0] for c in chain)})"))
    return findings


def _rule_hvr203(report: Report) -> List[RaceFinding]:
    findings = []
    skip_methods = {"__init__", "__new__", "__repr__", "__str__", "__del__",
                    "__enter__", "__exit__"}
    for mi in report.modules.values():
        for cname, ci in mi.classes.items():
            own_locks = set(ci.lock_attrs.values())
            if not own_locks:
                continue
            # field -> [(line, write, locked)]
            acc: Dict[str, List[Tuple[int, bool, bool]]] = {}
            for mname, fi in ci.methods.items():
                if mname in skip_methods:
                    continue
                entry = set(fi.entry_holds)
                for attr, line, write, held in fi.fields:
                    if attr in ci.lock_attrs:
                        continue
                    locked = bool((set(held) | entry) & own_locks)
                    acc.setdefault(attr, []).append((line, write, locked))
            for attr, uses in acc.items():
                locked_write = any(w and l for _, w, l in uses)
                locked_any = any(l for _, _, l in uses)
                unlocked_write = any(w and not l for _, w, l in uses)
                unlocked_any = any(not l for _, _, l in uses)
                if (locked_write and unlocked_any) or (locked_any and unlocked_write):
                    anchor = min(line for line, _, l in uses if not l)
                    lock_names = ", ".join(sorted(own_locks))
                    findings.append(RaceFinding(
                        "HVR203", mi.rel, anchor,
                        f"field '{cname}.{attr}' is guarded by {lock_names} in "
                        f"some methods but accessed without it here"))
        # module-global mutable containers vs module locks
        mod_locks = set(mi.locks.values())
        if mod_locks:
            gacc: Dict[str, List[Tuple[int, bool, bool]]] = {}
            for fi in mi.funcs.values():
                entry = set(fi.entry_holds)
                for gname, line, write, held in fi.globals_acc:
                    locked = bool((set(held) | entry) & mod_locks)
                    gacc.setdefault(gname, []).append((line, write, locked))
            for gname, uses in gacc.items():
                locked_write = any(w and l for _, w, l in uses)
                locked_any = any(l for _, _, l in uses)
                unlocked_write = any(w and not l for _, w, l in uses)
                unlocked_any = any(not l for _, _, l in uses)
                if (locked_write and unlocked_any) or (locked_any and unlocked_write):
                    anchor = min(line for line, _, l in uses if not l)
                    findings.append(RaceFinding(
                        "HVR203", mi.rel, anchor,
                        f"module global '{gname}' is mutated under "
                        f"{', '.join(sorted(mod_locks))} elsewhere but accessed "
                        f"without it here"))
    return findings


def _rule_hvr204(report: Report) -> List[RaceFinding]:
    findings = []
    # BFS from each signal handler through resolvable calls looking for an
    # unbounded acquire of a real lock.
    for mi in report.modules.values():
        for tok, reg_line in mi.signal_handlers:
            roots = _toks_to_funcs(report, mi, tok)
            seen: Set[str] = set()
            frontier = [(fi, [fi.qual]) for fi in roots]
            while frontier:
                fi, path = frontier.pop()
                if fi.qual in seen or len(path) > 10:
                    continue
                seen.add(fi.qual)
                fmi = report.modules.get(fi.module)
                if fmi is None:
                    continue
                for ident, line, bounded in fi.acquires:
                    if not bounded and _real_lock(ident):
                        findings.append(RaceFinding(
                            "HVR204", mi.rel, reg_line,
                            f"signal handler '{tok}' reaches unbounded acquire "
                            f"of {ident} at {fmi.rel}:{line} "
                            f"(via {' -> '.join(path)}); use "
                            f"acquire(timeout=...) on every handler path"))
                        break
                else:
                    for name, recv, line, held in fi.calls:
                        for q in _resolve_call(report, fmi, fi, name, recv):
                            callee = report.funcs.get(q)
                            if callee and callee.qual not in seen:
                                frontier.append((callee, path + [callee.qual]))
    return findings


def _toks_to_funcs(report: Report, mi: _ModuleInfo, tok: str) -> List[_FuncInfo]:
    out = []
    q = f"{mi.modname}:{tok}"
    if q in report.funcs:
        out.append(report.funcs[q])
    else:
        for fq, fi in report.funcs.items():
            if fi.module == mi.modname and fi.name == tok:
                out.append(fi)
    return out


def _rule_hvr205(report: Report) -> List[RaceFinding]:
    findings = []
    # 1. compute the shutdown-reachable closure by terminal call name,
    #    starting from basics.shutdown + all atexit roots.
    reachable_names: Set[str] = set()
    frontier: List[_FuncInfo] = []
    for mi in report.modules.values():
        for tok in mi.atexit_roots:
            frontier.extend(_toks_to_funcs(report, mi, tok))
        q = f"{mi.modname}:shutdown"
        if mi.modname.endswith("basics") and q in report.funcs:
            frontier.append(report.funcs[q])
    seen_q: Set[str] = set()
    while frontier:
        fi = frontier.pop()
        if fi.qual in seen_q:
            continue
        seen_q.add(fi.qual)
        for name, recv, line, held in fi.calls:
            if name in reachable_names:
                continue
            reachable_names.add(name)
            # generous closure: any package function with this terminal name
            for fq, cand in report.funcs.items():
                if cand.name == name and cand.qual not in seen_q:
                    frontier.append(cand)

    # 2. every Thread created in an init/arm path must have stop evidence in
    #    its owner scope reachable from shutdown.
    for mi in report.modules.values():
        for fi in mi.funcs.values():
            if not fi.thread_creates:
                continue
            if not any(p in fi.name.lower() for p in _INIT_PATH_NAMES):
                continue
            # owner scope: the class's methods, or the module's functions
            if fi.cls:
                ci = mi.classes.get(fi.cls)
                owner_funcs = list(ci.methods.values()) if ci else []
            else:
                owner_funcs = [f for f in mi.funcs.values() if f.cls is None]
            stoppers = [f for f in owner_funcs if f.has_stop_evidence]
            ok = any(
                f.name in reachable_names or f.qual in seen_q for f in stoppers)
            if not ok:
                for line, target in fi.thread_creates:
                    findings.append(RaceFinding(
                        "HVR205", mi.rel, line,
                        f"Thread created in '{fi.name}' has no stop/join "
                        f"reachable from basics.shutdown; register a stop "
                        f"path or join it on the shutdown path"))
    return findings


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


def _rel_to_modname(rel: str) -> str:
    p = rel
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    parts = p.split("/")
    if parts and parts[0] == _PKG:
        parts = parts[1:]
    return ".".join(parts) if parts else "__root__"


def analyze_sources(sources: Dict[str, str],
                    rules: Optional[FrozenSet[str]] = None) -> Report:
    """Analyze a mapping of repo-relative path -> source text."""
    t0 = time.monotonic()
    rules = rules or ALL_RULES
    report = Report()
    bare: List[RaceFinding] = []

    for rel, source in sorted(sources.items()):
        lines = source.splitlines()
        head = "\n".join(lines[:2])
        if _SKIP_FILE_RE.search(head):
            continue
        report.n_files += 1
        mi = _ModuleInfo(rel=rel, modname=_rel_to_modname(rel), tree=None,
                         source_lines=lines)
        try:
            mi.tree = ast.parse(source)
        except SyntaxError as exc:
            report.findings.append(RaceFinding(
                "HVR999", rel, exc.lineno or 1, f"syntax error: {exc.msg}"))
            continue
        bare.extend(_collect_suppressions(lines, mi))
        _index_def_lines(mi)
        _pass_a(mi)
        report.modules[mi.modname] = mi

    for mi in report.modules.values():
        _pass_b(mi)
        for ident in mi.locks.values():
            report.lock_idents.add(ident)
        for ci in mi.classes.values():
            report.lock_idents.update(ci.lock_attrs.values())
        for line, ident in mi.lock_sites.items():
            report.lock_table[(mi.rel, line)] = ident
            report.lock_idents.add(ident)
        report.funcs.update(mi.funcs)

    _propagate_holds(report)
    _build_order_graph(report)

    raw: List[RaceFinding] = []
    if "HVR201" in rules:
        raw.extend(_rule_hvr201(report))
    if "HVR202" in rules:
        raw.extend(_rule_hvr202(report))
    if "HVR203" in rules:
        raw.extend(_rule_hvr203(report))
    if "HVR204" in rules:
        raw.extend(_rule_hvr204(report))
    if "HVR205" in rules:
        raw.extend(_rule_hvr205(report))

    # apply suppressions + dedupe
    by_mod = {mi.rel: mi for mi in report.modules.values()}
    seen: Set[Tuple[str, str, int, str]] = set()
    for f in raw:
        mi = by_mod.get(f.path)
        if mi is not None and _suppressed(mi, f.code, f.line):
            continue
        key = (f.code, f.path, f.line, f.message)
        if key in seen:
            continue
        seen.add(key)
        report.findings.append(f)

    report.findings.extend(bare)
    report.findings.sort(key=lambda f: (f.path, f.line, f.code))
    report.seconds = time.monotonic() - t0
    return report


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        out.append(os.path.join(root, fn))
    return out


def analyze_paths(paths: Sequence[str],
                  rules: Optional[FrozenSet[str]] = None,
                  base: Optional[str] = None) -> Report:
    base = base or os.getcwd()
    sources: Dict[str, str] = {}
    for fp in iter_py_files(paths):
        rel = os.path.relpath(fp, base)
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                sources[rel] = fh.read()
        except OSError:
            continue
    return analyze_sources(sources, rules=rules)


# --------------------------------------------------------------------------
# runtime witness
# --------------------------------------------------------------------------

_witness_installed = False
_witness_edges: Dict[Tuple[str, str], int] = {}
_witness_locks: Dict[int, str] = {}          # id(proxy) -> ident
_witness_guard = threading.Lock()            # real lock, captured pre-swap
_witness_tls = threading.local()
_orig_lock = None
_orig_rlock = None
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _WitnessProxy:
    """Wraps a real lock; records per-thread acquisition edges."""

    __slots__ = ("_inner", "_ident")

    def __init__(self, inner, ident: str) -> None:
        self._inner = inner
        self._ident = ident

    def _record(self) -> None:
        stack = getattr(_witness_tls, "stack", None)
        if stack is None:
            stack = _witness_tls.stack = []
        with _witness_guard:
            for held in stack:
                if held != self._ident:
                    key = (held, self._ident)
                    _witness_edges[key] = _witness_edges.get(key, 0) + 1
        stack.append(self._ident)

    def _unrecord(self) -> None:
        stack = getattr(_witness_tls, "stack", None)
        if stack and self._ident in stack:
            # remove last occurrence (RLock re-entry safe)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self._ident:
                    del stack[i]
                    break

    def acquire(self, *args, **kwargs):
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            self._record()
        return ok

    def release(self):
        self._inner.release()
        self._unrecord()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") else False

    # Condition() interop if someone wraps us
    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):     # RLock
            return self._inner._is_owned()
        # plain Lock: the stdlib Condition fallback (acquire(0) probe)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<WitnessProxy {self._ident} {self._inner!r}>"


def _site_ident() -> str:
    """Allocation-site ident for factory-created locks: '<rel>.py:<line>'."""
    f = sys._getframe(2)
    rel = os.path.relpath(f.f_code.co_filename, os.path.dirname(_PKG_DIR))
    return f"{rel}:{f.f_lineno}"


def _caller_in_package() -> bool:
    f = sys._getframe(2)
    try:
        return os.path.abspath(f.f_code.co_filename).startswith(_PKG_DIR + os.sep)
    except Exception:
        return False


def install_witness() -> None:
    """Swap threading.Lock/RLock for witness factories and wrap existing
    package module-global locks in proxies."""
    global _witness_installed, _orig_lock, _orig_rlock
    if _witness_installed:
        return
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock

    def lock_factory(*a, **kw):
        inner = _orig_lock(*a, **kw)
        if _caller_in_package():
            proxy = _WitnessProxy(inner, _site_ident())
            _witness_locks[id(proxy)] = proxy._ident
            return proxy
        return inner

    def rlock_factory(*a, **kw):
        inner = _orig_rlock(*a, **kw)
        if _caller_in_package():
            proxy = _WitnessProxy(inner, _site_ident())
            _witness_locks[id(proxy)] = proxy._ident
            return proxy
        return inner

    threading.Lock = lock_factory          # type: ignore[assignment]
    threading.RLock = rlock_factory        # type: ignore[assignment]

    # sweep already-imported package modules for module-global locks
    lock_types = (type(_orig_lock()), type(_orig_rlock()))
    for modname, mod in list(sys.modules.items()):
        if not _in_pkg(modname) or mod is None:
            continue
        if modname == _PKG + ".analysis" \
                or modname.startswith(_PKG + ".analysis."):
            # never wrap the analyzer's own guard (_witness_guard must
            # stay a real lock or _record would re-enter itself)
            continue
        short = _strip_pkg(modname)
        for attr in list(vars(mod)):
            obj = getattr(mod, attr, None)
            if isinstance(obj, lock_types):
                ident = f"{short}:{attr}"
                proxy = _WitnessProxy(obj, ident)
                _witness_locks[id(proxy)] = ident
                setattr(mod, attr, proxy)
    _witness_installed = True


def uninstall_witness() -> None:
    """Restore threading factories.  Swapped module globals keep their
    proxies (they still delegate to the original lock, so behaviour is
    unchanged); edges stop accumulating once factories are restored."""
    global _witness_installed
    if not _witness_installed:
        return
    threading.Lock = _orig_lock            # type: ignore[assignment]
    threading.RLock = _orig_rlock          # type: ignore[assignment]
    _witness_installed = False


def witness_edges() -> Dict[Tuple[str, str], int]:
    with _witness_guard:
        return dict(_witness_edges)


def reset_witness_edges() -> None:
    with _witness_guard:
        _witness_edges.clear()


def dump_witness(path: str) -> None:
    with _witness_guard:
        rows = [{"held": a, "acquired": b, "count": n}
                for (a, b), n in sorted(_witness_edges.items())]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
    os.replace(tmp, path)


def load_witness(path: str) -> Dict[Tuple[str, str], int]:
    out: Dict[Tuple[str, str], int] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            out[(row["held"], row["acquired"])] = int(row.get("count", 1))
    return out


def maybe_install_from_env() -> None:
    """``HVD_LOCK_WITNESS=1``: install the witness; with
    ``HVD_LOCK_WITNESS_FILE`` too, dump its edges there at exit."""
    if os.environ.get("HVD_LOCK_WITNESS", "").strip() in ("1", "true", "on"):
        install_witness()
        path = os.environ.get("HVD_LOCK_WITNESS_FILE", "").strip()
        if path:
            import atexit
            atexit.register(dump_witness, path)


def _canonical(report: Report, ident: str) -> Optional[str]:
    """Map a witness ident to a static lock ident.

    Witness idents are either already canonical (`module:attr` from the
    module-global sweep) or allocation sites (`horovod_tpu_torch/x/y.py:LINE`).
    """
    if ident in report.lock_idents:
        return ident
    if ":" in ident and ident.rsplit(":", 1)[1].isdigit():
        rel, _, line = ident.rpartition(":")
        return report.lock_table.get((rel, int(line)))
    return None


def cross_check(report: Report,
                edges: Dict[Tuple[str, str], int]) -> List[RaceFinding]:
    """Assert every runtime acquisition edge is predicted statically.

    Returns findings (empty list == green).  HVR210 = edge observed at
    runtime but absent from the static may-hold-before graph (an analyzer
    gap).  HVR211 = runtime lock that static analysis never resolved.
    """
    findings: List[RaceFinding] = []
    for (held, acquired), count in sorted(edges.items()):
        ch = _canonical(report, held)
        ca = _canonical(report, acquired)
        if ch is None:
            findings.append(RaceFinding(
                "HVR211", "witness", 0,
                f"runtime lock '{held}' unknown to static analysis"))
            continue
        if ca is None:
            findings.append(RaceFinding(
                "HVR211", "witness", 0,
                f"runtime lock '{acquired}' unknown to static analysis"))
            continue
        if ch == ca:
            continue
        if (ch, ca) not in report.edges:
            findings.append(RaceFinding(
                "HVR210", "witness", 0,
                f"runtime edge {ch} -> {ca} (observed {count}x) not in the "
                f"static may-hold-before graph; the analyzer missed a hold "
                f"propagation path"))
    return findings


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.race",
        description="whole-package lock-graph analyzer (HVR201-HVR205)")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories (default: the "
                             "horovod_tpu_torch package)")
    parser.add_argument("--rules", default=",".join(sorted(ALL_RULES)),
                        help="comma-separated rule ids to run")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--witness", metavar="JSONL",
                        help="cross-check a witness log against the static graph")
    args = parser.parse_args(argv)

    rules = frozenset(r.strip() for r in args.rules.split(",") if r.strip())
    if args.paths:
        report = analyze_paths(args.paths, rules=rules)
    else:
        report = analyze_paths([_PKG_DIR], rules=rules,
                               base=os.path.dirname(_PKG_DIR))

    findings = list(report.findings)
    if args.witness:
        findings.extend(cross_check(report, load_witness(args.witness)))

    if args.format == "json":
        doc = report.to_dict()
        doc["findings"] = [f.to_dict() for f in findings]
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        print(f"hvdrace: {report.n_files} files, {len(report.lock_idents)} locks, "
              f"{len(report.edges)} edges, {len(findings)} findings "
              f"({report.seconds:.2f}s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
