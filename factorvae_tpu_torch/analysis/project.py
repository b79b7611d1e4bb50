"""Whole-program project index: the cross-module half of graftlint
(`factorvae_tpu/analysis/project.py`).

The module-local engine (engine.py) deliberately stops at module
boundaries; this index stitches the boundaries back together for the
analyses that are meaningless without them:

- **Cross-module call graph.** Every module's `ModuleModel` already
  resolves names through its import-alias table; the index uses that to
  link `step(3)` in `a.py` to `def step` in `b.py` when `a` wrote
  `from b import step` (or calls `b.step(...)`). Attribute calls that
  no import resolves (`daemon.handle_batch(...)`, `self.registry.get`)
  fall back to project-wide NAME matching — the same documented
  over-approximation the module-local engine uses, widened to the
  project: an edge too many makes reachability conservative, an edge
  too few makes it blind.

- **Thread-entry reachability.** Entry points are marked where
  concurrency is born: `threading.Thread(target=...)` /
  `ThreadPoolExecutor.submit(fn, ...)` targets, `signal.signal`
  handlers, and `do_*` methods of `http.server` request-handler
  classes. A function is *thread-reachable* when the call graph
  connects it to any such entry — that is the scope set the JGL009-011
  rules (concurrency.py) judge. `__call__` methods are a special case:
  they are invoked through variables the static graph cannot follow,
  so once the project has any thread entry at all they conservatively
  join the thread-reachable set (a callable object runs on
  whatever thread calls it).

- **Main-line reachability.** The dual set: everything reachable
  without crossing a thread entry (seeded from every function that is
  not itself an entry target, plus module-level code). A function can
  be in BOTH sets — `ModelRegistry.get` runs on the HTTP handler
  thread and on the stdin tick loop — and that dual membership is
  exactly what makes its unguarded counters a race.

- **Lock inference.** A class's lock attributes are the `self.X =
  threading.Lock()/RLock()` assignments (module-level locks the same
  way); an attribute written under `with self.X:` is *guarded by* X.
  Lock HELD-ness propagates through the call graph by intersection:
  a method called only from sites that hold the lock (the daemon's
  `_dispatch`/`_respond` under `handle_batch`'s tick lock) inherits
  it; one unlocked call site and the inherited set collapses — a
  conservative fixpoint, so propagation can only excuse a write when
  EVERY path to it holds the lock.

Like the engine, this is stdlib-only `ast` — nothing under analysis is
imported or executed.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from factorvae_tpu_torch.analysis.engine import (
    Finding,
    FuncInfo,
    ModuleModel,
    _terminal_name,
)

#: constructors whose result is a lock for guarded-attribute inference
LOCK_FACTORIES = {"threading.Lock", "threading.RLock"}

#: module-level constructors whose instances are tracked shared globals
GLOBAL_CONTAINER_CALLS = {
    "dict", "list", "set",
    "collections.OrderedDict", "collections.defaultdict",
    "collections.deque", "collections.Counter",
}

#: method names that mutate their receiver (the write half of JGL009's
#: shared-state tracking; reads are matched by attribute name)
MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "appendleft",
    "move_to_end", "write",
}

#: attribute-call names EXCLUDED from the project-wide name-match
#: fallback: they are overwhelmingly container/file methods
#: (`self._cache.clear()`, `fh.flush()`), and linking them to a
#: same-named def somewhere in the project manufactures absurd edges
#: (a dict `.clear()` in the daemon must not make a linter flow-walker
#: class thread-reachable). Same-class `self.clear()` calls still
#: resolve precisely before this fallback is consulted.
NO_NAME_MATCH = MUTATORS | {"flush", "close", "read", "result", "join",
                            "start", "set", "wait", "get_indexer"}

#: base-class name suffix marking stdlib HTTP request handlers — their
#: do_* methods run per request, potentially off the accept thread
HTTP_HANDLER_SUFFIX = "HTTPRequestHandler"

#: HTTP handler methods treated as entries (besides do_*)
HTTP_ENTRY_METHODS = {"log_message", "log_error"}

#: entry kinds in the index (Entry.kind values)
# "thread"   threading.Thread(target=...)
# "executor" <pool>.submit(fn, ...)
# "signal"   signal.signal(SIG, handler)
# "http"     do_*/log_* methods of *HTTPRequestHandler subclasses
# "callable" __call__ methods (conservative, see _mark_callables)


# ---------------------------------------------------------------------------
# data model


@dataclasses.dataclass
class ModuleRec:
    name: str                  # dotted module name ("pkg.sub.mod")
    path: str
    src: str
    tree: ast.Module
    model: ModuleModel


class FnNode:
    """One function (or the pseudo-node for a module's top-level code)
    in the project graph."""

    __slots__ = ("module", "model", "info", "cls", "key", "calls",
                 "writes", "self_reads", "attr_reads", "global_reads",
                 "held")

    def __init__(self, module: str, model: ModuleModel,
                 info: Optional[FuncInfo], cls: Optional[str]):
        self.module = module
        self.model = model
        self.info = info
        self.cls = cls
        qual = info.qualname if info is not None else "<module>"
        self.key = (module, qual)
        self.calls: List["CallSite"] = []
        self.writes: List["Access"] = []
        # precisely-attributable reads: `self.X` loads inside this
        # class's own methods (JGL009's composite-reader check)
        self.self_reads: List["Access"] = []
        self.attr_reads: Set[str] = set()
        self.global_reads: Set[Tuple[str, str]] = set()
        # locks held at EVERY call site of this function (fixpoint)
        self.held: Set[Tuple] = set()

    @property
    def name(self) -> str:
        return self.info.name if self.info is not None else "<module>"

    @property
    def qualname(self) -> str:
        return self.key[1]

    def label(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclasses.dataclass
class CallSite:
    callee: FnNode
    line: int
    held: frozenset            # lock ids held syntactically at the site
    precise: bool              # import/local/self-resolved (not name-match)


@dataclasses.dataclass
class Access:
    """One shared-state WRITE: an augmented assignment, a subscript
    store, a `del x[...]`, or a mutator method call. Plain rebinds
    (`self.x = v`, `G = v`) are CPython-atomic reference swaps and are
    deliberately not collected."""

    target: Tuple               # ("attr", module, cls, name) | ("global", module, name)
    fn: FnNode
    line: int
    kind: str                   # "aug" | "subscript" | "mutcall" | "del" | "read"
    held: frozenset             # effective locks: syntactic at the site


@dataclasses.dataclass
class Entry:
    kind: str                   # "thread" | "executor" | "signal" | "http" | "callable"
    fn: FnNode
    line: int


@dataclasses.dataclass
class ThreadSpawn:
    module: str
    line: int
    targets: List[FnNode]
    target_name: str
    daemon: bool
    handle: Optional[str]       # name or "self.X" the Thread was bound to
    joined: bool = False


# ---------------------------------------------------------------------------
# index


class ProjectIndex:
    def __init__(self, sources: Sequence[Tuple[str, Optional[str], str]]):
        """`sources` is collect_sources() output:
        [(file_path, package_root_or_None, src)]."""
        self.modules: Dict[str, ModuleRec] = {}
        self.errors: List[Finding] = []
        for path, root, src in sources:
            name = self._module_name(path, root)
            try:
                tree = ast.parse(src)
            except SyntaxError as e:
                self.errors.append(Finding(
                    "JGL000", path, e.lineno or 1,
                    f"unparseable file: {e.msg}"))
                continue
            if name in self.modules:
                # Two inputs deriving the same dotted name would
                # silently shadow each other — the engine's contract is
                # that nothing passed to the gate is ever dropped
                # quietly. Fail loudly (JGL000 is unsuppressible) and
                # still analyze the file under a disambiguated key so
                # its module-local findings are not lost; cross-module
                # edges keep resolving to the FIRST claimant.
                self.errors.append(Finding(
                    "JGL000", path, 1,
                    f"module name {name!r} collides with "
                    f"{self.modules[name].path} in this project index — "
                    f"cross-module resolution is ambiguous; pass "
                    f"distinct roots or rename one file"))
                name = f"{name}@{len(self.modules)}"
            self.modules[name] = ModuleRec(
                name, path, src, tree, ModuleModel(path, src, tree))

        self.fns: List[FnNode] = []
        self.fns_by_name: Dict[str, List[FnNode]] = {}
        self._by_module_name: Dict[Tuple[str, str], List[FnNode]] = {}
        self._node_to_fn: Dict[Tuple[str, int], FnNode] = {}
        self.module_nodes: Dict[str, FnNode] = {}
        # lock registries: (module, cls) -> {attr}, module -> {global}
        self.class_locks: Dict[Tuple[str, str], Set[str]] = {}
        self.module_locks: Dict[str, Set[str]] = {}
        # tracked module-level mutable containers: (module, name)
        self.globals: Set[Tuple[str, str]] = set()
        self.entries: List[Entry] = []
        self.thread_spawns: List[ThreadSpawn] = []
        # stdlib HTTP request-handler classes: instances are created
        # per request and die with it, so their attributes are
        # request-confined — JGL009 exempts them
        self.http_handler_classes: Set[Tuple[str, str]] = set()

        for rec in self.modules.values():
            self._collect_structure(rec)
        for rec in self.modules.values():
            self._collect_entries(rec)
        self._mark_callables()
        for rec in self.modules.values():
            self._walk_module(rec)
        self._mark_spawn_joins()
        self._propagate_held()
        self._compute_reachability()

    # ---- naming ----------------------------------------------------------

    @staticmethod
    def _module_name(path: str, root: Optional[str]) -> str:
        """Dotted module name as the code's own imports would spell it
        — anchored at the outermost PACKAGE directory, not at the CLI
        argument. A root that is itself a package (`--project
        factorvae_tpu_torch`) keeps its basename; a plain container root
        (the repo checkout, a fixtures folder) contributes no prefix
        and leading non-package directories are path, not package —
        otherwise `--project .` would name modules `repo.pkg.mod`
        while imports resolve `pkg.mod`, silently degrading every
        cross-module edge to a name match."""
        path = os.path.abspath(path)
        if root is None:
            return os.path.splitext(os.path.basename(path))[0]
        root = os.path.abspath(root)
        rel = os.path.relpath(path, root)
        parts = rel.split(os.sep)
        parts[-1] = os.path.splitext(parts[-1])[0]
        if os.path.exists(os.path.join(root, "__init__.py")):
            parts = [os.path.basename(root)] + parts
        else:
            base = root
            while len(parts) > 1 and not os.path.exists(
                    os.path.join(base, parts[0], "__init__.py")):
                base = os.path.join(base, parts[0])
                parts.pop(0)
        if parts[-1] == "__init__":
            parts.pop()
        return ".".join(p for p in parts if p)

    def records(self) -> List[ModuleRec]:
        return list(self.modules.values())

    # ---- structure -------------------------------------------------------

    def _collect_structure(self, rec: ModuleRec) -> None:
        cls_of: Dict[ast.AST, Optional[str]] = {}

        def visit(node, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                    cls_of[child] = cls
                    # nested defs get cls=None: their `self` (if any) is
                    # a closure variable, not this class's instance
                    visit(child, None)
                else:
                    visit(child, cls)

        visit(rec.tree, None)
        for info in rec.model.functions:
            fn = FnNode(rec.name, rec.model, info, cls_of.get(info.node))
            self._register(fn)
            self._node_to_fn[(rec.name, id(info.node))] = fn
        mod_fn = FnNode(rec.name, rec.model, None, None)
        self.module_nodes[rec.name] = mod_fn
        self.fns.append(mod_fn)

        # lock attributes / lock globals / tracked container globals
        for node in ast.walk(rec.tree):
            if not isinstance(node, ast.Assign) \
                    or not isinstance(node.value, ast.Call):
                continue
            resolved = rec.model.resolve(node.value.func)
            for tgt in node.targets:
                if resolved in LOCK_FACTORIES:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        owner = rec.model.enclosing_function(node)
                        cls = cls_of.get(owner.node) if owner else None
                        if cls:
                            self.class_locks.setdefault(
                                (rec.name, cls), set()).add(tgt.attr)
                    elif isinstance(tgt, ast.Name) \
                            and rec.model.enclosing_function(node) is None:
                        self.module_locks.setdefault(
                            rec.name, set()).add(tgt.id)
                elif (resolved in GLOBAL_CONTAINER_CALLS
                      and isinstance(tgt, ast.Name)
                      and rec.model.enclosing_function(node) is None):
                    self.globals.add((rec.name, tgt.id))
        for node in rec.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, (ast.Dict, ast.List, ast.Set)):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.globals.add((rec.name, tgt.id))

    def _register(self, fn: FnNode) -> None:
        self.fns.append(fn)
        self.fns_by_name.setdefault(fn.name, []).append(fn)
        self._by_module_name.setdefault(
            (fn.module, fn.name), []).append(fn)

    def fn_of(self, module: str, node: ast.AST) -> Optional[FnNode]:
        return self._node_to_fn.get((module, id(node)))

    def named_in(self, module: str, name: str) -> List[FnNode]:
        return self._by_module_name.get((module, name), [])

    # ---- call / target resolution ---------------------------------------

    def _resolve_targets(self, rec: ModuleRec, cls: Optional[str],
                         expr: ast.AST) -> Tuple[List[FnNode], bool]:
        """FnNodes a function-valued expression (call callee, thread
        target) can denote, plus whether the link is PRECISE (import /
        local / same-class) or a project-wide name match."""
        if isinstance(expr, ast.Lambda):
            fn = self.fn_of(rec.name, expr)
            return ([fn], True) if fn is not None else ([], True)
        resolved = rec.model.resolve(expr)
        if resolved and "." in resolved:
            prefix, _, last = resolved.rpartition(".")
            if prefix in self.modules:
                hits = self.named_in(prefix, last)
                if hits:
                    return hits, True
            elif isinstance(expr, ast.Name):
                # `from subprocess import run; run(...)`: the bare name
                # ALIAS-resolves outside the project, so it cannot
                # denote a local def — falling through to the local
                # name match would link an unrelated `def run` (and,
                # being a "precise" edge)
                return [], True
        if isinstance(expr, ast.Name):
            hits = self.named_in(rec.name, expr.id)
            return hits, True
        if isinstance(expr, ast.Attribute):
            name = expr.attr
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and cls is not None:
                same = [f for f in self.named_in(rec.name, name)
                        if f.cls == cls]
                if same:
                    return same, True
            # External-library calls resolve to nothing, not to a
            # name match: `subprocess.run(...)` / `np.asarray(...)` /
            # `ocp.args.Composite(...)` are rooted at an IMPORT alias,
            # so they cannot denote a project function — linking them
            # by terminal name would drag unrelated same-named defs
            # into reachability.
            base = expr.value
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name) and base.id in rec.model.aliases:
                return [], True
            if name in NO_NAME_MATCH:
                return [], False
            return list(self.fns_by_name.get(name, [])), False
        return [], True

    # ---- entries ---------------------------------------------------------

    def _entry_cls(self, rec: ModuleRec, node: ast.AST) -> Optional[str]:
        owner = rec.model.enclosing_function(node)
        if owner is None:
            return None
        fn = self.fn_of(rec.name, owner.node)
        return fn.cls if fn is not None else None

    def _collect_entries(self, rec: ModuleRec) -> None:
        parents = rec.model._parents
        for node in ast.walk(rec.tree):
            if isinstance(node, ast.ClassDef):
                if any(_terminal_name(b) is not None
                       and str(_terminal_name(b)).endswith(
                           HTTP_HANDLER_SUFFIX)
                       for b in node.bases):
                    self.http_handler_classes.add((rec.name, node.name))
                    for child in node.body:
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)) \
                                and (child.name.startswith("do_")
                                     or child.name in HTTP_ENTRY_METHODS):
                            fn = self.fn_of(rec.name, child)
                            if fn is not None:
                                self.entries.append(Entry(
                                    "http", fn, child.lineno))
                continue
            if not isinstance(node, ast.Call):
                continue
            resolved = rec.model.resolve(node.func)
            cls = self._entry_cls(rec, node)
            if resolved == "threading.Thread":
                target = next((kw.value for kw in node.keywords
                               if kw.arg == "target"), None)
                if target is None:
                    continue
                targets, _ = self._resolve_targets(rec, cls, target)
                daemon = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in node.keywords)
                handle = None
                parent = parents.get(node)
                if isinstance(parent, ast.Assign):
                    for tgt in parent.targets:
                        if isinstance(tgt, ast.Name):
                            handle = tgt.id
                        elif isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            handle = f"self.{tgt.attr}"
                self.thread_spawns.append(ThreadSpawn(
                    rec.name, node.lineno, targets,
                    _terminal_name(target) or "<lambda>", daemon, handle))
                for fn in targets:
                    self.entries.append(Entry("thread", fn, node.lineno))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "submit" and node.args:
                targets, _ = self._resolve_targets(rec, cls, node.args[0])
                for fn in targets:
                    self.entries.append(Entry("executor", fn, node.lineno))
            elif resolved == "signal.signal" and len(node.args) >= 2:
                targets, _ = self._resolve_targets(rec, cls, node.args[1])
                for fn in targets:
                    self.entries.append(Entry("signal", fn, node.lineno))

    def _mark_callables(self) -> None:
        """`__call__` runs on whatever thread invokes the object —
        untrackable statically — so once the project spawns ANY thread,
        every `__call__` conservatively joins the thread-reachable set
        (it stays main-reachable too)."""
        if not any(e.kind in ("thread", "executor", "http")
                   for e in self.entries):
            return
        for fn in self.fns_by_name.get("__call__", []):
            self.entries.append(Entry(
                "callable", fn,
                getattr(fn.info.node, "lineno", 1) if fn.info else 1))

    def _mark_spawn_joins(self) -> None:
        for spawn in self.thread_spawns:
            if spawn.handle is None:
                continue
            rec = self.modules[spawn.module]
            for node in ast.walk(rec.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join"):
                    continue
                v = node.func.value
                joined_name = None
                if isinstance(v, ast.Name):
                    joined_name = v.id
                elif isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id == "self":
                    joined_name = f"self.{v.attr}"
                if joined_name == spawn.handle:
                    spawn.joined = True
                    break

    # ---- the per-function walk (calls, writes, reads, held locks) --------

    def _lock_id(self, rec: ModuleRec, cls: Optional[str],
                 expr: ast.AST) -> Optional[Tuple]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and cls is not None \
                and expr.attr in self.class_locks.get((rec.name, cls),
                                                      ()):
            return ("L", rec.name, cls, expr.attr)
        if isinstance(expr, ast.Name) \
                and expr.id in self.module_locks.get(rec.name, ()):
            return ("L", rec.name, "", expr.id)
        return None

    def _global_id(self, rec: ModuleRec,
                   name_node: ast.Name) -> Optional[Tuple[str, str]]:
        """Tracked-global id for a Name, following from-imports
        (`from m import COUNTS` -> ("m", "COUNTS"))."""
        resolved = rec.model.aliases.get(name_node.id, name_node.id)
        if "." in resolved:
            mod, _, last = resolved.rpartition(".")
            gid = (mod, last)
        else:
            gid = (rec.name, resolved)
        return gid if gid in self.globals else None

    def _walk_module(self, rec: ModuleRec) -> None:
        for info in rec.model.functions:
            fn = self.fn_of(rec.name, info.node)
            body = info.node.body if not isinstance(info.node, ast.Lambda) \
                else [ast.Expr(info.node.body)]
            self._walk_body(rec, fn, body)
        # module-level code (everything outside function bodies)
        mod_fn = self.module_nodes[rec.name]
        self._walk_body(rec, mod_fn, rec.tree.body, module_level=True)

    def _walk_body(self, rec: ModuleRec, fn: FnNode, body,
                   module_level: bool = False) -> None:
        held: List[Tuple] = []

        def attr_target(expr) -> Optional[Tuple]:
            # self.X inside a class method -> class-attr id
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and fn.cls is not None:
                return ("attr", fn.module, fn.cls, expr.attr)
            if isinstance(expr, ast.Name):
                gid = self._global_id(rec, expr)
                if gid is not None:
                    return ("global",) + gid
            return None

        def record_write(target: Optional[Tuple], line: int,
                         kind: str) -> None:
            if target is not None:
                fn.writes.append(Access(
                    target, fn, line, kind, frozenset(held)))

        def visit(node) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # separate FnNode, walked on its own
            if isinstance(node, ast.ClassDef):
                if module_level:
                    for child in node.body:
                        visit(child)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    visit(item.context_expr)
                    lid = self._lock_id(rec, fn.cls, item.context_expr)
                    if lid is not None:
                        acquired.append(lid)
                held.extend(acquired)
                for st in node.body:
                    visit(st)
                if acquired:
                    del held[len(held) - len(acquired):]
                return
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        record_write(attr_target(tgt.value),
                                     node.lineno, "subscript")
                visit(node.value)
                for tgt in node.targets:
                    visit(tgt)
                return
            if isinstance(node, ast.AugAssign):
                tgt = node.target
                if isinstance(tgt, ast.Subscript):
                    record_write(attr_target(tgt.value),
                                 node.lineno, "subscript")
                else:
                    record_write(attr_target(tgt), node.lineno, "aug")
                    # `x += 1` READS x before storing (the lost-update
                    # half of the race) even though ast marks the
                    # target ctx=Store — count the read explicitly
                    if isinstance(tgt, ast.Attribute):
                        fn.attr_reads.add(tgt.attr)
                    elif isinstance(tgt, ast.Name):
                        gid = self._global_id(rec, tgt)
                        if gid is not None:
                            fn.global_reads.add(gid)
                visit(node.value)
                visit(tgt)
                return
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        record_write(attr_target(tgt.value),
                                     node.lineno, "del")
                    visit(tgt)
                return
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in MUTATORS:
                    record_write(attr_target(node.func.value),
                                 node.lineno, "mutcall")
                callees, precise = self._resolve_targets(
                    rec, fn.cls, node.func)
                site_held = frozenset(held)
                for callee in callees:
                    fn.calls.append(CallSite(
                        callee, node.lineno, site_held, precise))
                for child in ast.iter_child_nodes(node):
                    visit(child)
                return
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                fn.attr_reads.add(node.attr)
                if isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and fn.cls is not None:
                    fn.self_reads.append(Access(
                        ("attr", fn.module, fn.cls, node.attr),
                        fn, node.lineno, "read", frozenset(held)))
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load):
                gid = self._global_id(rec, node)
                if gid is not None:
                    fn.global_reads.add(gid)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for st in body:
            visit(st)

    # ---- held-lock fixpoint ---------------------------------------------

    def _propagate_held(self) -> None:
        """held(f) = ∩ over every call site of f of (locks at the site
        ∪ caller's own held set): a lock counts as held in f only when
        EVERY path into f holds it. Entry targets and uncalled
        functions pin at ∅ (someone outside the graph can call them)."""
        callers: Dict[Tuple, List[Tuple[FnNode, CallSite]]] = {}
        for fn in self.fns:
            for cs in fn.calls:
                callers.setdefault(cs.callee.key, []).append((fn, cs))
        entry_keys = {e.fn.key for e in self.entries}
        # Optimistic fixpoint: called, non-entry functions start at ⊤
        # (represented by None — "every lock") and only shrink; entry
        # targets and uncalled functions pin at ∅ (anything outside the
        # graph may invoke them holding nothing).
        held: Dict[Tuple, Optional[Set[Tuple]]] = {}
        for fn in self.fns:
            if fn.key in entry_keys or fn.key not in callers:
                held[fn.key] = set()
            else:
                held[fn.key] = None
        for _ in range(40):
            changed = False
            for fn in self.fns:
                sites = callers.get(fn.key)
                if not sites or fn.key in entry_keys:
                    continue
                acc: Optional[Set[Tuple]] = None  # ⊤ until constrained
                for caller, cs in sites:
                    ch = held[caller.key]
                    if ch is None:
                        continue  # ⊤ caller: site = ⊤, no constraint
                    site = set(cs.held) | ch
                    acc = site if acc is None else (acc & site)
                if acc is not None and held[fn.key] != acc:
                    held[fn.key] = acc
                    changed = True
            if not changed:
                break
        for fn in self.fns:
            fn.held = held.get(fn.key) or set()

    # ---- reachability ----------------------------------------------------

    def _compute_reachability(self) -> None:
        self._thread_witness: Dict[Tuple, str] = {}
        hard_targets = {e.fn.key for e in self.entries
                        if e.kind in ("thread", "executor", "signal",
                                      "http")}

        def bfs(seeds: List[Tuple[FnNode, str]],
                witness: Dict[Tuple, str]) -> Set[Tuple]:
            seen: Set[Tuple] = set()
            queue = list(seeds)
            while queue:
                fn, via = queue.pop(0)
                if fn.key in seen:
                    continue
                seen.add(fn.key)
                witness.setdefault(fn.key, via)
                for cs in fn.calls:
                    if cs.callee.key not in seen:
                        queue.append((cs.callee, via))
            return seen

        self._thread_set = bfs(
            [(e.fn, f"{e.kind}:{e.fn.label()}") for e in self.entries],
            self._thread_witness)
        main_seeds = [(fn, "") for fn in self.fns
                      if fn.key not in hard_targets]
        self._main_set = bfs(main_seeds, {})

    def thread_reachable(self, fn: FnNode) -> bool:
        return fn.key in self._thread_set

    def main_reachable(self, fn: FnNode) -> bool:
        return fn.key in self._main_set

    def entry_witness(self, fn: FnNode) -> str:
        return self._thread_witness.get(fn.key, "")

    def signal_entries(self) -> List[Entry]:
        return [e for e in self.entries if e.kind == "signal"]

    def closure(self, roots: Iterable[FnNode], max_fns: int = 400,
                max_depth: Optional[int] = None) -> List[FnNode]:
        """Call-graph closure from `roots` (bounded; the concurrency
        rules scan it for unsafe operations). `max_depth` caps the hop
        count from a root — JGL010 uses a small cap so findings anchor
        near the handler instead of deep inside shared sinks every
        caller funnels through."""
        seen: Set[Tuple] = set()
        out: List[FnNode] = []
        queue = [(fn, 0) for fn in roots]
        while queue and len(out) < max_fns:
            fn, depth = queue.pop(0)
            if fn.key in seen:
                continue
            seen.add(fn.key)
            out.append(fn)
            if max_depth is not None and depth >= max_depth:
                continue
            for cs in fn.calls:
                if cs.callee.key not in seen:
                    queue.append((cs.callee, depth + 1))
        return out

    def direct_call_lines(self, fn: FnNode) -> List[int]:
        """Lines where `fn` is CALLED (not spawned) anywhere in the
        project — the JGL011 'work re-runs at a synchronous barrier'
        exemption."""
        out = []
        for caller in self.fns:
            for cs in caller.calls:
                if cs.callee.key == fn.key:
                    out.append(cs.line)
        return out

    # ---- shared-state aggregation (JGL009 inputs) ------------------------

    def shared_writes(self) -> Dict[Tuple, List[Access]]:
        """All collected writes grouped by target id."""
        out: Dict[Tuple, List[Access]] = {}
        for fn in self.fns:
            for w in fn.writes:
                out.setdefault(w.target, []).append(w)
        return out

    def attr_readers(self, name: str) -> List[FnNode]:
        return [fn for fn in self.fns if name in fn.attr_reads]

    def self_reads_of(self, target: Tuple) -> List[Access]:
        """Same-class `self.X` reads of one class-attr target — the
        only reads precise enough to flag (cross-object attribute
        reads are name-matched and would misfire across classes)."""
        out: List[Access] = []
        for fn in self.fns:
            for r in fn.self_reads:
                if r.target == target:
                    out.append(r)
        return out

    def global_readers(self, gid: Tuple[str, str]) -> List[FnNode]:
        return [fn for fn in self.fns if gid in fn.global_reads]
