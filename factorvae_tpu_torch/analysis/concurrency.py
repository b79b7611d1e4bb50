"""graftlint concurrency rules JGL009-011 (whole-program mode only;
`factorvae_tpu/analysis/concurrency.py`).

These rules consume the `ProjectIndex` (project.py) — the cross-module
call graph with thread/signal/HTTP entry reachability and the per-class
guarded-attribute inference — and judge the failure modes a
multithreaded serving/training system actually dies of:

- JGL009  a shared mutable attribute (or module-level container) is
          written from a thread-reachable scope and accessed from
          main-line code (or vice versa) without holding the lock that
          guards its other writes — the `/metrics`-scrape-vs-tick
          counter race.
- JGL010  a signal handler's reachable closure performs
          async-signal-unsafe work: logging, I/O, lock acquisition.
          CPython runs handlers between bytecodes of the interrupted
          frame; a handler that takes the very lock the interrupted
          code holds deadlocks the process on the way down.
- JGL011  a `daemon=True` thread whose target performs file writes,
          with no `join()` and no synchronous re-run of the same work
          at a barrier: process exit tears the artifact mid-write (the
          torn-artifact fault class the chaos harness injects
          dynamically — `chaos` — caught statically here).

Every finding carries `thread_reachable=True` and an `entry_point`
naming the entry the reachability walk came through, which `--format
json` exposes (the CLI contract test pins the schema).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from factorvae_tpu_torch.analysis.engine import Finding, _terminal_name
from factorvae_tpu_torch.analysis.project import (
    Access,
    FnNode,
    ProjectIndex,
)

# ---------------------------------------------------------------------------
# JGL009 — unguarded cross-thread shared state


def _effective_held(w: Access) -> Set[Tuple]:
    """Locks held at a write: syntactic `with` context plus the locks
    the enclosing function inherits from every caller (fixpoint)."""
    return set(w.held) | set(w.fn.held)


def _describe_target(target: Tuple) -> str:
    if target[0] == "attr":
        _, module, cls, name = target
        return f"{cls}.{name}"
    _, module, name = target
    return f"{module}.{name}"


def _lock_name(lock_id: Tuple) -> str:
    _, module, cls, name = lock_id
    return f"self.{name}" if cls else name


def rule_jgl009(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for target, writes in sorted(index.shared_writes().items(),
                                 key=lambda kv: kv[0]):
        if target[0] == "attr":
            if (target[1], target[2]) in index.http_handler_classes:
                # request-handler instances are born and die within one
                # request on one thread; their attrs cannot be shared
                continue
            readers = index.attr_readers(target[3])
        else:
            readers = index.global_readers((target[1], target[2]))
        t_write = [w for w in writes if index.thread_reachable(w.fn)]
        m_write = [w for w in writes if index.main_reachable(w.fn)]
        t_access = bool(t_write) or any(
            index.thread_reachable(r) for r in readers)
        m_access = bool(m_write) or any(
            index.main_reachable(r) for r in readers)
        if not ((t_write and m_access) or (m_write and t_access)):
            continue  # single-domain state: owned by one side, no race
        guarded = [w for w in writes if _effective_held(w)]
        owning: Set[Tuple] = set()
        if guarded:
            owning = set.intersection(
                *[_effective_held(w) for w in guarded])
        witness = ""
        for w in t_write:
            witness = index.entry_witness(w.fn)
            if witness:
                break
        if not witness:
            for r in readers:
                witness = index.entry_witness(r)
                if witness:
                    break
        # Composite-reader check (precise same-class `self.X` reads
        # only): once an owning lock exists, a cross-domain read that
        # skips it sees torn composites — an OrderedDict iterated
        # mid-eviction, a paired counter snapshot straddling a tick.
        # Reads co-located with a write site (the `self.d[k] = v` load
        # inside the store) dedup against the write finding.
        read_findings: List[Tuple[Access, str]] = []
        if owning:
            write_lines = {(w.fn.key, w.line) for w in writes}
            t_w = bool(t_write)
            m_w = bool(m_write)
            for r in index.self_reads_of(target):
                if (r.fn.key, r.line) in write_lines:
                    continue
                if _effective_held(r):
                    continue
                crosses = (t_w and index.main_reachable(r.fn)) or \
                    (m_w and index.thread_reachable(r.fn))
                if crosses:
                    read_findings.append((r, "read"))
        for w, what_kind in [(w, "write") for w in writes] \
                + read_findings:
            if what_kind == "write" and _effective_held(w):
                continue  # holds a lock (the owning one on every path
                #           that can reach it, by the fixpoint's
                #           conservative construction)
            what = _describe_target(target)
            if what_kind == "read":
                lock = ", ".join(sorted({_lock_name(x)
                                         for x in owning}))
                findings.append(Finding(
                    "JGL009", w.fn.model.path, w.line,
                    f"shared '{what}' read here without its owning "
                    f"lock ({lock} guards its writes) while the "
                    f"attribute crosses the thread/main-line boundary "
                    f"— a composite read (iteration, paired counters) "
                    f"interleaves with a locked mutation; hold the "
                    f"lock around the read too",
                    thread_reachable=True, entry_point=witness))
                continue
            if owning:
                lock = ", ".join(sorted({_lock_name(x)
                                         for x in owning}))
                msg = (
                    f"shared '{what}' written here without its owning "
                    f"lock ({lock} guards its other writes) while the "
                    f"attribute is reachable from both a thread entry "
                    f"({witness or 'thread'}) and main-line code — a "
                    f"concurrent scrape/tick interleaves the "
                    f"read-modify-write; hold the lock here too")
            else:
                msg = (
                    f"shared '{what}' mutated with NO lock while "
                    f"written/read from both a thread-reachable scope "
                    f"({witness or 'thread'}) and main-line code — "
                    f"`x += 1` and container mutation are not atomic "
                    f"across threads; guard every write with one lock "
                    f"(see obs/metrics.LatencyHistogram) or suppress "
                    f"with the invariant that serializes these "
                    f"accesses")
            findings.append(Finding(
                "JGL009", w.fn.model.path, w.line, msg,
                thread_reachable=True, entry_point=witness))
    return findings


# ---------------------------------------------------------------------------
# JGL010 — async-signal-unsafe signal handlers


#: call names (plain) that allocate/log/do I/O
UNSAFE_NAMES = {"print", "open"}
#: terminal attribute calls that log, flush, or take locks
UNSAFE_ATTRS = {"log", "write", "flush", "acquire", "makedirs",
                "warn", "warning", "error", "info", "debug",
                "exception"}
#: resolved dotted calls (module helpers that lock + write internally)
UNSAFE_RESOLVED = {"time.sleep", "os.makedirs", "os.replace",
                   "os.rename"}
#: timeline helpers — they funnel into MetricsLogger.log (lock + file
#: write) and are the exact shape the SIGTERM drain used to have
UNSAFE_TIMELINE = {"timeline_event", "timeline_span",
                   "timeline_span_at"}


def _lockish_context(index: ProjectIndex, fn: FnNode,
                     expr: ast.AST) -> Optional[str]:
    rec = index.modules[fn.module]
    lid = index._lock_id(rec, fn.cls, expr)
    if lid is not None:
        return _lock_name(lid)
    name = _terminal_name(expr)
    if name and "lock" in name.lower():
        return name
    return None


def _unsafe_sites(index: ProjectIndex,
                  fn: FnNode) -> List[Tuple[int, str]]:
    """(line, what) for every async-signal-unsafe operation in `fn`'s
    own body."""
    if fn.info is None:
        return []
    out: List[Tuple[int, str]] = []
    model = fn.model
    stack = list(ast.iter_child_nodes(fn.info.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                lock = _lockish_context(index, fn, item.context_expr)
                if lock is not None:
                    out.append((node.lineno,
                                f"lock acquisition (`with {lock}`)"))
        elif isinstance(node, ast.Call):
            resolved = model.resolve(node.func)
            term = _terminal_name(node.func)
            if isinstance(node.func, ast.Name) \
                    and node.func.id in UNSAFE_NAMES:
                out.append((node.lineno, f"{node.func.id}() I/O"))
            elif term in UNSAFE_TIMELINE:
                out.append((node.lineno,
                            f"{term}() — locks the metrics stream and "
                            f"writes the RUN.jsonl"))
            elif resolved in UNSAFE_RESOLVED:
                out.append((node.lineno, f"{resolved}()"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in UNSAFE_ATTRS:
                out.append((node.lineno, f".{node.func.attr}() call"))
        stack.extend(ast.iter_child_nodes(node))
    return out


def rule_jgl010(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple] = set()
    for entry in index.signal_entries():
        handler = entry.fn
        # Two hops: the handler's own body plus what it directly calls
        # (and one level below — the `request_drain -> timeline_event`
        # shape). Deeper and every handler would re-anchor its finding
        # inside the shared logging sink all code funnels through,
        # losing the actionable site.
        for fn in index.closure([handler], max_depth=2):
            for line, what in _unsafe_sites(index, fn):
                key = (handler.key, fn.module, line)
                if key in seen:
                    continue
                seen.add(key)
                where = "" if fn.key == handler.key else \
                    f" (reached through '{fn.qualname}')"
                findings.append(Finding(
                    "JGL010", fn.model.path, line,
                    f"signal handler '{handler.qualname}' performs "
                    f"async-signal-unsafe work{where}: {what}. CPython "
                    f"runs handlers between bytecodes of the "
                    f"interrupted frame — if the interrupted code "
                    f"holds the same (non-reentrant) lock, the process "
                    f"deadlocks on the way down. Set a threading.Event "
                    f"and return; do the drain work on the serving "
                    f"loop (serve/daemon.py's SIGTERM shape)",
                    thread_reachable=True,
                    entry_point=f"signal:{handler.label()}"))
    return findings


# ---------------------------------------------------------------------------
# JGL011 — daemon file-writer threads without a shutdown barrier


#: file-mutating operations a daemon thread must not be mid-way through
#: at process exit
WRITE_RESOLVED = {"os.replace", "os.rename", "json.dump",
                  "pickle.dump", "numpy.save", "shutil.move"}


def _file_write_sites(index: ProjectIndex,
                      fn: FnNode) -> List[Tuple[int, str]]:
    if fn.info is None:
        return []
    out: List[Tuple[int, str]] = []
    model = fn.model
    stack = list(ast.iter_child_nodes(fn.info.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            resolved = model.resolve(node.func)
            if resolved in WRITE_RESOLVED:
                out.append((node.lineno, resolved))
            elif isinstance(node.func, ast.Name) \
                    and node.func.id == "open":
                mode = None
                if len(node.args) >= 2 and isinstance(
                        node.args[1], ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value,
                                                       ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and any(
                        c in mode for c in "wax+"):
                    out.append((node.lineno, f"open(..., {mode!r})"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "write":
                out.append((node.lineno, ".write()"))
        stack.extend(ast.iter_child_nodes(node))
    return out


def rule_jgl011(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for spawn in index.thread_spawns:
        if not spawn.daemon or spawn.joined or not spawn.targets:
            continue
        # Barrier exemption: the target is ALSO called directly
        # somewhere (checkpoint.py's manifest flush runs synchronously
        # at every read-side barrier) — a dead daemon thread's work is
        # redone, so a torn write cannot be the surviving state.
        if any(index.direct_call_lines(t) for t in spawn.targets):
            continue
        sites: List[Tuple[int, str, str]] = []
        for fn in index.closure(spawn.targets):
            for line, what in _file_write_sites(index, fn):
                sites.append((line, what, fn.qualname))
        if not sites:
            continue
        sites.sort()
        shown = "; ".join(
            f"{what} in '{qn}' (line {line})"
            for line, what, qn in sites[:3])
        path = index.modules[spawn.module].path
        findings.append(Finding(
            "JGL011", path, spawn.line,
            f"daemon=True thread '{spawn.target_name}' performs file "
            f"writes ({shown}) with no join() and no synchronous "
            f"re-run of the same work at a barrier — daemon threads "
            f"are killed mid-write at interpreter exit, leaving a "
            f"torn artifact (the torn-file fault class chaos injects "
            f"dynamically). join it on every shutdown path, or make "
            f"the work re-runnable at a read-side barrier",
            thread_reachable=True,
            entry_point=f"thread:{spawn.targets[0].label()}"))
    return findings


PROJECT_RULES = (rule_jgl009, rule_jgl010, rule_jgl011)
