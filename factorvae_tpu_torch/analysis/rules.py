"""graftlint rules JGL006-JGL008, JGL012 and JGL013
(`factorvae_tpu/analysis/rules.py`, the rules that are not about JAX).

Each rule is a function `(ModuleModel) -> list[Finding]`. They judge the
port's library code: a path that contains `factorvae_tpu_torch/`. The
scripts, the tests and `chip_smoke.py` own their stdout, clocks and error
policy and are exempt. The rule ids, the messages and the suppression
syntax are the JAX analyzer's, so findings compare one to one.

JGL001-005 (host syncs under jit, PRNG key reuse, jit-cache hazards,
donation, dtype drift in plan-governed paths) are about JAX and have no
counterpart here.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from factorvae_tpu_torch.analysis.engine import (
    Finding,
    ModuleModel,
    _terminal_name,
)

#: the library code the rules judge
LIBRARY = "factorvae_tpu_torch/"


def _target_names(targets) -> List[str]:
    out: List[str] = []

    def rec(t):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                rec(e)
        elif isinstance(t, ast.Starred):
            rec(t.value)

    for t in targets:
        rec(t)
    return out


# ---------------------------------------------------------------------------
# JGL006 — bare print() in library modules


# Exempt by construction: CLI surfaces whose job IS stdout.
JGL006_EXEMPT_BASENAMES = {"cli.py", "__main__.py"}
# The metrics sink itself: MetricsLogger's echo/degradation prints are
# the terminal end of the routing this rule enforces.
JGL006_EXEMPT_SUFFIXES = ("factorvae_tpu_torch/utils/logging.py",)


def _dunder_main_ranges(tree: ast.Module) -> List[tuple]:
    """(first, last) line ranges of top-level `if __name__ == ...`
    blocks — module smoke entries run as scripts, not as library code."""
    out = []
    for node in tree.body:
        if isinstance(node, ast.If) and any(
            isinstance(n, ast.Name) and n.id == "__name__"
            for n in ast.walk(node.test)
        ):
            out.append((node.lineno,
                        getattr(node, "end_lineno", node.lineno)))
    return out


def rule_jgl006(model: ModuleModel) -> List[Finding]:
    """Bare `print(` in a factorvae_tpu_torch library module. Library output
    belongs on the MetricsLogger/timeline event stream (one RUN.jsonl
    per run, machine-readable, wandb-forwardable); stray prints
    interleave unstructured text into whatever stdout the caller owns
    (chip_smoke.py's one-JSON-line contract, a CLI's table output).
    Exempt: CLI entry files (cli.py, __main__.py), `main()` functions
    and anything nested in one, module-level `if __name__ == "__main__"`
    smoke blocks, and the logger module itself (the sink)."""
    norm = model.path.replace(os.sep, "/")
    if LIBRARY not in norm:
        return []  # scripts/, tests/, chip_smoke.py own their stdout
    if os.path.basename(norm) in JGL006_EXEMPT_BASENAMES or any(
            norm.endswith(s) for s in JGL006_EXEMPT_SUFFIXES):
        return []
    guards = _dunder_main_ranges(model.tree)
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            continue
        if any(lo <= node.lineno <= hi for lo, hi in guards):
            continue
        fn = model.enclosing_function(node)
        cur, in_main = fn, False
        while cur is not None:
            if cur.name == "main":
                in_main = True
                break
            cur = cur.parent
        if in_main:
            continue
        where = f"'{fn.qualname}'" if fn is not None else "module level"
        findings.append(Finding(
            "JGL006", model.path, node.lineno,
            f"bare print() at {where} in a library module — route it "
            "through MetricsLogger.log (metrics/events) or the timeline "
            "so runs yield one coherent RUN.jsonl; CLI mains are exempt",
        ))
    return findings


# ---------------------------------------------------------------------------
# JGL007 — silent exception swallow in library code


# Call names (terminal attribute or plain name) that count as surfacing
# the failure: the MetricsLogger/timeline sinks, stdlib logging levels,
# warnings.warn, and print (stderr recipes in CLI-adjacent helpers).
JGL007_SURFACING_CALLS = {
    "log", "timeline_event", "print", "warn", "warning", "error",
    "exception", "debug", "info", "critical", "fail", "skip", "xfail",
}

BROAD_EXC_NAMES = {"Exception", "BaseException"}


def _broad_handler(h: ast.ExceptHandler) -> bool:
    """Bare `except:`, or a type (possibly in a tuple) resolving to
    Exception/BaseException. Narrow handlers (OSError, ValueError, ...)
    state what they expect and are out of scope."""
    if h.type is None:
        return True
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    return any(_terminal_name(t) in BROAD_EXC_NAMES for t in types)


def _handler_walk(body):
    """ast.walk over handler statements WITHOUT descending into nested
    function/lambda definitions: a `return` (or a Load of the bound
    name) inside a callback the handler merely defines runs later, in
    another frame — it does not surface THIS exception, and counting it
    would let `except Exception: callbacks.append(lambda: ...)` pass as
    an explicit failure policy."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _handler_surfaces(h: ast.ExceptHandler) -> bool:
    """Does the handler body re-raise, return, log, or capture the
    exception into a value? Any of these makes the failure policy
    explicit; a body with none of them swallowed the error silently."""
    for node in _handler_walk(h.body):
        if isinstance(node, (ast.Raise, ast.Return)):
            return True
        if isinstance(node, ast.Call) \
                and _terminal_name(node.func) in JGL007_SURFACING_CALLS:
            return True
        # `except Exception as e: out["error"] = str(e)` — the bound
        # exception flows into a value the caller will see
        if h.name and isinstance(node, ast.Name) \
                and isinstance(node.ctx, ast.Load) and node.id == h.name:
            return True
    return False


def rule_jgl007(model: ModuleModel) -> List[Finding]:
    """Broad `except Exception` handlers in `factorvae_tpu_torch/` library
    modules must make their failure policy explicit: re-raise, log the
    error (MetricsLogger / timeline_event / warnings / print-to-stderr),
    return an explicit error/fallback value, or convert the bound
    exception into a value. `except Exception: pass` (and fallthrough
    fallback assignments that never mention the error) hide real faults
    exactly where the self-healing machinery needs to see them
    (train/trainer.py's rollback, the daemon's breaker); deliberate best-effort swallows carry a
    justified suppression so the audit trail survives."""
    norm = model.path.replace(os.sep, "/")
    if LIBRARY not in norm:
        return []  # scripts/, tests/, chip_smoke.py own their error policy
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _broad_handler(node):
            continue
        if _handler_surfaces(node):
            continue
        what = "bare except:" if node.type is None else "except Exception"
        findings.append(Finding(
            "JGL007", model.path, node.lineno,
            f"{what} swallows the error silently — log it "
            "(MetricsLogger/timeline_event), re-raise, or return an "
            "explicit error value; a deliberate best-effort swallow "
            "needs a justified suppression",
        ))
    return findings


# ---------------------------------------------------------------------------
# JGL008 — wall-clock duration measurement in library code


def _is_walltime_call(model: ModuleModel, expr: ast.AST) -> bool:
    return isinstance(expr, ast.Call) \
        and model.resolve(expr.func) == "time.time" and not expr.args


def rule_jgl008(model: ModuleModel) -> List[Finding]:
    """`time.time()` used to MEASURE a duration — its value (directly
    or through an assigned name) participates in a subtraction — in
    `factorvae_tpu_torch/` library code. The Timeline contract
    (utils/logging.py) is monotonic `time.perf_counter` for every
    span/duration: wall-clock `time.time()` jumps under NTP steps and
    DST, so a duration measured on it can come out negative or wildly
    wrong, and its records land on a DIFFERENT time base than the rest
    of the run's spans. `time.time()` as a TIMESTAMP (the `ts` field
    of metric records, checkpoint `created` stamps) never subtracts
    and stays exempt — that is exactly what a wall clock is for."""
    norm = model.path.replace(os.sep, "/")
    if LIBRARY not in norm:
        return []  # scripts/, tests/, chip_smoke.py own their clocks
    # names bound to time.time() anywhere in the module (the engine's
    # standard name-based over-approximation)
    tracked: Set[str] = set()
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) \
                and _is_walltime_call(model, node.value):
            tracked.update(_target_names(node.targets))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None \
                and _is_walltime_call(model, node.value):
            tracked.update(_target_names([node.target]))

    def measures(expr: ast.AST) -> bool:
        return _is_walltime_call(model, expr) or (
            isinstance(expr, ast.Name) and expr.id in tracked)

    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                and (measures(node.left) or measures(node.right)):
            findings.append(Finding(
                "JGL008", model.path, node.lineno,
                "duration measured with wall-clock time.time() — the "
                "Timeline contract is monotonic time.perf_counter "
                "(an NTP step or DST jump corrupts the span, and the "
                "value shares no time base with the run's spans); "
                "keep time.time() for record timestamps only",
            ))
    return findings


# ---------------------------------------------------------------------------
# JGL012 — blocking network/synchronization call without a timeout


# resolved callable -> number of positional args at which the timeout
# parameter is covered positionally (urlopen(url, data, timeout) -> 3;
# create_connection(addr, timeout) -> 2; HTTP*Connection(host, port,
# timeout) -> 3). A `timeout=` keyword always satisfies the rule.
JGL012_TIMEOUT_CALLS = {
    "urllib.request.urlopen": 3,
    "socket.create_connection": 2,
    "http.client.HTTPConnection": 3,
    "http.client.HTTPSConnection": 3,
    "requests.get": None,
    "requests.post": None,
    "requests.put": None,
    "requests.delete": None,
    "requests.head": None,
    "requests.patch": None,
    "requests.request": None,
}

# constructors whose zero-arg `.wait()` blocks forever
JGL012_WAITABLE_CTORS = {"threading.Event", "threading.Condition"}


def _jgl012_wait_targets(model: ModuleModel) -> Set[str]:
    """Names module-locally bound to `threading.Event()` /
    `threading.Condition(...)` — plain locals ("done") and
    self-attributes ("self._stop") alike."""
    tracked: Set[str] = set()
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Call) and model.resolve(
                node.value.func) in JGL012_WAITABLE_CTORS):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                tracked.add(t.id)
            elif isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                tracked.add(f"self.{t.attr}")
    return tracked


def _jgl012_wait_receiver(func: ast.Attribute) -> Optional[str]:
    """'done' for `done.wait()`, 'self._x' for `self._x.wait()`."""
    v = func.value
    if isinstance(v, ast.Name):
        return v.id
    if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
            and v.value.id == "self":
        return f"self.{v.attr}"
    return None


def rule_jgl012(model: ModuleModel) -> List[Finding]:
    """Blocking network or synchronization call without an explicit
    timeout in `factorvae_tpu_torch/` library code. The serving plane
    is a mesh of sockets — router forwards, remote
    join/download, autoscale scrapes, readiness probes — and every
    untimed blocking call in it is a hang that outlives the peer: a
    worker that dies mid-recv parks the caller forever, invisible to
    the watcher that would have healed it. Two shapes are flagged:
    HTTP/socket calls (`urlopen`, `http.client.*Connection`,
    `socket.create_connection`, `requests.*`) with neither a
    `timeout=` keyword nor the positional timeout slot filled, and
    zero-arg `.wait()` on a `threading.Event`/`Condition` (blocks
    forever; `wait(t)` in a liveness-checking loop keeps the caller
    able to notice a dead peer). Deliberate untimed blocking carries a
    justified suppression."""
    norm = model.path.replace(os.sep, "/")
    if LIBRARY not in norm:
        return []  # scripts/, tests/, chip_smoke.py own their blocking
    tracked = _jgl012_wait_targets(model)
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        if any(kw.arg is None for kw in node.keywords):
            continue  # **kwargs may carry timeout — benefit of doubt
        if any(kw.arg == "timeout" for kw in node.keywords):
            continue
        resolved = model.resolve(node.func)
        if resolved in JGL012_TIMEOUT_CALLS:
            slot = JGL012_TIMEOUT_CALLS[resolved]
            if slot is not None and len(node.args) >= slot:
                continue
            findings.append(Finding(
                "JGL012", model.path, node.lineno,
                f"{resolved} without an explicit timeout — an untimed "
                "network call hangs forever when the peer dies "
                "mid-exchange; pass timeout= (the serving plane's "
                "watcher can only heal what returns)",
            ))
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "wait" and not node.args:
            recv = _jgl012_wait_receiver(node.func)
            if recv is not None and recv in tracked:
                findings.append(Finding(
                    "JGL012", model.path, node.lineno,
                    f"untimed {recv}.wait() on a threading "
                    "Event/Condition blocks forever if the notifier "
                    "dies — use wait(t) in a loop that can check "
                    "peer/thread liveness; a deliberate forever-block "
                    "needs a justified suppression",
                ))
    return findings


# ---------------------------------------------------------------------------
# JGL013 — same-function timeline_span_begin/_end pairing


def _jgl013_finally_nodes(func_node: ast.AST) -> Set[int]:
    """ids of every AST node lexically inside a `finally:` block of
    `func_node` (nested Trys included)."""
    protected: Set[int] = set()
    for node in ast.walk(func_node):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    protected.add(id(sub))
    return protected


def rule_jgl013(model: ModuleModel) -> List[Finding]:
    """`timeline_span_begin` paired with `timeline_span_end` in the
    SAME function in `factorvae_tpu_torch/` library code. The begin/end token
    API (utils/logging.py) exists for exactly one caller shape: a span
    opened on one thread and closed on another (the tick scheduler's
    queue-wait spans — submit() opens, the scheduler loop closes).
    Pairing them inside one function re-implements the `timeline_span`
    context manager by hand, and almost always wrong: without
    try/finally an exception between the calls leaks an open span the
    stream never sees the end of (the trace tree shows a request stuck
    forever in a stage it left), and with try/finally it is just the
    context manager, verbose. Cross-function begin/end — the sanctioned
    handoff — produces no finding."""
    norm = model.path.replace(os.sep, "/")
    if LIBRARY not in norm:
        return []  # scripts/, tests/, chip_smoke.py own their instrumentation
    begins: Dict[ast.AST, List[ast.Call]] = {}
    ends: Dict[ast.AST, List[ast.Call]] = {}
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if name not in ("timeline_span_begin", "timeline_span_end"):
            continue
        info = model.enclosing_function(node)
        if info is None:
            continue
        (begins if name == "timeline_span_begin" else ends).setdefault(
            info.node, []).append(node)
    findings: List[Finding] = []
    for func_node, begin_calls in begins.items():
        end_calls = ends.get(func_node)
        if not end_calls:
            continue  # begin-only: the cross-thread handoff, sanctioned
        protected = _jgl013_finally_nodes(func_node)
        if all(id(e) in protected for e in end_calls):
            msg = ("timeline_span_begin/timeline_span_end paired in one "
                   "function — this hand-rolls the timeline_span context "
                   "manager; the token API is for cross-thread handoff "
                   "only, use the context-manager form")
        else:
            msg = ("timeline_span_begin paired with timeline_span_end in "
                   "the same function without try/finally — an exception "
                   "between them leaks an open span (the trace tree shows "
                   "the request stuck in that stage forever); use the "
                   "timeline_span context-manager form")
        findings.append(Finding(
            "JGL013", model.path, min(b.lineno for b in begin_calls), msg,
        ))
    return findings


ALL_RULES = (rule_jgl006, rule_jgl007, rule_jgl008, rule_jgl012,
             rule_jgl013)
