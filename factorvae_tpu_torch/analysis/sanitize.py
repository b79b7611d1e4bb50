"""Runtime lock-order sanitizer: the dynamic half of the concurrency
gate (graftlint JGL009-011 are the static half;
`factorvae_tpu/analysis/sanitize.py`).

Static analysis can prove a write is unguarded; it cannot prove two
subsystems' locks are always taken in one global order — that property
only exists at runtime, the first time the subsystems COMPOSE (a
daemon tick holding the tick lock cold-starts a registry entry that
verifies a checkpoint that logs to the timeline...). `LockOrderRecorder`
wraps `threading.Lock` / `threading.RLock` construction while
installed, keeps a per-thread stack of held wrapped locks, and records
every *held-while-acquiring* pair as an edge in a directed graph keyed
by lock CREATION SITE (all instances born at `registry.py:210` are one
order class). A cycle in that graph is a lock-order inversion: two
threads interleaving those acquisition paths can deadlock, even if no
test run ever actually deadlocked. `check()` fails loudly with the
cycle and a witness (thread + acquire site) per edge.

Usage (the tier-1 fixture in tests/test_sanitize.py drives the
Checkpointer + Timeline + metrics + registry + chaos lock set through
exactly this):

    rec = LockOrderRecorder(only=("factorvae_tpu_torch/",))
    with rec:                      # patches the lock factories
        ...build loggers/checkpointers/registries, run the workload...
    rec.check()                    # raises LockOrderError on a cycle

Notes and scope:

- Only locks CREATED while the recorder is installed are wrapped
  (construction-time patch, not acquisition-time). `only` filters by
  the creation site's filename, so stdlib-internal locks (threading's
  own Conditions, the executors') stay native and unrecorded.
  Locks born BEFORE install — module-level locks like `utils/profiling`'s
  capture lock, created at import — are invisible to the patch;
  fixtures bring them in explicitly with `adopt(module, "_LOCK")`,
  which wraps the existing lock in place and restores it on
  uninstall.
- Same-site edges (two instances of one class nested) are excluded
  from cycle detection: instance-order within a class needs its own
  discipline and would otherwise self-cycle on the first fleet of
  per-seed Checkpointers.
- RLock re-entry (same instance already held by this thread) records
  no edge — re-acquisition is not an ordering event.
- `make_lock(label)` hands out a wrapped lock directly (no patching) —
  the seeded-inversion tests use it for deterministic labels.
- The wrapper tolerates releases it never saw (Condition's
  `_release_save` bypasses `release()`): the held stack is pruned by
  identity, never assumed balanced.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["LockOrderError", "LockOrderRecorder", "RecordedLock"]

_THIS_FILE = os.path.abspath(__file__)


class LockOrderError(AssertionError):
    """A lock-order inversion (cycle in the held-while-acquiring
    graph) was recorded; the message carries the cycle and witnesses."""


def _acquire_site() -> str:
    """file:line of the frame that called into the lock wrapper."""
    f = sys._getframe(1)
    while f is not None and os.path.abspath(
            f.f_code.co_filename) == _THIS_FILE:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class RecordedLock:
    """Transparent proxy over a real lock that reports acquisition
    order to its recorder. Same acquire/release/context-manager
    surface; everything else delegates to the wrapped lock."""

    def __init__(self, recorder: "LockOrderRecorder", inner,
                 label: str, reentrant: bool):
        self._recorder = recorder
        self._inner = inner
        self.label = label
        self.reentrant = reentrant

    def acquire(self, *args, **kwargs):
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            self._recorder._acquired(self)
        return ok

    def release(self):
        self._recorder._released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, attr):
        # Condition() introspects _is_owned/_release_save/... on RLocks
        return getattr(self._inner, attr)

    def __repr__(self):
        return f"<RecordedLock {self.label}>"


class LockOrderRecorder:
    def __init__(self, only: Optional[Sequence[str]] = None):
        #: substrings a creation site's path must contain to be
        #: wrapped; empty = wrap every lock created while installed
        self.only = tuple(p.replace(os.sep, "/") for p in (only or ()))
        # (held_label, acquired_label) -> witness
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._tls = threading.local()
        self._meta = threading.Lock()   # guards _edges (a REAL lock)
        self._orig: Optional[tuple] = None
        # (owner, attr, original) for adopt()ed pre-existing locks
        self._adopted: List[tuple] = []

    # ---- construction-time patch ----------------------------------------

    def install(self) -> "LockOrderRecorder":
        if self._orig is not None:
            return self
        self._orig = (threading.Lock, threading.RLock)
        rec = self

        def factory(orig, reentrant):
            def patched():
                frame = sys._getframe(1)
                fname = frame.f_code.co_filename.replace(os.sep, "/")
                if rec.only and not any(p in fname for p in rec.only):
                    return orig()
                label = (f"{os.path.basename(fname)}:"
                         f"{frame.f_lineno}")
                return RecordedLock(rec, orig(), label, reentrant)
            return patched

        threading.Lock = factory(self._orig[0], False)
        threading.RLock = factory(self._orig[1], True)
        return self

    def uninstall(self) -> None:
        if self._orig is not None:
            threading.Lock, threading.RLock = self._orig
            self._orig = None
        while self._adopted:
            owner, attr, original = self._adopted.pop()
            setattr(owner, attr, original)

    def __enter__(self) -> "LockOrderRecorder":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()

    def make_lock(self, label: str,
                  reentrant: bool = False) -> RecordedLock:
        """A wrapped lock with an explicit label, without patching the
        factories — deterministic handles for tests."""
        orig = self._orig or (threading.Lock, threading.RLock)
        inner = orig[1]() if reentrant else orig[0]()
        return RecordedLock(self, inner, label, reentrant)

    def adopt(self, owner, attr: str,
              label: Optional[str] = None) -> RecordedLock:
        """Wrap an ALREADY-CONSTRUCTED lock bound at `owner.attr` (a
        module global like utils.profiling._LOCK, or an instance
        attribute). The construction-time patch cannot see locks
        created before install() — module-level locks are born at
        import — so fixtures adopt them explicitly: the existing inner
        lock is wrapped in place (every use site that goes through the
        name sees the recorder) and restored on uninstall()."""
        inner = getattr(owner, attr)
        if isinstance(inner, RecordedLock):
            return inner
        name = getattr(owner, "__name__", type(owner).__name__)
        wrapped = RecordedLock(self, inner, label or f"{name}.{attr}",
                               reentrant=not hasattr(inner, "locked"))
        setattr(owner, attr, wrapped)
        self._adopted.append((owner, attr, inner))
        return wrapped

    # ---- acquisition tracking -------------------------------------------

    def _stack(self) -> List[RecordedLock]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _acquired(self, lock: RecordedLock) -> None:
        stack = self._stack()
        if any(h is lock for h in stack):
            # re-entry on the same instance: not an ordering event,
            # but keep the stack balanced for the matching release
            stack.append(lock)
            return
        site = _acquire_site()
        new_edges = []
        seen_labels = set()
        for held in stack:
            if held.label == lock.label or held.label in seen_labels:
                continue  # same order class / duplicate held label
            seen_labels.add(held.label)
            new_edges.append((held.label, lock.label))
        if new_edges:
            thread = threading.current_thread().name
            with self._meta:
                for edge in new_edges:
                    self._edges.setdefault(edge, {
                        "thread": thread, "site": site})
        stack.append(lock)

    def _released(self, lock: RecordedLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return
        # a release we never saw acquired (Condition internals):
        # nothing to prune, nothing to complain about

    # ---- analysis --------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], dict]:
        with self._meta:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Every distinct cycle (as a label path a -> b -> ... -> a)
        in the held-while-acquiring graph."""
        edges = self.edges()
        adj: Dict[str, List[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        for succs in adj.values():
            succs.sort()
        out: List[List[str]] = []
        seen_cycles = set()

        def dfs(node: str, path: List[str], on_path: set) -> None:
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cycle = path[path.index(nxt):] + [nxt]
                    # dedup by ROTATION-normalized edge sequence, not
                    # node set: A->B->C->A and A->C->B->A over the same
                    # three locks are two distinct inversions and must
                    # both be reported (each names different edges to
                    # fix)
                    seq = tuple(cycle[:-1])
                    key = min(seq[i:] + seq[:i]
                              for i in range(len(seq)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cycle)
                    continue
                on_path.add(nxt)
                dfs(nxt, path + [nxt], on_path)
                on_path.discard(nxt)

        for start in sorted(adj):
            dfs(start, [start], {start})
        return out

    def report(self) -> str:
        """Human-readable inversion report: each cycle with the
        witness (thread + acquire site) for every edge on it."""
        cycles = self.cycles()
        if not cycles:
            return "lock-order sanitizer: no inversions " \
                   f"({len(self.edges())} ordered pair(s) observed)"
        edges = self.edges()
        lines = [f"lock-order inversion: {len(cycles)} cycle(s) in the "
                 "held-while-acquiring graph"]
        for cycle in cycles:
            lines.append("  cycle: " + " -> ".join(cycle))
            for a, b in zip(cycle, cycle[1:]):
                w = edges.get((a, b), {})
                lines.append(
                    f"    {a} held while acquiring {b}  "
                    f"[thread {w.get('thread', '?')}, "
                    f"at {w.get('site', '?')}]")
        lines.append(
            "  two threads interleaving these acquisition paths "
            "deadlock; pick one global order and take the locks in it")
        return "\n".join(lines)

    def check(self) -> None:
        """Raise `LockOrderError` with the full report if any cycle
        was recorded."""
        if self.cycles():
            raise LockOrderError(self.report())
