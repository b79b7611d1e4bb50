"""Deterministic fault injection for the port's recovery paths
(`factorvae_tpu/chaos/__init__.py`).

A `ChaosPlan` is a seeded list of `Fault`s, each pinned to coordinates and
bounded by a fire count. It is installed in-process (`install`, or the
scoped `active` that tests use so that no plan outlives its test), or
through the `FACTORVAE_CHAOS` environment variable holding the plan as
JSON, which is read once, at the process's first query. An injection point asks `fault(kind, **coords)` and acts only on a
match, which consumes one firing; so a fault at epoch 2 fires once, and
the epoch replayed after a rollback runs clean.

The kinds (`KINDS`, the JAX package's tuple) and their injection points:

    kind                 injection point             recovery exercised
    nan_grads            a train epoch's gradients   the finite guard skips
                         (train/loop.py; `epoch`,    the steps; the
                         fleets also `lane`)         trainer's rollback
    kill_mid_save        Checkpointer.save (`step`): the step is lost whole;
                         the write queued (async)    the manifest-less step
                         or committed before its     restores unverified;
                         manifest (sync); SIGKILL    resume continues bitwise
    corrupt_checkpoint   host-side byte flips:       sha256 manifest ->
    corrupt_artifact     ops.corrupt_checkpoint_step quarantine and restore's
                         / ops.corrupt_file          fallback; the registry
                                                     refuses the weights
    torn_jsonl           ops.tear_jsonl              the walk-forward
                                                     journal's .bak fallback
                                                     and the timeline
                                                     readers' tolerance of a
                                                     torn tail (obs/report,
                                                     obs/timeline)
    stream_fail          ChunkStream._produce        bounded retry with
    stream_stall         (`chunk`; data/stream.py)   backoff; `delay_s` of
                                                     latency for a stall
    serve_cold_fail      ModelRegistry.get, a        the cold start's bounded
                         tombstone's reload          retry with backoff
    serve_stall          ModelRegistry.score         the daemon's deadline
                         (`delay_s` of latency)      and circuit breaker
    serve_malformed      none: tests feed garbage    {"ok": false} answers
    kill_mid_append      PanelStore.append_panel,    the re-run overwrites
                         `step` 0 before the slab,   the orphan slab
                         1 before the manifest       (SIGKILL, chaos/ops.py)
    corrupt_append_slab  PanelStore.append_panel,    sha256 check before the
                         after the slab lands        manifest commit
    kill_mid_refit       WalkForwardOperator's       the journaled refit
                         refit stage, `step` 0       stage re-runs; the
                         before the fit, 1 after it  candidate's checkpoints
                         before the journal commit   resume the fit bitwise
    kill_between_admit_  ScoringDaemon.admit, after  a re-run re-admits the
    and_drain            the verdict, before the     same bytes and completes
                         alias flip (SIGKILL)        the flip
    fidelity_gate_reject ScoringDaemon.admit         the candidate is retired,
                         (`request` = the Nth        the incumbent serves on
                         admission) forces a reject
    kill_worker          WorkerPool's watcher tick   the router reroutes; the
                         (`request` = the worker's   watcher respawns the
                         index): SIGKILL a local     worker from the AOT store
                         worker                      on the same port
    kill_remote_worker   the same, for a pool-       the agent's cold re-join:
                         launched remote agent       verified downloads, then
                                                     re-registration

A plan that names any other kind is refused, never ignored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Iterator, List, Optional, Sequence

KINDS = (
    "nan_grads",
    "kill_mid_save",
    "corrupt_checkpoint",
    "corrupt_artifact",
    "torn_jsonl",
    "stream_fail",
    "stream_stall",
    "serve_cold_fail",
    "serve_stall",
    "serve_malformed",
    # walk-forward cycle stages (wf/)
    "kill_mid_append",
    "corrupt_append_slab",
    "kill_mid_refit",
    "kill_between_admit_and_drain",
    "fidelity_gate_reject",
    # the serving fleet (serve/pool.py)
    "kill_worker",
    "kill_remote_worker",
)
ENV_VAR = "FACTORVAE_CHAOS"

_COORDS = ("epoch", "step", "lane", "chunk", "request")


@dataclasses.dataclass
class Fault:
    """One injected fault. A coordinate of -1 matches anything; `times`
    bounds how many matching queries fire (-1: every one)."""

    kind: str
    epoch: int = -1
    step: int = -1
    lane: int = -1
    chunk: int = -1
    request: int = -1
    times: int = 1
    delay_s: float = 0.0
    rng_seed: int = 0
    path: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos fault kind {self.kind!r}; choose from {KINDS}")

    def matches(self, coords: dict) -> bool:
        """Every pinned coordinate must be present in the query and equal."""
        for k in _COORDS:
            pin = getattr(self, k)
            if pin != -1 and (k not in coords or int(coords[k]) != int(pin)):
                return False
        return True


class ChaosPlan:
    """Faults plus their consumption state; `find` is thread-safe and
    records each firing in `fired`."""

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.seed = int(seed)
        self._remaining = [f.times for f in self.faults]
        self.fired: List[dict] = []
        self._lock = threading.Lock()

    def find(self, kind: str, **coords) -> Optional[Fault]:
        """The first live fault of `kind` matching `coords`, consuming one
        firing; None otherwise."""
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.kind != kind or self._remaining[i] == 0 or not f.matches(coords):
                    continue
                if self._remaining[i] > 0:
                    self._remaining[i] -= 1
                self.fired.append({"kind": kind, **coords})
                return f
        return None

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [dataclasses.asdict(f) for f in self.faults]})

    @classmethod
    def from_json(cls, blob: str) -> "ChaosPlan":
        d = json.loads(blob)
        return cls([Fault(**f) for f in d.get("faults", [])], seed=int(d.get("seed", 0)))


_PLAN: Optional[ChaosPlan] = None
_ENV_CHECKED = False


def install(plan: Optional[ChaosPlan]) -> Optional[ChaosPlan]:
    """Install the process-wide plan (None: off); returns the previous one.
    An explicit install wins over the environment variable."""
    global _PLAN, _ENV_CHECKED
    prev, _PLAN = _PLAN, plan
    _ENV_CHECKED = True
    return prev


def current_plan() -> Optional[ChaosPlan]:
    """The installed plan; FACTORVAE_CHAOS is read once, at the first query
    of the process, if nothing was installed before."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        blob = os.environ.get(ENV_VAR)
        if blob:
            _PLAN = ChaosPlan.from_json(blob)
    return _PLAN


def fault(kind: str, **coords) -> Optional[Fault]:
    """The injection-point query: None unless a live matching fault is
    installed."""
    plan = current_plan()
    return None if plan is None else plan.find(kind, **coords)


@contextlib.contextmanager
def active(plan: ChaosPlan) -> Iterator[ChaosPlan]:
    """Install `plan` for the block; restore the previous plan, and re-arm
    the environment check, after."""
    global _ENV_CHECKED
    prev_checked = _ENV_CHECKED
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)
        _ENV_CHECKED = prev_checked
