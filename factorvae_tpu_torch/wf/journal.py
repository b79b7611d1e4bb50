"""Torn-write-tolerant cycle journal of the walk-forward operator
(`factorvae_tpu/wf/journal.py`).

One JSON document (`<run>_wf.json`) records every cycle's stage commits, so
a walk-forward run killed at any boundary resumes: a committed stage's
recorded result is reused verbatim, an uncommitted stage re-runs (every
stage can run again, `wf/operator.py`).

Durability:

- every save is tmp-write + fsync + atomic rename: a reader never sees a
  half-written journal, and a kill mid-save leaves the previous commit;
- before each rename the previous committed document is copied to
  `<path>.bak`, so damage to the main file (a torn write, the chaos kind
  `torn_jsonl`'s `ops.tear_jsonl`) costs one stage's re-run, not the run;
- a journal whose main and backup documents both fail to parse raises
  `JournalError` with a one-line message saying what to do; the operator
  never guesses at a cycle's state.

Schema:

    {"version": 1,
     "meta": {"incumbent_path": ...},          # operator facts
     "cycles": [
        {"id": "c00002", "done": false,
         "facts": {...},                       # begin_cycle kwargs
         "marks": {"refit_started": true},     # sub-stage markers
         "stages": {"append": {...}, "judge": {...}, ...}}]}
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

#: cycle stages, in execution order (wf/operator.py runs them in this
#: order and commits each exactly once per cycle)
STAGES = ("append", "judge", "refit", "promote", "verify")


class JournalError(RuntimeError):
    """Unusable journal state, with a one-line actionable message."""


class CycleJournal:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        # Transient, per-process: NEVER stored in the document (a
        # persisted flag would mark the journal damaged forever).
        self._recovered = False
        self._doc = self._load()

    # ---- durability ------------------------------------------------------

    def _load(self) -> dict:
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return {"version": 1, "meta": {}, "cycles": []}
        except ValueError:
            pass
        # Main document torn/corrupt: fall back to the previous commit.
        try:
            with open(self.path + ".bak") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            raise JournalError(
                f"cycle journal {self.path} is unreadable and no "
                f"usable {os.path.basename(self.path)}.bak exists; "
                f"move the damaged file aside to start a fresh run, or "
                f"restore the journal from backup") from None
        doc.setdefault("meta", {})
        self._recovered = True
        return doc

    def _save(self) -> None:
        if os.path.exists(self.path):
            # Keep the previous committed document reachable: read the
            # bytes that are on disk NOW and land them as .bak via the
            # same atomic-rename discipline.
            with open(self.path, "rb") as fh:
                prev = fh.read()
            bak_tmp = self.path + ".bak.tmp"
            with open(bak_tmp, "wb") as fh:
                fh.write(prev)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(bak_tmp, self.path + ".bak")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._doc, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    # ---- run-level facts -------------------------------------------------

    @property
    def recovered_from_backup(self) -> bool:
        """True only in the process that actually fell back to .bak —
        the next (healthy) load reports False again."""
        return self._recovered

    def get_meta(self, key: str, default: Any = None) -> Any:
        return self._doc.get("meta", {}).get(key, default)

    def set_meta(self, key: str, value: Any) -> None:
        self._doc.setdefault("meta", {})[key] = value
        self._save()

    # ---- cycles ----------------------------------------------------------

    def current(self) -> Optional[dict]:
        """The newest cycle record, or None on a fresh journal."""
        cycles = self._doc["cycles"]
        return cycles[-1] if cycles else None

    def open_cycle(self) -> Optional[dict]:
        """The newest cycle IF it is still in flight (the resume
        target), else None."""
        cur = self.current()
        return cur if cur is not None and not cur.get("done") else None

    def begin_cycle(self, cycle_id: str, **facts) -> dict:
        """Open a cycle (idempotent: re-beginning the open cycle with
        the same id resumes it; a different id while one is open is a
        caller bug and raises)."""
        cur = self.open_cycle()
        if cur is not None:
            if cur["id"] != cycle_id:
                raise JournalError(
                    f"cycle {cur['id']} is still open in {self.path} "
                    f"but the caller asked to begin {cycle_id!r}; "
                    f"finish or abandon the open cycle first")
            return cur
        cur = {"id": str(cycle_id), "done": False, "facts": dict(facts),
               "marks": {}, "stages": {},
               "started": round(time.time(), 3)}
        self._doc["cycles"].append(cur)
        self._save()
        return cur

    def committed(self, stage: str) -> Optional[dict]:
        """The open cycle's committed result for `stage`, or None."""
        if stage not in STAGES:
            raise JournalError(
                f"unknown stage {stage!r} (stages: {', '.join(STAGES)})")
        cur = self.open_cycle()
        return None if cur is None else cur["stages"].get(stage)

    def commit(self, stage: str, result: dict) -> dict:
        """Commit one stage's result to the open cycle (atomic rename;
        re-running a committed stage is the operator bug this API makes
        impossible to miss)."""
        if stage not in STAGES:
            raise JournalError(
                f"unknown stage {stage!r} (stages: {', '.join(STAGES)})")
        cur = self.open_cycle()
        if cur is None:
            raise JournalError(
                f"no open cycle in {self.path} to commit "
                f"stage {stage!r} to")
        if stage in cur["stages"]:
            raise JournalError(
                f"stage {stage!r} of cycle {cur['id']} is already "
                f"committed; committed stages are immutable")
        cur["stages"][stage] = dict(result, _ts=round(time.time(), 3))
        self._save()
        return cur["stages"][stage]

    def mark(self, key: str, value: Any = True) -> None:
        """Sub-stage marker on the open cycle (e.g. `refit_started`:
        set AFTER the candidate workspace is wiped, so a resume can
        tell a crashed refit-in-progress from a never-started one)."""
        cur = self.open_cycle()
        if cur is None:
            raise JournalError(
                f"no open cycle in {self.path} to mark {key!r} on")
        cur.setdefault("marks", {})[key] = value
        self._save()

    def marked(self, key: str) -> Any:
        cur = self.open_cycle()
        return None if cur is None else cur.get("marks", {}).get(key)

    def finish_cycle(self) -> dict:
        cur = self.open_cycle()
        if cur is None:
            raise JournalError(f"no open cycle in {self.path} to finish")
        missing = [s for s in STAGES if s not in cur["stages"]]
        if missing:
            raise JournalError(
                f"cycle {cur['id']} cannot finish with uncommitted "
                f"stage(s): {', '.join(missing)}")
        cur["done"] = True
        cur["finished"] = round(time.time(), 3)
        self._save()
        return cur

    def cycles(self) -> list:
        return list(self._doc["cycles"])
