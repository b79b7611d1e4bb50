"""Incremental panel store: append-only day slabs and a sha256 manifest
(`factorvae_tpu/data/append.py`).

A walk-forward loop adds one trading day per cycle. Re-writing the whole
history to add a day is slow, and a kill mid-write corrupts the one file the
run depends on. The store keeps the panel as a sequence of slabs instead:

    <dir>/MANIFEST.json          instruments, columns, ordered slab records
    <dir>/slabs/slab_00001.npz   values (I, D_s, C+1) float32,
                                 valid (D_s, I) bool, dates datetime64[D]

Dates are stored in their numpy dtype and read back in it, so they round-trip
exactly. (The JAX store writes pandas' `asi8`, microseconds under pandas 3,
and reads the numbers back as nanoseconds.)

Crash discipline, exercised by the chaos kinds `kill_mid_append` and
`corrupt_append_slab`:

- a slab lands by a tmp-write and an atomic rename, then is re-read and its
  sha256 checked against the bytes meant to be written, before the manifest
  commit; a mismatch removes the slab and raises `AppendError` with the
  manifest untouched;
- the manifest commits by a tmp-write and an atomic rename; a kill between
  the slab's rename and the manifest's leaves an orphan slab, which the
  re-run of the append overwrites;
- appending exactly the store's last slab again returns its record (the
  resume of a cycle); any other overlap is an error.

`load_panel` gives the whole history as one `Panel`; a consumer that holds
the previous panel takes only the new slab (`PanelDataset.extend_days`).
With a timeline installed, a committed slab is an `append_slab` mark and a
rejected one an `append_slab_rejected` mark.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import List, Optional

import numpy as np

from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.chaos import ops as chaos_ops
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.utils.logging import timeline_event

MANIFEST_NAME = "MANIFEST.json"
SLAB_DIRNAME = "slabs"


class AppendError(RuntimeError):
    """An append or a validation failed; the message says what to do."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _slab_bytes(piece: Panel) -> bytes:
    """One slab as npz bytes: uncompressed, fixed key order, so the same
    piece gives the same bytes."""
    buf = io.BytesIO()
    np.savez(buf, values=np.asarray(piece.values, np.float32),
             valid=np.asarray(piece.valid, bool),
             dates=np.asarray(piece.dates, "datetime64[D]"))
    return buf.getvalue()


def _read_slab(path: str):
    with np.load(path) as z:
        return z["values"], z["valid"], z["dates"]


def align_to_instruments(piece: Panel, instruments: np.ndarray) -> Panel:
    """`piece` on the instrument axis `instruments`: an instrument it lacks
    becomes an invalid NaN row; one the axis has never seen is refused (a
    wider cross-section means new padding and a retrain, not an append)."""
    store_inst = np.asarray(instruments)
    piece_inst = np.asarray(piece.instruments)
    unknown = sorted(set(piece_inst.tolist()) - set(store_inst.tolist()))
    if unknown:
        raise AppendError(
            f"appended panel brings {len(unknown)} instrument(s) the store has never "
            f"seen (first: {unknown[0]!r}); the cross-section axis is fixed at store "
            "creation: rebuild the store to widen it")
    if piece_inst.shape == store_inst.shape and (piece_inst == store_inst).all():
        return piece
    pos = {str(n): i for i, n in enumerate(piece_inst)}
    d, c = piece.num_days, piece.values.shape[-1]
    values = np.full((len(store_inst), d, c), np.nan, np.float32)
    valid = np.zeros((d, len(store_inst)), bool)
    for j, name in enumerate(store_inst):
        i = pos.get(str(name))
        if i is not None:
            values[j] = piece.values[i]
            valid[:, j] = piece.valid[:, i]
    return Panel(values=values, valid=valid, dates=piece.dates, instruments=store_inst)


class PanelStore:
    """Append-only slab store over one panel history (the module docstring
    has the layout and the crash discipline)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, MANIFEST_NAME)
        try:
            with open(path) as fh:
                self._manifest = json.load(fh)
        except FileNotFoundError:
            raise AppendError(f"no panel store at {self.directory} (missing "
                              f"{MANIFEST_NAME}); create one with "
                              "PanelStore.create(dir, panel)") from None
        except ValueError as e:
            raise AppendError(f"panel store manifest {path} is corrupt ({e}); the slabs "
                              "are intact: rebuild the manifest or restore it") from None

    @classmethod
    def create(cls, directory: str, panel: Panel) -> "PanelStore":
        """A store seeded with `panel` as slab 1. A store that holds data is
        refused; an empty one (a create killed between its manifest commit
        and the seed slab) is adopted and seeded."""
        directory = os.path.abspath(directory)
        if os.path.exists(os.path.join(directory, MANIFEST_NAME)):
            existing = cls(directory)
            if existing.generation > 0:
                raise AppendError(f"panel store already exists at {directory}; open it "
                                  "with PanelStore(dir) and append instead")
            existing.append_panel(panel)
            return existing
        os.makedirs(os.path.join(directory, SLAB_DIRNAME), exist_ok=True)
        manifest = {"version": 1, "instruments": [str(n) for n in panel.instruments],
                    "num_columns": int(panel.values.shape[-1]), "slabs": []}
        tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
        store = cls(directory)
        store.append_panel(panel)
        return store

    @property
    def generation(self) -> int:
        """Number of committed slabs."""
        return len(self._manifest["slabs"])

    @property
    def instruments(self) -> np.ndarray:
        return np.asarray(self._manifest["instruments"])

    @property
    def num_columns(self) -> int:
        """Feature columns + the label (fixed at creation)."""
        return int(self._manifest["num_columns"])

    @property
    def slabs(self) -> List[dict]:
        return list(self._manifest["slabs"])

    @property
    def num_days(self) -> int:
        return sum(int(s["num_days"]) for s in self._manifest["slabs"])

    @property
    def end_date(self) -> Optional[np.datetime64]:
        if not self._manifest["slabs"]:
            return None
        return np.datetime64(self._manifest["slabs"][-1]["end"], "D")

    def _slab_path(self, name: str) -> str:
        return os.path.join(self.directory, SLAB_DIRNAME, name)

    def _commit_manifest(self) -> None:
        path = os.path.join(self.directory, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._manifest, fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def append_panel(self, piece: Panel) -> dict:
        """Append `piece` as one new slab and return its manifest record,
        validated before the commit; `piece` equal to the last slab's days
        returns that slab's record."""
        piece = align_to_instruments(piece, self.instruments)
        if int(piece.values.shape[-1]) != self.num_columns:
            raise AppendError(f"appended panel has {piece.values.shape[-1]} columns; the "
                              f"store was created with {self.num_columns}: the feature "
                              "schema is fixed at store creation")
        if piece.num_days == 0:
            raise AppendError("appended panel has zero days")
        start, end = str(piece.dates[0]), str(piece.dates[-1])
        last_end = self.end_date
        if last_end is not None and piece.dates[0] <= last_end:
            last = self._manifest["slabs"][-1]
            if (start, end, piece.num_days) == (last["start"], last["end"], last["num_days"]):
                if _sha256_file(self._slab_path(last["name"])) != hashlib.sha256(
                        _slab_bytes(piece)).hexdigest():
                    raise AppendError(
                        f"re-appended days [{start}, {end}] differ from the committed "
                        f"slab {last['name']}: same dates, other bytes; the incoming "
                        "feed is not deterministic")
                return dict(last)
            raise AppendError(f"appended days start at {start} but the store already "
                              f"ends at {last_end}; appends must be strictly newer (or "
                              "exactly the final slab, for an idempotent resume)")

        name = f"slab_{self.generation + 1:05d}.npz"
        # killed before any byte lands: a re-run is a plain run
        if chaos.fault("kill_mid_append", step=0) is not None:
            chaos_ops.kill_now()
        data = _slab_bytes(piece)
        record = {"name": name, "num_days": int(piece.num_days), "start": start,
                  "end": end, "sha256": hashlib.sha256(data).hexdigest()}
        final = self._slab_path(name)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = final + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
        # killed between the slab's commit and the manifest's: the orphan
        # slab is overwritten by the re-run
        if chaos.fault("kill_mid_append", step=1) is not None:
            chaos_ops.kill_now()
        corrupt = chaos.fault("corrupt_append_slab")
        if corrupt is not None:
            chaos_ops.corrupt_file(final, rng_seed=corrupt.rng_seed)
        on_disk = _sha256_file(final)
        if on_disk != record["sha256"]:
            os.remove(final)
            timeline_event("append_slab_rejected", cat="recovery", resource="data",
                           slab=name, expected=record["sha256"], actual=on_disk)
            raise AppendError(
                f"slab {name} failed sha256 validation before commit (wrote "
                f"{record['sha256'][:12]}…, read back {on_disk[:12]}…); the slab was "
                "removed and the manifest is untouched: retry the append")
        self._manifest["slabs"].append(record)
        self._commit_manifest()
        timeline_event("append_slab", cat="data", resource="data", slab=name,
                       days=record["num_days"], start=record["start"], end=record["end"])
        return dict(record)

    def verify(self) -> Optional[str]:
        """None when every committed slab's bytes match its sha256, else a
        line naming the first that does not."""
        for rec in self._manifest["slabs"]:
            path = self._slab_path(rec["name"])
            if not os.path.exists(path):
                return f"slab missing: {rec['name']}"
            if _sha256_file(path) != rec["sha256"]:
                return f"sha256 mismatch: {rec['name']}"
        return None

    def load_slab(self, record: dict, verify: bool = True) -> Panel:
        """One slab as a Panel on the store's instrument axis."""
        path = self._slab_path(record["name"])
        if verify and _sha256_file(path) != record["sha256"]:
            raise AppendError(f"slab {record['name']} failed sha256 verification; the "
                              "store is damaged: restore the slab or rebuild from the "
                              "source feed")
        values, valid, dates = _read_slab(path)
        return Panel(values=values, valid=valid, dates=dates, instruments=self.instruments)

    def load_panel(self, verify: bool = False) -> Panel:
        """The whole history as one Panel (the slabs concatenated on the day
        axis); `verify=True` checks every slab's sha256 first."""
        if not self._manifest["slabs"]:
            raise AppendError(f"panel store {self.directory} is empty")
        if verify:
            bad = self.verify()
            if bad is not None:
                raise AppendError(f"panel store {self.directory} failed verification "
                                  f"({bad}); restore the slab or rebuild the store")
        pieces = [_read_slab(self._slab_path(r["name"])) for r in self._manifest["slabs"]]
        return Panel(values=np.concatenate([p[0] for p in pieces], axis=1),
                     valid=np.concatenate([p[1] for p in pieces], axis=0),
                     dates=np.concatenate([p[2] for p in pieces]),
                     instruments=self.instruments)
