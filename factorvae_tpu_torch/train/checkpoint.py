"""Full-state checkpoints of a training run, with integrity and async saves
(`factorvae_tpu/train/checkpoint.py`).

One file per saved epoch, `<directory>/epoch_<n>.pt`, written to a temporary
name, fsynced and renamed, so a reader never sees half a file. It holds what
a resumed run needs to continue exactly: the model's and the optimizer's
state_dicts, the scheduler's position, the train step count, the noise
generator's state, a mixed run's loss scale and finite-step count (absent
on float32 runs), and a `meta` dict (epoch, best validation loss, config,
and `clean`: no bad signal at that epoch, so it may anchor a rollback). The
newest `keep` files stay; an epoch replayed after a rollback replaces its
file (and its manifest and any quarantine mark).

Integrity, as in the JAX package:

- every committed step gets a manifest, `<directory>/manifests/<n>.json`:
  the sha256 of its payload file, the bytes, the canonical config hash of
  the run that wrote it (`step_manifest`, `verify_manifest`);
- `restore` verifies the chosen step first. An implicit (latest) restore
  quarantines a corrupt step (`<directory>/quarantine/<n>.json`, a
  `ckpt_quarantine` timeline mark) and falls back to the next older step
  that verifies; an explicit `step=` raises `CheckpointIntegrityError`. A
  payload that fails to load is quarantined the same way. A step that
  retention evicted is "missing", never quarantined. A step without a
  manifest restores unverified;
- `all_steps`/`latest_step` leave quarantined steps out, and
  `verified_steps` checks every step eagerly (the fleet's group resume
  takes the largest step every lane has verified).

Saves are asynchronous when `async_save` (`train.async_checkpointing`, on
by default). `save()` takes a host snapshot at once (every tensor copied to
the CPU, so the caller may go on updating the state); a background thread
then serializes it, writes tmp + fsync + rename, and writes the manifest
after the commit. The barrier is on the read side: `latest_step`,
`all_steps`, `restore` and `close()` drain the queue first
(`wait_until_finished`). Synchronous saves write the same snapshot, so both
modes leave the same bytes. A kill mid-save (the chaos kind
`kill_mid_save`, fired where the JAX package fires it: the write enqueued,
or committed without its manifest) loses only that step; a committed step
without a manifest restores unverified. `save_seconds` and
`manifest_seconds` record, per save, the time the caller was blocked in
`save()` and the time the manifest's sha256 took.

Best-validation weights go through `params.save_weights`, which writes the
sibling manifest `<path>.manifest.json`; `verify_params_dir` checks it and
`serve.registry.ModelRegistry.register_checkpoint` refuses a directory that
fails. The weights are the float32 masters whatever the training dtype.
"""

from __future__ import annotations

import atexit
import hashlib
import io
import json
import os
import queue
import re
import threading
import time
import warnings
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.chaos import ops as chaos_ops
from factorvae_tpu_torch.config import config_hash
from factorvae_tpu_torch.train.state import TrainState
from factorvae_tpu_torch.utils.logging import timeline_event, timeline_span

MANIFEST_DIRNAME = "manifests"
QUARANTINE_DIRNAME = "quarantine"
PARAMS_MANIFEST_SUFFIX = ".manifest.json"
_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointIntegrityError(RuntimeError):
    """An explicitly requested step failed verification or would not load
    (the latest-step path never raises it: it quarantines and falls back)."""


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_json_atomic(path: str, obj) -> None:
    """`obj` as JSON at `path` by tmp-write + fsync + rename."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def step_manifest(root: str, names=None, cfg_hash: Optional[str] = None) -> dict:
    """The manifest of the files `names` under `root` (every file under
    `root` when None): sha256 per file (by path relative to `root`), total
    bytes, and the config hash of the run that wrote them."""
    if names is None:
        names = sorted(os.path.relpath(os.path.join(d, n), root)
                       for d, _, files in os.walk(root) for n in files)
    files, nbytes = {}, 0
    for rel in sorted(names):
        p = os.path.join(root, rel)
        files[rel] = sha256_file(p)
        nbytes += os.path.getsize(p)
    return {"config_hash": cfg_hash, "files": files, "nbytes": nbytes,
            "created": round(time.time(), 3)}


def verify_manifest(root: str, manifest: dict) -> Optional[str]:
    """None when every file of the manifest exists under `root` with its
    sha256; otherwise a line naming the first that does not."""
    for rel, digest in sorted((manifest.get("files") or {}).items()):
        p = os.path.join(root, rel)
        if not os.path.exists(p):
            return f"payload file missing: {rel}"
        if sha256_file(p) != digest:
            return f"sha256 mismatch: {rel}"
    return None


def _host(obj):
    """`obj` with every tensor copied to the CPU (a snapshot the caller's
    later updates cannot reach)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _snapshot(state: TrainState, meta: dict) -> dict:
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "generator": state.generator.get_state(),
        "step": state.step,
        "meta": meta,
    }
    if state.loss_scale is not None:
        payload["loss_scale"] = float(state.loss_scale)     # a float32 value
        payload["good_steps"] = int(state.good_steps)
    return _host(payload)


_LIVE: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _drain_all() -> None:
    """Finish every queued save before the interpreter exits."""
    for ck in list(_LIVE):
        try:
            ck.wait_until_finished()
        except Exception as e:  # noqa: BLE001 - exiting; the step is lost, as in a kill
            warnings.warn(f"a checkpoint write queued at exit failed: {e}")


class Checkpointer:
    """Per-epoch full-state checkpoints with manifests, quarantine and
    async saves (the module docstring has the layout and the semantics)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        self.async_save = bool(async_save)
        self.save_seconds: list = []         # per save: time blocked in save()
        self.manifest_seconds: list = []     # per committed step: the sha256 pass
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        _LIVE.add(self)

    # ---- paths -----------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_{int(step)}.pt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, MANIFEST_DIRNAME, f"{int(step)}.json")

    def _quarantine_path(self, step: int) -> str:
        return os.path.join(self.directory, QUARANTINE_DIRNAME, f"{int(step)}.json")

    def _committed(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    # ---- quarantine ------------------------------------------------------

    def is_quarantined(self, step: int) -> bool:
        return os.path.exists(self._quarantine_path(step))

    def quarantine(self, step: int, reason: str) -> None:
        """Mark a step corrupt: left out of the steps readers see from now
        on, never deleted (its bytes stay for inspection)."""
        os.makedirs(os.path.join(self.directory, QUARANTINE_DIRNAME), exist_ok=True)
        write_json_atomic(self._quarantine_path(step),
                          {"step": int(step), "reason": reason,
                           "ts": round(time.time(), 3)})
        timeline_event("ckpt_quarantine", cat="recovery", resource="checkpoint",
                       step=int(step), reason=reason)

    def quarantined_steps(self) -> list:
        qdir = os.path.join(self.directory, QUARANTINE_DIRNAME)
        try:
            return sorted(int(os.path.splitext(n)[0]) for n in os.listdir(qdir)
                          if n.endswith(".json"))
        except OSError:
            return []

    # ---- manifests -------------------------------------------------------

    def manifest(self, step: int) -> Optional[dict]:
        """The step's manifest, or None when none was written. A manifest
        that exists but does not parse raises: damage to the manifest fails
        the step, it does not demote it to unverified."""
        try:
            with open(self._manifest_path(step)) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return None

    def verify_step(self, step: int) -> Tuple[bool, Optional[str]]:
        """(ok, reason): not ok when quarantined, "missing" when the payload
        is absent (evicted or never committed), (True, "unverified") without
        a manifest, (True, None) when the payload matches its manifest."""
        if self.is_quarantined(step):
            return False, "quarantined"
        if not os.path.exists(self._path(step)):
            return False, "missing"
        try:
            manifest = self.manifest(step)
        except (OSError, ValueError) as e:
            return False, f"manifest unreadable: {e}"
        if manifest is None:
            return True, "unverified"
        bad = verify_manifest(self.directory, manifest)
        return (False, bad) if bad else (True, None)

    # ---- save ------------------------------------------------------------

    def save(self, step: int, state: TrainState, meta: dict) -> str:
        """Checkpoint `state` as step `step`: a host snapshot now, the write
        now (sync) or on the background thread (async)."""
        step = int(step)
        t0 = time.perf_counter()
        with timeline_span(f"ckpt_save_{step}", cat="checkpoint", resource="checkpoint",
                           step=step, mode="async" if self.async_save else "sync"):
            if step in self._pending_or_committed():
                # a replayed epoch: the replayed bytes are the ones that stay
                self.wait_until_finished()
                for stale in (self._path(step), self._manifest_path(step),
                              self._quarantine_path(step)):
                    try:
                        os.remove(stale)
                    except FileNotFoundError:
                        pass
            payload = _snapshot(state, meta)
            cfg = meta.get("config") if isinstance(meta, dict) else None
            job = (step, payload, config_hash(cfg) if isinstance(cfg, dict) else None)
            if self.async_save:
                self._enqueue(job)
            else:
                self._write(*job, manifest=False)
        # the window a commit protocol must survive: the write queued (async)
        # or committed without its manifest (sync)
        if chaos.fault("kill_mid_save", step=step) is not None:
            chaos_ops.kill_now()
        if not self.async_save:
            self._write_manifest(step, job[2])
            self._evict()
        self.save_seconds.append(time.perf_counter() - t0)
        return self._path(step)

    def _pending_or_committed(self) -> set:
        with self._queue.mutex:
            pending = {job[0] for job in self._queue.queue if job is not None}
        return pending | set(self._committed())

    def _enqueue(self, job) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                # graftlint: disable=JGL011 close() joins it and the atexit drain waits for every queued write; a write is tmp + fsync + rename, so a kill leaves no torn file
                self._worker = threading.Thread(target=self._run, daemon=True,
                                                name="ckpt-writer")
                self._worker.start()
            self._queue.put(job)

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                if self._error is None:
                    self._write(*job)
            except BaseException as e:    # noqa: BLE001 - re-raised at the barrier
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, payload: dict, cfg_hash: Optional[str],
               manifest: bool = True) -> None:
        os.makedirs(self.directory, exist_ok=True)
        buf = io.BytesIO()
        torch.save(payload, buf)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(buf.getbuffer())
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        if manifest:
            self._write_manifest(step, cfg_hash)
            self._evict()

    def _write_manifest(self, step: int, cfg_hash: Optional[str]) -> None:
        t0 = time.perf_counter()
        name = os.path.basename(self._path(step))
        doc = dict(step_manifest(self.directory, [name], cfg_hash), step=int(step))
        os.makedirs(os.path.join(self.directory, MANIFEST_DIRNAME), exist_ok=True)
        write_json_atomic(self._manifest_path(step), doc)
        with self._lock:
            self.manifest_seconds.append(time.perf_counter() - t0)

    def _evict(self) -> None:
        for old in self._committed()[:-self.keep]:
            for path in (self._path(old), self._manifest_path(old)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    # ---- read side: the barrier and verification --------------------------

    def wait_until_finished(self) -> None:
        """Drain the queued saves; a write that failed raises here."""
        if self._worker is not None:
            with timeline_span("ckpt_barrier", cat="checkpoint", resource="checkpoint"):
                self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"an async checkpoint write in {self.directory} "
                               f"failed: {err}") from err

    def all_steps(self) -> list:
        """Every retained committed, non-quarantined step, ascending."""
        self.wait_until_finished()
        bad = set(self.quarantined_steps())
        return [s for s in self._committed() if s not in bad]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verified_steps(self) -> list:
        """`all_steps` with every step verified now: a step that fails is
        quarantined; unverified (manifest-less) steps stay in."""
        out = []
        for s in self.all_steps():
            ok, reason = self.verify_step(s)
            if ok:
                out.append(s)
            else:
                self.quarantine(s, reason or "corrupt")
        return out

    def restore(self, state: TrainState, step: Optional[int] = None,
                verified: bool = False) -> dict:
        """Load step `step` (the newest verified one by default) into `state`
        in place and return its meta. `verified=True` skips the sha256 pass
        of an explicit step that `verified_steps` has just checked."""
        explicit = step is not None
        candidates = [int(step)] if explicit else list(reversed(self.all_steps()))
        if explicit:
            self.wait_until_finished()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        for s in candidates:
            ok, reason = (True, None) if (verified and explicit) else self.verify_step(s)
            if not ok:
                if reason == "missing":
                    if explicit:
                        raise FileNotFoundError(
                            f"no checkpoint step {s} in {self.directory} (evicted by "
                            f"retention or never committed; retained steps: "
                            f"{self._committed()})")
                    continue
                self.quarantine(s, reason or "corrupt")
                if explicit:
                    raise CheckpointIntegrityError(
                        f"checkpoint step {s} in {self.directory} failed integrity "
                        f"verification ({reason}); it is now quarantined: restore "
                        "another step or retrain")
                continue
            if reason == "unverified":
                timeline_event("ckpt_unverified", cat="checkpoint", resource="checkpoint",
                               step=s)
            try:
                payload = torch.load(self._path(s), map_location="cpu", weights_only=True)
            except Exception as e:      # noqa: BLE001 - fenced like any other damage
                self.quarantine(s, f"restore failed: {type(e).__name__}: {e}")
                if explicit:
                    raise CheckpointIntegrityError(
                        f"checkpoint step {s} in {self.directory} failed to load "
                        f"({type(e).__name__}: {e}); it is now quarantined: restore "
                        "another step or retrain") from e
                continue
            self._load(state, payload)
            return payload["meta"]
        raise FileNotFoundError(f"no verifiable checkpoint in {self.directory} (all "
                                f"retained steps quarantined: {self.quarantined_steps()})")

    @staticmethod
    def _load(state: TrainState, payload: dict) -> None:
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])
        if "loss_scale" in payload:
            state.loss_scale = np.float32(payload["loss_scale"])
            state.good_steps = int(payload["good_steps"])

    def close(self) -> None:
        """Drain the queued saves and stop the writer thread (a later save
        starts it again)."""
        try:
            self.wait_until_finished()
        finally:
            with self._lock:
                worker, self._worker = self._worker, None
            if worker is not None and worker.is_alive():
                self._queue.put(None)
                worker.join()


class RankZeroCheckpointer:
    """A `Checkpointer` shared by the ranks of a mesh: rank 0 holds the files
    and writes them (from its host snapshot: the ranks' states are bitwise
    equal), every rank calls the same methods in the same order, and what
    rank 0 reads (a step, a restored state, the error a restore raised) is
    broadcast so every rank continues from the same bytes. A barrier closes
    each save, so a rank never reads ahead of a file rank 0 is writing."""

    def __init__(self, ckpt: Optional[Checkpointer], world):
        self.ckpt = ckpt           # rank 0's; None on the other ranks
        self.world = world

    def _share(self, value):
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=self.world.ranks[0], group=self.world.group)
        return box[0]

    def save(self, step: int, state: TrainState, meta: dict) -> Optional[str]:
        import torch.distributed as dist

        out = self.ckpt.save(step, state, meta) if self.ckpt is not None else None
        if self.ckpt is not None:
            self.ckpt.wait_until_finished()
        dist.barrier(group=self.world.group)
        return out

    def latest_step(self) -> Optional[int]:
        return self._share(self.ckpt.latest_step() if self.ckpt is not None else None)

    def restore(self, state: TrainState, step: Optional[int] = None) -> dict:
        """Rank 0's `Checkpointer.restore`, its state and meta (or its
        exception) broadcast to every rank."""
        got = None
        if self.ckpt is not None:
            try:
                meta = self.ckpt.restore(state, step=step)
                got = ("ok", _snapshot(state, meta))
            except (FileNotFoundError, CheckpointIntegrityError) as e:
                got = ("error", (type(e).__name__, str(e)))
        kind, value = self._share(got)
        if kind == "error":
            raise {"FileNotFoundError": FileNotFoundError}.get(
                value[0], CheckpointIntegrityError)(value[1])
        if self.ckpt is None:
            Checkpointer._load(state, value)
        return value["meta"]

    def close(self) -> None:
        if self.ckpt is not None:
            self.ckpt.close()


# ---- best-validation weights ------------------------------------------------


def write_params_manifest(path: str) -> str:
    """The sibling manifest `<path>.manifest.json` of a weights directory
    (every file in it); returns the manifest's path."""
    path = os.path.abspath(path)
    out = path + PARAMS_MANIFEST_SUFFIX
    write_json_atomic(out, step_manifest(path))
    return out


def verify_params_dir(path: str) -> Optional[str]:
    """Check a weights directory against its sibling manifest: None when it
    matches or when there is no manifest (a directory written before
    manifests: unverifiable, not corrupt); a line naming the damage
    otherwise, a manifest that does not parse included."""
    path = os.path.abspath(path)
    try:
        with open(path + PARAMS_MANIFEST_SUFFIX) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        return f"manifest unreadable: {e}"
    return verify_manifest(path, manifest)


def save_params(directory: str, name: str, model: torch.nn.Module, config) -> str:
    """`params.save_weights` under `<directory>/<name>` (with its manifest)."""
    from factorvae_tpu_torch.params import save_weights

    return save_weights(model, config, os.path.join(os.path.abspath(directory), name))


def load_params(path: str) -> dict:
    """The state_dict of a weights directory (not verified; the registry
    verifies before it loads)."""
    from factorvae_tpu_torch.params import read_state_dict

    return read_state_dict(path)
