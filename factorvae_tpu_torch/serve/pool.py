"""Worker fleet: N scoring daemons behind one control plane
(`factorvae_tpu/serve/pool.py`).

The pool spawns N `python -m factorvae_tpu_torch.serve --http PORT
--scheduler` processes (fork + exec through `subprocess.Popen`: never a
`multiprocessing` fork of a process that may hold a CUDA context), keeps
them healthy and gives the router (`serve/router.py`) its worker table. On
one card each worker is its own process with its own CUDA context; the
card time-slices between them, so what a pool buys there is host
parallelism: one interpreter, one tick thread and one response path per
worker.

**Warm joins.** Every worker of a checkout shares the kernel libraries of
`factorvae_tpu_torch/_build/`, or of the `compile_cache` directory the pool
hands each worker (`--compile_cache`): worker 0 builds what is missing, and
a later worker loads them, so its `/metrics` scrapes `compile 0,
compile_cached > 0` (`_build` serialises check-then-build with a lock file,
so two processes that miss one library build it once). On top, the pool
pre-exports every admitted weights directory into an **AOT store**
(`AotStore`: one `eval/export_aot.py` artifact per alias, atomic tmp +
rename, a digest sidecar): a respawned worker admits the artifacts, with
no weights directory read. The export runs in this process on the CPU; the
pool process never builds a panel and never touches the card.

**Lifecycle.** `start()` raises worker 0, reads the panel width off its
`/stats`, pre-exports the store, then raises the rest. A watcher thread
polls each worker: process death respawns it from the store on the same
port (the router's table stays stable) and replays the fan-out admits;
`/healthz` sets the ok / degraded / failing state the router routes on.
`stop()` fans SIGTERM out (each daemon drains its tick in flight), then
reaps. The chaos kinds `kill_worker` and `kill_remote_worker` (`request` =
the worker's index) SIGKILL a worker from the watcher tick.

**Admit fan-out.** `admit_fanout(payload)` refreshes the store from the
candidate weights directory, then POSTs `/admit` to each worker in turn;
a respawned worker replays the log, so a crash never brings yesterday's
incumbent back.

**Remote workers.** A worker on another host registers over HTTP (the
router's `POST /register`, `adopt_remote`) with a capability digest that
must match the store's; the store doubles as a content-addressed artifact
service (`manifest`, `capability_digest`, `blob_path`: the router's `GET
/artifacts` and `GET /artifact/<sha256>`) from which a cold host joins
(`serve/remote.py`). `launch_remote` starts such an agent on this host.
`scale_up` / `scale_down` are the autoscaler's actuators and
`rolling_upgrade` respawns the fleet one worker at a time.

Locking: `self._lock` guards the worker table, the counters and the admit
log; scrapes, spawns and exports run outside it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

from factorvae_tpu_torch.chaos import fault as chaos_fault
from factorvae_tpu_torch.utils.logging import timeline_event, timeline_now


class PoolError(RuntimeError):
    """A pool-level failure with a one-line message."""


def http_json(url: str, payload: Optional[dict] = None, timeout: float = 30.0):
    """One JSON round trip (POST with `payload`, else GET). An HTTP error
    whose body is JSON (a 503 health answer, a shed) is returned; only a
    transport failure or a non-JSON error body raises."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        try:
            return json.loads(body)
        except ValueError:
            raise PoolError(f"{url} answered HTTP {e.code}: {body[:200]}") from None


def http_text(url: str, timeout: float = 30.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def http_bytes(url: str, timeout: float = 600.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def file_sha256(path: str) -> str:
    """Streamed sha256 of a file: the content address an artifact is served
    and verified under."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


class AotStore:
    """Disk store of serving artifacts, one per alias: `<root>/<alias>` is an
    `eval/export_aot.py` artifact whose file name is the alias a worker
    admits it under (the alias the weights directory would have had). A
    `<alias>.meta.json` sidecar records the exported weights' digest, n_max
    and the file's sha256, so an unchanged directory exports nothing.
    `platform` is the device the artifacts are for (the workers').

    Content addressing: `manifest()` lists every alias with its sha256,
    `capability_digest()` is one digest over the (alias, sha256) pairs, and
    `blob_path(sha256)` resolves an address to a file: the router serves
    these as `GET /artifacts` and `GET /artifact/<sha256>`."""

    def __init__(self, root: str, platform: str = "cuda"):
        self.root = os.path.abspath(root)
        self.platform = platform
        os.makedirs(self.root, exist_ok=True)
        self._sha_cache: dict = {}     # (alias, mtime, size) -> sha256
        self._sha_lock = threading.Lock()

    def path_for(self, alias: str) -> str:
        return os.path.join(self.root, alias)

    def has(self, alias: str) -> bool:
        return os.path.isfile(self.path_for(alias))

    def aliases(self) -> List[str]:
        return sorted(n for n in os.listdir(self.root)
                      if not n.endswith((".meta.json", ".tmp"))
                      and os.path.isfile(os.path.join(self.root, n)))

    def export_checkpoint(self, path: str, n_max: int) -> str:
        """Export one weights directory as an f32 artifact at width `n_max`
        (on the CPU, for `platform`); returns its path. Nothing is exported
        when the sidecar's weights digest and n_max match. Atomic: a killed
        export never leaves a torn artifact."""
        from factorvae_tpu_torch.eval.export_aot import export_prediction
        from factorvae_tpu_torch.models.factorvae import load_model
        from factorvae_tpu_torch.serve.registry import _digest, checkpoint_config

        path = os.path.abspath(path)
        alias = os.path.basename(path)
        config = checkpoint_config(path)
        model = load_model(config, checkpoint_path=path, device="cpu")
        digest = _digest(model.state_dict())
        out = self.path_for(alias)
        meta_path = out + ".meta.json"
        try:
            with open(meta_path) as fh:
                prior = json.load(fh)
        except (OSError, ValueError):
            prior = {}
        if (prior.get("digest") == digest and prior.get("n_max") == int(n_max)
                and prior.get("platform") == self.platform and os.path.isfile(out)):
            return out
        blob = export_prediction(model, config, n_max=int(n_max), platform=self.platform)
        tmp = out + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, out)
        _write_json(meta_path, {"digest": digest, "n_max": int(n_max), "source": path,
                                "platform": self.platform,
                                "sha256": hashlib.sha256(blob).hexdigest()})
        timeline_event("aot_export", cat="serve", resource="pool", alias=alias,
                       n_max=int(n_max), bytes=len(blob))
        return out

    def adopt_artifact(self, path: str) -> str:
        """Copy an artifact file into the store under its alias (its name)."""
        path = os.path.abspath(path)
        out = self.path_for(os.path.basename(path))
        if out != path:
            tmp = out + ".tmp"
            shutil.copyfile(path, tmp)
            os.replace(tmp, out)
        return out

    def sha256_for(self, alias: str) -> str:
        """The alias' content address, cached by (mtime, size) and kept in
        the sidecar, so an unchanged artifact is hashed once."""
        path = self.path_for(alias)
        st = os.stat(path)
        key = (alias, st.st_mtime_ns, st.st_size)
        with self._sha_lock:
            sha = self._sha_cache.get(key)
        if sha:
            return sha
        meta_path = path + ".meta.json"
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
            fresh = os.stat(meta_path).st_mtime_ns >= st.st_mtime_ns
        except (OSError, ValueError):
            meta, fresh = {}, False
        sha = meta.get("sha256")
        if not (sha and fresh):
            sha = file_sha256(path)
            _write_json(meta_path, {**meta, "sha256": sha})
        with self._sha_lock:
            self._sha_cache[key] = sha
        return sha

    def manifest(self) -> List[dict]:
        """Every alias with its sha256, size and exported n_max: the body of
        `GET /artifacts`."""
        out = []
        for alias in self.aliases():
            path = self.path_for(alias)
            try:
                try:
                    with open(path + ".meta.json") as fh:
                        meta = json.load(fh)
                except (OSError, ValueError):
                    meta = {}
                out.append({"alias": alias, "sha256": self.sha256_for(alias),
                            "bytes": os.path.getsize(path), "n_max": meta.get("n_max")})
            except OSError:
                continue   # replaced mid-scrape: the next scrape sees it
        return out

    def capability_digest(self) -> str:
        """One digest over the sorted (alias, sha256) pairs: the fleet's
        artifact-set identity, which a registering worker must present."""
        lines = sorted(f"{m['alias']} {m['sha256']}" for m in self.manifest())
        return hashlib.sha256("\n".join(lines).encode()).hexdigest()

    def blob_path(self, sha256: str) -> Optional[str]:
        """The artifact file whose content address is `sha256`, or None."""
        for alias in self.aliases():
            try:
                if self.sha256_for(alias) == sha256:
                    return self.path_for(alias)
            except OSError:
                continue
        return None


class Worker:
    """One worker slot; its fields change under the pool's lock. `kind` is
    "local" (a daemon the pool spawned) or "remote" (one that registered over
    HTTP; `proc` is its agent when the pool launched it, else None, and then
    scrapes are its only liveness signal)."""

    def __init__(self, index: int, port: int, log_path: str, host: str = "127.0.0.1",
                 kind: str = "local"):
        self.index = index
        self.kind = kind
        self.wid = f"w{index}" if kind == "local" else f"r{index}"
        self.host = host
        self.port = port
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.cmd: Optional[list] = None          # a remote agent's respawn command
        self.capability: Optional[str] = None
        self.state = "starting"   # starting|ok|degraded|failing|dead|draining|upgrading
        self.restarts = 0
        self.fails = 0            # consecutive scrape failures
        self.last_health: Optional[dict] = None
        self.admits_replayed = 0
        self.respawn_source: Optional[str] = None   # aot_store|specs|artifact_service

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def describe(self) -> dict:
        return {"worker_id": self.wid, "kind": self.kind, "host": self.host,
                "port": self.port, "url": self.url, "state": self.state,
                "pid": self.proc.pid if self.proc else None, "restarts": self.restarts,
                "respawn_source": self.respawn_source, "capability": self.capability,
                "healthz": f"{self.url}/healthz", "metrics": f"{self.url}/metrics",
                "stats": f"{self.url}/stats", "health": self.last_health,
                "log": self.log_path}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _terminate(proc: subprocess.Popen, timeout: float) -> None:
    """SIGTERM (the daemon's drain), SIGKILL after `timeout`, then reap."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


class WorkerPool:
    """Spawn, heal and drain N `python -m factorvae_tpu_torch.serve` workers.

    `model_specs` are the daemon's `--model` arguments (weights directories
    or artifact files), `dataset_args` its panel arguments (`["--dataset",
    p]` or `["--synthetic", "D,S"]`), `extra_args` pass through. `device` is
    the workers' `--device` and the store's platform. A `cpu` worker runs
    with one OpenMP and one MKL thread, so N workers divide the host instead
    of each taking every core; a `cuda` worker gets no such setting.
    `tick_ms` / `max_tick_batch` set each worker's scheduler (None: its
    default). Every worker warms its models before it serves."""

    #: consecutive scrape failures before a live worker counts as failing
    SCRAPE_FAILS_FAILING = 3
    #: seconds a starting worker has to answer /healthz
    START_TIMEOUT_S = 600.0

    def __init__(self, model_specs: Sequence[str], dataset_args: Sequence[str],
                 n_workers: int, store_dir: str, work_dir: Optional[str] = None,
                 device: str = "cuda", extra_args: Sequence[str] = (),
                 tick_ms: Optional[float] = None, max_tick_batch: Optional[int] = None,
                 metrics_base: Optional[str] = None, health_interval_s: float = 0.5,
                 compile_cache: Optional[str] = None):
        if n_workers < 1:
            raise PoolError("a pool needs at least 1 worker")
        self.model_specs = [os.path.abspath(m) for m in model_specs]
        self.dataset_args = list(dataset_args)
        self.device = device
        self.store = AotStore(store_dir, platform=device.split(":")[0])
        self.work_dir = os.path.abspath(work_dir or tempfile.mkdtemp(prefix="serve_pool_"))
        os.makedirs(self.work_dir, exist_ok=True)
        self.extra_args = list(extra_args)
        self.tick_ms = tick_ms
        self.max_tick_batch = max_tick_batch
        self.metrics_base = metrics_base
        self.compile_cache = (compile_cache if compile_cache in (None, "off")
                              else os.path.abspath(compile_cache))
        self.health_interval_s = float(health_interval_s)
        worker_env = dict(os.environ)
        # workers run with cwd=work_dir: make this checkout importable
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        worker_env["PYTHONPATH"] = repo + os.pathsep + worker_env.get("PYTHONPATH", "")
        if self.store.platform == "cpu":
            worker_env.setdefault("OMP_NUM_THREADS", "1")
            worker_env.setdefault("MKL_NUM_THREADS", "1")
        self.env = worker_env       # read-only after this
        self._lock = threading.Lock()
        self.workers: List[Worker] = [
            Worker(i, free_port(), os.path.join(self.work_dir, f"w{i}.log"))
            for i in range(int(n_workers))]
        self.n_max: Optional[int] = None
        self.respawns = 0
        self.kills = 0            # chaos kill_worker firings
        self.remote_kills = 0     # chaos kill_remote_worker firings
        self.remote_adopts = 0
        self.upgrades = 0
        self._next_index = int(n_workers)
        # the URL remote agents join through; set once the router listens
        self.router_url: Optional[str] = None
        self._admit_log: List[dict] = []
        self._draining = False
        self._watcher: Optional[threading.Thread] = None

    # ---- spawning --------------------------------------------------------

    def _serve_cmd(self, w: Worker) -> list:
        cmd = [sys.executable, "-m", "factorvae_tpu_torch.serve", "--http", str(w.port),
               "--scheduler", "--device", self.device, "--warmup"]
        if self.metrics_base:
            base, ext = os.path.splitext(self.metrics_base)
            cmd += ["--metrics_jsonl", f"{base}_{w.wid}{ext or '.jsonl'}"]
        if self.compile_cache is not None:
            cmd += ["--compile_cache", self.compile_cache]
        return cmd

    def _worker_cmd(self, w: Worker, models: Sequence[str]) -> list:
        cmd = self._serve_cmd(w)
        for m in models:
            cmd += ["--model", m]
        cmd += self.dataset_args
        if self.tick_ms is not None:
            cmd += ["--tick_ms", str(float(self.tick_ms))]
        if self.max_tick_batch is not None:
            cmd += ["--max_batch", str(int(self.max_tick_batch))]
        return cmd + self.extra_args

    def _respawn_models(self) -> tuple:
        """(models, source): the store's artifacts when it holds every alias,
        else the original specs (a death before the first export)."""
        aliases = [os.path.basename(m) for m in self.model_specs]
        if all(self.store.has(a) for a in aliases):
            return [self.store.path_for(a) for a in aliases], "aot_store"
        return list(self.model_specs), "specs"

    def _spawn(self, w: Worker, models: Sequence[str]) -> None:
        self._spawn_cmd(w, self._worker_cmd(w, models))

    def _spawn_cmd(self, w: Worker, cmd: Sequence[str]) -> None:
        """Start (or restart) one worker process; the handle lands under the
        lock, the spawn runs outside it."""
        log = open(w.log_path, "ab")
        try:
            proc = subprocess.Popen(list(cmd), stdout=log, stderr=log, env=self.env,
                                    cwd=self.work_dir)
        finally:
            log.close()   # the child holds its own descriptor
        with self._lock:
            w.proc = proc
            w.state = "starting"
            w.fails = 0
            w.admits_replayed = 0

    def _wait_healthy(self, workers: Sequence[Worker]) -> None:
        timeout_s = self.START_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        remaining = list(workers)
        while remaining and time.monotonic() < deadline:
            still = []
            for w in remaining:
                if w.proc is not None and w.proc.poll() is not None:
                    raise PoolError(f"worker {w.wid} died during startup "
                                    f"(rc={w.proc.returncode}); log tail:\n"
                                    f"{self.worker_log_tail(w)}")
                try:
                    health = http_json(w.url + "/healthz", timeout=2.0)
                except (OSError, ValueError, PoolError):
                    still.append(w)     # not listening yet
                    continue
                with self._lock:
                    w.last_health = health
                    w.state = "ok" if health.get("ok") else "failing"
                    # the strikes of its start-up scrapes are spent: one late
                    # refused scrape must not fail a worker that just came up
                    w.fails = 0
            remaining = still
            if remaining:
                time.sleep(0.2)
        if remaining:
            raise PoolError(f"worker(s) {', '.join(w.wid for w in remaining)} never "
                            f"answered /healthz within {timeout_s:.0f}s (logs under "
                            f"{self.work_dir})")

    def worker_log_tail(self, w: Worker, n: int = 2000) -> str:
        try:
            with open(w.log_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(0, fh.tell() - n))
                return fh.read().decode(errors="replace")
        except OSError:
            return "<no log>"

    def start(self) -> None:
        """Worker 0 first (it builds any missing kernel library), then the
        store's pre-export at the panel width worker 0 reports, then the
        rest of the fleet, which finds the libraries built."""
        with self._lock:
            ws = list(self.workers)
        self._spawn(ws[0], self.model_specs)
        self._wait_healthy(ws[:1])
        stats = http_json(ws[0].url + "/stats", timeout=30.0)
        self.n_max = int((stats.get("panel") or {}).get("n_max") or 0)
        self.pre_export()
        for w in ws[1:]:
            self._spawn(w, self.model_specs)
        if len(ws) > 1:
            self._wait_healthy(ws[1:])
        self._watcher = threading.Thread(target=self._watch, name="pool-watcher",
                                         daemon=True)
        self._watcher.start()

    def pre_export(self) -> List[str]:
        """Fill the store from the model specs: weights directories export,
        artifact files are copied in. A failure is logged, not fatal: the
        store speeds respawns up, and the specs stay the fallback."""
        done = []
        for spec in self.model_specs:
            try:
                if os.path.isdir(spec):
                    if not self.n_max:
                        raise PoolError("panel width unknown; start() reads it off "
                                        "worker 0's /stats before exporting")
                    done.append(self.store.export_checkpoint(spec, self.n_max))
                else:
                    done.append(self.store.adopt_artifact(spec))
            except Exception as e:   # noqa: BLE001 - the specs stay the fallback
                timeline_event("aot_export_failed", cat="serve", resource="pool",
                               spec=spec, error=str(e))
        return done

    # ---- the routing view --------------------------------------------------

    def healthy_ids(self) -> List[str]:
        with self._lock:
            return [w.wid for w in self.workers if w.state in ("ok", "degraded")]

    def worker(self, wid: str) -> Worker:
        with self._lock:
            for w in self.workers:
                if w.wid == wid:
                    return w
        raise PoolError(f"unknown worker {wid!r}")

    def note_failure(self, wid: str) -> None:
        """A forward to the worker failed: stop routing to it until the
        watcher's next scrape clears it or its death is confirmed."""
        with self._lock:
            for w in self.workers:
                if w.wid == wid:
                    w.fails += 1
                    if w.state in ("ok", "degraded"):
                        w.state = "failing"
                    return

    def stats(self) -> dict:
        with self._lock:
            return {"workers": [w.describe() for w in self.workers],
                    "healthy": sum(1 for w in self.workers
                                   if w.state in ("ok", "degraded")),
                    "remote": sum(1 for w in self.workers if w.kind == "remote"),
                    "respawns": self.respawns, "kills": self.kills,
                    "remote_kills": self.remote_kills,
                    "remote_adopts": self.remote_adopts, "upgrades": self.upgrades,
                    "admits_fanned_out": len(self._admit_log),
                    "aot_store": self.store.root, "device": self.device,
                    "n_max": self.n_max, "draining": self._draining}

    # ---- remote workers, scaling, upgrades ---------------------------------

    def adopt_remote(self, host: str, port: int,
                     capability: Optional[str] = None) -> Worker:
        """Adopt a worker that registered over HTTP. Its capability digest
        must match the store's: a worker serving another artifact set would
        answer with the wrong weights, which routing cannot detect.
        Idempotent by (host, port): a re-joining agent heals its slot."""
        expect = self.store.capability_digest()
        if capability is not None and expect and capability != expect:
            raise PoolError(
                f"remote worker {host}:{port} presented capability digest "
                f"{capability[:12]}… but the fleet serves {expect[:12]}…: it holds "
                "another artifact set; re-sync from GET /artifacts and register again")
        with self._lock:
            w = next((x for x in self.workers
                      if x.host == host and x.port == int(port)), None)
            rejoin = w is not None and w.state == "dead"
            if w is not None:
                if rejoin:
                    w.restarts += 1
                w.fails = 0
                w.state = "starting"
            else:
                idx = self._next_index
                self._next_index += 1
                w = Worker(idx, int(port), os.path.join(self.work_dir, f"r{idx}.log"),
                           host=host, kind="remote")
                self.workers.append(w)
                self.remote_adopts += 1
            w.capability = capability
            # a joining agent downloaded the current store, which every
            # fan-out refreshes first: it holds every promotion already
            w.admits_replayed = len(self._admit_log)
        # one scrape now makes it routable at once, and is the join's first
        # clock probe
        try:
            t0 = timeline_now()
            health = http_json(w.url + "/healthz", timeout=2.0)
            t1 = timeline_now()
        except (OSError, ValueError, PoolError):
            health = None
        if health is not None:
            with self._lock:
                w.last_health = health
                w.state = "ok" if health.get("ok") else "failing"
            self._log_clock_probe(w, health, t0, t1)
        timeline_event("remote_adopt", cat="serve", resource="pool", worker=w.wid,
                       host=host, port=int(port), rejoin=rejoin, state=w.state)
        return w

    def _retire(self, w: Worker, timeout: float = 30.0) -> None:
        """Drain-shaped removal: out of routing, SIGTERM, off the table."""
        with self._lock:
            w.state = "draining"
        if w.proc is not None:
            _terminate(w.proc, timeout)
        with self._lock:
            w.state = "dead"
            if w in self.workers:
                self.workers.remove(w)

    def deregister(self, wid: str) -> dict:
        """A graceful leave (`POST /deregister`); a pool-launched agent is
        terminated (its drain finishes the work in flight)."""
        self._retire(self.worker(wid))
        timeline_event("remote_deregister", cat="serve", resource="pool", worker=wid)
        return {"ok": True, "worker": wid}

    def launch_remote(self, router_url: Optional[str] = None, port: Optional[int] = None,
                      extra_args: Sequence[str] = (), wait_healthy: bool = False) -> Worker:
        """Start a joining agent on this host: `python -m factorvae_tpu_torch.serve
        --join <router>` downloads the artifact set, verifies every digest,
        serves it and registers itself, the protocol a remote host speaks.
        The slot exists up front, so the watcher owns the agent (kill ->
        respawn -> cold re-join)."""
        router_url = router_url or self.router_url
        if not router_url:
            raise PoolError("launch_remote needs the router's URL (set pool.router_url "
                            "once the router listens, or pass router_url=)")
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        w = Worker(idx, int(port or free_port()),
                   os.path.join(self.work_dir, f"r{idx}.log"), kind="remote")
        w.cmd = self._serve_cmd(w) + [
            "--join", router_url,
            "--aot_store", os.path.join(self.work_dir, f"r{idx}_store")] + list(extra_args)
        with self._lock:
            self.workers.append(w)
        self._spawn_cmd(w, w.cmd)
        timeline_event("remote_launch", cat="serve", resource="pool", worker=w.wid,
                       port=w.port)
        if wait_healthy:
            self._wait_healthy([w])
        return w

    def artifact_manifest(self) -> dict:
        """What a cold host needs to join (`GET /artifacts`): the artifacts
        with their addresses, the capability digest, and the panel and worker
        arguments the agents mirror."""
        return {"ok": True, "artifacts": self.store.manifest(),
                "capability_digest": self.store.capability_digest(),
                "dataset_args": list(self.dataset_args),
                "extra_args": list(self.extra_args), "n_max": self.n_max}

    def scale_up(self) -> Optional[Worker]:
        """One more worker: a joining agent when the router's URL is set,
        else a local daemon off the store. Blocks until it answers
        /healthz."""
        with self._lock:
            if self._draining:
                return None
        if self.router_url:
            w = self.launch_remote()
        else:
            with self._lock:
                idx = self._next_index
                self._next_index += 1
                w = Worker(idx, free_port(), os.path.join(self.work_dir, f"w{idx}.log"))
                self.workers.append(w)
            models, source = self._respawn_models()
            self._spawn(w, models)
            with self._lock:
                w.respawn_source = source
        self._wait_healthy([w])
        with self._lock:
            n_workers = len(self.workers)
        timeline_event("scale_up", cat="serve", resource="pool", worker=w.wid,
                       kind=w.kind, workers=n_workers)
        return w

    def scale_down(self, wid: Optional[str] = None) -> Optional[Worker]:
        """Retire one worker whose process this pool owns (the newest, or
        `wid`); never worker 0, which anchors n_max."""
        with self._lock:
            cands = [w for w in self.workers
                     if w.index != 0 and w.proc is not None
                     and w.state not in ("dead", "draining", "upgrading")]
            w = next((x for x in cands if x.wid == wid), None) if wid else (
                cands[-1] if cands else None)
            if w is None:
                return None
        self._retire(w)
        with self._lock:
            n_workers = len(self.workers)
        timeline_event("scale_down", cat="serve", resource="pool", worker=w.wid,
                       workers=n_workers)
        return w

    def rolling_upgrade(self) -> dict:
        """One worker at a time: out of routing ("upgrading", the watcher
        keeps off), SIGTERM (its drain answers the tick in flight), respawn
        from the same artifacts under the code now on disk, healthy before
        the next. An externally joined remote is skipped with a note; a
        worker that fails to come back stops the roll."""
        with self._lock:
            snapshot = [w for w in self.workers if w.state != "dead"]
        results = []
        for w in snapshot:
            if w.proc is None:
                results.append({"worker": w.wid, "ok": False,
                                "error": "externally joined remote worker; upgrade its "
                                         "agent from its own host"})
                continue
            t0 = time.monotonic()
            with self._lock:
                w.state = "upgrading"
            _terminate(w.proc, 60.0)
            if w.kind == "remote":
                self._spawn_cmd(w, w.cmd)
                source = "artifact_service"
            else:
                models, source = self._respawn_models()
                self._spawn(w, models)
            try:
                self._wait_healthy([w])
            except PoolError as e:
                results.append({"worker": w.wid, "ok": False, "error": str(e)})
                break
            with self._lock:
                w.restarts += 1
                w.respawn_source = source
                self.upgrades += 1
            wall = time.monotonic() - t0
            results.append({"worker": w.wid, "ok": True, "wall_s": round(wall, 3)})
            timeline_event("worker_upgraded", cat="serve", resource="pool", worker=w.wid,
                           wall_s=round(wall, 3), source=source)
        return {"ok": bool(results) and all(r.get("ok") for r in results),
                "workers": results}

    # ---- admit fan-out -----------------------------------------------------

    def admit_fanout(self, payload: dict, timeout: float = 600.0) -> dict:
        """Refresh the store from the candidate weights directory, then POST
        `/admit` to every worker in turn (each runs its own gate and alias
        flip). The admission is logged for respawns to replay; `ok` is the
        AND of the workers'."""
        payload = dict(payload)
        path = payload.get("path")
        if isinstance(path, str) and os.path.isdir(path) and self.n_max:
            try:
                self.store.export_checkpoint(path, self.n_max)
            except Exception as e:   # noqa: BLE001 - the workers admit from the path
                timeline_event("aot_export_failed", cat="serve", resource="pool",
                               spec=path, error=str(e))
        with self._lock:
            self._admit_log.append(payload)
            targets = [(w.wid, w.url) for w in self.workers]
        results = []
        for wid, url in targets:
            try:
                resp = http_json(url + "/admit", payload, timeout=timeout)
            except Exception as e:   # noqa: BLE001 - one worker's answer
                resp = {"ok": False, "error": str(e)}
            results.append({"worker": wid, **(resp or {})})
        with self._lock:
            for w in self.workers:
                w.admits_replayed = len(self._admit_log)
        ok = all(r.get("ok") for r in results)
        timeline_event("admit_fanout", cat="serve", resource="pool",
                       alias=payload.get("alias"), ok=ok, workers=len(results))
        return {"ok": ok, "alias": payload.get("alias", "prod"), "workers": results}

    def _replay_admits(self, w: Worker) -> None:
        """After a respawn, the fan-out admits since the worker's start, in
        order, so its aliases land on the fleet's generation."""
        with self._lock:
            todo = self._admit_log[w.admits_replayed:]
            already = w.admits_replayed
        for i, payload in enumerate(todo):
            try:
                http_json(w.url + "/admit", payload, timeout=600.0)
            except Exception as e:   # noqa: BLE001 - retried at the next scrape
                timeline_event("admit_replay_failed", cat="serve", resource="pool",
                               worker=w.wid, error=str(e))
                break
            with self._lock:
                w.admits_replayed = already + i + 1

    # ---- the watcher -------------------------------------------------------

    def _watch(self) -> None:
        """Respawn on death and scrape health, one pass per interval, until
        stop()."""
        while True:
            with self._lock:
                if self._draining:
                    return
                snapshot = list(self.workers)
            for w in snapshot:
                self._watch_one(w)
            time.sleep(self.health_interval_s)

    def _owned_elsewhere(self, w: Worker, proc) -> bool:
        """Under the lock: the slot left the table, is being drained or
        upgraded (scale_down, deregister, rolling_upgrade own it), or has
        another process than the one this pass looked at. The watcher
        neither respawns nor rewrites such a slot: its pass works from a
        snapshot that those may have changed meanwhile."""
        return (self._draining or w not in self.workers or w.proc is not proc
                or w.state in ("draining", "upgrading"))

    def _watch_one(self, w: Worker) -> None:
        with self._lock:
            proc, state = w.proc, w.state
            if self._owned_elsewhere(w, proc):
                return
        if proc is not None:
            kind = "kill_worker" if w.kind == "local" else "kill_remote_worker"
            if chaos_fault(kind, request=w.index) is not None:
                proc.kill()
                proc.wait(timeout=30)
                with self._lock:
                    if w.kind == "local":
                        self.kills += 1
                    else:
                        self.remote_kills += 1
                timeline_event(f"chaos_{kind}", cat="recovery", resource="pool",
                               worker=w.wid)
            if proc.poll() is not None:
                with self._lock:
                    if self._owned_elsewhere(w, proc):
                        return
                    w.state = "dead"
                    w.last_health = None
                    self.respawns += 1
                timeline_event("worker_dead", cat="recovery", resource="pool",
                               worker=w.wid, rc=proc.returncode)
                if w.kind == "remote":     # the agent re-joins cold, same port
                    self._spawn_cmd(w, w.cmd)
                    source = "artifact_service"
                else:
                    models, source = self._respawn_models()
                    self._spawn(w, models)
                with self._lock:
                    w.restarts += 1
                    w.respawn_source = source
                timeline_event("worker_respawn", cat="recovery", resource="pool",
                               worker=w.wid, source=source)
                return
        try:
            t0 = timeline_now()
            health = http_json(w.url + "/healthz", timeout=2.0)
            t1 = timeline_now()
        except (OSError, ValueError, PoolError):
            # strikes toward "failing"; an external remote (nothing to poll)
            # is dead after twice as many, and only re-registering heals it
            with self._lock:
                if self._owned_elsewhere(w, proc):
                    return
                w.fails += 1
                if w.fails >= self.SCRAPE_FAILS_FAILING and w.state != "starting":
                    w.state = "failing"
                if (w.proc is None and w.kind == "remote"
                        and w.fails >= 2 * self.SCRAPE_FAILS_FAILING):
                    w.state = "dead"
                    w.last_health = None
            return
        self._log_clock_probe(w, health, t0, t1)
        status = str(health.get("status", "failing"))
        with self._lock:
            if self._owned_elsewhere(w, proc):
                return
            w.fails = 0
            w.last_health = health
            w.state = status if status in ("ok", "degraded", "failing") else "failing"
            needs_replay = (w.restarts > 0 and w.state == "ok"
                            and w.admits_replayed < len(self._admit_log))
        if state == "starting" and w.restarts > 0:
            timeline_event("worker_recovered", cat="recovery", resource="pool",
                           worker=w.wid, restarts=w.restarts)
        if needs_replay:
            self._replay_admits(w)

    @staticmethod
    def _log_clock_probe(w: Worker, health: dict, t0: Optional[float],
                         t1: Optional[float]) -> None:
        """A clock-alignment sample: the worker's /healthz echoes its
        timeline clock (`mono`), bracketed by `t0`/`t1` on this process's."""
        mono = health.get("mono") if isinstance(health, dict) else None
        if (t0 is None or t1 is None or not isinstance(mono, (int, float))
                or isinstance(mono, bool)):
            return
        timeline_event("clock_probe", cat="serve", resource="pool", worker=w.wid,
                       remote_mono=float(mono), local_t0=t0, local_t1=t1)

    def scrape_metrics(self, w: Worker, timeout: float = 10.0) -> str:
        return http_text(w.url + "/metrics", timeout=timeout)

    # ---- shutdown ----------------------------------------------------------

    def stop(self, drain_timeout_s: float = 30.0) -> None:
        """SIGTERM every worker (each drains its tick in flight), SIGKILL the
        stragglers after the timeout, reap. The watcher stops first, so no
        draining worker is respawned. Idempotent."""
        with self._lock:
            self._draining = True
        if self._watcher is not None and self._watcher.is_alive():
            self._watcher.join(timeout=max(10.0, self.health_interval_s * 4))
        with self._lock:
            procs = [(w, w.proc) for w in self.workers if w.proc is not None]
        for _, proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + drain_timeout_s
        for w, proc in procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            with self._lock:
                w.state = "dead"
        if self._watcher is not None:
            # dead workers reset any call the watcher was blocked on
            if self._watcher.is_alive():
                self._watcher.join(timeout=30)
            if not self._watcher.is_alive():
                self._watcher = None
        timeline_event("pool_stop", cat="serve", resource="pool", workers=len(procs))
