"""A remote worker's bootstrap: join a fleet from its artifact service
(`factorvae_tpu/serve/remote.py`).

A cold host runs

    python -m factorvae_tpu_torch.serve --join http://router:8800 --http 8787 --scheduler

and this module makes it a fleet member in three moves:

1. **Sync.** `GET /artifacts` lists every artifact as (alias, sha256,
   bytes); `fetch_artifact` downloads each from `GET /artifact/<sha256>`
   and verifies the digest before the bytes land under their final name
   (tmp + `os.replace`). A mismatch retries; exhausted retries raise
   `JoinError` with the observed and expected digests, and nothing corrupt
   is left on disk. An artifact already on disk that hashes right is kept,
   so a respawned agent re-joins warm.
2. **Mirror.** The manifest carries the fleet's panel and worker arguments;
   `prepare_join` applies them to the agent's namespace (flags the user gave
   win).
3. **Register.** Once the daemon's own `/healthz` answers,
   `register_when_healthy`'s thread POSTs `/register` with the host, port
   and the capability digest of what was materialized (the formula of
   `AotStore.capability_digest`); the pool refuses another digest.

Admission then checks the bytes once more: the registry re-hashes each
artifact against the digest it was fetched under.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict

from factorvae_tpu_torch.serve.pool import http_bytes, http_json
from factorvae_tpu_torch.utils.logging import timeline_event, timeline_now


class JoinError(RuntimeError):
    """The join failed in a way a retry will not fix."""


def fetch_manifest(router_url: str, timeout: float = 30.0) -> dict:
    """The fleet's `GET /artifacts` manifest."""
    try:
        man = http_json(router_url.rstrip("/") + "/artifacts", timeout=timeout)
    except (OSError, ValueError) as e:
        raise JoinError(f"cannot reach the fleet's artifact service at "
                        f"{router_url}/artifacts: {e}") from e
    if not (isinstance(man, dict) and man.get("ok") and isinstance(man.get("artifacts"), list)):
        raise JoinError(f"{router_url}/artifacts answered {str(man)[:200]}: not an "
                        "artifact manifest; is that a router port?")
    return man


def fetch_artifact(router_url: str, alias: str, sha256: str, dest_dir: str,
                   retries: int = 3, timeout: float = 600.0) -> str:
    """Download one artifact by content address into `dest_dir/<alias>`,
    verified before it lands under that name; returns the path."""
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, alias)
    if os.path.isfile(dest):
        with open(dest, "rb") as fh:
            if hashlib.sha256(fh.read()).hexdigest() == sha256:
                return dest        # a warm re-join
    url = router_url.rstrip("/") + "/artifact/" + sha256
    last = ""
    for attempt in range(max(1, int(retries))):
        try:
            blob = http_bytes(url, timeout=timeout)
        except (OSError, ValueError) as e:
            last = f"transfer failed: {e}"
            time.sleep(min(2.0, 0.2 * (attempt + 1)))
            continue
        got = hashlib.sha256(blob).hexdigest()
        if got != sha256:      # a torn or corrupt transfer: nothing touches disk
            last = f"digest mismatch: fetched bytes hash to {got[:12]}… not {sha256[:12]}…"
            timeline_event("join_refetch", cat="serve", resource="remote", alias=alias,
                           attempt=attempt, error=last)
            continue
        tmp = dest + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, dest)
        with open(dest + ".meta.json.tmp", "w") as fh:
            json.dump({"sha256": sha256, "source": url}, fh)
        os.replace(dest + ".meta.json.tmp", dest + ".meta.json")
        return dest
    raise JoinError(f"artifact {alias} ({sha256[:12]}…) could not be fetched from {url} "
                    f"after {retries} attempts ({last}); the agent serves no unverified "
                    "bytes: check the router's store and re-join")


def capability_digest(alias_to_sha: Dict[str, str]) -> str:
    """The digest over what this agent materialized, by the formula of
    `AotStore.capability_digest`."""
    lines = sorted(f"{a} {s}" for a, s in alias_to_sha.items())
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def prepare_join(args, parser) -> str:
    """Download every artifact (verified) into `args.aot_store` (a temporary
    directory when unset), point `--model` at them, mirror the fleet's panel
    and worker arguments (flags given on the command line win), and keep
    each path's expected digest for admission (`args._expected_sha256`).
    Returns the capability digest to register with."""
    import tempfile

    man = fetch_manifest(args.join)
    if not man["artifacts"]:
        raise JoinError(f"{args.join}/artifacts lists no artifacts: the fleet has "
                        "nothing to serve yet; start the pool with --model first")
    dest = args.aot_store or tempfile.mkdtemp(prefix="join_store_")
    args.aot_store = dest
    paths: Dict[str, str] = {}
    expected: Dict[str, str] = {}
    for a in man["artifacts"]:
        alias, sha = str(a.get("alias")), str(a.get("sha256"))
        p = fetch_artifact(args.join, alias, sha, dest)
        paths[alias] = p
        expected[p] = sha
    if not args.model:
        args.model = [paths[a] for a in sorted(paths)]
    args._expected_sha256 = expected
    argv = [str(x) for x in (man.get("extra_args") or [])]
    if not args.dataset and not args.synthetic:
        argv += [str(x) for x in (man.get("dataset_args") or [])]
    if argv:
        parser.parse_args(argv, namespace=args)
    if args.max_stocks is None and man.get("n_max"):
        args.max_stocks = int(man["n_max"])
    cap = capability_digest({a: expected[p] for a, p in paths.items()})
    fleet_cap = man.get("capability_digest")
    if fleet_cap and cap != fleet_cap:
        raise JoinError(f"materialized capability digest {cap[:12]}… does not match the "
                        f"fleet's {str(fleet_cap)[:12]}…: the manifest changed mid-sync; "
                        "re-join")
    timeline_event("join_synced", cat="serve", resource="remote", artifacts=len(paths),
                   capability=cap[:12], store=dest)
    return cap


def register_when_healthy(router_url: str, port: int, capability: str,
                          host: str = "127.0.0.1", timeout_s: float = 600.0
                          ) -> threading.Thread:
    """A daemon thread: wait for this worker's own /healthz, then POST
    /register to the router, retrying with backoff (the router may be
    restarting)."""

    def run() -> None:
        deadline = time.monotonic() + timeout_s
        me = f"http://127.0.0.1:{port}/healthz"
        while time.monotonic() < deadline:
            try:
                if http_json(me, timeout=2.0).get("ok"):
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        else:
            return
        backoff = 0.2
        while time.monotonic() < deadline:
            try:
                t0 = timeline_now()
                out = http_json(router_url.rstrip("/") + "/register",
                                payload={"host": host, "port": int(port),
                                         "capability": capability}, timeout=10.0)
                t1 = timeline_now()
            except (OSError, ValueError):
                out = None
            if isinstance(out, dict) and out.get("ok"):
                mono = out.get("mono")     # the router's clock: a reverse probe
                if (t0 is not None and t1 is not None and isinstance(mono, (int, float))
                        and not isinstance(mono, bool)):
                    timeline_event("clock_probe", cat="serve", resource="remote",
                                   worker="router", remote_mono=float(mono),
                                   local_t0=t0, local_t1=t1)
                timeline_event("join_registered", cat="serve", resource="remote",
                               host=host, port=int(port))
                return
            timeline_event("join_register_retry", cat="serve", resource="remote",
                           answer=str(out)[:200])
            time.sleep(backoff)
            backoff = min(5.0, backoff * 2)

    # graftlint: disable=JGL011 its only writes are timeline lines, appended one at a time under the logger's lock; the readers skip a torn last line
    t = threading.Thread(target=run, name="join-register", daemon=True)
    t.start()
    return t
