"""Fleet stream collector — merge per-process RUN.jsonl streams onto
one clock (pillar 6, the transport half of obs/trace.py).

Every fleet process — router and each worker daemon — writes its own
RUN.jsonl whose span times are relative to its OWN `perf_counter`
origin (utils/logging.py `Timeline`). The timeline renderer works around this
inside one stream with per-process sections (`obs.timeline`
`span_sections`); a fleet makes the workaround untenable: a trace's
spans live in N files on M hosts, each on a different base. This module
solves it:

* **Transport** — router and workers expose ``GET /runstream?since=<n>``
  serving their RUN.jsonl tail from byte offset `n`, cut at the last
  newline (``obs/live.py tail_bytes`` — the torn-line follower
  contract over HTTP) with the resume offset in an ``X-Runstream-Next``
  response header. Polling with the returned offset is an incremental,
  idempotent tail-follow of a remote file.

* **Clock alignment** — the pool's health watcher already scrapes every
  worker's ``/healthz`` on an interval; that response now echoes the
  worker's timeline clock (``"mono"``, seconds on ITS base). The
  watcher wraps the scrape in local before/after stamps and logs a
  ``clock_probe`` mark ``{worker, remote_mono, local_t0, local_t1}``
  into the ROUTER's stream. Offset estimation is classic NTP-style:
  ``offset = (local_t0 + local_t1)/2 - remote_mono``, best probe = the
  minimum round trip (tightest bound on where inside the RTT the remote
  stamp landed). `estimate_offsets` keeps the min-RTT probe per worker;
  remote joins get a first probe from the `/register` handshake, so a
  worker is alignable as soon as it is routable.

* **Merge** — `merge_records` rebases every worker record's times
  (`t0`/`t1`/`t`) by its offset onto the router base, tags each record
  with its source process (``proc`` field, additive), and sorts by
  time. The output is one JSONL stream `obs.trace` renders trees from
  as if the fleet had been one process.

CLI::

    python -m factorvae_tpu_torch.obs.collect --router http://HOST:PORT \
        [--out MERGED.jsonl] [--since-file STATE.json]

A copy of `factorvae_tpu/obs/collect.py` (host Python over the same records,
so both readers give the same output on a stream); the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

#: mark name the pool/remote handshake probes log under
CLOCK_PROBE = "clock_probe"


def parse_lines(payload: str) -> List[dict]:
    """JSON records from a /runstream payload; blank/torn lines are
    impossible by the tail_bytes contract but tolerated anyway."""
    records = []
    for line in payload.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def fetch_runstream(base_url: str, since: int = 0,
                    timeout: float = 10.0) -> Tuple[List[dict], int]:
    """One /runstream poll against a fleet process. Returns (records,
    next_offset); pass `next_offset` back as `since` to tail."""
    url = f"{base_url.rstrip('/')}/runstream?since={int(since)}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        payload = resp.read().decode("utf-8", errors="replace")
        nxt = int(resp.headers.get("X-Runstream-Next", since))
    return parse_lines(payload), nxt


def fetch_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def estimate_offsets(router_records: Iterable[dict]) -> Dict[str, dict]:
    """Per-worker clock offset from `clock_probe` marks in the router
    stream: {worker_id: {"offset", "rtt", "probes"}}. The kept estimate
    is the minimum-RTT probe's midpoint offset — the probe whose
    round trip bounds the remote stamp tightest."""
    best: Dict[str, dict] = {}
    for rec in router_records:
        if rec.get("event") != "mark" or rec.get("name") != CLOCK_PROBE:
            continue
        wid = rec.get("worker")
        try:
            t0 = float(rec["local_t0"])
            t1 = float(rec["local_t1"])
            remote = float(rec["remote_mono"])
        except (KeyError, TypeError, ValueError):
            continue
        rtt = max(0.0, t1 - t0)
        offset = (t0 + t1) / 2.0 - remote
        cur = best.get(wid)
        if cur is None:
            best[wid] = {"offset": offset, "rtt": rtt, "probes": 1}
        else:
            cur["probes"] += 1
            if rtt < cur["rtt"]:
                cur["offset"], cur["rtt"] = offset, rtt
    return best


def rebase(rec: dict, offset: float, proc: str) -> dict:
    """Copy of `rec` with its timeline times shifted onto the collector
    base and a `proc` source tag. Wall-clock `ts` is left alone — it
    was never a usable cross-process axis and stays what the writer
    wrote."""
    out = dict(rec)
    for key in ("t0", "t1", "t"):
        if key in out and isinstance(out[key], (int, float)):
            out[key] = round(float(out[key]) + offset, 6)
    out["proc"] = proc
    return out


def merge_records(router_records: List[dict],
                  worker_records: Dict[str, List[dict]],
                  offsets: Optional[Dict[str, dict]] = None) -> List[dict]:
    """One stream on the router clock: router records pass through
    (offset 0, proc="router"); each worker's records shift by its
    estimated offset. Workers with no probe yet merge unshifted but
    tagged `aligned=False` so a renderer can refuse to compare their
    times. Sorted by timeline time (run_meta headers first)."""
    if offsets is None:
        offsets = estimate_offsets(router_records)
    merged = [rebase(r, 0.0, "router") for r in router_records]
    for wid, records in worker_records.items():
        est = offsets.get(wid)
        for rec in records:
            out = rebase(rec, est["offset"] if est else 0.0, wid)
            if est is None:
                out["aligned"] = False
            merged.append(out)

    def key(rec: dict) -> tuple:
        t = rec.get("t0", rec.get("t"))
        return (0, 0.0) if t is None else (1, float(t))

    merged.sort(key=key)
    return merged


def discover_workers(router_url: str, timeout: float = 10.0) -> Dict[str, str]:
    """{worker_id: base_url} for routable workers, from router /stats."""
    stats = fetch_json(f"{router_url.rstrip('/')}/stats", timeout=timeout)
    pool = stats.get("pool", stats)
    out = {}
    for w in pool.get("workers", ()):
        if w.get("state") in ("ok", "degraded") and w.get("url"):
            out[w["worker_id"]] = w["url"]
    return out


def collect_fleet(router_url: str,
                  since: Optional[Dict[str, int]] = None,
                  timeout: float = 10.0,
                  ) -> Tuple[List[dict], Dict[str, int]]:
    """One collection sweep over a live fleet: pull the router's tail,
    discover workers, pull each worker's tail, align and merge. `since`
    maps process id -> byte offset from the previous sweep (mutated
    copy returned), so repeated sweeps are an incremental tail-follow
    of the whole fleet."""
    since = dict(since or {})
    router_records, since["router"] = fetch_runstream(
        router_url, since.get("router", 0), timeout=timeout)
    worker_records: Dict[str, List[dict]] = {}
    for wid, url in discover_workers(router_url, timeout=timeout).items():
        try:
            worker_records[wid], since[wid] = fetch_runstream(
                url, since.get(wid, 0), timeout=timeout)
        except OSError:
            continue   # worker died between discovery and pull — next sweep
    return merge_records(router_records, worker_records), since


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.collect",
        description="Merge a serving fleet's RUN.jsonl streams onto one "
                    "clock (trace plane transport, docs/observability.md "
                    "pillar 6).")
    p.add_argument("--router", required=True,
                   help="router base URL, e.g. http://127.0.0.1:8700")
    p.add_argument("--out", default=None,
                   help="write merged JSONL here (default: stdout)")
    p.add_argument("--since-file", default=None,
                   help="JSON file persisting per-process offsets across "
                        "invocations (incremental collection)")
    p.add_argument("--timeout", type=float, default=10.0)
    args = p.parse_args(argv)

    since: Dict[str, int] = {}
    if args.since_file:
        try:
            with open(args.since_file) as fh:
                since = {k: int(v) for k, v in json.load(fh).items()}
        except (OSError, ValueError):
            since = {}
    try:
        merged, since = collect_fleet(args.router, since=since,
                                      timeout=args.timeout)
    except OSError as e:
        print(f"error: cannot reach fleet at {args.router}: {e}",
              file=sys.stderr)
        return 2
    out_fh = open(args.out, "a") if args.out else sys.stdout
    try:
        for rec in merged:
            out_fh.write(json.dumps(rec) + "\n")
    finally:
        if args.out:
            out_fh.close()
    if args.since_file:
        with open(args.since_file, "w") as fh:
            json.dump(since, fh)
    print(f"collected {len(merged)} record(s) from "
          f"{len(set(r.get('proc') for r in merged))} process(es)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
