"""Worker autoscaling from the router's own signals
(`factorvae_tpu/serve/autoscale.py`).

Every `interval_s` the loop reads `router.autoscale_signals()` (queue
depth, observed p99 against the declared SLO, healthy workers) and decides
up, down or nothing:

- **Up** when pressured: p99 above the SLO, queue depth above
  `queue_high_per_worker` x healthy, or fewer healthy workers than
  `min_workers`, for `up_after` consecutive ticks.
- **Down** when idle: queue depth at most `queue_low` and p99 under half
  the SLO (when one is declared), for `down_after` consecutive ticks; down
  is slower than up on purpose, since flapping costs cold joins.
- **Bounds.** Never below `min_workers` nor above `max_workers`, and
  `cooldown_s` after an action before the next.

`decide()` is pure (signals in, verdict out, plus the hysteresis counters);
`tick()` acts through `pool.scale_up` / `pool.scale_down`. One daemon
thread, paced by `Event.wait`, joined by `stop()`.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from factorvae_tpu_torch.utils.logging import timeline_event


class AutoScaler:
    """Scale `pool` between `min_workers` and `max_workers` from `router`'s
    signals. `start()` / `stop()` run the loop on a thread; `tick()` runs one
    read-decide-act round inline."""

    interval_s = 1.0             # seconds between ticks
    up_after = 2                 # consecutive pressured ticks before "up"
    down_after = 6               # consecutive idle ticks before "down"
    cooldown_s = 5.0             # after an action, before the next
    queue_high_per_worker = 4    # queue depth per healthy worker that pressures
    queue_low = 1                # queue depth at or under which the fleet idles

    def __init__(self, pool, router, min_workers: int = 1, max_workers: int = 4,
                 slo_ms: float = 0.0):
        self.pool = pool
        self.router = router
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.slo_ms = float(slo_ms)
        # the hysteresis counters: decide() runs on the loop thread while the
        # router's handler threads read describe() and metric_families()
        self._lock = threading.Lock()
        self._above = 0
        self._below = 0
        self._cooldown_ticks = 0
        self.ticks = 0
        self.ups = 0
        self.downs = 0
        self.last_decision: Optional[str] = None
        self.last_reason: str = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- policy (pure) ---------------------------------------------------

    def _slo(self, sig: dict) -> float:
        return float(sig.get("slo_ms") or self.slo_ms or 0.0)

    def _pressure(self, sig: dict) -> Tuple[bool, List[str]]:
        """Is the fleet pressured this tick, and why."""
        why = []
        healthy = int(sig.get("workers_healthy") or 0)
        queue = int(sig.get("queue_depth") or 0)
        p99, slo = sig.get("p99_ms"), self._slo(sig)
        if healthy < self.min_workers:
            why.append(f"healthy {healthy} < min {self.min_workers}")
        if queue > self.queue_high_per_worker * max(1, healthy):
            why.append(f"queue {queue} > {self.queue_high_per_worker}/worker")
        if slo > 0 and p99 is not None and p99 > slo:
            why.append(f"p99 {p99:.1f}ms > SLO {slo:g}ms")
        return bool(why), why

    def _idle(self, sig: dict) -> bool:
        p99, slo = sig.get("p99_ms"), self._slo(sig)
        if int(sig.get("queue_depth") or 0) > self.queue_low:
            return False
        return not (slo > 0 and p99 is not None and p99 > 0.5 * slo)

    def decide(self, sig: dict) -> Optional[str]:
        """One tick of policy: "up", "down" or None, from `sig` and the
        hysteresis counters alone (no pool, router or clock)."""
        with self._lock:
            self.ticks += 1
            if self._cooldown_ticks > 0:
                self._cooldown_ticks -= 1
                self.last_decision, self.last_reason = None, "cooldown"
                return None
            total = int(sig.get("workers_total") or 0)
            pressured, why = self._pressure(sig)
            if pressured:
                self._above += 1
                self._below = 0
            elif self._idle(sig):
                self._below += 1
                self._above = 0
            else:
                self._above = self._below = 0
            if self._above >= self.up_after and total < self.max_workers:
                self._above = self._below = 0
                self._cooldown_ticks = self._cooldown_ratio()
                self.last_decision, self.last_reason = "up", "; ".join(why)
                return "up"
            if self._below >= self.down_after and total > self.min_workers:
                self._above = self._below = 0
                self._cooldown_ticks = self._cooldown_ratio()
                self.last_decision = "down"
                self.last_reason = (f"idle: queue <= {self.queue_low} for "
                                    f"{self.down_after} ticks")
                return "down"
            self.last_decision = None
            self.last_reason = "; ".join(why) if pressured else ""
            return None

    def _cooldown_ratio(self) -> int:
        if self.interval_s <= 0:
            return 0
        return max(0, int(round(self.cooldown_s / self.interval_s)))

    # ---- actuation -------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One read-decide-act round; returns the action taken."""
        sig = self.router.autoscale_signals()
        verdict = self.decide(sig)
        if verdict is None:
            return None
        try:
            done = self.pool.scale_up() if verdict == "up" else self.pool.scale_down()
        except Exception as e:   # noqa: BLE001 - the loop outlives one failed action
            timeline_event("autoscale_failed", cat="serve", resource="autoscaler",
                           action=verdict, error=str(e)[:200])
            return None
        if done is not None:
            with self._lock:
                if verdict == "up":
                    self.ups += 1
                else:
                    self.downs += 1
        timeline_event("autoscale", cat="serve", resource="autoscaler", action=verdict,
                       reason=self.last_reason, queue=sig.get("queue_depth"),
                       p99_ms=sig.get("p99_ms"), healthy=sig.get("workers_healthy"))
        return verdict

    # ---- loop ------------------------------------------------------------

    def start(self) -> None:
        # graftlint: disable=JGL009 a threading.Event: set/clear/wait take its own lock
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join it (an action in flight finishes first)."""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=60)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:   # noqa: BLE001 - one bad scrape stops nothing
                timeline_event("autoscale_tick_error", cat="serve",
                               resource="autoscaler", error=str(e)[:200])

    # ---- telemetry -------------------------------------------------------

    def describe(self) -> dict:
        with self._lock:
            return {"min_workers": self.min_workers, "max_workers": self.max_workers,
                    "slo_ms": self.slo_ms, "interval_s": self.interval_s,
                    "ticks": self.ticks, "ups": self.ups, "downs": self.downs,
                    "last_decision": self.last_decision, "last_reason": self.last_reason,
                    "pressured_ticks": self._above, "idle_ticks": self._below,
                    "cooldown_ticks": self._cooldown_ticks}

    def metric_families(self):
        """Exposition families for the router's /metrics."""
        from factorvae_tpu_torch.obs.metrics import PREFIX, metric_line

        with self._lock:
            ups, downs = self.ups, self.downs
        p = f"{PREFIX}_router_autoscale"
        return [(f"{p}_ups_total", "counter", "autoscaler scale-up actions",
                 [metric_line(f"{p}_ups_total", ups)]),
                (f"{p}_downs_total", "counter", "autoscaler scale-down actions",
                 [metric_line(f"{p}_downs_total", downs)]),
                (f"{p}_max_workers", "gauge", "autoscaler worker-count ceiling",
                 [metric_line(f"{p}_max_workers", self.max_workers)]),
                (f"{p}_min_workers", "gauge", "autoscaler worker-count floor",
                 [metric_line(f"{p}_min_workers", self.min_workers)])]
