"""Served-score drift monitors (`factorvae_tpu/obs/drift.py`).

The daemon watches the scores it answers with:

- a distribution digest per (model, day) (count, mean, std, min, max and
  quantiles of the finite cross-section), computed once per (model, day)
  and marked on the timeline as `score_digest`;
- the day-over-day rank correlation of a model's served cross-section
  against the previous day it served, paired by instrument. Below the
  model's threshold (with at least `min_overlap` pairs) it marks
  `score_drift`.

Host numpy only: the daemon digests the scores it already copied to the
host, and the scores are untouched.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from factorvae_tpu_torch.utils.logging import timeline_event

#: mark names this monitor emits (obs.report keys its flag on the
#: second one; obs/report.DRIFT_MARK_FLAGS references it)
DIGEST_MARK = "score_digest"
DRIFT_MARK = "score_drift"

_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


def score_digest(scores: np.ndarray) -> dict:
    """Distribution digest of one served cross-section (finite entries
    only; an all-NaN day digests honestly to n=0 + null moments)."""
    vals = np.asarray(scores, np.float64).reshape(-1)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return {"n": 0, "mean": None, "std": None, "min": None,
                "max": None,
                **{f"p{int(q * 100)}": None for q in _QUANTILES}}
    qs = np.quantile(vals, _QUANTILES)
    return {
        "n": int(vals.size),
        "mean": round(float(vals.mean()), 6),
        "std": round(float(vals.std()), 6),
        "min": round(float(vals.min()), 6),
        "max": round(float(vals.max()), 6),
        **{f"p{int(q * 100)}": round(float(v), 6)
           for q, v in zip(_QUANTILES, qs)},
    }


def rank_correlation(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """Spearman rank correlation of two paired score vectors (average
    ranks for ties — the same convention ops.stats.masked_spearman
    uses), or None when fewer than 3 finite pairs exist."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 3:
        return None
    a, b = a[ok], b[ok]

    def avg_rank(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        ranks = np.empty(x.size, np.float64)
        ranks[order] = np.arange(x.size, dtype=np.float64)
        # tie groups share their mean rank
        sx = x[order]
        i = 0
        while i < sx.size:
            j = i
            while j + 1 < sx.size and sx[j + 1] == sx[i]:
                j += 1
            if j > i:
                ranks[order[i:j + 1]] = (i + j) / 2.0
            i = j + 1
        return ranks

    ra, rb = avg_rank(a), avg_rank(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return None  # a constant ranking correlates with nothing
    c = float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / (sa * sb))
    return round(c, 6)


class ScoreDriftMonitor:
    """Per-model drift state over the daemon's served scores.

    `observe(model, day, names, scores)` is idempotent per
    (model, day): the first sighting computes the digest, pairs the
    cross-section with the model's previously-served day by instrument
    name, and (when enough names overlap) scores the day-over-day rank
    correlation — emitting the timeline marks and flipping `drifting`
    when it lands below `threshold`. Repeat sightings return the cached
    digest and emit nothing, so the request path pays once per scored
    day, not once per request."""

    def __init__(self, threshold: float = 0.5, min_overlap: int = 8):
        self.threshold = float(threshold)
        self.min_overlap = max(3, int(min_overlap))
        # model -> {"days": {day: digest}, "last_day", "last_scores"
        #           (name -> score), "last_corr", "drift_events"}
        self._models: Dict[str, dict] = {}
        # Per-model threshold overrides (the admit gate's policy):
        # `threshold` above is the daemon-wide default
        # (--drift_threshold); a model admitted with its own gate —
        # POST /admit's drift_threshold, or set_threshold — judges its
        # day-over-day correlation against that instead. The active
        # value is exposed per model on /stats and /metrics.
        self._thresholds: Dict[str, float] = {}
        # Guards the per-model state: observe()
        # runs on whatever thread answers scoring requests while
        # `GET /metrics` reads stats() — the LatencyHistogram pattern.
        self._lock = threading.Lock()

    def set_threshold(self, model: str,
                      threshold: Optional[float]) -> None:
        """Per-model drift threshold (None clears the override back to
        the monitor-wide default)."""
        with self._lock:
            if threshold is None:
                self._thresholds.pop(str(model), None)
            else:
                self._thresholds[str(model)] = float(threshold)

    def threshold_for(self, model: str) -> float:
        """The ACTIVE threshold for one model (override or default)."""
        with self._lock:
            return self._thresholds.get(str(model), self.threshold)

    def observe(self, model: str, day: int,
                names: Sequence[str], scores: np.ndarray,
                alias: Optional[str] = None) -> Optional[dict]:
        """Digest one served (model, day) cross-section; returns the
        digest (cached on repeats, None for empty cross-sections)."""
        with self._lock:
            return self._observe(model, day, names, scores, alias)

    def _observe(self, model: str, day: int,
                 names: Sequence[str], scores: np.ndarray,
                 alias: Optional[str]) -> Optional[dict]:
        st = self._models.setdefault(
            model, {"days": {}, "last_day": None, "last_scores": None,
                    "last_corr": None, "drift_events": 0})
        day = int(day)
        if day in st["days"]:
            return st["days"][day]
        vals = np.asarray(scores, np.float64).reshape(-1)
        digest = score_digest(vals)
        st["days"][day] = digest
        timeline_event(DIGEST_MARK, cat="serve", resource="serve",
                       model=model, alias=alias, day=day, **digest)
        by_name = {str(n): float(v) for n, v in zip(names, vals)}
        prev_day, prev = st["last_day"], st["last_scores"]
        # only a DIFFERENT day advances the day-over-day chain; it need
        # not be adjacent — the daemon sees whatever days clients ask
        # for, and the drift signal is "vs the last served day"
        if prev is not None and prev_day != day:
            common = sorted(set(by_name) & set(prev))
            if len(common) >= self.min_overlap:
                corr = rank_correlation(
                    np.array([by_name[n] for n in common]),
                    np.array([prev[n] for n in common]))
                if corr is not None:
                    st["last_corr"] = corr
                    threshold = self._thresholds.get(model,
                                                     self.threshold)
                    if corr < threshold:
                        st["drift_events"] += 1
                        timeline_event(
                            DRIFT_MARK, cat="serve", resource="serve",
                            model=model, alias=alias, day=day,
                            prev_day=prev_day, rank_corr=corr,
                            threshold=threshold,
                            n_common=len(common))
        # days can arrive out of order (backtest replays): the chain
        # follows ARRIVAL order — yesterday is "the day this model
        # served before this one", the serving-side contract
        st["last_day"], st["last_scores"] = day, by_name
        return digest

    # ---- read side -------------------------------------------------------

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def drifting(self, model: str) -> bool:
        """Current drift state: the model's latest day-over-day rank
        correlation landed below its ACTIVE threshold (False until a
        correlation exists). The walk-forward judge stage promotes this
        from alert to refit trigger."""
        with self._lock:
            st = self._models.get(str(model))
            if st is None or st["last_corr"] is None:
                return False
            threshold = self._thresholds.get(str(model), self.threshold)
            return st["last_corr"] < threshold

    def stats(self) -> dict:
        """Per-model drift summary for /stats and /metrics: digests,
        last correlation, drift-event count, the ACTIVE threshold and
        the current drift state."""
        out = {}
        with self._lock:
            for model, st in sorted(self._models.items()):
                threshold = self._thresholds.get(model, self.threshold)
                out[model] = {
                    "days_digested": len(st["days"]),
                    "last_day": st["last_day"],
                    "last_rank_corr": st["last_corr"],
                    "drift_events": st["drift_events"],
                    "threshold": threshold,
                    "drifting": bool(st["last_corr"] is not None
                                     and st["last_corr"] < threshold),
                }
        return out
