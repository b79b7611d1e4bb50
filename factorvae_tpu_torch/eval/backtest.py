"""Daily top-k/drop-n backtest on prediction scores
(`factorvae_tpu/eval/backtest.py`; numpy and pandas only).

The port's own copy of the JAX package's simulators, which stand in for the
reference notebook's qlib `TopkDropoutStrategy(topk=50, n_drop=10)` with
open/close costs of 5bp/15bp (backtest.ipynb cells 6-8):

- `topk_dropout_backtest`: the equal-weight screener. Each day it holds
  the `topk` best-scored names, swapping at most `n_drop` of the held ones
  for the best unheld; returns net and gross daily returns, turnover,
  cumulative and excess return and the max drawdown.
- `simulate_topk_account`: the account simulation of cell 6 (cash and
  positions from `account=1e8`, per-order `min_cost`, `limit_threshold`
  rejection, the 0.95 risk degree), whose report frame lets `risk_analysis`
  give cell 8's annualized excess-return table.

pandas is imported inside the functions, so importing this module (as the
CLI does only for `--backtest`) loads none. Run on an exported score CSV:

    python -m factorvae_tpu_torch.eval.backtest SCORES.csv \\
        [--labels panel.pkl] [--topk 50 --n_drop 10] [--plot out.png]
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    import pandas as pd


@dataclasses.dataclass
class BacktestResult:
    daily_return: pd.Series          # net of cost
    daily_return_wo_cost: pd.Series
    turnover: pd.Series              # traded fraction per day (one side)
    cumulative_return: float
    cumulative_return_wo_cost: float
    excess_return: Optional[float]
    excess_return_wo_cost: Optional[float]
    max_drawdown: float
    mean_turnover: float

    def summary(self) -> dict:
        return {
            "cumulative_return": self.cumulative_return,
            "cumulative_return_wo_cost": self.cumulative_return_wo_cost,
            "excess_return": self.excess_return,
            "excess_return_wo_cost": self.excess_return_wo_cost,
            "max_drawdown": self.max_drawdown,
            "mean_turnover": self.mean_turnover,
        }


def _max_drawdown(curve: np.ndarray) -> float:
    if not len(curve):
        return 0.0
    # include the initial capital of 1.0 so a drawdown from inception counts
    peak = np.maximum.accumulate(np.concatenate([[1.0], curve]))[1:]
    return float(np.min(curve / peak - 1.0))


def topk_dropout_backtest(
    scores: pd.DataFrame,
    score_col: str = "score",
    label_col: str = "LABEL0",
    topk: int = 50,
    n_drop: int = 10,
    open_cost: float = 0.0005,      # 5 bp  (backtest.ipynb cell 6)
    close_cost: float = 0.0015,     # 15 bp
    benchmark: Optional[pd.Series] = None,
) -> BacktestResult:
    """scores: (datetime, instrument)-indexed frame with a score column and
    a realized next-period return column (the LABEL0 the exporter merges,
    as notebook cell 5 does). `benchmark`: optional per-day benchmark
    returns indexed by datetime."""
    import pandas as pd

    df = scores.dropna(subset=[score_col, label_col])
    dates = df.index.get_level_values(0).unique().sort_values()

    held: set = set()
    rets, rets_wo, turns = [], [], []
    for date in dates:
        day = df.loc[date]
        ranked = day[score_col].sort_values(ascending=False)
        universe = list(ranked.index)
        if not held:
            new_held = set(universe[:topk])
        else:
            # currently-held names in today's score order (worst last);
            # `universe` is already ranked, so one filtered pass suffices
            alive_ranked = [s for s in universe if s in held]
            candidates = [s for s in universe if s not in held]
            n_swap = min(n_drop, len(candidates), len(alive_ranked))
            # refill slots lost to delisted/missing names, then swap n_drop
            keep = alive_ranked[: max(0, len(alive_ranked) - n_swap)]
            refill = topk - len(keep)
            new_held = set(keep) | set(candidates[:refill])
        buys = len(new_held - held)
        sells = len(held - new_held)
        turnover = buys / max(topk, 1)
        gross = float(day.loc[sorted(new_held), label_col].mean()) if new_held else 0.0
        cost = (buys * open_cost + sells * close_cost) / max(topk, 1)
        rets_wo.append(gross)
        rets.append(gross - cost)
        turns.append(turnover)
        held = new_held

    daily = pd.Series(rets, index=dates, name="return")
    daily_wo = pd.Series(rets_wo, index=dates, name="return_wo_cost")
    turn = pd.Series(turns, index=dates, name="turnover")
    curve = (1.0 + daily).cumprod()
    curve_wo = (1.0 + daily_wo).cumprod()
    cum = float(curve.iloc[-1] - 1.0) if len(curve) else 0.0
    cum_wo = float(curve_wo.iloc[-1] - 1.0) if len(curve_wo) else 0.0

    excess = excess_wo = None
    if benchmark is not None:
        b = benchmark.reindex(dates).fillna(0.0)
        bench_cum = float((1.0 + b).prod() - 1.0)
        excess = cum - bench_cum
        excess_wo = cum_wo - bench_cum

    return BacktestResult(
        daily_return=daily,
        daily_return_wo_cost=daily_wo,
        turnover=turn,
        cumulative_return=cum,
        cumulative_return_wo_cost=cum_wo,
        excess_return=excess,
        excess_return_wo_cost=excess_wo,
        max_drawdown=_max_drawdown(curve.to_numpy()),
        mean_turnover=float(turn.iloc[1:].mean()) if len(turn) > 1 else 0.0,
    )


# ---------------------------------------------------------------------------
# Full-fidelity account simulation (backtest.ipynb cells 6 & 8 semantics)
# ---------------------------------------------------------------------------

# qlib annualization scaler for daily CN-market frequency (238 trading
# days/year — qlib.contrib.evaluate.risk_analysis's day default).
TRADING_DAYS_PER_YEAR = 238


def risk_analysis(r: pd.Series, N: int = TRADING_DAYS_PER_YEAR) -> dict:
    """qlib `risk_analysis` parity (contrib.evaluate, mode='sum'): mean,
    std (ddof=1), annualized return = mean*N, IR = mean/std*sqrt(N), and
    max drawdown of the CUMSUM curve (qlib's default 'sum' mode — not the
    compounded curve used by `_max_drawdown` above)."""
    import pandas as pd

    r = r.dropna()
    if len(r) == 0:
        return {k: float("nan") for k in (
            "mean", "std", "annualized_return", "information_ratio",
            "max_drawdown")}
    mean = float(r.mean())
    std = float(r.std(ddof=1))
    cum = r.cumsum()
    mdd = float((cum - cum.cummax()).min())
    return {
        "mean": mean,
        "std": std,
        "annualized_return": mean * N,
        "information_ratio": (mean / std * float(np.sqrt(N))) if std > 0
                             else float("nan"),
        "max_drawdown": mdd,
    }


@dataclasses.dataclass
class AccountBacktestResult:
    """Account-level simulation output mirroring qlib's portfolio metrics.

    `report` mirrors `report_normal_df` (backtest.ipynb cell 6): columns
    account / return / turnover / cost / bench / cash / value, where
    `return` is GROSS of cost and `cost` is the day's cost as a fraction
    of start-of-day account value — so cell 8's
    `risk_analysis(return - bench - cost)` applies verbatim.
    """

    report: pd.DataFrame
    risk_excess_without_cost: dict
    risk_excess_with_cost: dict
    final_positions: dict = dataclasses.field(default_factory=dict)

    def analysis_frame(self) -> pd.DataFrame:
        """The cell-8 table: a (analysis, risk) x metric frame."""
        import pandas as pd

        return pd.concat({
            "excess_return_without_cost": pd.DataFrame(
                {"risk": self.risk_excess_without_cost}),
            "excess_return_with_cost": pd.DataFrame(
                {"risk": self.risk_excess_with_cost}),
        })

    def summary(self) -> dict:
        end = self.report["account"].iloc[-1] if len(self.report) else np.nan
        start = self.report["account"].iloc[0] if len(self.report) else np.nan
        return {
            "final_account": float(end),
            "annualized_excess_return_with_cost":
                self.risk_excess_with_cost["annualized_return"],
            "annualized_excess_return_without_cost":
                self.risk_excess_without_cost["annualized_return"],
            "information_ratio_with_cost":
                self.risk_excess_with_cost["information_ratio"],
            "max_drawdown_with_cost":
                self.risk_excess_with_cost["max_drawdown"],
            "mean_turnover": float(self.report["turnover"].mean())
                             if len(self.report) else np.nan,
        }


def simulate_topk_account(
    scores: pd.DataFrame,
    score_col: str = "score",
    label_col: str = "LABEL0",
    topk: int = 50,
    n_drop: int = 10,
    account: float = 1e8,
    open_cost: float = 0.0005,
    close_cost: float = 0.0015,
    min_cost: float = 5.0,
    limit_threshold: Optional[float] = 0.095,
    risk_degree: float = 0.95,
    benchmark: Optional[pd.Series] = None,
) -> AccountBacktestResult:
    """TopkDropoutStrategy + SimulatorExecutor analogue with real cash and
    position accounting (backtest.ipynb cell 6 exchange_kwargs).

    Semantics per trading day t (scores dated t; the reference label is
    `Ref($close,-2)/Ref($close,-1)-1`, i.e. the close(t+1)->close(t+2)
    return earned by a position entered at close(t+1)):

    - Strategy (qlib TopkDropoutStrategy, method_buy='top'/
      method_sell='bottom'): rank held names and the top
      `n_drop + topk - held` candidates together; sell the held names
      that fall below rank `topk` in that combined ranking (at most
      `n_drop` by construction), buy the best-ranked candidates to
      refill freed + empty slots. A held name that still outranks every
      candidate is NOT dropped.
    - Exchange: an order is REJECTED when the name moves through
      `limit_threshold` on the execution day — buys at limit-up
      (change >= +thr), sells at limit-down (change <= -thr). The
      execution-day (close(t)->close(t+1)) change of a day-t decision is
      exactly the name's label at t-1, so the limit check uses the label
      shifted one day; names missing from today's frame are suspended
      (unsellable, value carried at 0 return), while an in-frame name
      with a NaN score but finite label ranks NaN-last yet deals
      normally (the signal is missing, not the market). First-day names
      with no prior label are assumed tradable.
    - Costs: per executed order, `max(traded_value * rate, min_cost)`
      with the open/close rates of cell 6; deducted from cash.
    - Cash: sells credit proceeds minus cost; buys split
      `cash * risk_degree` equally (qlib BaseSignalStrategy.get_risk_degree
      = 0.95) across accepted buy orders.
    - Mark to market: every held position earns its day-t label; account
      value = cash + sum(position values). Positions drift from equal
      weight exactly as in qlib (no daily rebalance of held names).
    """
    import pandas as pd

    df = scores.dropna(subset=[score_col])
    # Trading days = every day present in the input frame, INCLUDING days
    # where every score is NaN (all-suspended / no-signal days): qlib's
    # executor still steps those days — holdings mark to market against
    # the day's labels and no orders are generated. Deriving the calendar
    # from the post-dropna frame would silently delete such a day and
    # with it a full day of portfolio return.
    dates = scores.index.get_level_values(0).unique().sort_values()
    scored_dates = set(df.index.get_level_values(0))
    # Names present in the frame per day, scored or not: an in-frame name
    # with a NaN score but a finite label DID trade that day (the signal
    # is missing, not the market) — qlib ranks it NaN-last and the
    # exchange fills its sell. Only a name absent from the day's frame
    # entirely is suspended.
    names_by_date = {
        d: set(g.index.get_level_values(1))
        for d, g in scores.groupby(level=0)}
    if len(dates) == 0:
        empty = pd.DataFrame(
            columns=["account", "return", "turnover", "cost", "cash",
                     "value", "bench"],
            index=pd.DatetimeIndex([], name="datetime"))
        nan_risk = risk_analysis(pd.Series([], dtype=float))
        return AccountBacktestResult(
            report=empty, risk_excess_without_cost=nan_risk,
            risk_excess_with_cost=dict(nan_risk))

    # (day, name) -> label / prior-day label (execution-day change proxy).
    labels = scores[label_col]
    by_name = labels.sort_index().reset_index()
    by_name.columns = ["datetime", "instrument", "label"]
    by_name["prev"] = by_name.groupby("instrument")["label"].shift(1)
    by_name["prev_date"] = by_name.groupby("instrument")["datetime"].shift(1)
    # Only a CONSECUTIVE prior trading day is a valid execution-day change:
    # a name returning from a suspension gap must not be limit-checked
    # against a stale, weeks-old move.
    cal = {d: i for i, d in enumerate(
        labels.index.get_level_values(0).unique().sort_values())}
    prev_label = {
        (d, i): v
        for d, i, v, pd_ in zip(by_name["datetime"], by_name["instrument"],
                                by_name["prev"], by_name["prev_date"])
        if np.isfinite(v)
        and pd_ in cal and cal[d] - cal[pd_] == 1
    }

    cash = float(account)
    pos: dict = {}                  # name -> market value
    rows = []
    for date in dates:
        if date in scored_dates:
            day = df.loc[date]
            # Deterministic tie-break: a stable sort on
            # the instrument-sorted frame breaks equal scores by
            # instrument name, so runs are reproducible where qlib's
            # quicksort order would be platform-defined.
            ranked = day[score_col].sort_index().sort_values(
                ascending=False, kind="mergesort")
        else:
            # All-NaN score day: CHOSEN INTERPRETATION (pending a
            # differential run against qlib): we
            # model qlib's strategy as emitting no trade decision at all
            # — no sells even from a drifted (above-topk) book, nothing
            # bought; positions only mark to market below. qlib's
            # TopkDropoutStrategy ranks with na_position='last' and
            # could conceivably still emit sells from an all-NaN
            # ranking, so this branch is the first scenario to diff
            # against real qlib when data access lands.
            ranked = pd.Series(dtype=float)
        universe = list(ranked.index)
        day_names = set(universe)
        in_frame = names_by_date.get(date, day_names)
        start_value = cash + sum(pos.values())

        def tradable(name, side):
            # Suspension (qlib Exchange volume==0): a held name absent
            # from today's frame ENTIRELY cannot transact on the
            # execution day — it can still be *selected* for sale
            # (below), as qlib's strategy ranks it, but the order is
            # rejected here. An in-frame name whose score is NaN is NOT
            # suspended: the market traded, only the signal is missing.
            if name not in in_frame and side == "sell":
                return False
            # No finite label at t means no close(t+1)->close(t+2) path:
            # the name cannot be dealt on the execution day (suspension/
            # delisting straddling it). qlib's volume==0 rejection is
            # side-independent, so BOTH buys and sells are refused; the
            # position stays marked at its carried value, exactly like a
            # suspended holding.
            if name in in_frame:
                lab = labels.get((date, name))
                if lab is None or not np.isfinite(lab):
                    return False
            if limit_threshold is None:
                return True
            chg = prev_label.get((date, name))
            if chg is None:
                return True
            return chg < limit_threshold if side == "buy" \
                else chg > -limit_threshold

        # --- strategy: target holdings (qlib comb ranking) --------------
        # qlib TopkDropoutStrategy ranks CURRENT holdings by today's
        # score with missing/suspended names ranked NaN-last (worst):
        # they occupy sell slots (and are then rejected by the exchange)
        # rather than silently passing the slot to the next-worst scored
        # name.
        held_scored = [s for s in universe if s in pos]     # today's order
        held_unscored = sorted(s for s in pos if s not in day_names)
        held_ranked = held_scored + held_unscored           # NaN ranks last
        candidates = [s for s in universe if s not in pos]
        n_held = len(pos)
        today_cand = candidates[: n_drop + max(0, topk - n_held)]
        cand_set = set(today_cand)
        # comb = holdings + candidates in score order, unscored holdings
        # at the bottom (qlib's pd.concat([last, today]).sort_values with
        # NaN last); sells are the held names falling below rank topk —
        # at most n_drop of them by construction of |today_cand|.
        comb = [s for s in universe if s in pos or s in cand_set]
        comb += held_unscored
        below_topk = set(comb[topk:])
        want_sell = [s for s in held_ranked if s in below_topk]
        # Unclamped qlib sizing (len(sell) + topk - held): a portfolio
        # drifted above topk (blocked sell + executed buy) buys fewer
        # than it sells and self-corrects back to topk.
        want_buy = today_cand[: max(0, len(want_sell) + topk - n_held)]
        if date not in scored_dates:
            # No signal today -> qlib generates no trade decision: even a
            # drifted above-topk book must not shed its (arbitrarily
            # ranked) unscored holdings.
            want_sell, want_buy = [], []

        # --- exchange: sells first (frees cash), limit/suspension aware -
        cost_today = 0.0
        traded = 0.0
        for name in want_sell:
            if not tradable(name, "sell"):
                continue
            v = pos.pop(name)
            fee = max(v * close_cost, min_cost) if v > 0 else 0.0
            cash += v - fee
            cost_today += fee
            traded += v
        buys = [n for n in want_buy if tradable(n, "buy")]
        if buys:
            per = cash * risk_degree / len(buys)
            for name in buys:
                fee = max(per * open_cost, min_cost)
                if per <= 0 or cash < per + fee:
                    continue
                cash -= per + fee
                cost_today += fee
                pos[name] = per
                traded += per

        # --- mark to market against today's labels ----------------------
        for name in list(pos):
            lab = labels.get((date, name))
            if lab is not None and np.isfinite(lab):
                pos[name] *= 1.0 + float(lab)
        end_value = cash + sum(pos.values())

        gross_ret = (end_value - start_value + cost_today) / start_value
        rows.append({
            "datetime": date,
            "account": end_value,
            "return": gross_ret,
            "turnover": traded / start_value,
            "cost": cost_today / start_value,
            "cash": cash,
            "value": sum(pos.values()),
        })

    report = pd.DataFrame(rows).set_index("datetime")
    if benchmark is not None:
        report["bench"] = benchmark.reindex(report.index).fillna(0.0)
    else:
        report["bench"] = 0.0

    excess_wo = report["return"] - report["bench"]
    excess_w = excess_wo - report["cost"]
    return AccountBacktestResult(
        report=report,
        risk_excess_without_cost=risk_analysis(excess_wo),
        risk_excess_with_cost=risk_analysis(excess_w),
        final_positions=dict(pos),
    )




def main(argv=None) -> int:
    """CLI: full backtest suite over an exported score CSV.

    Reproduces the reference's backtest notebook outputs (cells 6-8)
    from a `scores/...csv` artifact: TopkDropout screener headline
    metrics, the account-simulation summary, the annualized
    excess-return risk table, and optionally the report_graph figure.
    """
    import pandas as pd

    import argparse
    import json

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("scores_csv", help="CSV with datetime,instrument,score"
                                      "[,LABEL0] (eval.export_scores output)")
    p.add_argument("--labels", default=None,
                   help="reference-schema panel pickle supplying LABEL0 "
                        "when the CSV has none")
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--n_drop", type=int, default=10)
    p.add_argument("--account", type=float, default=1e8)
    p.add_argument("--open_cost", type=float, default=0.0005)
    p.add_argument("--close_cost", type=float, default=0.0015)
    p.add_argument("--min_cost", type=float, default=5.0)
    p.add_argument("--limit_threshold", type=float, default=0.095)
    p.add_argument("--benchmark", default=None, metavar="CSV",
                   help="per-day benchmark returns (columns: datetime, "
                        "return) — the CSI300 series of notebook cell 6. "
                        "Without it the excess tables are vs zero (i.e. "
                        "absolute returns), NOT comparable to the "
                        "reference's cell-8 numbers")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="write the report_graph 4-panel figure here")
    args = p.parse_args(argv)

    df = pd.read_csv(args.scores_csv, parse_dates=["datetime"])
    df = df.set_index(["datetime", "instrument"]).sort_index()
    if "LABEL0" not in df.columns:
        if not args.labels:
            p.error("scores CSV has no LABEL0 column; pass --labels")
        from factorvae_tpu_torch.data.panel import load_frame

        df = df.join(load_frame(args.labels)["LABEL0"], how="inner")
        if len(df) == 0:
            p.error("joining --labels matched ZERO rows — do the "
                    "instrument/date conventions of the CSV and the "
                    "panel agree?")
    # Do NOT pre-drop NaN rows here: the account simulator derives the
    # trading calendar from the full frame (an all-NaN-score day is a
    # no-trade day that still marks to market) and models in-frame
    # NaN-label names as undealable. Refuse only frames where score and
    # label never co-occur on a row (e.g. a misaligned --labels join) —
    # marginal non-NaN counts alone would let that run silently.
    if not (df["score"].notna() & df["LABEL0"].notna()).any():
        p.error("no scored rows with labels to backtest")

    benchmark = None
    if args.benchmark:
        b = pd.read_csv(args.benchmark, parse_dates=["datetime"])
        benchmark = b.set_index("datetime")["return"].sort_index()

    # the screener needs labeled rows; the account simulator keeps
    # NaN-label rows (rankable, but undealable on the execution day —
    # both order sides rejected — and mark-to-market skipped)
    screener = topk_dropout_backtest(
        df.dropna(subset=["score", "LABEL0"]),
        topk=args.topk, n_drop=args.n_drop,
        open_cost=args.open_cost, close_cost=args.close_cost,
        benchmark=benchmark)
    acct = simulate_topk_account(
        df, topk=args.topk, n_drop=args.n_drop, account=args.account,
        open_cost=args.open_cost, close_cost=args.close_cost,
        min_cost=args.min_cost, limit_threshold=args.limit_threshold,
        benchmark=benchmark)
    out = {
        "screener": {k: v for k, v in screener.summary().items()
                     if v is not None},
        "account": acct.summary(),
        "excess_return_without_cost": acct.risk_excess_without_cost,
        "excess_return_with_cost": acct.risk_excess_with_cost,
        "benchmark": args.benchmark or "none (excess == absolute return)",
    }
    if args.plot:
        from factorvae_tpu_torch.eval.plots import report_graph

        out["plot"] = report_graph(acct.report, args.plot)

    def _clean(o):
        """Strict JSON: numpy scalars -> python, NaN/inf -> null."""
        if isinstance(o, dict):
            return {k: _clean(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [_clean(v) for v in o]
        if isinstance(o, (np.floating, np.integer)):
            o = float(o)
        if isinstance(o, float) and not np.isfinite(o):
            return None
        return o

    print(json.dumps(_clean(out), indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
