"""The backtest report figure (`factorvae_tpu/eval/plots.py`): the
reference's `report_graph` artifact (backtest.ipynb cell 7) drawn from a
`simulate_topk_account(...).report` frame in four panels: cumulative
strategy and benchmark return, drawdown, excess return with and without
cost, and daily turnover. matplotlib is imported when it is called, through
an explicit Agg canvas, so no global backend changes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Okabe-Ito: fixed assignment, never cycled
_C_STRATEGY = "#0072B2"   # blue
_C_BENCH = "#999999"      # gray
_C_NOCOST = "#E69F00"     # orange
_C_EXCESS = "#009E73"     # green
_GRID = dict(color="#d0d0d0", linewidth=0.6, alpha=0.7)


def report_graph(
    report,
    path: str,
    title: Optional[str] = None,
) -> str:
    """Render the 4-panel backtest report to `path` (PNG).

    `report` is an `AccountBacktestResult.report` frame: datetime index,
    columns return / bench / cost / turnover (account/cash/value are
    not plotted). Returns `path`.
    """
    # Render through an explicit Agg canvas — no pyplot, no global
    # backend switch (a notebook caller's inline/Qt backend is untouched)
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    net = report["return"] - report["cost"]
    cum = (1.0 + net).cumprod() - 1.0
    cum_wo = (1.0 + report["return"]).cumprod() - 1.0
    cum_bench = (1.0 + report["bench"]).cumprod() - 1.0
    curve = 1.0 + cum
    drawdown = curve / np.maximum.accumulate(
        np.concatenate([[1.0], curve.to_numpy()]))[1:] - 1.0
    ex_wo = (report["return"] - report["bench"]).cumsum()
    ex_w = (report["return"] - report["bench"] - report["cost"]).cumsum()

    fig = Figure(figsize=(9, 10))
    FigureCanvasAgg(fig)
    axes = fig.subplots(4, 1, sharex=True)
    ax = axes[0]
    ax.plot(cum.index, cum, color=_C_STRATEGY, lw=1.6, label="strategy")
    ax.plot(cum_wo.index, cum_wo, color=_C_NOCOST, lw=1.2, ls="--",
            label="strategy w/o cost")
    ax.plot(cum_bench.index, cum_bench, color=_C_BENCH, lw=1.4,
            label="benchmark")
    ax.set_ylabel("cumulative return")
    ax.legend(frameon=False, fontsize=8)

    ax = axes[1]
    ax.fill_between(drawdown.index, drawdown, 0.0, color=_C_STRATEGY,
                    alpha=0.35, lw=0)
    ax.plot(drawdown.index, drawdown, color=_C_STRATEGY, lw=1.0)
    ax.set_ylabel("drawdown")

    ax = axes[2]
    ax.plot(ex_wo.index, ex_wo, color=_C_EXCESS, lw=1.4,
            label="excess w/o cost")
    ax.plot(ex_w.index, ex_w, color=_C_EXCESS, lw=1.2, ls="--",
            label="excess w/ cost")
    ax.set_ylabel("cumulative excess")
    ax.legend(frameon=False, fontsize=8)

    ax = axes[3]
    ax.plot(report.index, report["turnover"], color=_C_STRATEGY, lw=1.0)
    ax.set_ylabel("turnover")

    for ax in axes:
        ax.grid(True, **_GRID)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path
