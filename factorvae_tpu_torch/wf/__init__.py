"""The walk-forward refit (`factorvae_tpu/wf`).

`wf.operator.WalkForwardOperator` runs the nightly append -> judge -> refit
-> promote -> verify cycle as a journaled state machine over the port's
store, dataset, daemon and trainer; `python -m factorvae_tpu_torch.wf` is
its command line.
"""

from factorvae_tpu_torch.wf.journal import STAGES, CycleJournal, JournalError
from factorvae_tpu_torch.wf.operator import (
    WalkForwardError,
    WalkForwardOperator,
    holdout_day_indices,
    refit_rank_ic,
    warm_refit,
)

__all__ = [
    "STAGES",
    "CycleJournal",
    "JournalError",
    "WalkForwardError",
    "WalkForwardOperator",
    "holdout_day_indices",
    "refit_rank_ic",
    "warm_refit",
]
