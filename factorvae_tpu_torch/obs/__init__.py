"""The observatory (`factorvae_tpu/obs/`): the trace plane (`obs/trace.py`),
the served-score drift monitors (`obs/drift.py`), the daemon's Prometheus
exposition and textfile exporter (`obs/metrics.py`), the training-health
probes (`obs/probes.py`), the comms bill (`obs/comms.py`), memory
watermarks (`obs/memory.py`), and the readers of a run's stream
(`obs/report.py`, `obs/timeline.py`, `obs/live.py`, `obs/collect.py`),
and the perf-regression ledger over the port's own bench history
(`obs/ledger.py`, `python -m factorvae_tpu_torch.obs.ledger`).
Host-side Python and numpy only, copied rather than imported from the JAX
package. Profiling lives in `utils/` (`utils/profiling.py`,
`utils/trace_summary.py`).
"""
