"""The serving observatory (`factorvae_tpu/obs/`, in part): the trace plane
(`obs/trace.py`), the served-score drift monitors (`obs/drift.py`) and the
daemon's Prometheus exposition (`obs/metrics.py`). Host-side Python and
numpy only, copied rather than imported from the JAX package. The report,
live, ledger, collect and profiling modules wait for ROADMAP Queue 1 item
11.
"""
