"""graftlint for the port (`factorvae_tpu/analysis`, the rules that are
not about JAX).

The AST rules check what the source says, in the port's library code
(any path containing `factorvae_tpu_torch/`):

- JGL006  bare print() in library modules (route through the
          MetricsLogger/timeline stream).
- JGL007  broad `except Exception` that swallows the error silently.
- JGL008  wall-clock time.time() measuring a duration (the Timeline
          contract is monotonic perf_counter).
- JGL009  whole-program only: shared mutable attribute/global written
          across the thread/main-line boundary without its owning lock.
- JGL010  whole-program only: async-signal-unsafe work (logging, I/O,
          lock acquisition) reachable from a signal handler.
- JGL011  whole-program only: daemon=True thread performing file
          writes with no join/flush barrier on any shutdown path.
- JGL012  blocking network call (urlopen/create_connection/requests/
          HTTPConnection) without a timeout, or a zero-argument
          Event/Condition `.wait()` that cannot notice a dead waker.
- JGL013  timeline_span_begin paired with timeline_span_end in the
          same function (the token API is cross-thread handoff only).
- JGL000  meta: unparseable file, a missing path, or a `graftlint:
          disable` suppression carrying no justification. Never
          suppressible.

JGL001-005 (host syncs under jit, PRNG key reuse, jit-cache hazards,
donation, dtype drift) and the IR backend (JIR001-004, `--ir`) are about
JAX and its compiled programs; the port has neither.

Suppression syntax (same line, or a standalone comment on the line
above)::

    except Exception:  # graftlint: disable=JGL007 best-effort cleanup

The justification text after the rule list is REQUIRED — a bare disable
is itself a finding.

CLI::

    python -m factorvae_tpu_torch.analysis factorvae_tpu_torch scripts/torch_*.py
    python -m factorvae_tpu_torch.analysis --project     # whole-program

`--project` builds ONE cross-module index (import-resolved call graph,
thread/signal/HTTP entry reachability, per-class guarded-attribute
inference — analysis/project.py) over every path, which enables the
concurrency rules JGL009-011; with no paths it takes the package and
`scripts/torch_*.py`. Per-path mode checks each file alone.

The runtime complement is `analysis/sanitize.py`: a lock-order recorder
that the tests drive over the Checkpointer (and its writer thread),
Timeline, MetricsLogger, `obs/metrics`, registry, chaos and TickScheduler
lock set, failing on held-while-acquiring cycles static analysis cannot
prove.

The engine is stdlib-only (ast + tokenize) and never executes or imports
the code under analysis; importing this package imports no torch.
"""

from factorvae_tpu_torch.analysis.engine import (
    Finding,
    analyze_paths,
    analyze_project,
    analyze_source,
    main,
)

__all__ = ["Finding", "analyze_paths", "analyze_project",
           "analyze_source", "main"]
