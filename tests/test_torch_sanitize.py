"""The port's lock-order sanitizer (`factorvae_tpu_torch/analysis/sanitize.py`)
and the races its static half (graftlint JGL009-011) found in the port.

- The recorder's semantics, as `tests/test_sanitize.py` pins them for the
  JAX copy: edges, re-entrancy, same-site exclusion, cross-thread
  witnesses, `adopt`, the factory patch and its `only` filter.
- The tier-1 composition on the CPU: the port's `Checkpointer` with its
  async writer thread, `Timeline` and `MetricsLogger`, `obs/metrics`,
  `obs/drift`, `ChunkStream`, `ModelRegistry`, `chaos`, and the daemon's
  `TickScheduler` with its admission thread answering ticks and an admit
  from several client threads; the locks made at import (`_build`'s
  counter lock, `utils/profiling`'s capture lock) come in through
  `adopt`. The recorded held-while-acquiring graph must be acyclic, and a
  seeded inversion must fail with the report. The native panel ops' lock
  under the daemon's tick lock: an append beside ticks and fill maps.
- The repaired sites: the autoscaler's loop joined on `stop`, the
  checkpoint drain at exit surfacing a failed write, the build counters
  and `Checkpointer.manifest_seconds` under their locks.
"""

from __future__ import annotations

import threading
import types
import warnings

import numpy as np
import pytest

from factorvae_tpu_torch.analysis.sanitize import LockOrderError, LockOrderRecorder

# ---------------------------------------------------------------------------
# the recorder


class TestLockOrderRecorder:
    def test_consistent_order_is_clean(self):
        rec = LockOrderRecorder()
        a, b = rec.make_lock("A"), rec.make_lock("B")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert rec.cycles() == []
        rec.check()
        assert ("A", "B") in rec.edges() and ("B", "A") not in rec.edges()

    def test_inversion_is_a_cycle(self):
        rec = LockOrderRecorder()
        a, b = rec.make_lock("A"), rec.make_lock("B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        (cycle,) = rec.cycles()
        assert set(cycle) == {"A", "B"}
        with pytest.raises(LockOrderError) as exc:
            rec.check()
        assert "cycle: " in str(exc.value) and "held while acquiring" in str(exc.value)

    def test_three_lock_cycle(self):
        rec = LockOrderRecorder()
        a, b, c = (rec.make_lock(x) for x in "ABC")
        for first, second in ((a, b), (b, c), (c, a)):
            with first:
                with second:
                    pass
        (cycle,) = rec.cycles()
        assert set(cycle) == {"A", "B", "C"}

    def test_rlock_reentry_records_no_edge(self):
        rec = LockOrderRecorder()
        r = rec.make_lock("R", reentrant=True)
        with r:
            with r:
                pass
        assert rec.edges() == {}
        rec.check()

    def test_same_site_instances_excluded(self):
        rec = LockOrderRecorder()
        a, b = rec.make_lock("ckpt._lock"), rec.make_lock("ckpt._lock")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert rec.cycles() == []

    def test_cross_thread_inversion_detected(self):
        rec = LockOrderRecorder()
        a, b = rec.make_lock("A"), rec.make_lock("B")

        def nest(first, second):
            with first:
                with second:
                    pass

        for args in ((a, b), (b, a)):
            t = threading.Thread(target=nest, args=args)
            t.start()
            t.join()
        assert len(rec.cycles()) == 1
        assert rec.edges()[("A", "B")]["thread"]

    def test_release_out_of_order_tolerated(self):
        rec = LockOrderRecorder()
        a, b = rec.make_lock("A"), rec.make_lock("B")
        a.acquire()
        b.acquire()
        a.release()
        b.release()
        assert rec.cycles() == []

    def test_distinct_inversions_over_same_locks_both_reported(self):
        rec = LockOrderRecorder()
        a, b, c = (rec.make_lock(x) for x in "ABC")
        for first, second in ((a, b), (b, c), (c, a), (a, c), (c, b), (b, a)):
            with first:
                with second:
                    pass
        assert len(rec.cycles()) >= 2

    def test_adopt_wraps_preexisting_lock_and_restores(self):
        mod = types.SimpleNamespace(_LOCK=threading.Lock())
        original = mod._LOCK
        rec = LockOrderRecorder()
        with rec:
            wrapped = rec.adopt(mod, "_LOCK", label="mod._LOCK")
            other = rec.make_lock("other")
            with mod._LOCK:
                with other:
                    pass
            assert mod._LOCK is wrapped
        assert mod._LOCK is original
        assert ("mod._LOCK", "other") in rec.edges()

    def test_factory_patch_wraps_and_restores(self):
        rec = LockOrderRecorder()
        orig_lock = threading.Lock
        with rec:
            assert type(threading.Lock()).__name__ == "RecordedLock"
        assert threading.Lock is orig_lock
        with LockOrderRecorder(only=("no/such/path/",)):
            assert type(threading.Lock()).__name__ != "RecordedLock"


# ---------------------------------------------------------------------------
# the port's lock set


C, T, H, K, M = 6, 4, 8, 3, 4


def _config(tmp_path, seed=0):
    from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    return Config(model=ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                    num_portfolios=M, seq_len=T),
                  data=DataConfig(seq_len=T),
                  train=TrainConfig(num_epochs=1, seed=seed, save_dir=str(tmp_path),
                                    checkpoint_every=0))


class TestPortLockSet:
    def test_subsystem_lock_set_is_acyclic(self, tmp_path):
        rec = LockOrderRecorder(only=("factorvae_tpu_torch/",))
        from factorvae_tpu_torch import _build, chaos
        from factorvae_tpu_torch.data.loader import PanelDataset
        from factorvae_tpu_torch.data.stream import ChunkStream
        from factorvae_tpu_torch.data.synthetic import synthetic_panel
        from factorvae_tpu_torch.models.factorvae import load_model
        from factorvae_tpu_torch.obs.drift import ScoreDriftMonitor
        from factorvae_tpu_torch.obs.metrics import LatencyHistogram, daemon_metrics
        from factorvae_tpu_torch.params import save_weights
        from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler
        from factorvae_tpu_torch.serve.registry import ModelRegistry
        from factorvae_tpu_torch.train.checkpoint import Checkpointer
        from factorvae_tpu_torch.train.trainer import init_train_state
        from factorvae_tpu_torch.utils import profiling
        from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline

        panel = synthetic_panel(num_days=14, num_instruments=6, num_features=C,
                                missing_prob=0.1, seed=3)
        cfg, cand_cfg = _config(tmp_path, 0), _config(tmp_path, 1)
        save_weights(load_model(cand_cfg, device="cpu"), cand_cfg, str(tmp_path / "cand"))
        with rec:
            # locks made at import are brought in by hand
            rec.adopt(_build, "_COUNTS_LOCK")
            rec.adopt(profiling, "_LOCK")
            logger = MetricsLogger(jsonl_path=str(tmp_path / "run.jsonl"), echo=False)
            prev = install_timeline(Timeline(logger))
            try:
                hist = LatencyHistogram()
                t = threading.Thread(target=lambda: [hist.observe(0.01) for _ in range(10)])
                t.start()
                hist.render("factorvae_serve_latency")
                t.join()
                _build.compile_event_counts()

                mon = ScoreDriftMonitor(min_overlap=3)
                names = ["a", "b", "c", "d"]
                mon.observe("m0", 0, names, np.array([1.0, 2.0, 3.0, 4.0]))
                mon.observe("m0", 1, names, np.array([4.0, 3.0, 2.0, 1.0]))
                mon.stats()

                def make_chunk(i, alloc):
                    a = alloc("values", (3, 2), np.float32)
                    a[...] = i
                    return (a,)

                stream = ChunkStream(make_chunk, 3, "cpu")
                assert len(list(stream)) == 3 and stream.stats()["chunks"] == 3

                with chaos.active(chaos.ChaosPlan([chaos.Fault("serve_stall",
                                                               delay_s=0.0)])):
                    assert chaos.fault("serve_stall") is not None

                # the async writer thread: save, barrier, verified restore
                state = init_train_state(cfg.model, cfg.train, 10, "cpu")
                ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
                ck.save(0, state, {"epoch": 0})
                ck.save(1, state, {"epoch": 1})
                assert ck.restore(state)["epoch"] == 1 and len(ck.manifest_seconds) == 2
                ck.close()

                # the daemon: ticks from client threads through the
                # scheduler, an admit on its admission thread, /metrics
                ds = PanelDataset(panel, seq_len=T, device="cpu")
                reg = ModelRegistry(device="cpu")
                reg.register_params(load_model(cfg, device="cpu"), cfg, alias="m0")
                daemon = ScoringDaemon(reg, ds)
                sched = TickScheduler(daemon, tick_ms=1.0)
                try:
                    answers = []
                    clients = [threading.Thread(target=lambda i=i: answers.extend(
                        sched.submit([{"id": i, "model": "m0", "day": 8 + i % 4}])))
                        for i in range(6)]
                    for c in clients:
                        c.start()
                    (verdict,) = sched.submit([{
                        "id": "a", "cmd": "admit", "path": str(tmp_path / "cand"),
                        "alias": "m0", "holdout_days": [9, 10, 11], "min_margin": -2.0}])
                    for c in clients:
                        c.join(60)
                    assert all(r["ok"] for r in answers) and len(answers) == 6
                    assert verdict["cmd"] == "admit" and "promoted" in verdict, verdict
                    assert "factorvae_serve_requests_total" in daemon_metrics(daemon)
                finally:
                    sched.close()
            finally:
                install_timeline(prev)
                logger.finish()
        rec.check()
        edges = rec.edges()
        assert edges, "the composition recorded no nesting"
        assert any("daemon.py" in a and "registry.py" in b for a, b in edges), sorted(edges)

    def test_native_lock_under_the_daemon_is_acyclic(self, tmp_path):
        """The native panel ops' lock (`native._LOCK`, made at import) under
        the daemon's tick lock: an append (`extend_dataset` recomputes the
        fill maps) while client threads tick and another thread builds
        fill maps of its own."""
        from factorvae_tpu_torch import native
        from factorvae_tpu_torch.data.loader import PanelDataset
        from factorvae_tpu_torch.data.synthetic import synthetic_panel
        from factorvae_tpu_torch.data.windows import compute_fill_maps
        from factorvae_tpu_torch.models.factorvae import load_model
        from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler
        from factorvae_tpu_torch.serve.registry import ModelRegistry

        panel = synthetic_panel(num_days=14, num_instruments=6, num_features=C,
                                missing_prob=0.1, seed=3)
        history, piece = (panel.date_slice(None, str(panel.dates[11])),
                          panel.date_slice(str(panel.dates[12]), None))
        cfg = _config(tmp_path)
        rec = LockOrderRecorder(only=("factorvae_tpu_torch/",))
        with rec:
            rec.adopt(native, "_LOCK")
            daemon = ScoringDaemon(ModelRegistry(device="cpu"),
                                   PanelDataset(history, seq_len=T, device="cpu"))
            daemon.registry.register_params(load_model(cfg, device="cpu"), cfg, alias="m0")
            sched = TickScheduler(daemon, tick_ms=1.0)
            try:
                answers = []
                threads = [threading.Thread(target=lambda i=i: answers.extend(
                    sched.submit([{"id": i, "model": "m0", "day": 8 + i % 4}])))
                    for i in range(4)]
                threads.append(threading.Thread(
                    target=lambda: [compute_fill_maps(panel.valid) for _ in range(5)]))
                for t in threads:
                    t.start()
                assert daemon.extend_dataset(piece)
                for t in threads:
                    t.join(60)
                assert len(answers) == 4 and all(r["ok"] for r in answers)
                assert len(daemon.dataset.dates) == 14
            finally:
                sched.close()
        rec.check()
        assert any("daemon.py" in a and "native" in b for a, b in rec.edges()), \
            sorted(rec.edges())

    def test_seeded_inversion_fails_loudly(self):
        rec = LockOrderRecorder(only=("factorvae_tpu_torch/",))
        with rec:
            from factorvae_tpu_torch.obs.metrics import LatencyHistogram

            hist = LatencyHistogram()
            reg_lock = rec.make_lock("registry._lock", reentrant=True)
            with reg_lock:
                hist.observe(0.01)
            with hist._lock:
                with reg_lock:
                    pass
        with pytest.raises(LockOrderError) as exc:
            rec.check()
        report = str(exc.value)
        assert "registry._lock" in report and "metrics.py" in report
        assert "held while acquiring" in report


# ---------------------------------------------------------------------------
# the repaired sites


class _Router:
    def autoscale_signals(self):
        return {}


class TestRepairedSites:
    def test_autoscaler_stop_joins_its_loop(self):
        from factorvae_tpu_torch.serve.autoscale import AutoScaler

        scaler = AutoScaler(pool=None, router=_Router())
        scaler.interval_s = 0.01
        scaler.decide = lambda sig: None
        scaler.start()
        thread = scaler._thread
        assert thread.is_alive()
        scaler.stop()
        assert not thread.is_alive() and scaler._thread is None

    def test_a_failed_write_at_exit_is_surfaced(self, tmp_path):
        from factorvae_tpu_torch.train import checkpoint

        ck = checkpoint.Checkpointer(str(tmp_path / "ck"), async_save=True)
        ck._error = OSError("disk full")
        ck._worker = threading.current_thread()      # a barrier with a writer
        ck._queue.put(None)
        ck._queue.get()
        ck._queue.task_done()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            checkpoint._drain_all()
        assert any("disk full" in str(w.message) for w in caught)
        ck._worker = None

    def test_build_counters_under_their_lock(self, monkeypatch):
        from factorvae_tpu_torch import _build

        held = []
        lock = _build._COUNTS_LOCK

        class Spy:
            def __enter__(self):
                held.append(True)
                return lock.__enter__()

            def __exit__(self, *exc):
                return lock.__exit__(*exc)

        monkeypatch.setattr(_build, "_COUNTS_LOCK", Spy())
        assert set(_build.compile_event_counts()) == {"compile", "compile_cached"}
        assert held == [True]

    def test_manifest_seconds_appended_under_the_lock(self, tmp_path):
        from factorvae_tpu_torch.train.checkpoint import Checkpointer
        from factorvae_tpu_torch.train.trainer import init_train_state

        cfg = _config(tmp_path)
        state = init_train_state(cfg.model, cfg.train, 10, "cpu")
        ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
        entered = []
        inner = ck._lock

        class Spy:
            def __enter__(self):
                entered.append(threading.current_thread().name)
                return inner.__enter__()

            def __exit__(self, *exc):
                return inner.__exit__(*exc)

        ck._lock = Spy()
        for step in range(3):
            ck.save(step, state, {"epoch": step})
        ck.wait_until_finished()
        assert len(ck.manifest_seconds) == 3
        assert entered.count("ckpt-writer") == 3      # each manifest's append
        ck.close()


def test_build_counters_survive_many_loading_threads(tmp_path, monkeypatch):
    """16 threads load 200 libraries each (a stand-in CDLL) under a 1 µs
    switch interval: every cached load is counted, none lost."""
    import sys

    from factorvae_tpu_torch import _build

    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "timeline_compile", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_counts", {"compile": 0, "compile_cached": 0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda t=t: [_build.load(f"k{t}_{i}")
                                                        for i in range(200)])
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert _build.compile_event_counts() == {"compile": 0, "compile_cached": 3200}
