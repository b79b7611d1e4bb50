"""The serving fleet on the CPU: the port's router, pool, autoscaler,
exposition merge, remote join and AOT artifacts against the JAX package's
on the same inputs.

- Placement: `rendezvous_order` and the router's bounded-load
  `_candidates` give the JAX router's lists over a seeded grid of keys and
  worker sets, through worker loss.
- `merge_expositions`, `inject_labels` and `autoscale_families`: byte-equal
  to the JAX ones on the same scrapes.
- `AutoScaler.decide`: the JAX action sequence on seeded signal sequences.
- `capability_digest` (the agent's and the store's): equal to the JAX ones
  on the same alias -> sha256 map and the same files.
- Artifacts (C 8, T 5, H 8, K 4, M 8, 16 stocks): the port's
  `export_prediction` -> `load_exported` on the CPU against JAX
  `export_aot.load_exported(...).call` from the same Flax weights, f32 and
  int8, at rtol 1e-5 / atol 1e-6; an artifact exported for cuda and moved
  to the CPU scores as the CPU export; a JAX artifact is refused in one
  line.
- A 2-worker `--device cpu` pool and its router over weights directories
  (a 30-day pickle of 12 stocks): routed scores against the JAX daemon's
  `handle_batch` from the same weights (rtol 1e-5 / atol 1e-6), sticky
  routing, `/stats` and the merged `/metrics`, the pre-exported store, and
  an `admit_fanout` that flips both workers.
- A 2-worker pool over artifact files: `kill_worker` reroutes, the worker
  respawns from the store on its port and scores bitwise as before.
- A remote join against a stub artifact service: a corrupt transfer is
  retried, persistent corruption refused; hedging and shedding against stub
  workers (as `tests/test_remote.py` drives the JAX router).

Each subprocess wait has its own timeout; the pools are stopped (SIGTERM,
then reap) in fixture teardown.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import build_panel as jbuild_panel
from factorvae_tpu.data import load_frame as jload_frame
from factorvae_tpu.data import panel_to_frame as jpanel_to_frame
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.obs import metrics as jmetrics
from factorvae_tpu.serve import autoscale as jautoscale
from factorvae_tpu.serve import pool as jpool
from factorvae_tpu.serve import remote as jremote
from factorvae_tpu.serve import router as jrouter
from factorvae_tpu.serve.daemon import ScoringDaemon as JScoringDaemon
from factorvae_tpu.serve.registry import ModelRegistry as JModelRegistry
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import build_panel, load_frame
from factorvae_tpu_torch.eval.export_aot import ArtifactError, export_prediction, load_exported
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.obs import metrics as tmetrics
from factorvae_tpu_torch.params import flax_to_torch, save_weights
from factorvae_tpu_torch.serve import autoscale, remote, router
from factorvae_tpu_torch.serve.pool import AotStore, PoolError, WorkerPool, http_json
from factorvae_tpu_torch.serve.registry import ModelRegistry

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
C, T, H, K, M = 8, 5, 8, 4, 8
DAYS, STOCKS = 30, 12


def _cfgs(seed):
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, stochastic_inference=False),
        data=jconfig.DataConfig(seq_len=T), train=jconfig.TrainConfig(seed=seed))
    return jcfg, tconfig.Config.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """A 30-day pickle, both packages' datasets over it, and three models'
    Flax weights with their port weights directories."""
    root = tmp_path_factory.mktemp("pool")
    jp = synthetic_panel(num_days=DAYS, num_instruments=STOCKS, num_features=C,
                         missing_prob=0.2, seed=6)
    pkl = str(root / "panel.pkl")
    jpanel_to_frame(jp).to_pickle(pkl)
    models, dirs = [], []
    for seed in range(3):
        jcfg, tcfg = _cfgs(seed)
        params = jload_model(jcfg, n_max=16)[1]
        model = FactorVAE(tcfg.model)
        model.load_state_dict(flax_to_torch(params))
        dirs.append(save_weights(model, tcfg, str(root / "weights" / f"m{seed}")))
        models.append((jcfg, tcfg, params, model.eval()))
    return dict(root=root, pkl=pkl, models=models, dirs=dirs,
                jds=JPanelDataset(jbuild_panel(jload_frame(pkl)), seq_len=T),
                tds=PanelDataset(build_panel(load_frame(pkl)), seq_len=T, device="cpu"))


# ---- placement ---------------------------------------------------------------


def _placements(router_cls, steps):
    r = router_cls(types.SimpleNamespace(), max_inflight=0)
    return [r._candidates(key, healthy) for key, healthy in steps]


def test_rendezvous_and_bounded_load_equal_jax():
    rng = random.Random(11)
    grid = []
    for n in (1, 2, 3, 4, 7):
        ids = [f"w{i}" for i in range(n)] + [f"r{n + i}" for i in range(rng.randint(0, 2))]
        for _ in range(12):
            key = f"{rng.getrandbits(48):012x}"
            assert router.rendezvous_order(key, ids) == jrouter.rendezvous_order(key, ids)
            grid.append(key)
    ids = ["w0", "w1", "w2", "w3"]
    steps = [(k, ids) for k in grid[:24]]
    steps += [(k, ids[:3]) for k in grid[:30]]          # w3 lost
    steps += [(k, ["w0", "w2"]) for k in grid[10:40]]   # and w1
    steps += [(k, ids + ["r9"]) for k in grid]          # a remote joins
    got = _placements(router.Router, steps)
    assert got == _placements(jrouter.Router, steps)
    owners = [c[0] for c in got[:24]]
    assert max(owners.count(w) for w in ids) <= 6       # ceil(24 / 4)


# ---- expositions and the autoscaler -------------------------------------------


def _scrape(worker: int) -> str:
    h = tmetrics.LatencyHistogram()
    for i in range(5 + worker):
        h.observe(0.003 * (i + 1) * (worker + 1), trace_id=f"t{worker}-{i}")
    fams = [("factorvae_serve_requests_total", "counter", "answered",
             [tmetrics.metric_line("factorvae_serve_requests_total", 7 + worker)]),
            ("factorvae_serve_request_latency_seconds", "histogram", "latency",
             h.render("factorvae_serve_request_latency_seconds")),
            ("factorvae_compile_total", "counter", "libraries",
             [tmetrics.metric_line("factorvae_compile_total", worker, {"kind": "compile"}),
              tmetrics.metric_line("factorvae_compile_total", 2, {"kind": "compile_cached"})])]
    return tmetrics.render_families(fams) + 'untyped_sample{a="x\\"y"} 3\n'


def test_merge_expositions_and_labels_equal_jax():
    parts = [({"worker_id": f"w{i}"}, _scrape(i)) for i in range(3)]
    signals = {"queue_depth": 3, "p50_ms": 4.5, "p99_ms": None, "slo_ms": 50.0,
               "workers_healthy": 2, "workers_total": 3,
               "worker_inflight": {"w1": 2, "w0": 1}}
    extra = tmetrics.autoscale_families(signals)
    assert extra == jmetrics.autoscale_families(signals)
    got = tmetrics.merge_expositions(parts, extra_families=extra)
    assert got == jmetrics.merge_expositions(parts, extra_families=extra)
    for line in _scrape(1).splitlines():
        if not line.startswith("#"):
            labels = {"worker_id": "w1", "x": 'q"'}
            assert (tmetrics.inject_labels(line, labels)
                    == jmetrics.inject_labels(line, labels))
    heads = [ln for ln in got.splitlines() if ln.startswith(("# HELP", "# TYPE"))]
    assert len(heads) == len(set(heads))                # one HELP/TYPE per family
    assert 'factorvae_compile_total{worker_id="w2",kind="compile"} 2' in got


def _signal_walk(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    total = 2
    for _ in range(n):
        total = int(np.clip(total + rng.integers(-1, 2), 1, 5))
        yield {"queue_depth": int(rng.integers(0, 20)),
               "p99_ms": None if rng.random() < 0.2 else float(rng.uniform(1, 200)),
               "slo_ms": float(rng.choice([0.0, 50.0, 100.0])),
               "workers_healthy": int(rng.integers(0, total + 1)), "workers_total": total}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_decides_as_jax(seed):
    kw = dict(min_workers=1, max_workers=4, slo_ms=80.0)
    port, jax_ = autoscale.AutoScaler(None, None, **kw), jautoscale.AutoScaler(None, None, **kw)
    got, want = [], []
    for sig in _signal_walk(seed):
        got.append((port.decide(sig), port.last_reason))
        want.append((jax_.decide(sig), jax_.last_reason))
    assert got == want and {a for a, _ in got} >= {"up", None}
    assert port.describe() == jax_.describe()


def test_capability_digest_equals_jax(tmp_path):
    blobs = {"m0": b"alpha", "m1.aot": b"beta bytes", "z": b""}
    pairs = {a: hashlib.sha256(b).hexdigest() for a, b in blobs.items()}
    assert remote.capability_digest(pairs) == jremote.capability_digest(pairs)
    for alias, blob in blobs.items():
        (tmp_path / alias).write_bytes(blob)
    store = AotStore(str(tmp_path))
    assert store.capability_digest() == jpool.AotStore(str(tmp_path)).capability_digest()
    assert store.capability_digest() == remote.capability_digest(pairs)
    assert store.blob_path(pairs["m1.aot"]) == store.path_for("m1.aot")
    assert store.blob_path("0" * 64) is None


# ---- artifacts -----------------------------------------------------------------


def _day_inputs(rig, day):
    x, _, mask = rig["tds"].gather(torch.tensor([day]))
    return x, mask


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_artifact_scores_equal_jax_artifact(rig, int8):
    from factorvae_tpu.eval.export_aot import export_prediction as jexport
    from factorvae_tpu.eval.export_aot import load_exported as jload

    jcfg, tcfg, params, model = rig["models"][0]
    n_max = rig["tds"].n_max
    art = load_exported(export_prediction(model, tcfg, n_max, int8=int8, platform="cpu"))
    jart = jload(jexport(params, jcfg, n_max=n_max, int8=int8))
    assert art.header["config_hash"] == tconfig.config_hash(tcfg.to_dict())
    assert (art.header["n_max"], art.header["int8"], art.header["platforms"]) == (
        n_max, int8, ["cpu"])
    ops = {str(n.target) for n in art.program.graph.nodes if n.op == "call_function"}
    assert {"factorvae_tpu_torch.gru_fwd.default",
            "factorvae_tpu_torch.attention_fwd.default"} <= ops
    for day in (T, 17, DAYS - 1):
        x, mask = _day_inputs(rig, day)
        got = art.call(x, mask).numpy()
        want = np.asarray(jart.call(x.numpy(), mask.numpy()))
        assert got.shape == want.shape == (1, n_max)
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        assert np.array_equal(np.isnan(got), ~mask.numpy())


def test_cuda_export_moved_to_cpu_equals_cpu_export(rig):
    _, tcfg, _, model = rig["models"][1]
    n_max = rig["tds"].n_max
    blob = export_prediction(model, tcfg, n_max, platform="cuda")
    assert load_exported(blob, device="cpu").header["platforms"] == ["cuda"]
    cpu = load_exported(export_prediction(model, tcfg, n_max, platform="cpu"))
    x, mask = _day_inputs(rig, 20)
    assert torch.equal(load_exported(blob, device="cpu").call(x, mask).nan_to_num(),
                       cpu.call(x, mask).nan_to_num())


def test_jax_and_malformed_artifacts_are_refused_in_one_line(rig):
    from factorvae_tpu.eval.export_aot import export_prediction as jexport

    jcfg, tcfg, params, model = rig["models"][0]
    for blob, words in (
            (jexport(params, jcfg, n_max=16), "JAX StableHLO"),
            (b"no header at all", "no factorvae AOT header"),
            (b"FVAE-AOT1\n{not json\npayload", "header is corrupt"),
            (export_prediction(model, tcfg, 16, platform="cpu")[:-200], "deserialize")):
        with pytest.raises(ArtifactError) as ei:
            load_exported(blob, device="cpu")
        assert words in str(ei.value) and "\n" not in str(ei.value)
    blob = export_prediction(model, tcfg, 16, platform="cpu")
    with pytest.raises(ArtifactError, match="expected deadbeef"):
        load_exported(blob, expect_config_hash="deadbeef")


def test_registry_artifact_gate_eviction_and_cold_start(rig, tmp_path):
    _, tcfg, _, model = rig["models"][0]
    ds = rig["tds"]
    path = tmp_path / "a0"
    path.write_bytes(export_prediction(model, tcfg, ds.n_max, platform="cpu"))
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    reg = ModelRegistry(device="cpu", budget_bytes=1)
    with pytest.raises(Exception, match="corrupt"):
        reg.register_artifact(str(path), expected_sha256="0" * 64)
    key = reg.register_artifact(str(path), expected_sha256=sha)
    assert reg.get("a0").source == "artifact" and key == tconfig.config_hash(tcfg.to_dict())
    days = np.arange(T, DAYS)
    want = reg.score("a0", ds, days)
    reg.register_checkpoint(rig["dirs"][1])            # evicts the artifact
    assert key not in reg.keys()
    assert np.array_equal(reg.score("a0", ds, days), want, equal_nan=True)   # cold start
    assert reg.cold_starts == 1


# ---- a pool of CPU workers ----------------------------------------------------------


def _post(port, body, path="/score", timeout=120.0):
    return http_json(f"http://127.0.0.1:{port}{path}", body, timeout=timeout)


def _start_fleet(rig, specs, name, **pool_kw):
    root = rig["root"] / name
    pool = WorkerPool(specs, ["--dataset", rig["pkl"]], 2, str(root / "store"),
                      work_dir=str(root / "work"), device="cpu", health_interval_s=0.2,
                      **pool_kw)
    r = router.Router(pool, hedge=False)
    try:
        pool.start()
        r.start()
    except BaseException:
        r.stop()
        raise
    return pool, r


class TestWeightsFleet:
    """A 2-worker pool over weights directories; torn down before the
    chaos test below, whose fault would otherwise reach its watcher too."""

    @pytest.fixture(scope="class")
    def fleet(self, rig):
        pool, r = _start_fleet(rig, rig["dirs"][:2], "weights")
        yield pool, r
        r.stop()
        assert all(w.proc.poll() is not None for w in pool.workers)


    @staticmethod
    def _jax_answers(rig, reqs):
        reg = JModelRegistry()
        for i in (0, 1):
            jcfg, _, params, _ = rig["models"][i]
            reg.register_params(params, jcfg, alias=f"m{i}")
        return JScoringDaemon(reg, rig["jds"], stochastic=False).handle_batch(reqs)


    def test_routed_scores_equal_the_jax_daemon(self, rig, fleet):
        pool, r = fleet
        reqs = [{"id": 1, "model": "m0", "day": 20, "top": 5}, {"id": 2, "model": "m1", "day": 21},
                {"id": 3, "model": "m0", "days": [22, 23]}, {"id": 4, "model": "m1", "day": 99}]
        got = _post(r.port, reqs)
        want = self._jax_answers(rig, reqs)
        for g, w in zip(got, want):
            assert g["ok"] == w["ok"] and g["id"] == w["id"]
            if not w["ok"]:
                continue
            assert [x["instruments"] for x in g["results"]] == [x["instruments"]
                                                               for x in w["results"]]
            for gx, wx in zip(g["results"], w["results"]):
                np.testing.assert_allclose(gx["scores"], wx["scores"], **SCORE_TOL)
        owners = {g["model"]: g["worker"] for g in got[:3]}
        for _ in range(3):            # sticky: a key goes to the same worker
            again = _post(r.port, [{"model": "m0", "day": 20}, {"model": "m1", "day": 20}])
            assert {a["model"]: a["worker"] for a in again} == owners
        assert len(set(owners.values())) == 2                # bounded load: one each


    def test_stats_metrics_and_the_store(self, fleet):
        pool, r = fleet
        port = r.port
        stats = http_json(f"http://127.0.0.1:{port}/stats")
        workers = stats["pool"]["workers"]
        assert [w["worker_id"] for w in workers] == ["w0", "w1"]
        for w in workers:
            assert w["metrics"] == f"{w['url']}/metrics" and w["state"] == "ok"
            assert http_json(w["healthz"])["ok"]
        assert stats["router"]["cuda_initialized"] is False
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        heads = [ln for ln in text.splitlines() if ln.startswith(("# HELP", "# TYPE"))]
        assert len(heads) == len(set(heads))
        for wid in ("w0", "w1"):
            assert f'factorvae_serve_ticks_total{{worker_id="{wid}"}}' in text
        assert "factorvae_router_requests_total" in text
        man = http_json(f"http://127.0.0.1:{port}/artifacts")
        assert sorted(a["alias"] for a in man["artifacts"]) == ["m0", "m1"]
        assert man["capability_digest"] == pool.store.capability_digest()
        sha = man["artifacts"][0]["sha256"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", f"/artifact/{sha}")
        assert hashlib.sha256(conn.getresponse().read()).hexdigest() == sha
        conn.close()


    def test_admit_fanout_flips_every_worker(self, rig, fleet):
        pool, r = fleet
        assert not _post(r.port, {"model": "prod", "day": 20})["ok"]     # no alias yet
        out = _post(r.port, {"path": rig["dirs"][2], "alias": "prod"}, path="/admit",
                    timeout=240.0)
        assert out["ok"] and [w["worker"] for w in out["workers"]] == ["w0", "w1"]
        assert all(w["promoted"] for w in out["workers"])
        keys = {w["model"] for w in out["workers"]}
        assert len(keys) == 1
        for wid in ("w0", "w1"):       # each worker answers for the alias directly
            url = pool.worker(wid).url
            resp = http_json(url + "/score", {"model": "prod", "day": 20})
            assert resp["ok"] and resp["model"] in keys
        assert pool.stats()["admits_fanned_out"] == 1 and pool.store.has("m2")


def test_kill_worker_respawns_from_the_store_bitwise(rig, tmp_path):
    arts = []
    for i in (0, 1):
        _, tcfg, _, model = rig["models"][i]
        path = tmp_path / f"m{i}"
        path.write_bytes(export_prediction(model, tcfg, rig["tds"].n_max, platform="cpu"))
        arts.append(str(path))
    pool, r = _start_fleet(rig, arts, "artifacts")
    try:
        reqs = [{"model": "m0", "day": 20}, {"model": "m1", "days": [21, 22]}]
        before = _post(r.port, reqs)
        victim = pool.worker(before[1]["worker"])
        port = victim.port
        plan = chaos.ChaosPlan([chaos.Fault("kill_worker", request=victim.index)])
        with chaos.active(plan):
            deadline = time.monotonic() + 30
            while not plan.fired and time.monotonic() < deadline:
                time.sleep(0.05)
            during = _post(r.port, reqs)        # rerouted, none fails
            assert all(d["ok"] for d in during)
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline and not (
                    victim.restarts == 1 and victim.state == "ok"):
                time.sleep(0.1)
        assert victim.restarts == 1 and victim.state == "ok"
        assert victim.respawn_source == "aot_store" and victim.port == port
        assert pool.stats()["kills"] == 1
        # the killed worker's keys may have moved to worker 0 while it was
        # down (sticky placement keeps them there): ask it directly
        mine = [i for i, b in enumerate(before) if b["worker"] == victim.wid]
        after = http_json(victim.url + "/score", [reqs[i] for i in mine], timeout=120)
        after = after if isinstance(after, list) else [after]
        assert [a["results"] for a in after] == [before[i]["results"] for i in mine]
    finally:
        r.stop()


# ---- the remote join ----------------------------------------------------------------


class _ArtifactStub(threading.Thread):
    """/artifacts and /artifact/<sha>; the first `corrupt_first` blob answers
    (or all, with `corrupt_always`) are corrupted."""

    def __init__(self, blobs, corrupt_first=0, corrupt_always=False):
        super().__init__(name="artifact-stub", daemon=True)
        from http.server import BaseHTTPRequestHandler, HTTPServer

        self.fetches = 0
        stub, left = self, [corrupt_first]

        class Handler(BaseHTTPRequestHandler):
            def _body(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/artifacts":
                    arts = [{"alias": a, "sha256": hashlib.sha256(b).hexdigest(),
                             "bytes": len(b)} for a, b in sorted(blobs.items())]
                    cap = remote.capability_digest({a["alias"]: a["sha256"] for a in arts})
                    self._body(200, json.dumps({"ok": True, "artifacts": arts,
                                                "capability_digest": cap,
                                                "dataset_args": ["--synthetic", "8,8"],
                                                "extra_args": ["--seed", "3"],
                                                "n_max": 8}).encode())
                    return
                stub.fetches += 1
                for b in blobs.values():
                    if hashlib.sha256(b).hexdigest() == self.path.rsplit("/", 1)[1]:
                        if corrupt_always or left[0] > 0:
                            left[0] -= 1
                            b = b"CORRUPTED" + b
                        self._body(200, b, "application/octet-stream")
                        return
                self._body(404, b'{"ok": false}')

            def log_message(self, *a):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.start()

    def run(self):
        self.server.serve_forever(poll_interval=0.05)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.join(timeout=10)


def test_join_retries_a_corrupt_transfer_then_refuses(tmp_path):
    from factorvae_tpu_torch.serve.__main__ import build_parser

    blobs = {"m0": b"FVAE-AOT1\n{}\nstand-in payload", "m1": b"second artifact"}
    stub = _ArtifactStub(blobs, corrupt_first=1)
    try:
        args = build_parser().parse_args(["--join", stub.url, "--aot_store",
                                          str(tmp_path / "join")])
        cap = remote.prepare_join(args, build_parser())
        assert stub.fetches == 3                      # one torn transfer re-fetched
        assert [os.path.basename(m) for m in args.model] == ["m0", "m1"]
        assert {os.path.basename(p): s for p, s in args._expected_sha256.items()} == {
            a: hashlib.sha256(b).hexdigest() for a, b in blobs.items()}
        assert (args.synthetic, args.seed, args.max_stocks) == ("8,8", 3, 8)
        assert cap == remote.capability_digest(
            {a: hashlib.sha256(b).hexdigest() for a, b in blobs.items()})
        assert sorted(os.listdir(tmp_path / "join")) == [
            "m0", "m0.meta.json", "m1", "m1.meta.json"]
    finally:
        stub.close()
    bad = _ArtifactStub(blobs, corrupt_always=True)
    try:
        with pytest.raises(remote.JoinError) as ei:
            remote.fetch_artifact(bad.url, "m0", hashlib.sha256(blobs["m0"]).hexdigest(),
                                  str(tmp_path / "bad"), retries=2)
        assert "digest mismatch" in str(ei.value) and "re-join" in str(ei.value)
        assert os.listdir(tmp_path / "bad") == []
    finally:
        bad.close()


def test_the_watcher_leaves_slots_it_does_not_own(tmp_path):
    """A slot that left the table (deregistered, scaled down) or is being
    upgraded is not respawned, even when the watcher's pass saw it before
    its owner changed it; a live slot whose process died is."""
    pool = WorkerPool([], ["--synthetic", "8,8"], 1, str(tmp_path / "store"),
                      work_dir=str(tmp_path / "work"), device="cpu")
    spawned = []
    pool._spawn_cmd = lambda w, cmd: spawned.append(w.wid)
    pool._spawn = lambda w, models: spawned.append(w.wid)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=60)
    w = pool.workers[0]
    w.proc, w.state = dead, "ok"
    pool.workers.remove(w)                   # deregistered after the snapshot
    pool._watch_one(w)
    w.state = "upgrading"
    pool.workers.append(w)
    pool._watch_one(w)
    assert spawned == [] and pool.respawns == 0
    w.state = "ok"                           # its own process died: respawn
    pool._watch_one(w)
    assert spawned == ["w0"] and pool.respawns == 1 and w.restarts == 1


def test_a_worker_that_came_up_survives_one_late_failed_scrape(tmp_path):
    """The scrapes that failed while a worker started are not strikes once it
    answered /healthz: a watcher pass whose scrape was refused just before
    (its result landing after) leaves it routable; three failures in a row
    make it failing."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from factorvae_tpu_torch.serve.pool import free_port

    class Health(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = b'{"ok": true, "status": "ok"}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), Health)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    alive = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        pool = WorkerPool([], ["--synthetic", "8,8"], 1, str(tmp_path / "store"),
                          work_dir=str(tmp_path / "work"), device="cpu")
        w = pool.workers[0]
        w.proc, w.port = alive, free_port()     # nothing listens yet
        for _ in range(5):                       # the start-up scrapes fail
            pool._watch_one(w)
        assert w.state == "starting" and w.fails == 5
        w.port = server.server_address[1]
        pool._wait_healthy([w])
        assert w.state == "ok" and pool.healthy_ids() == ["w0"]
        w.port = free_port()
        pool._watch_one(w)                       # a late refused scrape
        assert w.state == "ok" and pool.healthy_ids() == ["w0"]
        pool._watch_one(w)
        pool._watch_one(w)
        assert w.state == "failing" and pool.healthy_ids() == []
    finally:
        alive.kill()
        alive.wait(timeout=60)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_adopt_remote_refuses_another_artifact_set(tmp_path):
    pool = WorkerPool([], ["--synthetic", "8,8"], 1, str(tmp_path / "store"),
                      work_dir=str(tmp_path / "work"), device="cpu")
    (tmp_path / "store" / "m0").write_bytes(b"artifact zero")
    with pytest.raises(PoolError, match="re-sync"):
        pool.adopt_remote("127.0.0.1", 19999, capability="deadbeef" * 8)
    cap = pool.store.capability_digest()
    w = pool.adopt_remote("127.0.0.1", 18801, capability=cap)
    assert pool.adopt_remote("127.0.0.1", 18801, capability=cap) is w
    assert pool.stats()["remote_adopts"] == 1
    assert pool.deregister(w.wid)["ok"] and all(x is not w for x in pool.workers)


# ---- hedging and shedding against stub workers ----------------------------------------


class _StubWorker(threading.Thread):
    """POST /score answers each request tagged after `delay_s` (with `error`:
    ok false and that error)."""

    def __init__(self, tag, delay_s=0.0, error=None):
        super().__init__(name=f"stub-{tag}", daemon=True)
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.hits = 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                stub.hits += 1
                reqs = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                time.sleep(delay_s)
                body = json.dumps([{"id": q.get("id"), "ok": error is None, "tag": tag,
                                    **({"error": error} if error else {})}
                                   for q in reqs]).encode()
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass       # a cancelled hedge leg

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.start()

    def run(self):
        self.server.serve_forever(poll_interval=0.05)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class _FakePool:
    def __init__(self, ports):
        self._w = {wid: types.SimpleNamespace(wid=wid, host="127.0.0.1", port=p)
                   for wid, p in ports.items()}
        self.failures = []

    def healthy_ids(self):
        return sorted(self._w)

    def worker(self, wid):
        return self._w[wid]

    def note_failure(self, wid):
        self.failures.append(wid)

    def stats(self):
        return {"healthy": len(self._w), "draining": False, "respawns": 0,
                "workers": [{"worker_id": w, "state": "ok"} for w in sorted(self._w)]}

    def stop(self):
        pass


@pytest.mark.parametrize("mode", ["measured", "pinned"])
def test_hedge_first_answer_wins_and_counts_once(mode):
    slow, fast = _StubWorker("slow", 1.5), _StubWorker("fast")
    pool = _FakePool({"wslow": slow.port, "wfast": fast.port})
    r = router.Router(pool, **({"hedge_ms": 10.0} if mode == "pinned" else {}))
    if mode == "measured":
        r._lat_window.extend([0.02] * 30)             # p90 = 20 ms
    r._assign["m"] = "wslow"
    r.start()
    try:
        t0 = time.monotonic()
        resp = _post(r.port, {"id": 1, "model": "m"})
        assert resp["tag"] == "fast" and resp["worker"] == "wfast"
        assert time.monotonic() - t0 < 1.0
        time.sleep(0.3)
        st = r.stats()["router"]
        assert (st["requests"], st["forwarded"]) == (1, 1)
        assert st["hedge"]["hedges"] == st["hedge"]["hedge_wins"] == 1
        assert st["proxy_errors"] == 0 and pool.failures == []
        assert r.lat_hist.count == 1
    finally:
        r.stop(stop_pool=False)
        slow.close()
        fast.close()


def test_hedge_waits_for_its_delay_and_measured_samples():
    fast, other = _StubWorker("primary"), _StubWorker("secondary")
    pool = _FakePool({"w0": fast.port, "w1": other.port})
    r = router.Router(pool, hedge_ms=500.0)
    r._assign["m"] = "w0"
    r.start()
    try:
        for i in range(3):
            assert _post(r.port, {"id": i, "model": "m"})["tag"] == "primary"
        assert r.stats()["router"]["hedge"]["hedges"] == 0 and other.hits == 0
    finally:
        r.stop(stop_pool=False)
        fast.close()
        other.close()
    auto = router.Router(pool)
    assert auto._hedge_delay_s() is None
    auto._lat_window.extend([0.01] * 19)
    assert auto._hedge_delay_s() is None
    auto._lat_window.append(0.01)
    assert auto._hedge_delay_s() == pytest.approx(0.01)
    assert router.Router(pool, hedge_ms=7.5, hedge=False)._hedge_delay_s() is None


def test_a_draining_workers_unscored_answer_fails_over():
    """A worker whose scheduler is closing answers "daemon is shutting
    down" without scoring: the router forwards to the next worker and marks
    the draining one, as for a refused connection."""
    from factorvae_tpu_torch.serve.daemon import SHUTTING_DOWN

    draining, live = _StubWorker("draining", error=SHUTTING_DOWN), _StubWorker("live")
    pool = _FakePool({"w0": draining.port, "w1": live.port})
    r = router.Router(pool, hedge=False)
    r._assign["m"] = "w0"
    try:
        out = r.route_batch([{"id": 1, "model": "m"}, {"id": 2, "model": "m"}])
        assert [o["tag"] for o in out] == ["live", "live"] and all(o["ok"] for o in out)
        assert pool.failures == ["w0"] and r.proxy_errors == 1 and r.reroutes == 1
    finally:
        draining.close()
        live.close()


def test_shedding_past_max_inflight_and_without_workers():
    slow = _StubWorker("slow", 0.8)
    pool = _FakePool({"w0": slow.port})
    r = router.Router(pool, max_inflight=1, hedge=False)
    r.start()
    try:
        first = threading.Thread(target=_post, args=(r.port, {"model": "m"}))
        first.start()
        time.sleep(0.3)
        conn = http.client.HTTPConnection("127.0.0.1", r.port, timeout=30)
        conn.request("POST", "/score", body=json.dumps({"model": "m"}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 503 and resp.getheader("Retry-After") == "1"
        assert body["retry_after_s"] == 1.0 and "inflight >= 1" in body["error"]
        first.join(timeout=30)
        assert not first.is_alive()
        assert r.stats()["router"]["shed"] == 1
    finally:
        r.stop(stop_pool=False)
        slow.close()
    empty = router.Router(_FakePool({}), hedge=False)
    out = empty.route_batch([{"model": "m"}])
    assert "no healthy worker" in out[0]["error"] and empty.shed == 1


# ---- the build lock --------------------------------------------------------------------

_BUILD_PROBE = r"""
import ctypes, json, sys
from pathlib import Path
from factorvae_tpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build.ctypes.CDLL = lambda path: object()
_build.load("gru_fwd")
print(json.dumps(_build.compile_event_counts()))
"""


def test_two_processes_that_miss_a_library_build_it_once(tmp_path):
    """A stand-in nvcc counts its calls and takes a second; two processes
    that miss the same library at once build every kernel library once
    between them (a first miss builds all of them), and the second counts
    the library it loads as compile_cached."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    calls = tmp_path / "calls"
    (bindir / "nvcc").write_text(
        f'#!/bin/sh\necho x >> "{calls}"\nsleep 1\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift; done\n')
    (bindir / "nvcc").chmod(0o755)
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda"),
           "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE, str(tmp_path / "build")],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    from factorvae_tpu_torch import _build

    n = len(_build.KERNELS)
    assert calls.read_text().count("x") == n
    assert sorted(outs, key=lambda o: o["compile"]) == [
        {"compile": 0, "compile_cached": 1}, {"compile": n, "compile_cached": 0}]
