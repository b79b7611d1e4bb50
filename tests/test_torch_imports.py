"""Guards of the PyTorch port: what it imports (every module, the training,
CLI, quantization, fleet, stream, append, serving and observability ones
included, and a scoring pass at each precision rung and on a
stream-resident panel, a float32 and a mixed training epoch, a fleet's epoch
and its lane-batched scoring pass, a CLI run without --backtest, and a
scoring daemon's fused ticks at each rung with its metrics, drift, trace
and scheduler, an AOT artifact admitted and scored, a walk-forward
cycle through its command line, and a probed epoch under a profiler
capture read back by the run readers, rematerialized epochs (serial and a
fleet), the static analyzer on a module, a 1 x 1 mesh's epoch, fleet and
scoring pass (`parallel/` among the modules), with no JAX, Flax,
pandas or JAX-package module loaded),
that the JAX weights carry across without loss, and that `chip_smoke.py`
refuses to run without a GPU instead of falling back to the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from factorvae_tpu import config as jconfig
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.params import flax_to_torch, torch_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import factorvae_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)

from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
from factorvae_tpu_torch.eval.predict import predict_panel
from factorvae_tpu_torch.models.factorvae import load_model
from factorvae_tpu_torch import config

cfg = config.Config(model=config.ModelConfig(num_features=6, hidden_size=4,
                    num_factors=3, num_portfolios=5, seq_len=4))
ds = PanelDataset(synthetic_panel_dense(12, 5, 6), seq_len=4, device="cpu")
scores = predict_panel(load_model(cfg, device="cpu"), cfg, ds,
                       ds.split_days(None, None), stochastic=False)
assert scores.shape == (12, 8) and np.isfinite(scores[:, :5]).all()
# the stream residency: the same scores from chunks of a host-resident panel
stream_ds = PanelDataset(synthetic_panel_dense(12, 5, 6), seq_len=4, device="cpu",
                         residency="stream")
assert np.array_equal(predict_panel(load_model(cfg, device="cpu"), cfg, stream_ds,
                                    ds.split_days(None, None), stochastic=False),
                      scores, equal_nan=True)
# the precision ladder's scoring rungs: bf16 and int8 weight-only
import dataclasses
bf16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
for rung_cfg, int8 in ((bf16, False), (cfg, True), (bf16, True)):
    s = predict_panel(load_model(cfg, device="cpu"), rung_cfg, ds,
                      ds.split_days(None, None), stochastic=False, int8=int8)
    assert s.shape == (12, 8) and np.isfinite(s[:, :5]).all()

import tempfile
from factorvae_tpu_torch.train.trainer import Trainer

with tempfile.TemporaryDirectory() as save_dir:
    tcfg = config.Config(model=cfg.model, data=config.DataConfig(seq_len=4),
                         train=config.TrainConfig(num_epochs=1, checkpoint_every=1,
                                                  save_dir=save_dir))
    state, out = Trainer(tcfg, ds, device="cpu").fit()
    assert state.step == len(ds.split_days(None, None))
    assert np.isfinite(out["history"][0]["train_loss"])
    # a mixed epoch: bf16 compute over f32 masters, the dynamic loss scale
    mixed = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train,
                                                                compute_dtype="bfloat16"))
    state, out = Trainer(mixed, ds, device="cpu").fit()
    assert np.isfinite(out["history"][0]["train_loss"]) and state.loss_scale > 0
assert {"factorvae_tpu_torch.train.trainer", "factorvae_tpu_torch.train.loop",
        "factorvae_tpu_torch.train.state", "factorvae_tpu_torch.train.checkpoint",
        "factorvae_tpu_torch.ops.kl", "factorvae_tpu_torch.ops.quant"} <= set(names)

# a fleet of two seeds, one epoch, then its lane-batched scoring pass
from factorvae_tpu_torch.eval.predict import predict_panel_fleet
from factorvae_tpu_torch.train.fleet import FleetTrainer

with tempfile.TemporaryDirectory() as save_dir:
    tcfg = config.Config(model=cfg.model, data=config.DataConfig(seq_len=4),
                         train=config.TrainConfig(num_epochs=1, save_dir=save_dir))
    fleet_state, out = FleetTrainer(tcfg, ds, seeds=[0, 1], device="cpu").fit()
    assert np.isfinite(out["history"][0]["train_loss"]).all()
    s = predict_panel_fleet(out["best_params"], tcfg, ds, ds.split_days(None, None),
                            stochastic=False)
    assert s.shape == (2, 12, 8) and np.isfinite(s[:, :, :5]).all()
assert {"factorvae_tpu_torch.train.fleet", "factorvae_tpu_torch.train.pbt",
        "factorvae_tpu_torch.eval.sweep", "factorvae_tpu_torch.data.stream",
        "factorvae_tpu_torch.data.append", "factorvae_tpu_torch.chaos.ops"} <= set(names)

# the CLI after the panel is built (no --backtest): train, score, export
from factorvae_tpu_torch import cli

with tempfile.TemporaryDirectory() as out:
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--num_epochs", "1", "--num_latent", "6", "--hidden_size", "4",
        "--num_factor", "3", "--num_portfolio", "5", "--seq_len", "4",
        "--start_time", "2015-01-01", "--fit_end_time", "2015-01-12",
        "--val_start_time", "2015-01-13", "--val_end_time", "2015-01-16",
        "--score_start", "2015-01-05", "--score_end", "2015-01-16",
        "--save_dir", out + "/models", "--score_dir", out + "/scores",
        "--metrics_jsonl", out + "/run.jsonl"])
    assert cli.run(cli.config_from_args(args), args, synthetic_panel_dense(12, 5, 6)) == 0
    import os
    assert os.listdir(out + "/scores") == ["VAE-Revision2_3_True_None_6_4.csv"]
assert {"factorvae_tpu_torch.cli", "factorvae_tpu_torch.ops.stats",
        "factorvae_tpu_torch.eval.metrics", "factorvae_tpu_torch.eval.backtest",
        "factorvae_tpu_torch.eval.plots", "factorvae_tpu_torch.utils.logging",
        "factorvae_tpu_torch.chaos"} <= set(names)

# the daemon: fused ticks at each rung, the exposition, a scheduler tick
from factorvae_tpu_torch.obs.metrics import daemon_metrics
from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler
from factorvae_tpu_torch.serve.registry import ModelRegistry

reg = ModelRegistry(device="cpu")
rungs = ("float32", "bfloat16", "int8")
for s in (0, 1):
    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=s))
    for p in rungs:
        reg.register_params(load_model(c, device="cpu"), c, precision=p, alias=f"{p}{s}")
daemon = ScoringDaemon(reg, ds)
out = daemon.handle_batch([{"model": f"{p}{s}", "day": 6, "trace": {"trace_id": "t",
                            "span_id": "s"}} for p in rungs for s in (0, 1)])
assert all(r["ok"] and r["batched_with"] == 2 for r in out), out
assert "factorvae_compile_total" in daemon_metrics(daemon)
sched = TickScheduler(daemon)
assert sched.submit([{"model": "float320", "day": 7}])[0]["ok"]
sched.close()
assert {"factorvae_tpu_torch.serve.daemon", "factorvae_tpu_torch.serve.registry",
        "factorvae_tpu_torch.serve.__main__", "factorvae_tpu_torch.obs.trace",
        "factorvae_tpu_torch.obs.drift", "factorvae_tpu_torch.obs.metrics"} <= set(names)

# the fleet's modules, and an AOT artifact admitted and scored day by day
from factorvae_tpu_torch.eval.export_aot import export_prediction

reg.register_artifact(export_prediction(load_model(cfg, device="cpu"), cfg, ds.n_max,
                                        platform="cpu"), alias="aot")
assert np.isfinite(reg.score("aot", ds, ds.split_days(None, None))[:, :5]).all()
assert {"factorvae_tpu_torch.serve.pool", "factorvae_tpu_torch.serve.router",
        "factorvae_tpu_torch.serve.remote", "factorvae_tpu_torch.serve.autoscale",
        "factorvae_tpu_torch.eval.export_aot"} <= set(names)

# the walk-forward command: bootstrap and one cycle on a synthetic store
from factorvae_tpu_torch.wf.__main__ import main as wf_main

with tempfile.TemporaryDirectory() as run:
    assert wf_main(["--run_dir", run, "--force_refit", "--epochs", "1", "--init_days", "12",
                    "--stocks", "5", "--features", "6", "--hidden", "4", "--factors", "3",
                    "--portfolios", "5", "--seq_len", "4", "--min_margin", "2",
                    "--device", "cpu"]) == 0
assert {"factorvae_tpu_torch.wf", "factorvae_tpu_torch.wf.journal",
        "factorvae_tpu_torch.wf.operator", "factorvae_tpu_torch.wf.__main__"} <= set(names)

# the run observatory: a probed epoch with a timeline and a capture, read back
from factorvae_tpu_torch.obs import report, timeline
from factorvae_tpu_torch.utils import logging as tlog
from factorvae_tpu_torch.utils.profiling import trace
from factorvae_tpu_torch.utils.trace_summary import summarize_trace

with tempfile.TemporaryDirectory() as run:
    logger = tlog.MetricsLogger(jsonl_path=run + "/run.jsonl", echo=False)
    prev = tlog.install_timeline(tlog.Timeline(logger))
    tcfg = config.Config(model=cfg.model, data=config.DataConfig(seq_len=4),
                         train=config.TrainConfig(num_epochs=1, obs_probes=True,
                                                  save_dir=run + "/m"))
    with trace(run + "/trace"):
        _, out = Trainer(tcfg, ds, device="cpu", logger=logger).fit()
    tlog.install_timeline(prev)
    logger.finish()
    assert np.isfinite(out["history"][0]["grad_norm_mean"])
    rep = report.build_report(timeline.open_run(run + "/run.jsonl")[0])
    assert rep["num_epochs"] == 1 and rep["flags"] == []
    assert summarize_trace(run + "/trace")["total_us"] > 0
assert {"factorvae_tpu_torch.obs.probes", "factorvae_tpu_torch.obs.report",
        "factorvae_tpu_torch.obs.timeline", "factorvae_tpu_torch.obs.live",
        "factorvae_tpu_torch.obs.collect", "factorvae_tpu_torch.obs.memory",
        "factorvae_tpu_torch.utils.profiling",
        "factorvae_tpu_torch.utils.trace_summary"} <= set(names)

# the eleventh slice: rematerialized epochs, a seed fleet under "full"; the
# decomposition, comparison, ETL and analysis modules import without pandas
for rung in ("dots", "full"):
    with tempfile.TemporaryDirectory() as run:
        rcfg = config.Config(model=cfg.model, data=config.DataConfig(seq_len=4),
                             train=config.TrainConfig(num_epochs=1, remat=rung,
                                                      checkpoint_every=0, save_dir=run))
        _, out = Trainer(rcfg, ds, device="cpu").fit()
        assert np.isfinite(out["history"][0]["train_loss"])
        if rung == "full":
            _, out = FleetTrainer(rcfg, ds, seeds=[0, 1], device="cpu").fit()
            assert np.isfinite(out["history"][0]["train_loss"]).all()
from factorvae_tpu_torch.analysis import analyze_paths
assert analyze_paths([pkg.__path__[0] + "/train/loop.py"]) == []
assert {"factorvae_tpu_torch.eval.factors", "factorvae_tpu_torch.eval.compare",
        "factorvae_tpu_torch.data.etl", "factorvae_tpu_torch.analysis",
        "factorvae_tpu_torch.analysis.engine", "factorvae_tpu_torch.analysis.rules",
        "factorvae_tpu_torch.analysis.project", "factorvae_tpu_torch.analysis.concurrency",
        "factorvae_tpu_torch.analysis.sanitize",
        "factorvae_tpu_torch.analysis.__main__"} <= set(names)

# the thirteenth slice: a 1 x 1 mesh epoch and fleet, mesh scoring, the
# parallel package and the comms block
from factorvae_tpu_torch.parallel import single_device_mesh
from factorvae_tpu_torch.parallel.collective_ops import comm_counts
with tempfile.TemporaryDirectory() as run:
    mcfg = config.Config(model=cfg.model, data=config.DataConfig(seq_len=4),
                         train=config.TrainConfig(num_epochs=1, checkpoint_every=1,
                                                  save_dir=run))
    mds = PanelDataset(synthetic_panel_dense(12, 5, 6), seq_len=4, device="cpu")
    tr = Trainer(mcfg, mds, device="cpu", mesh=single_device_mesh())
    state, out = tr.fit()
    assert np.isfinite(out["history"][0]["train_loss"]) and tr.comms_block()["collective_ops"] == 0
    _, out = FleetTrainer(mcfg, mds, seeds=[0, 1], device="cpu", use_mesh=True).fit()
    assert np.isfinite(out["history"][0]["train_loss"]).all()
    s = predict_panel(state.model, mcfg, mds, mds.split_days(None, None), mesh=tr.mesh)
    assert s.shape == (12, 8) and np.isfinite(s[:, :5]).all() and comm_counts() == {}
assert {"factorvae_tpu_torch.parallel", "factorvae_tpu_torch.parallel.mesh",
        "factorvae_tpu_torch.parallel.compose", "factorvae_tpu_torch.parallel.multihost",
        "factorvae_tpu_torch.parallel.partition", "factorvae_tpu_torch.parallel.sharding",
        "factorvae_tpu_torch.parallel.collective_ops", "factorvae_tpu_torch.parallel.ring",
        "factorvae_tpu_torch.obs.comms"} <= set(names)

def banned(mod):
    top = mod.split(".")[0]
    return (top in ("jax", "jaxlib", "flax", "pandas", "factorvae_tpu")
            or mod.startswith("factorvae_tpu."))

print(len(names), sorted(m for m in sys.modules if banned(m)))
"""


def test_port_imports_no_jax_flax_pandas_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, banned = proc.stdout.splitlines()[-1].split(maxsplit=1)   # after the CLI's echo
    assert int(n_modules) >= 20
    assert banned.strip() == "[]"


def test_flax_tree_round_trips_bitwise_through_the_port():
    cfg = jconfig.ModelConfig(num_features=12, hidden_size=8, num_factors=4,
                              num_portfolios=10, seq_len=6)
    _, params = jload_model(jconfig.Config(model=cfg), n_max=8)
    state = flax_to_torch(params)
    model = FactorVAE(tconfig.ModelConfig(num_features=12, hidden_size=8,
                                          num_factors=4, num_portfolios=10, seq_len=6))
    model.load_state_dict(state)            # strict: every leaf used exactly once
    assert set(state) == set(model.state_dict())
    back = torch_to_flax(model.state_dict())
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(path)
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    # the inner tree alone maps the same way
    inner = flax_to_torch(params["params"]["model"])
    assert all(np.array_equal(inner[k].numpy(), state[k].numpy()) for k in state)


def test_flax_to_torch_refuses_an_incomplete_tree():
    cfg = jconfig.ModelConfig(num_features=12, hidden_size=8, num_factors=4,
                              num_portfolios=10, seq_len=6)
    _, params = jload_model(jconfig.Config(model=cfg), n_max=8)
    state = flax_to_torch(params)
    state.pop("factor_predictor.query")
    model = FactorVAE(tconfig.ModelConfig(num_features=12, hidden_size=8,
                                          num_factors=4, num_portfolios=10, seq_len=6))
    with pytest.raises(RuntimeError, match="factor_predictor.query"):
        model.load_state_dict(state)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """No CUDA device (this host), or the script copied away from the
    repository: a non-zero exit and never an "ok" result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr or "Error" in proc.stderr
