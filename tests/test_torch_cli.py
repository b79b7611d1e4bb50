"""The port's experiment CLI against the JAX CLI, and the port's rollback
recovery against the JAX `Trainer`.

Both CLIs read the same reference-schema pickle, on the CPU (the port's
kernels run their plain versions there). Their runs are deterministic:
`config_from_args` is patched to dropout 0 in both packages, the loss is
the NLL, the scores the prior mean, and the port starts from the JAX
Trainer's initial weights (`params.flax_to_torch`). Tolerances:

- per-epoch losses at rtol 2e-5, the bound of the Trainer test
  (`test_torch_train.py`);
- the scores of the two training runs at rtol 2e-5 / atol 2e-6: the
  weights after three epochs of Adam differ by its magnified rounding
  (read: 3.7e-7 apart at most, on scores up to 0.15);
- scores from the same (carried-over) weights at rtol 1e-5 / atol 1e-6,
  the repo's torch-oracle tolerance, and RankIC and RankIC_IR within 1e-6;
- a run resumed after a crash equals an unbroken run bitwise.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from factorvae_tpu import chaos as jchaos
from factorvae_tpu import cli as jcli
from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import build_panel as jbuild_panel
from factorvae_tpu.data import load_frame as jload_frame
from factorvae_tpu.data import panel_to_frame as jpanel_to_frame
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import chaos, cli
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.params import flax_to_torch, save_weights
from factorvae_tpu_torch.train import trainer as trainer_mod
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils.logging import MetricsLogger

C, T, H, K, M = 6, 5, 8, 4, 10
LOSS_RTOL = 2e-5
TRAINED_SCORE_RTOL, TRAINED_SCORE_ATOL = 2e-5, 2e-6
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
IC_ATOL = 1e-6
DETERMINISTIC = ["--recon_loss", "nll", "--deterministic_scores"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    path = str(root / "panel.pkl")
    jpanel_to_frame(jp).to_pickle(path)
    return root, path, [str(x.date()) for x in jp.dates]


def _argv(data, out, *extra, epochs=3):
    root, path, d = data
    out = os.path.join(str(root), out)
    return ["--dataset", path, "--num_latent", str(C), "--hidden_size", str(H),
            "--num_factor", str(K), "--num_portfolio", str(M), "--seq_len", str(T),
            "--start_time", d[0], "--fit_end_time", d[24], "--val_start_time", d[25],
            "--val_end_time", d[35], "--score_start", d[10], "--score_end", d[35],
            "--num_epochs", str(epochs), "--lr", "1e-3", "--seed", "3", "--run_name", "cli",
            "--save_dir", f"{out}/models", "--score_dir", f"{out}/scores",
            "--metrics_jsonl", f"{out}/run.jsonl", *extra]


def _no_dropout(config_from_args):
    def patched(args):
        cfg = config_from_args(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    return patched


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _named(events, name):
    return [e for e in events if e["event"] == name]


def _csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def _floats(rows, col):
    return np.array([float(r[col]) if r[col] else np.nan for r in rows], np.float32)


@pytest.fixture(scope="module")
def jax_run(data):
    argv = _argv(data, "jax", *DETERMINISTIC, "--no-bf16")
    config_from_args = _no_dropout(jcli.config_from_args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "config_from_args", config_from_args)
        assert jcli.main(argv) == 0
    jcfg = config_from_args(jcli.build_parser().parse_args(argv))
    dataset = JPanelDataset(jbuild_panel(jload_frame(data[1])), seq_len=T)
    weights = flax_to_torch(JTrainer(jcfg, dataset).init_state().params)
    return {"argv": argv, "cfg": jcfg, "weights": weights, "n_max": dataset.n_max,
            "events": _events(argv[argv.index("--metrics_jsonl") + 1]),
            "out": os.path.join(str(data[0]), "jax")}


def _from_weights(weights):
    init_state = Trainer.init_state

    def patched(self):
        state = init_state(self)
        state.model.load_state_dict(weights)
        return state
    return patched


@pytest.fixture(scope="module")
def port_run(data, jax_run):
    argv = _argv(data, "port", *DETERMINISTIC, "--device", "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "config_from_args", _no_dropout(cli.config_from_args))
        mp.setattr(Trainer, "init_state", _from_weights(jax_run["weights"]))
        assert cli.main(argv) == 0
    return {"events": _events(argv[argv.index("--metrics_jsonl") + 1]),
            "out": os.path.join(str(data[0]), "port")}


class TestCliAgainstJax:
    def test_events_losses_and_artifact_names(self, jax_run, port_run):
        got, want = port_run["events"], jax_run["events"]
        # --metrics_jsonl installs a timeline in both CLIs: its spans and marks
        # come beside the run's records, and the epochs' spans are the JAX ones
        timeline = {"span", "mark"}
        names = {e["event"] for e in got} - timeline
        assert names == {"run_meta", "config", "execution_layout", "epoch", "best", "scores"}
        assert ([e["event"] for e in got if e["event"] not in timeline]
                == [e["event"] for e in want if e["event"] in names])

        def epoch_spans(events):
            return [(e["name"], e["resource"]) for e in events if e["event"] == "span"
                    and e["name"].startswith(("train_epoch_", "val_epoch_"))]

        assert epoch_spans(got) == epoch_spans(want) != []
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([e[key] for e in _named(got, "epoch")],
                                       [e[key] for e in _named(want, "epoch")],
                                       rtol=LOSS_RTOL, err_msg=key)
        assert ([e["step"] for e in _named(got, "epoch")]
                == [e["step"] for e in _named(want, "epoch")])
        # the best-weights and full-state checkpoint directories (the JAX
        # package's integrity manifests beside them are ROADMAP Queue 1 item 8)
        dirs = [sorted(n for n in os.listdir(os.path.join(run["out"], "models"))
                       if os.path.isdir(os.path.join(run["out"], "models", n)))
                for run in (port_run, jax_run)]
        name = jax_run["cfg"].checkpoint_name()
        assert dirs[0] == dirs[1] == [name, name + "_ckpt"]
        assert os.listdir(os.path.join(port_run["out"], "scores")) == [
            jax_run["cfg"].score_name() + ".csv"]

    def test_csv_rows(self, jax_run, port_run):
        name = jax_run["cfg"].score_name() + ".csv"
        head, rows = _csv(os.path.join(port_run["out"], "scores", name))
        jhead, jrows = _csv(os.path.join(jax_run["out"], "scores", name))
        assert head == jhead == ["datetime", "instrument", "score", "LABEL0"]
        assert [r[:2] for r in rows] == [r[:2] for r in jrows]
        assert np.array_equal(_floats(rows, 3), _floats(jrows, 3), equal_nan=True)
        np.testing.assert_allclose(_floats(rows, 2), _floats(jrows, 2),
                                   rtol=TRAINED_SCORE_RTOL, atol=TRAINED_SCORE_ATOL)

    def test_score_only_from_the_jax_best_weights(self, data, jax_run):
        """The JAX run's best weights carried across: the port's
        --score_only scores and Rank-IC equal the JAX run's."""
        jcfg = jax_run["cfg"]
        best = os.path.join(jax_run["out"], "models", jcfg.checkpoint_name())
        _, params = jload_model(jcfg, checkpoint_path=best, n_max=jax_run["n_max"])
        argv = _argv(data, "carried", *DETERMINISTIC, "--device", "cpu", "--score_only")
        tcfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        model = FactorVAE(tcfg.model)
        model.load_state_dict(flax_to_torch(params))
        save_weights(model, tcfg, os.path.join(tcfg.train.save_dir, tcfg.checkpoint_name()))
        assert cli.main(argv) == 0
        name = jcfg.score_name() + ".csv"
        head, rows = _csv(os.path.join(str(data[0]), "carried", "scores", name))
        jhead, jrows = _csv(os.path.join(jax_run["out"], "scores", name))
        assert head == jhead and [r[:2] for r in rows] == [r[:2] for r in jrows]
        np.testing.assert_allclose(_floats(rows, 2), _floats(jrows, 2),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
        got = _named(_events(argv[argv.index("--metrics_jsonl") + 1]), "scores")[0]
        want = _named(jax_run["events"], "scores")[0]
        for key in ("rank_ic", "rank_ic_ir"):
            assert np.isfinite(got[key])
            assert abs(got[key] - want[key]) <= IC_ATOL, key


class _Crash(Exception):
    pass


class TestCliResume:
    def test_resume_after_a_crash_equals_an_unbroken_run_bitwise(self, data, monkeypatch):
        """The default, stochastic settings (dropout, the sampled loss and
        scores), so the noise generator must round-trip too."""
        full = _argv(data, "full", "--device", "cpu")
        part = _argv(data, "part", "--device", "cpu")
        assert cli.main(full) == 0
        calls = []
        train_epoch = trainer_mod.train_epoch

        def crash_at_epoch_2(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise _Crash()
            return train_epoch(*a, **kw)

        monkeypatch.setattr(trainer_mod, "train_epoch", crash_at_epoch_2)
        with pytest.raises(_Crash):
            cli.main(part)
        monkeypatch.setattr(trainer_mod, "train_epoch", train_epoch)
        assert cli.main(part + ["--resume"]) == 0

        root = str(data[0])
        ev_full = _events(os.path.join(root, "full", "run.jsonl"))
        ev_part = _events(os.path.join(root, "part", "run.jsonl"))
        assert [e["epoch"] for e in _named(ev_part, "resume")] == [2]
        done, redone = _named(ev_full, "epoch")[2], _named(ev_part, "epoch")[-1]
        for key in ("epoch", "train_loss", "val_loss", "lr", "step"):
            assert done[key] == redone[key], key
        assert _named(ev_full, "scores")[0]["rank_ic"] == _named(ev_part, "scores")[-1]["rank_ic"]
        name = "cli_factor_4_hdn_8_port_10_seed_3"
        a, b = (torch.load(os.path.join(root, run, "models", name, "weights.pt"))
                for run in ("full", "part"))
        assert all(torch.equal(a[k], b[k]) for k in a)
        csv_name = "cli_4_True_None_6_8.csv"
        with open(os.path.join(root, "full", "scores", csv_name), "rb") as fa, \
                open(os.path.join(root, "part", "scores", csv_name), "rb") as fb:
            assert fa.read() == fb.read()


def _trainers(tmp_path, epochs, **train):
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    d = [str(x.date()) for x in jp.dates]
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=3, recover_after=2,
                                  save_dir=str(tmp_path / "jax"), **train))
    tcfg = tconfig.Config.from_dict(jcfg.to_dict())
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, save_dir=str(tmp_path / "port")))
    jlog = JMetricsLogger(jsonl_path=str(tmp_path / "jax.jsonl"), echo=False)
    tlog = MetricsLogger(jsonl_path=str(tmp_path / "port.jsonl"), echo=False)
    # the JAX Trainer compiles its chaos trace only if a plan is installed
    # when it is built
    jtr = lambda: JTrainer(jcfg, JPanelDataset(jp, seq_len=T), logger=jlog)  # noqa: E731
    tr = Trainer(tcfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu", logger=tlog)
    return jtr, tr


class TestRecoveryAgainstJax:
    @pytest.mark.parametrize("case", ["rollback", "rollback_unavailable"])
    def test_same_trail_events_and_losses(self, tmp_path, case):
        """`rollback`: nan_grads at epochs 2 and 3 of 6, a checkpoint every
        epoch: the streak rolls back to epoch 1 at half the lr and replays.
        `rollback_unavailable`: nan_grads at epochs 0 and 1 of 4 with no
        checkpoints: the lr is halved in place."""
        if case == "rollback":
            epochs, faults, train = 6, (2, 3), {}
            trail, event = [0, 1, 2, 3, 2, 3, 4, 5], {"restored_step": 1}
        else:
            epochs, faults, train = 4, (0, 1), {"checkpoint_every": 0}
            trail, event = [0, 1, 2, 3], {"epoch": 1}
        make_jtr, tr = _trainers(tmp_path, epochs, **train)
        with jchaos.active(jchaos.ChaosPlan([jchaos.Fault("nan_grads", epoch=e)
                                             for e in faults])):
            jtr = make_jtr()
            jstate = jtr.init_state()
            weights = flax_to_torch(jstate.params)
            _, jout = jtr.fit(state=jstate)
        plan = chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=e) for e in faults])
        state = tr.init_state()
        state.model.load_state_dict(weights)
        with chaos.active(plan):
            state, out = tr.fit(state=state)
        assert len(plan.fired) == 2
        hist, jhist = out["history"], jout["history"]
        assert [r["epoch"] for r in hist] == [r["epoch"] for r in jhist] == trail
        assert ([r["skipped_steps"] for r in hist]
                == [r["skipped_steps"] for r in jhist])
        assert sum(r["skipped_steps"] > 0 for r in hist) == 2
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([r[key] for r in hist], [r[key] for r in jhist],
                                       rtol=LOSS_RTOL, err_msg=key)
        tr.logger.finish()
        jtr.logger.finish()
        got = _named(_events(str(tmp_path / "port.jsonl")), "recovery")
        want = _named(_events(str(tmp_path / "jax.jsonl")), "recovery")
        assert len(got) == len(want) == 1
        assert got[0]["kind"] == want[0]["kind"] == case
        assert got[0]["lr_scale"] == want[0]["lr_scale"] == 0.5
        for key, value in event.items():
            assert got[0][key] == want[0][key] == value
        assert all(torch.isfinite(p).all() for p in state.model.parameters())


class TestChaosEnvironment:
    def test_the_variable_is_read_once_per_process_as_in_jax(self, monkeypatch):
        """FACTORVAE_CHAOS is parsed at the first query only: its fault
        fires once, a later text is not read, and `active` re-arms the
        check on exit. The JAX module answers the same queries alike."""
        def queries(mod):
            monkeypatch.setattr(mod, "_PLAN", None)
            monkeypatch.setattr(mod, "_ENV_CHECKED", False)
            plan = mod.ChaosPlan([mod.Fault("nan_grads", epoch=1)])
            monkeypatch.setenv(mod.ENV_VAR, plan.to_json())
            got = [mod.fault("nan_grads", epoch=0), mod.fault("nan_grads", epoch=1),
                   mod.fault("nan_grads", epoch=1)]
            monkeypatch.setenv(mod.ENV_VAR, mod.ChaosPlan(
                [mod.Fault("nan_grads", epoch=2)]).to_json())
            got.append(mod.fault("nan_grads", epoch=2))
            monkeypatch.setattr(mod, "_PLAN", None)
            monkeypatch.setattr(mod, "_ENV_CHECKED", False)
            with mod.active(mod.ChaosPlan([])):
                got.append(mod.fault("nan_grads", epoch=2))
            got.append(mod.fault("nan_grads", epoch=2))     # re-armed: read now
            return [None if f is None else (f.kind, f.epoch) for f in got]

        want = [None, ("nan_grads", 1), None, None, None, ("nan_grads", 2)]
        assert queries(chaos) == queries(jchaos) == want

    def test_an_unported_kind_in_the_variable_raises(self, monkeypatch):
        monkeypatch.setattr(chaos, "_PLAN", None)
        monkeypatch.setattr(chaos, "_ENV_CHECKED", False)
        monkeypatch.setenv(chaos.ENV_VAR, json.dumps(
            {"seed": 0, "faults": [{"kind": "kill_everything", "step": 1}]}))
        with pytest.raises(ValueError, match="unknown chaos fault kind 'kill_everything'"):
            chaos.fault("nan_grads", epoch=1)


REFUSED = [
    (["--no-pallas"], "--no-pallas", None),
    # above the CUDA kernels' kMaxH on the card (ROADMAP Queue 2 "Limits")
    (["--hidden_size", "96", "--device", "cuda"], "hidden_size 96", None),
]


class TestCliObs:
    """The observability flags, each on a CPU run of the CLI."""

    def test_obs_logs_probes_and_a_timeline_into_run_jsonl(self, data, monkeypatch, tmp_path):
        from factorvae_tpu.obs import report as jreport
        from factorvae_tpu.obs import timeline as jtimeline

        from factorvae_tpu_torch.obs.probes import EVAL_PROBE_KEYS, TRAIN_PROBE_KEYS

        monkeypatch.chdir(tmp_path)
        argv = [a for a in _argv(data, "obs", "--device", "cpu", "--obs", epochs=2)]
        i = argv.index("--metrics_jsonl")
        del argv[i:i + 2]                                # --obs alone: RUN.jsonl here
        assert cli.main(argv) == 0
        recs = [json.loads(x) for x in open(tmp_path / "RUN.jsonl")]
        (obs,) = [r for r in recs if r["event"] == "obs"]
        assert obs == {**obs, "probes": True, "run_jsonl": "RUN.jsonl"}
        epochs = [r for r in recs if r["event"] == "epoch"]
        assert len(epochs) == 2
        for rec in epochs:
            assert set(TRAIN_PROBE_KEYS) <= set(rec)
            assert {"val_" + k for k in EVAL_PROBE_KEYS} <= set(rec)
        run = jtimeline.load_run(str(tmp_path / "RUN.jsonl"))
        assert {"train_epoch_0", "val_epoch_1"} <= {s["name"] for s in run["spans"]}
        assert jreport.build_report(run)["flags"] == []

    def test_prom_textfile_holds_the_last_epoch(self, data):
        from factorvae_tpu.obs import metrics as jmetrics

        root = data[0]
        prom = os.path.join(str(root), "obs_prom", "x.prom")
        assert cli.main(_argv(data, "obs_prom", "--device", "cpu", "--prom_textfile", prom,
                              epochs=2)) == 0
        epochs = [r for r in map(json.loads, open(os.path.join(str(root), "obs_prom",
                                                                 "run.jsonl")))
                  if r["event"] == "epoch"]
        jexp = jmetrics.TextfileExporter(prom + ".jax")
        for rec in epochs:
            jexp.export_epoch({k: v for k, v in rec.items() if k not in ("ts", "event")})
        text = open(prom).read()
        assert text == open(prom + ".jax").read()
        assert "factorvae_train_epoch 1" in text and "factorvae_train_epochs_total 2" in text

    def test_profile_captures_training_and_scoring(self, data, capsys):
        from factorvae_tpu_torch.utils import trace_summary

        out = os.path.join(str(data[0]), "obs_profile", "trace")
        assert cli.main(_argv(data, "obs_profile", "--device", "cpu", "--profile", out,
                              epochs=1)) == 0
        capsys.readouterr()
        assert trace_summary.main([out, "--top", "40"]) == 0
        text = capsys.readouterr().out
        assert "trace files : 1" in text and "train_epoch_0" in text

    def test_debug_nans_runs_training_in_anomaly_mode(self, data, monkeypatch):
        seen = []
        fit = Trainer.fit

        def spy(self, *a, **kw):
            seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()))
            return fit(self, *a, **kw)

        monkeypatch.setattr(Trainer, "fit", spy)
        assert cli.main(_argv(data, "obs_nans", "--device", "cpu", "--debug_nans",
                              epochs=1)) == 0
        assert seen == [(True, True)] and not torch.is_anomaly_enabled()


def _read_nothing(monkeypatch):
    opened = []
    load_frame = cli.load_frame

    def recording(*a, **kw):
        opened.append(a)
        return load_frame(*a, **kw)

    monkeypatch.setattr(cli, "load_frame", recording)
    return opened


class TestCliRefusals:
    @pytest.mark.parametrize("extra,flag,item", REFUSED, ids=[r[1] for r in REFUSED])
    def test_refused_flag_exits_2_before_the_dataset(self, data, monkeypatch, capsys,
                                                     extra, flag, item):
        opened = _read_nothing(monkeypatch)
        assert cli.main(_argv(data, "refused", "--device", "cpu", *extra)) == 2
        err = capsys.readouterr().err.strip()
        assert err.startswith(f"error: {flag}") and len(err.splitlines()) == 1
        assert "ROADMAP" in err and (item is None or f"Queue 1 item {item})" in err)
        assert opened == []

    @pytest.mark.parametrize("extra", [["--pallas"], ["--pallas_auto"], ["--no-bf16"],
                                       ["--fleet_seeds", "1"], ["--fleet_seeds", "3"],
                                       ["--hyper_grid", "1e-3:1,3e-3:0.1"], ["--no-obs"],
                                       ["--panel_residency", "hbm"],
                                       ["--compile_cache", "off"], ["--num_workers", "8"],
                                       ["--bf16"], ["--int8_scores"]],
                             ids=lambda e: " ".join(e))
    def test_accepted_flags_change_nothing(self, extra):
        """Accepted, and nothing in the config changes but what the flag
        sets: --bf16 the compute dtype (--int8_scores acts at scoring)."""
        base = cli.build_parser().parse_args(["--device", "cpu"])
        args = cli.build_parser().parse_args(["--device", "cpu", *extra])
        assert cli.refusal(args) is None
        want = cli.config_from_args(base).to_dict()
        if extra == ["--bf16"]:
            want["model"]["compute_dtype"] = "bfloat16"
        assert cli.config_from_args(args).to_dict() == want

    def test_stream_flags_set_the_data_config(self):
        args = cli.build_parser().parse_args(["--device", "cpu", "--panel_residency",
                                              "stream", "--stream_chunk_days", "8"])
        assert cli.refusal(args) is None
        data = cli.config_from_args(args).data
        assert (data.panel_residency, data.stream_chunk_days) == ("stream", 8)
        preset = cli.build_parser().parse_args(["--device", "cpu", "--preset", "flagship",
                                                "--panel_residency", "stream"])
        assert cli.config_from_args(preset).data.panel_residency == "stream"

    @pytest.mark.parametrize("fleet", [["--fleet_seeds", "2"],
                                       ["--hyper_grid", "1e-3:1,3e-3:0.1"]],
                             ids=["fleet_seeds", "hyper_grid"])
    def test_fleet_flags_with_stream_residency_write_the_hbm_csv(self, data, fleet):
        """A fleet on a stream-resident panel: the winner's score CSV byte
        for byte the "hbm" run's."""
        csvs = []
        for name, extra in (("hbm", []), ("stream", ["--panel_residency", "stream",
                                                     "--stream_chunk_days", "8"])):
            argv = _argv(data, f"stream_{fleet[0][2:]}_{name}", "--device", "cpu", *fleet,
                         *extra, epochs=1)
            assert cli.main(argv) == 0
            (scores,) = _named(_events(argv[argv.index("--metrics_jsonl") + 1]), "scores")
            with open(scores["path"], "rb") as fh:
                csvs.append(fh.read())
        assert csvs[0] == csvs[1] and len(csvs[0]) > 100

    @pytest.mark.parametrize("case", ["missing_dataset", "empty_train_split",
                                      "feature_mismatch", "no_checkpoint", "no_cuda"])
    def test_exit_2_errors(self, data, monkeypatch, capsys, case):
        argv = _argv(data, f"err_{case}", "--device", "cpu")
        want = {"missing_dataset": "error: dataset not found",
                "empty_train_split": "error: no trading days in [2000-01-01, 2000-02-01]",
                "feature_mismatch": "error: model expects 7 features",
                "no_checkpoint": "error: no checkpoint at",
                "no_cuda": "error: no CUDA device"}[case]
        if case == "missing_dataset":
            argv[argv.index("--dataset") + 1] = "/nonexistent/panel.pkl"
        elif case == "empty_train_split":
            argv += ["--start_time", "2000-01-01", "--fit_end_time", "2000-02-01"]
        elif case == "feature_mismatch":
            argv += ["--num_latent", "7"]
        elif case == "no_checkpoint":
            argv += ["--score_only"]
        else:
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
            argv += ["--device", "cuda"]
        assert cli.main(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith(want), err
        if case == "empty_train_split":
            assert "the dataset covers [" in err


class TestCliMesh:
    """`--mesh` in one process is the 1 x 1 mesh (the multi-rank CLI under
    torchrun is tests/test_torch_multihost.py): the CSV is the run's without
    --mesh byte for byte, serial and fleets alike; a 'stock' axis the world
    cannot hold exits 2 with one line, after the panel is read."""

    @pytest.mark.parametrize("extra", [[], ["--fleet_seeds", "3"],
                                       ["--hyper_grid", "1e-3:1,3e-3:0.1"]],
                             ids=["serial", "fleet_seeds", "hyper_grid"])
    def test_mesh_in_one_process_writes_the_plain_csv(self, data, extra):
        out = {}
        for name, mesh in (("plain", []), ("mesh", ["--mesh"])):
            tag = f"mesh1x1_{name}_{'_'.join(extra) or 'serial'}".replace(":", "")
            assert cli.main(_argv(data, tag, "--device", "cpu", *extra, *mesh,
                                  epochs=1)) == 0
            scores = os.path.join(str(data[0]), tag, "scores")
            (csv_name,) = os.listdir(scores)
            out[name] = open(os.path.join(scores, csv_name)).read()
        assert out["mesh"] == out["plain"]

    def test_a_stock_axis_the_world_cannot_hold_exits_2(self, data, capsys):
        assert cli.main(_argv(data, "mesh_too_wide", "--device", "cpu", "--mesh",
                              "--mesh_stock", "2", epochs=1)) == 2
        err = capsys.readouterr().err.strip()
        assert err.startswith("error: cannot build the requested (data x stock) mesh")
        assert len(err.splitlines()) == 1 and "not divisible by stock axis 2" in err

    def test_mesh_stock_below_one_is_refused_before_the_dataset(self, data, monkeypatch,
                                                               capsys):
        opened = _read_nothing(monkeypatch)
        assert cli.main(_argv(data, "refused", "--device", "cpu", "--mesh",
                              "--mesh_stock", "0")) == 2
        err = capsys.readouterr().err.strip()
        assert err.startswith("error: --mesh_stock 0") and len(err.splitlines()) == 1
        assert opened == []


CONFIG_ARGV = [
    [],
    ["--num_epochs", "5", "--lr", "3e-4", "--seed", "7", "--run_name", "r",
     "--save_dir", "/tmp/x", "--dataset", "d.pkl", "--start_time", "2010-01-01",
     "--end_time", "2019-12-31", "--max_stocks", "320"],
    ["--num_latent", "360", "--seq_len", "60", "--hidden_size", "60", "--num_factor",
     "60", "--num_portfolio", "64"],
    ["--preset", "flagship"],
    ["--preset", "csi300-k60", "--num_epochs", "2", "--lr", "1e-3", "--seed", "1",
     "--fit_end_time", "2016-12-31", "--deterministic_scores"],
    ["--preset", "alpha360-k60", "--recon_loss", "nll", "--kl_weight", "0.5",
     "--days_per_step", "4", "--wandb"],
    ["--recon_loss", "nll"],
    ["--kl_weight", "0.1", "--stochastic_scores"],
    ["--days_per_step", "8", "--deterministic_scores", "--no-obs"],
]


class TestCliExport:
    def test_export_writes_an_artifact_whose_scores_equal_score_only(self, data, port_run):
        """--score_only --export on the trained run's best weights: the
        artifact (one exported call per day) gives the CSV's scores, at the
        repo's score tolerance (the CSV is scored 32 days per call)."""
        import shutil

        from factorvae_tpu_torch.eval.predict import score_table
        from factorvae_tpu_torch.serve.registry import ModelRegistry

        out = os.path.join(str(data[0]), "exported")
        shutil.copytree(os.path.join(port_run["out"], "models"), os.path.join(out, "models"))
        path = os.path.join(out, "model.aot")
        argv = _argv(data, "exported", *DETERMINISTIC, "--device", "cpu", "--score_only",
                     "--export", path)
        assert cli.main(argv) == 0
        args = cli.build_parser().parse_args(argv)
        cfg = cli.config_from_args(args)
        exported = _named(_events(argv[argv.index("--metrics_jsonl") + 1]), "export")
        assert exported[0]["path"] == path and exported[0]["bytes"] == os.path.getsize(path)
        dataset = PanelDataset(cli.build_panel(cli.load_frame(data[1])), seq_len=T,
                               device="cpu")
        reg = ModelRegistry(device="cpu")
        reg.register_artifact(path)
        assert reg.get("model.aot").artifact.header["platforms"] == ["cpu"]
        days = dataset.split_days(args.score_start, args.score_end)
        table = score_table(dataset, days, reg.score("model.aot", dataset, days))
        _, rows = _csv(os.path.join(out, "scores", cfg.score_name() + ".csv"))
        assert len(rows) == len(table["score"])
        np.testing.assert_allclose(np.asarray(table["score"], np.float32), _floats(rows, 2),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)

    def test_export_platform_tpu_is_refused_by_name(self, data, monkeypatch, capsys):
        opened = _read_nothing(monkeypatch)
        assert cli.main(_argv(data, "refused", "--device", "cpu", "--export", "m.aot",
                              "--export_platform", "tpu")) == 2
        err = capsys.readouterr().err.strip()
        assert err.startswith("error: --export_platform tpu") and len(err.splitlines()) == 1
        assert "cuda or cpu" in err and opened == []


class TestConfigFromArgs:
    @pytest.mark.parametrize("argv", CONFIG_ARGV, ids=lambda a: " ".join(a) or "defaults")
    def test_equals_the_jax_config(self, argv):
        """Equal `to_dict()` but for the fields the port leaves out or
        fixes: the Pallas knobs and the compute dtype (float32 here)."""
        got = cli.config_from_args(cli.build_parser().parse_args(argv)).to_dict()
        want = jcli.config_from_args(jcli.build_parser().parse_args(argv)).to_dict()
        assert got["model"].pop("compute_dtype") == "float32"
        want["model"].pop("compute_dtype")
        assert set(want["model"]) - set(got["model"]) == {"use_pallas_attention",
                                                          "use_pallas_gru"}
        for key in ("use_pallas_attention", "use_pallas_gru"):
            want["model"].pop(key)
        assert got == want

    def test_parser_has_every_jax_flag_with_its_default(self):
        def flags(parser):
            return {a.dest: (tuple(a.option_strings), a.default)
                    for a in parser._actions if a.dest != "help"}

        got, want = flags(cli.build_parser()), flags(jcli.build_parser())
        assert set(got) - set(want) == {"device"}
        assert {k: got[k] for k in want} == want


# ---- --auto_plan and --compile_cache ---------------------------------------

# the row's width: the pickle's 11 instruments, padded to 12 under a plan
PLAN_N = 11


def _plan_row(platform="cpu", **blocks):
    return {"platform": platform, "shape": {"c": C, "t": T, "h": H, "k": K, "m": M},
            "n_min": PLAN_N, "n_max": PLAN_N, "pad_target": 12,
            "train": {"flatten_days": True, "days_per_step": 4, "compute_dtype": "float32"},
            "score": {"flatten_days": True, "compute_dtype": "float32"},
            "source": "test row: train 0.0100 s/day", **blocks}


@pytest.fixture
def plan_table(tmp_path, monkeypatch):
    """Point both packages' planners at a table of the given rows (the same
    rows written by each package's save_rows)."""
    from factorvae_tpu import plan as jplan
    from factorvae_tpu_torch import plan as tplan

    def write(*rows):
        j, t = str(tmp_path / "jax_table.json"), str(tmp_path / "torch_table.json")
        jplan.save_rows(rows, path=j)
        tplan.save_rows(rows, path=t)
        monkeypatch.setenv(jplan.PLAN_TABLE_ENV, j)
        monkeypatch.setenv(tplan.PLAN_TABLE_ENV, t)
    return write


def _plan_knobs(rec: dict) -> dict:
    kernel = ("use_pallas_attention", "use_pallas_gru", "kernel_gru", "kernel_attention",
              "kernels_resolved", "ts", "event")
    return {k: v for k, v in rec.items() if k not in kernel}


class TestCliPlan:
    def test_plan_record_equals_the_jax_clis(self, data, plan_table):
        """Both CLIs log their `plan` record before --score_only finds no
        checkpoint; the knobs are equal, the kernels' route is the port's."""
        plan_table(_plan_row(fleet={"seeds_per_program": 2}, serve={"hedge_ms": 0}),
                   _plan_row("gpu", train={"days_per_step": 8}))
        assert jcli.main(_argv(data, "jplan", "--auto_plan", "--score_only")) == 2
        assert cli.main(_argv(data, "tplan", "--auto_plan", "--score_only",
                              "--device", "cpu")) == 2
        (want,) = _named(_events(os.path.join(str(data[0]), "jplan", "run.jsonl")), "plan")
        (got,) = _named(_events(os.path.join(str(data[0]), "tplan", "run.jsonl")), "plan")
        assert _plan_knobs(got) == _plan_knobs(want)
        assert got["provenance"] == "measured" and got["days_per_step"] == 4
        assert got["pad_target"] == 12 and got["seeds_per_program"] == 2
        assert got["kernels_resolved"] == {"attention": "plain", "gru": "plain"}

    def test_auto_plan_trains_the_rows_knobs(self, data, plan_table):
        """The trained config takes the row's days_per_step, dtype and pad,
        and the scores CSV is byte for byte the one of a run given the same
        knobs as explicit flags."""
        plan_table(_plan_row())
        root = str(data[0])
        assert cli.main(_argv(data, "auto", "--auto_plan", "--device", "cpu", epochs=2)) == 0
        assert cli.main(_argv(data, "flags", "--days_per_step", "4", "--max_stocks", "12",
                              "--device", "cpu", epochs=2)) == 0
        events = _events(os.path.join(root, "auto", "run.jsonl"))
        (rec,) = _named(events, "plan")
        assert rec["provenance"] == "measured" and rec["source"].startswith("test row")
        # obs/report reads the promised rate off the record's source
        from factorvae_tpu_torch.obs.report import plan_measured_days_per_sec

        assert plan_measured_days_per_sec(events) == pytest.approx(100.0)
        (layout,) = _named(events, "execution_layout")
        assert (layout["days_per_step"], layout["compute_dtype"], layout["n_padded"]) == \
            (4, "float32", 12)
        assert _named(_events(os.path.join(root, "flags", "run.jsonl")), "plan") == []
        (name,) = os.listdir(os.path.join(root, "auto", "scores"))
        assert open(os.path.join(root, "auto", "scores", name), "rb").read() == \
            open(os.path.join(root, "flags", "scores", name), "rb").read()

    def test_explicit_flags_keep_precedence(self, data, plan_table):
        plan_table(_plan_row(train_remat={"remat": "full"}))
        assert cli.main(_argv(data, "kept", "--auto_plan", "--days_per_step", "2",
                              "--max_stocks", "16", "--bf16", "--device", "cpu",
                              epochs=1)) == 0
        events = _events(os.path.join(str(data[0]), "kept", "run.jsonl"))
        (rec,) = _named(events, "plan")
        assert (rec["days_per_step"], rec["pad_target"], rec["compute_dtype"]) == \
            (4, 12, "float32")
        (layout,) = _named(events, "execution_layout")
        assert (layout["days_per_step"], layout["n_padded"], layout["compute_dtype"]) == \
            (2, 16, "bfloat16")
        (cfg,) = [tconfig.Config.from_json(e["json"]) for e in _named(events, "config")]
        assert cfg.train.remat == "none"      # the config record is the flags' config

    def test_a_width_outside_every_row_takes_the_default(self, data, plan_table):
        plan_table({**_plan_row(), "n_min": 12, "n_max": 20})
        assert cli.main(_argv(data, "dflt", "--auto_plan", "--score_only",
                              "--device", "cpu")) == 2
        (rec,) = _named(_events(os.path.join(str(data[0]), "dflt", "run.jsonl")), "plan")
        assert rec["provenance"] == "default" and rec["days_per_step"] == 1

    def test_fleet_seeds_train_in_programs_of_the_rows_width(self, data, plan_table):
        plan_table(_plan_row(train={"days_per_step": 1}, fleet={"seeds_per_program": 2}))
        assert cli.main(_argv(data, "fleet_plan", "--auto_plan", "--fleet_seeds", "4",
                              "--device", "cpu", epochs=1)) == 0
        events = _events(os.path.join(str(data[0]), "fleet_plan", "run.jsonl"))
        assert [e["seeds"] for e in _named(events, "fleet_execution_layout")] == \
            [[3, 4], [5, 6]]
        assert [e["seed"] for e in _named(events, "sweep_seed")] == [3, 4, 5, 6]
        assert len(_named(events, "fleet_sweep")) == 1

    @pytest.mark.parametrize("blocks,lanes,groups", [
        ({"hyper": {"lanes_per_program": 2}, "fleet": {"seeds_per_program": 3}}, 2, [2, 1]),
        ({"fleet": {"seeds_per_program": 2}}, 2, [2, 1]),
        ({"fleet": {"seeds_per_program": 1}}, 3, [3])],
        ids=["lanes", "seeds_above_1", "whole_grid"])
    def test_hyper_grid_lanes_then_seeds_then_the_whole_grid(self, data, plan_table,
                                                             blocks, lanes, groups):
        plan_table(_plan_row(train={"days_per_step": 1}, **blocks))
        out = "grid_" + "_".join(f"{k}{v}" for b in blocks.values() for k, v in b.items())
        assert cli.main(_argv(data, out, "--auto_plan", "--hyper_grid",
                              "1e-3:1,3e-3:0.5,2e-3:0.1", "--device", "cpu", epochs=1)) == 0
        events = _events(os.path.join(str(data[0]), out, "run.jsonl"))
        (bucket,) = _named(events, "grid_bucket")
        assert bucket["lanes_per_program"] == lanes
        assert [len(e["seeds"]) for e in _named(events, "fleet_execution_layout")] == groups
        assert len(_named(events, "grid_point")) == 3

    def test_compile_cache_dir_is_logged_and_off_is_off(self, data, monkeypatch, tmp_path):
        from factorvae_tpu_torch import _build

        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        monkeypatch.delenv("FACTORVAE_COMPILE_CACHE", raising=False)
        cache = str(tmp_path / "cc")
        assert cli.main(_argv(data, "cc", "--compile_cache", cache, "--score_only",
                              "--device", "cpu")) == 2
        (rec,) = _named(_events(os.path.join(str(data[0]), "cc", "run.jsonl")),
                        "compile_cache")
        assert rec["dir"] == cache and os.path.isdir(cache) and _build.BUILD_DIR == tmp_path / "cc"
        monkeypatch.setenv("FACTORVAE_COMPILE_CACHE", str(tmp_path / "env"))
        assert cli.main(_argv(data, "cc_off", "--compile_cache", "off", "--score_only",
                              "--device", "cpu")) == 2
        assert _named(_events(os.path.join(str(data[0]), "cc_off", "run.jsonl")),
                      "compile_cache") == []
        assert not (tmp_path / "env").exists()
        assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
