"""The port's execution planner (`factorvae_tpu_torch/plan.py`) against the
JAX planner, and its autotune tool on the CPU.

The JAX `plan_for`, `apply_plan`, `pad_target_policy`, `describe` and
`save_rows` are the oracle on the same explicit tables, for the "cpu" and
"gpu" platforms. The port's `Plan` has no kernel switch, so the JAX plan's
`use_pallas_attention`, `use_pallas_gru`, `kernel_gru` and
`kernel_attention` are set aside, and the JAX config's `use_pallas_*`.
Everything else must be equal: the resolution is exact, no tolerance.

The autotune tool runs with `--device cpu --days 4 --reps 1` on a tiny shape
(C 6, T 5, H 8, K 4, M 8 at 10 and 12 stocks) added to its `SHAPES` for the
test; its timings are CPU timings and are only checked to be recorded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import tarfile

import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu import plan as jplan
from factorvae_tpu_torch import _build, autotune
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch import plan as tplan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_KEYS = ("use_pallas_attention", "use_pallas_gru", "kernel_gru", "kernel_attention")
K60 = dict(num_features=158, seq_len=20, hidden_size=60, num_factors=60, num_portfolios=128)
FLAGSHIP = dict(num_features=158, seq_len=20, hidden_size=64, num_factors=96,
                num_portfolios=128)


def _shapes(n, **shape):
    shape = shape or K60
    return jplan.ShapeKey(n_stocks=n, **shape), tplan.ShapeKey(n_stocks=n, **shape)


def row(platform, n_min=300, n_max=300, shape=None, **kw):
    s = shape or K60
    r = {"platform": platform,
         "shape": {"c": s["num_features"], "t": s["seq_len"], "h": s["hidden_size"],
                   "k": s["num_factors"], "m": s["num_portfolios"]},
         "n_min": n_min, "n_max": n_max,
         "train": {"flatten_days": True, "days_per_step": 4, "compute_dtype": "bfloat16"},
         "score": {"flatten_days": False, "compute_dtype": "float32"},
         "source": "test row"}
    r.update(kw)
    return r


def _no_envelope(p):
    r = row(p)
    del r["n_min"], r["n_max"]
    return [r]


def _no_score(p):
    r = row(p)
    del r["score"]
    return [r]


# (id, table for a platform, queried width): one case per row block of the
# JAX planner's tests
CASES = [
    ("envelope_inside", lambda p: [row(p, 280, 320)], 300),
    ("envelope_below", lambda p: [row(p, 310, 320)], 300),
    ("envelope_missing", _no_envelope, 300),
    ("other_platform", lambda p: [row("gpu" if p == "cpu" else "cpu")], 300),
    ("other_shape", lambda p: [row(p, shape=FLAGSHIP)], 300),
    ("first_match_wins", lambda p: [row(p, 250, 350, train={"days_per_step": 2}),
                                    row(p, 300, 300)], 300),
    ("score_inherits_train", _no_score, 300),
    ("row_pad_target", lambda p: [row(p, pad_target=320)], 300),
    ("fleet", lambda p: [row(p, fleet={"seeds_per_program": 4})], 300),
    ("fleet_null", lambda p: [row(p, fleet=None)], 300),
    ("hyper", lambda p: [row(p, hyper={"lanes_per_program": 8})], 300),
    ("stream", lambda p: [row(p, stream={"panel_residency": "stream", "chunk_days": 16})],
     300),
    ("stream_null", lambda p: [row(p, stream={})], 300),
    ("obs", lambda p: [row(p, obs={"probes": True})], 300),
    ("serve_precision", lambda p: [row(p, serve={"precision": "int8"})], 300),
    ("serve_tick", lambda p: [row(p, serve={"tick_ms": 0, "max_tick_batch": 32})], 300),
    ("serve_hedge_zero", lambda p: [row(p, serve={"hedge_ms": 0, "slo_ms": 50.0})], 300),
    ("serve_null", lambda p: [row(p, serve=None)], 300),
    ("train_precision", lambda p: [row(p, train_precision={"precision": "bfloat16",
                                                           "fidelity": 0.9})], 300),
    ("train_remat", lambda p: [row(p, train_remat={"remat": "dots"})], 300),
    ("mesh_with_dps", lambda p: [row(p, mesh={"data_axis": 2, "stock_axis": 2,
                                              "days_per_step": 2})], 300),
    ("mesh_without_dps", lambda p: [row(p, mesh={"data_axis": 2, "stock_axis": 2})], 300),
    ("budgets", lambda p: [row(p, budgets={"compile_seconds": 30.0,
                                           "peak_hbm_bytes": 1 << 30,
                                           "comm_bytes_per_epoch": 123})], 300),
    ("null_blocks", lambda p: [row(p, fleet=None, hyper=None, stream=None, obs=None,
                                   serve=None, train_precision=None, train_remat=None,
                                   mesh=None, budgets=None)], 300),
    ("kernels_block", lambda p: [row(p, kernels={"gru": "xla", "attention": "pallas"})],
     300),
    ("default", lambda p: [], 356),
]
PLATFORMS = ["cpu", "gpu"]


def _jax_plan_dict(p) -> dict:
    return {k: v for k, v in p.to_dict().items() if k not in KERNEL_KEYS}


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("shard", [1, 3])
@pytest.mark.parametrize("case,table,n", CASES, ids=[c[0] for c in CASES])
def test_plan_for_resolves_the_jax_plan(case, table, n, shard, platform):
    js, ts = _shapes(n)
    rows = table(platform)
    want = jplan.plan_for(js, platform, table=rows, shard=shard)
    got = tplan.plan_for(ts, platform, table=rows, shard=shard)
    assert got.to_dict() == _jax_plan_dict(want)
    assert got.provenance == ("default" if case in ("envelope_below", "envelope_missing",
                                                    "other_platform", "other_shape",
                                                    "default") else "measured")
    assert got == tplan.plan_for_config(tconfig.Config(model=tconfig.ModelConfig(**K60)),
                                        n, platform, shard, rows)
    d = got.describe(ts, platform=platform)
    want_d = want.describe(js, platform=platform)
    assert {k: v for k, v in d.items() if k != "kernels_resolved"} == \
        {k: v for k, v in want_d.items() if k not in (*KERNEL_KEYS, "kernels_resolved")}
    route = "cuda" if platform == "gpu" else "plain"
    assert d["kernels_resolved"] == {"attention": route, "gru": route}


def _configs():
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**K60), data=jconfig.DataConfig(seq_len=20),
                          train=jconfig.TrainConfig(remat="full", obs_probes=True))
    return jcfg, tconfig.Config.from_dict(jcfg.to_dict())


def _config_dict(cfg) -> dict:
    d = cfg.to_dict()
    d["model"] = {k: v for k, v in d["model"].items() if not k.startswith("use_pallas")}
    return d


KEEPS = [{}, {"keep_days_per_step": True, "keep_dtype": True, "keep_pad": True},
         {"keep_residency": True, "keep_obs": True, "keep_remat": True},
         {"keep_layout": True}, {"keep_mesh": True}]


@pytest.mark.parametrize("keep", KEEPS, ids=lambda k: "+".join(k) or "none")
@pytest.mark.parametrize("case,table,n", CASES, ids=[c[0] for c in CASES])
def test_apply_plan_gives_the_jax_config(case, table, n, keep):
    jcfg, tcfg = _configs()
    js, ts = _shapes(n)
    rows = table("gpu")
    got = tplan.apply_plan(tcfg, tplan.plan_for(ts, "cuda", table=rows), **keep)
    want = jplan.apply_plan(jcfg, jplan.plan_for(js, "gpu", table=rows), **keep)
    assert _config_dict(got) == _config_dict(want)
    m = tplan.score_model_config(got.model, tplan.plan_for(ts, "cuda", table=rows))
    wm = jplan.score_model_config(want.model, jplan.plan_for(js, "gpu", table=rows))
    assert dataclasses.asdict(m) == {k: v for k, v in dataclasses.asdict(wm).items()
                                     if not k.startswith("use_pallas")}


@pytest.mark.parametrize("n,shard", [(300, 1), (301, 1), (356, 1), (800, 1), (301, 3),
                                     (1, 1), (357, 8)])
@pytest.mark.parametrize("platform", PLATFORMS)
def test_pad_target_policy_is_the_jax_policy_off_tpu(n, shard, platform):
    assert tplan.pad_target_policy(n, platform, shard) == \
        jplan.pad_target_policy(n, platform, shard)
    # the quantum is 4 on the card too: the flagship's 300 stocks pad to 300
    assert tplan.pad_target_policy(300, "cuda") == 300


def test_save_rows_writes_the_jax_bytes(tmp_path):
    """The same rows give the same file from both packages, through a
    supersession: a stale merged [300, 356] row is dropped by fresh
    per-width rows, a row of another shape or platform stays."""
    steps = [
        [row("gpu", 300, 356, shape=FLAGSHIP), row("gpu"), row("cpu", 300, 356)],
        [row("gpu", 300, 300, shape=FLAGSHIP, source="fresh 300"),
         row("gpu", 356, 356, shape=FLAGSHIP, source="fresh 356",
             fleet={"seeds_per_program": 8})],
        [row("gpu", 280, 320, serve={"tick_ms": 0})],
    ]
    j, t = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    for new in steps:
        assert jplan.save_rows(new, path=j) == j
        assert tplan.save_rows(new, path=t) == t
        assert open(t, "rb").read() == open(j, "rb").read()
    rows = tplan.load_table(t)
    assert [r["source"] for r in rows if r["shape"]["k"] == 96] == ["fresh 300", "fresh 356"]
    assert len(rows) == 4


@pytest.mark.parametrize("content", [None, "{not json", '{"rows": 5}', '"a string"',
                                     '{"rows": [1, "x", null]}'],
                         ids=["missing", "corrupt", "rows_not_a_list", "not_a_table",
                              "no_dict_rows"])
def test_a_bad_table_file_falls_back(tmp_path, content):
    path = tmp_path / "table.json"
    if content is not None:
        path.write_text(content)
    assert tplan.load_table(str(path)) == jplan._read_rows(str(path)) == []
    p = tplan.plan_for(_shapes(300)[1], "cuda", table_path_=str(path))
    assert p.provenance == "default" and p.days_per_step == 1


class TestWherePortDiffers:
    def test_it_reads_its_own_table_and_never_plan_table_json(self, monkeypatch, tmp_path):
        monkeypatch.delenv(tplan.PLAN_TABLE_ENV, raising=False)
        assert tplan.table_path() == os.path.join(tplan._REPO_ROOT, "PLAN_TABLE_TORCH.json")
        assert tplan.table_path() != jplan.table_path()
        # the JAX package's table holds measured CPU rows for the flagship
        js, ts = _shapes(300, **FLAGSHIP)
        monkeypatch.delenv(jplan.PLAN_TABLE_ENV, raising=False)
        assert jplan.plan_for(js, "cpu").provenance == "measured"
        assert tplan.plan_for(ts, "cpu").provenance == "default"
        # nor does the JAX variable move the port's table
        monkeypatch.setenv(jplan.PLAN_TABLE_ENV, jplan.DEFAULT_TABLE_PATH)
        assert tplan.plan_for(ts, "cpu").provenance == "default"
        mine = tmp_path / "mine.json"
        tplan.save_rows([row("cpu", shape=FLAGSHIP)], path=str(mine))
        monkeypatch.setenv(tplan.PLAN_TABLE_ENV, str(mine))
        assert tplan.plan_for(ts, "cpu").source == "test row"

    def test_no_builtin_row_and_no_tpu_default(self, tmp_path):
        empty = str(tmp_path / "none.json")
        assert tplan.load_table(empty) == []
        js, ts = _shapes(356, **FLAGSHIP)
        jtpu = jplan.plan_for(js, "tpu", table_path_=empty)
        assert (jtpu.provenance, jtpu.days_per_step, jtpu.compute_dtype) == \
            ("measured", 8, "bfloat16")           # the JAX package's builtin TPU row
        for platform in ("tpu", "cuda", "cpu", None):
            p = tplan.plan_for(ts, platform, table_path_=empty)
            assert (p.provenance, p.days_per_step, p.compute_dtype, p.flatten_days) == \
                ("default", 1, "float32", False)
        pkg = os.path.dirname(tplan.__file__)
        for root, _, files in os.walk(pkg):
            for f in files:
                if f.endswith((".py", ".cu", ".cuh")):
                    text = open(os.path.join(root, f)).read()
                    assert "v5e" not in text and "round-2" not in text, f

    def test_a_kernels_block_changes_nothing(self):
        ts = _shapes(300)[1]
        for platform in PLATFORMS:
            plain = tplan.plan_for(ts, platform, table=[row(platform)])
            for block in ({"gru": "xla", "attention": "xla"}, {"gru": "pallas"}):
                pinned = row(platform, kernels=block, use_pallas_gru=False)
                assert tplan.plan_for(ts, platform, table=[pinned]) == plain
        assert not any(f.name in KERNEL_KEYS for f in dataclasses.fields(tplan.Plan))

    def test_platform_follows_the_device_argument(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for device, kind in (("cuda", "gpu"), ("cuda:1", "gpu"), (torch.device("cuda"), "gpu"),
                             ("gpu", "gpu"), ("cpu", "cpu"), (torch.device("cpu"), "cpu"),
                             (None, "gpu")):
            assert tplan.platform_kind(device) == kind
        ts = _shapes(300)[1]
        table = [row("gpu"), row("cpu", train={"days_per_step": 2})]
        assert tplan.plan_for(ts, "cpu", table=table).days_per_step == 2
        assert tplan.plan_for(ts, "cuda", table=table).days_per_step == 4


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        monkeypatch.delenv(tplan.COMPILE_CACHE_ENV, raising=False)

    def test_off_without_path_or_variable(self):
        assert tplan.setup_compilation_cache() is None
        assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR

    def test_off_turns_it_off_despite_the_variable(self, monkeypatch, tmp_path):
        monkeypatch.setenv(tplan.COMPILE_CACHE_ENV, str(tmp_path / "env"))
        assert tplan.setup_compilation_cache("off") is None
        assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
        assert not (tmp_path / "env").exists()

    @pytest.mark.parametrize("off", [None, "off"])
    def test_off_after_a_move_puts_the_build_back(self, monkeypatch, tmp_path, off):
        """An in-process caller that once gave a DIR builds in the checkout
        again on a later call without one."""
        assert tplan.setup_compilation_cache(str(tmp_path / "moved")) == str(tmp_path / "moved")
        assert _build.BUILD_DIR == tmp_path / "moved"
        assert tplan.setup_compilation_cache(off) is None
        assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
        assert _build.library_path("gru_fwd").parent == _build.DEFAULT_BUILD_DIR

    def test_path_then_variable_moves_the_build_directory(self, monkeypatch, tmp_path):
        monkeypatch.setenv(tplan.COMPILE_CACHE_ENV, str(tmp_path / "env"))
        monkeypatch.chdir(tmp_path)
        got = tplan.setup_compilation_cache("flag")
        assert got == str(tmp_path / "flag") and os.path.isdir(got)
        assert _build.BUILD_DIR == tmp_path / "flag"
        assert _build.library_path("gru_fwd").parent == tmp_path / "flag"
        assert tplan.setup_compilation_cache() == str(tmp_path / "env")
        assert _build.BUILD_DIR == tmp_path / "env"


# ---- the autotune tool -----------------------------------------------------

TINY = dict(stocks=[10, 12], features=6, seq_len=5, hidden=8, factors=4, portfolios=8)
RACES = ["--fleet", "--hyper", "--stream", "--serve", "--train_precision", "--remat"]


class _Quiet:
    def log(self, event, **fields):
        pass


def _autotune(monkeypatch, capsys, out, *extra):
    monkeypatch.setitem(autotune.SHAPES, "tiny", TINY)
    rc = autotune.main(["--config", "tiny", "--device", "cpu", "--days", "4", "--reps", "1",
                        "--out", str(out), *extra])
    out = capsys.readouterr()
    _autotune.err = out.err
    return rc, (json.loads(out.out)["rows"] if rc == 0 and "--dry_run" not in extra else None)


def _defaults_raced(r: dict) -> None:
    m = r["measured"]
    assert {"flat=1_dps1_float32", "flat=1_dps1_bfloat16", "flat=1_dps8_float32",
            "flat=1_dps8_bfloat16"} == set(m["train"]) == set(m["train_warmup_s"])
    assert set(m["score"]) == {"flat=1_float32", "flat=1_bfloat16"}
    assert set(m["fleet"]) == set(m["hyper"]) == {"S=1", "S=2", "S=4", "S=8"}
    assert set(m["stream"]) == {"hbm", "stream_c16", "stream_c32", "stream_c64"}
    assert set(m["serve"]["rates"]) == {"float32", "bfloat16", "int8"}
    assert m["serve"]["fidelity"]["float32"] == 1.0
    assert set(m["serve"]["tick"]) == {"tick0ms", "tick2ms", "tick10ms"}
    assert m["train_precision"]["s_per_day"]["float32"] == m["train"][
        f"flat=1_dps{r['train']['days_per_step']}_float32"]
    assert {"none", "dots", "full"} <= set(m["train_remat"])
    # no memory reading on the CPU: no doubled-batch candidate
    assert m["train_remat"]["none"]["peak_bytes"] is None
    assert not any("_dps" in k for k in m["train_remat"])
    assert all(v > 0 for v in m["train"].values())


class TestAutotune:
    def test_it_writes_rows_with_every_default_raced(self, monkeypatch, capsys, tmp_path):
        out = tmp_path / "table.json"
        rc, rows = _autotune(monkeypatch, capsys, out, *RACES)
        assert rc == 0
        table = tplan.load_table(str(out))
        assert table == sorted(rows, key=lambda r: json.dumps(tplan._row_key(r)))
        assert [(r["n_min"], r["n_max"]) for r in rows] in ([(10, 10), (12, 12)],
                                                           [(10, 12)])
        for r in rows:
            assert r["platform"] == "cpu" and r["train"]["flatten_days"] is True
            assert r["shape"] == {"c": 6, "t": 5, "h": 8, "k": 4, "m": 8}
            for m in (r["measured"].values() if "n=10" in r["measured"]
                      else [r["measured"]]):
                _defaults_raced({**r, "measured": m})
            assert "train " in r["source"] and "on cpu (cpu; " in r["source"]
            assert "python -m factorvae_tpu_torch.autotune --config tiny" in r["source"]
            assert {"fleet", "hyper", "stream", "serve"} <= set(r)
            for key in ("train_precision", "train_remat"):
                assert key not in r or r[key].get("precision", r[key].get("remat")) not in \
                    ("float32", "none")
        # the planner reads them back as measured, with obs/report's rate
        from factorvae_tpu_torch.obs.report import _PLAN_RATE_RE

        p = tplan.plan_for(tplan.ShapeKey(6, 5, 8, 4, 8, 10), "cpu", table_path_=str(out))
        assert p.provenance == "measured" and p.pad_target == 12
        assert float(_PLAN_RATE_RE.search(p.source).group(1)) > 0

    def test_a_second_run_supersedes_the_first(self, monkeypatch, capsys, tmp_path):
        out = tmp_path / "table.json"
        stale = {**row("cpu", 9, 13), "shape": {"c": 6, "t": 5, "h": 8, "k": 4, "m": 8},
                 "source": "stale"}
        other = row("cpu")
        tplan.save_rows([stale, other], path=str(out))
        rc, first = _autotune(monkeypatch, capsys, out)
        rc2, second = _autotune(monkeypatch, capsys, out)
        assert rc == rc2 == 0
        table = tplan.load_table(str(out))
        assert [r["source"] for r in table if r["shape"]["k"] == 4] == \
            [r["source"] for r in second]
        assert all(r["source"] != "stale" for r in table) and other in table
        assert len(table) == len(second) + 1

    def test_dry_run_writes_nothing(self, monkeypatch, capsys, tmp_path):
        out = tmp_path / "table.json"
        rc, _ = _autotune(monkeypatch, capsys, out, "--dry_run")
        assert rc == 0 and not out.exists()

    @pytest.mark.parametrize("flag,says", [("--kernels", "no kernel switch")])
    def test_refused_flag_exits_2_with_one_line(self, monkeypatch, capsys, tmp_path,
                                                flag, says):
        out = tmp_path / "table.json"
        rc, _ = _autotune(monkeypatch, capsys, out, flag)
        err = _autotune.err.strip()
        assert rc == 2 and len(err.splitlines()) == 1 and says in err
        assert err.startswith(f"error: {flag}") and not out.exists()

    def test_mesh_races_the_one_by_one_mesh_in_one_process(self, monkeypatch, capsys,
                                                           tmp_path):
        """`--mesh` without torchrun: a world of one, the 1 x 1 mesh against
        no mesh at the train winner's days_per_step; a mesh block only when
        the mesh won, which the planner reads back."""
        out = tmp_path / "table.json"
        rc, rows = _autotune(monkeypatch, capsys, out, "--mesh")
        assert rc == 0
        for r in rows:
            for m in (r["measured"].values() if "n=10" in r["measured"] else [r["measured"]]):
                dps = r["train"]["days_per_step"]
                assert set(m["mesh"]) == {"none", f"mesh_1x1_dps{dps}"}
            assert "mesh race on float32 flat=1 over 1 devices" in r["source"] or \
                "mesh race on bfloat16 flat=1 over 1 devices" in r["source"]
            won = min(m["mesh"], key=m["mesh"].get)
            assert ("mesh" in r) == won.startswith("mesh_")
            p = tplan.plan_for(tplan.ShapeKey(6, 5, 8, 4, 8, r["n_min"]), "cpu",
                               table_path_=str(out))
            assert (p.mesh_data_axis, p.mesh_stock_axis) == \
                ((1, 1) if "mesh" in r else (0, 0))

    @pytest.mark.parametrize("world,dps,winner", [(2, 1, (2, 1)), (2, 8, None),
                                                  (4, 1, (2, 2)), (4, 2, (1, 4))],
                             ids=["w2_mesh", "w2_none", "w4_2x2", "w4_1x4"])
    def test_race_mesh_is_the_jax_race(self, monkeypatch, world, dps, winner):
        """The same candidates, keys, winner, block and sentence as the JAX
        tool's `race_mesh` over as many devices, from the same times."""
        import importlib.util

        import jax

        spec = importlib.util.spec_from_file_location(
            "jax_autotune_plan", os.path.join(REPO, "scripts", "autotune_plan.py"))
        jtool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jtool)

        def seconds(d, mesh_shape):
            s = 0.01 + 0.001 * d
            return s - 0.005 if tuple(mesh_shape or ()) == winner else s

        devices = jax.devices()
        monkeypatch.setattr(jax, "devices", lambda *a, **k: devices[:world])
        monkeypatch.setattr(jtool, "_time_serial_mesh",
                            lambda shape, knobs, d, days, reps, mesh=None:
                            seconds(d, None if mesh is None else mesh.devices.shape))
        monkeypatch.setattr(autotune, "_mesh_rates",
                            lambda points, *a: {k: seconds(d, m)
                                                for k, (d, m) in points.items()})
        knobs = {"flatten_days": True, "days_per_step": dps, "compute_dtype": "float32"}
        shape = dict(TINY, stocks=10)
        want = jtool.race_mesh("tiny", shape, knobs, 4, 1, logger=_Quiet())
        got = autotune.race_mesh("tiny", shape, knobs, 4, 1, "cpu", world=world)
        assert got == want
        assert (got["data_axis"], got["stock_axis"]) == (winner or (0, 0))

    def test_a_mesh_block_goes_into_the_row_and_back_out_of_the_planner(self, tmp_path):
        base = row("cpu", 300, 300, source="autotune k60", measured={"train": {}})
        block = {"data_axis": 2, "stock_axis": 1, "days_per_step": 2,
                 "measured": {"none": 0.2, "mesh_2x1_dps2": 0.1},
                 "source": "mesh race on float32 flat=1 over 2 devices"}
        got = autotune._with_mesh_block(base, block)
        assert got["mesh"] == {"data_axis": 2, "stock_axis": 1, "days_per_step": 2}
        assert got["measured"] == {"train": {}, "mesh": block["measured"]}
        assert got["source"] == "autotune k60; mesh race on float32 flat=1 over 2 devices"
        none = autotune._with_mesh_block(base, dict(block, data_axis=0, stock_axis=0))
        assert "mesh" not in none and none["measured"]["mesh"] == block["measured"]
        path = str(tmp_path / "t.json")
        tplan.save_rows([got], path=path)
        tshape, jshape = _shapes(300)
        p = tplan.plan_for(tshape, "cpu", table_path_=path)
        jp = jplan.plan_for(jshape, "cpu", table=[got])
        assert (p.mesh_data_axis, p.mesh_stock_axis, p.mesh_days_per_step) == (2, 1, 2) == \
            (jp.mesh_data_axis, jp.mesh_stock_axis, jp.mesh_days_per_step)

    @pytest.mark.parametrize("device,local,cards,backend,refused", [
        ("cuda", 2, 1, None, True), ("cuda", 1, 1, "gloo", True), ("cuda", 2, 2, "nccl", False),
        ("cuda", 1, 1, None, False), ("cpu", 4, 0, "gloo", False)],
        ids=["two_ranks_one_card", "gloo_on_cuda", "a_card_each", "one", "cpu"])
    def test_ranks_sharing_a_card_are_refused(self, device, local, cards, backend, refused):
        msg = autotune.shared_card_refusal(device, local, cards, backend)
        assert (msg is not None) == refused
        if refused:
            assert msg.startswith("--mesh: ") and "\n" not in msg and "share" in msg

    def test_a_shared_card_race_exits_2_with_one_line(self, monkeypatch, capsys, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        out = tmp_path / "table.json"
        rc = autotune.main(["--config", "flagship", "--mesh", "--device", "cuda",
                            "--out", str(out)])
        err = capsys.readouterr().err.strip()
        assert rc == 2 and len(err.splitlines()) == 1 and err.startswith("error: --mesh:")
        assert not out.exists()

    def test_two_ranks_race_the_jax_candidates(self, tmp_path):
        """A world of 2 on the CPU (gloo): the no-mesh baselines and the
        2 x 1 and 1 x 2 meshes at the JAX tool's keys; rank 0 alone writes
        the table, and the planner reads its mesh block back."""
        from factorvae_tpu.parallel.compose import (
            compatible_days_per_step,
            mesh_shape_candidates,
        )
        from torch_dist_rig import autotune_mesh, run_world

        out = str(tmp_path / "table.json")
        results = run_world(2, autotune_mesh, tmp_path, dict(TINY, stocks=[10]), out,
                            ["--device", "cpu", "--days", "4", "--reps", "1"], timeout=180)
        assert [r["rc"] for r in results] == [0, 0] and results[1]["rows"] is None
        (r,) = results[0]["rows"]
        dps = r["train"]["days_per_step"]
        cells = [c for c in mesh_shape_candidates(2) if c != (1, 1)]
        nones = sorted({dps} | {compatible_days_per_step(dps, dp) for dp, _ in cells})
        want = {"none" if d == dps else f"none_dps{d}" for d in nones} | {
            f"mesh_{dp}x{sp}_dps{compatible_days_per_step(dps, dp)}" for dp, sp in cells}
        assert set(r["measured"]["mesh"]) == want
        assert "over 2 devices" in r["source"]
        won = min(r["measured"]["mesh"], key=r["measured"]["mesh"].get)
        p = tplan.plan_for(tplan.ShapeKey(6, 5, 8, 4, 8, 10), "cpu", table_path_=out)
        if won.startswith("mesh_"):
            dp, sp = (int(x) for x in won.split("_")[1].split("x"))
            assert r["mesh"]["data_axis"] == p.mesh_data_axis == dp
            assert r["mesh"]["stock_axis"] == p.mesh_stock_axis == sp
        else:
            assert "mesh" not in r and p.mesh_data_axis == p.mesh_stock_axis == 0

    @pytest.mark.parametrize("fid,rates,want", [
        ({"bfloat16": 0.995, "int8": 0.95}, {"float32": 1, "bfloat16": 3, "int8": 5},
         "bfloat16"),
        ({"bfloat16": 0.98, "int8": 0.97}, {"float32": 1, "bfloat16": 3, "int8": 5},
         "float32"),
        ({"bfloat16": 0.999, "int8": 0.999}, {"float32": 4, "bfloat16": 3, "int8": 2},
         "float32"),
        ({"bfloat16": float("nan"), "int8": 0.999}, {"float32": 1, "bfloat16": 9,
                                                     "int8": 2}, "int8")],
        ids=["bf16_past_floor", "under_floor", "f32_fastest", "nan_fidelity"])
    def test_serve_gate(self, fid, rates, want):
        assert autotune.serve_winner(rates, {"float32": 1.0, **fid}) == want

    @pytest.mark.parametrize("f32,bf16,corr,want", [
        (2.0, 1.0, 0.9, "bfloat16"), (2.0, 1.0, 0.79, "float32"),
        (1.0, 2.0, 0.99, "float32"), (2.0, 1.0, float("nan"), "float32")],
        ids=["faster_past_floor", "under_floor", "slower", "nan"])
    def test_train_precision_gate(self, f32, bf16, corr, want):
        assert autotune.train_precision_winner(f32, bf16, corr) == want

    def test_a_rung_under_its_floor_is_not_persisted(self, monkeypatch, capsys, tmp_path):
        """Fidelities fixed below both floors and bfloat16 timed fastest: no
        precision key in `serve`, no `train_precision` block."""
        monkeypatch.setattr(autotune, "_rank_corr", lambda a, b: 0.5)
        monkeypatch.setattr(autotune, "serve_winner", _spy(autotune.serve_winner, {
            "float32": 1.0, "bfloat16": 2.0, "int8": 3.0}))
        monkeypatch.setattr(autotune, "train_precision_winner", _spy(
            autotune.train_precision_winner, None, (2.0, 1.0)))
        rc, rows = _autotune(monkeypatch, capsys, tmp_path / "t.json", "--serve",
                             "--train_precision")
        assert rc == 0
        for r in rows:
            assert "precision" not in r["serve"] and "train_precision" not in r
            fid = (r["measured"].get("n=10") or r["measured"])["serve"]["fidelity"]
            assert fid == {"float32": 1.0, "bfloat16": 0.5, "int8": 0.5}


def _git(cwd, *args) -> str:
    return subprocess.run(["git", "-C", str(cwd), "-c", "user.name=t", "-c",
                           "user.email=t@t", *args], check=True, capture_output=True,
                          text=True).stdout.strip()


def _repo_with_the_tool(root):
    """A git repository holding this checkout's `.gitattributes` and
    `autotune.py`, committed; its HEAD."""
    pkg = root / "factorvae_tpu_torch"
    pkg.mkdir(parents=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(here, ".gitattributes"), root / ".gitattributes")
    shutil.copy(autotune.__file__, pkg / "autotune.py")
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-q", "-m", "tool")
    return _git(root, "rev-parse", "HEAD")


class TestCommit:
    """The row's commit: the one `git archive` stamps, else the checkout's
    HEAD, else "commit not recorded"."""

    @pytest.mark.parametrize("archived,stamped", [("HEAD", True), ("HEAD^{tree}", False)],
                             ids=["commit", "bare_tree"])
    def test_git_archive_of_a_commit_stamps_it(self, tmp_path, archived, stamped):
        head = _repo_with_the_tool(tmp_path / "repo")
        tar = tmp_path / "a.tar"
        _git(tmp_path / "repo", "archive", "-o", str(tar), archived)
        with tarfile.open(tar) as t:
            src = t.extractfile("factorvae_tpu_torch/autotune.py").read().decode()
        (line,) = [ln for ln in src.splitlines() if ln.startswith("_ARCHIVED_COMMIT = ")]
        assert line == (f'_ARCHIVED_COMMIT = "{head}"' if stamped
                        else '_ARCHIVED_COMMIT = "$Format:%H$"')

    def test_a_stamp_names_its_commit(self, monkeypatch, tmp_path):
        monkeypatch.setattr(autotune, "_ARCHIVED_COMMIT", "0123456789abcdef" * 2 + "01234567")
        monkeypatch.setattr(autotune, "_REPO", str(tmp_path))
        assert autotune._commit() == "commit 0123456789ab"

    def test_a_checkout_names_its_head_and_its_changes(self, monkeypatch, tmp_path):
        head = _repo_with_the_tool(tmp_path)
        monkeypatch.setattr(autotune, "_REPO", str(tmp_path))
        assert autotune._commit() == f"commit {head[:12]}"
        (tmp_path / "untracked.txt").write_text("x")
        assert autotune._commit() == f"commit {head[:12]}"
        (tmp_path / ".gitattributes").write_text("")
        assert autotune._commit() == f"commit {head[:12]} with uncommitted changes"

    @pytest.mark.parametrize("inside_a_repo", [False, True], ids=["no_git", "nested"])
    def test_outside_its_own_repository_nothing_is_recorded(self, monkeypatch, tmp_path,
                                                            inside_a_repo):
        """An archive unpacked in no repository, or inside another one, does
        not take that repository's HEAD for its own."""
        if inside_a_repo:
            _repo_with_the_tool(tmp_path)
        (tmp_path / "unpacked").mkdir()
        monkeypatch.setattr(autotune, "_REPO", str(tmp_path / "unpacked"))
        assert autotune._commit() == "commit not recorded"


def _spy(fn, rates=None, times=None):
    """`fn` called with the given rates (serve) or (f32, bf16) times (train)
    in place of the measured ones."""
    def call(*args):
        if rates is not None:
            return fn(rates, args[1])
        return fn(*times, args[2])
    return call
