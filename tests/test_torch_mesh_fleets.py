"""Fleets on every mesh the JAX package trains them on, against the JAX
package's on the same mesh and within the port: hyper-fleets and
population-based training with their lanes over 'data', and the seed fleet
on a hierarchical ('host', 'data', 'stock') mesh.

A world of 2 gloo ranks (`tests/torch_dist_rig.py`) trains on the 2 x 1
mesh, one lane a 'data' rank for the 2-lane hyper-fleet; the JAX side runs
`FleetTrainer(lane_configs=..., mesh=2x1)` and `pbt_fit(mesh=2x1)` over
this process's virtual CPU devices (`tests/conftest.py`). A world of 4
trains seeds [3, 4] at days_per_step 2 on 'host' 2 x 'data' 2 x 'stock' 1
(a lane a rank, each update's days split over 'host'), against the JAX
`FleetTrainer` on the same mesh of 4 virtual devices, and on 'host' 2 x
'data' 1 x 'stock' 2 (both lanes stacked on every rank), against the port's
fleet in one process. Every port lane
starts from its seed's Flax weights (`params.flax_to_torch`); dropout 0 and
the NLL loss, so no framework's noise enters. Tolerances, the fleet tests'
(`test_torch_fleet.py`):

- per-epoch losses, fitness and best_val: rtol 2e-5;
- parameters after two epochs of Adam: rtol 2e-5 / atol 2e-6, except the
  two whose gradient is zero in exact arithmetic (`ZERO_GRAD`), held to the
  sum of the run's learning rates, and the elements whose first-step
  gradient lies within 10 eps (1e-7) of zero: Adam's first step moves such
  an element by lr * g / (|g| + eps), which turns a rounding difference in
  a gradient of 1e-8 into one of 1e-5, in one process as on the mesh; they
  are held to 2 lr (`_first_step_noise`: one element of the GRU's hidden
  kernel, most of the predictor's query and key kernel, whose first
  gradients vanish at the init);
- PBT's winners, exploited lanes and scalars: equal;
- the ranks against each other, and a PBT stopped after generation 0 and
  resumed against the unbroken mesh run: bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from factorvae_tpu import config as jconfig
from factorvae_tpu.config import MeshConfig as JMeshConfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.train.fleet import FleetTrainer as JFleetTrainer
from factorvae_tpu.train.fleet import unstack_state as junstack
from factorvae_tpu.parallel.mesh import make_hierarchical_mesh as jhier
from factorvae_tpu.train.pbt import pbt_fit as jpbt_fit
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.pbt import pbt_fit
from torch_dist_rig import (
    _panel,
    assert_ranks_bitwise,
    fleet_result,
    hier_fleets,
    lane_configs,
    mesh_fleets,
    pbt_result,
    run_world,
    start_from,
)

C, T, H, K, M = 6, 5, 8, 4, 10
HYPER = [(3, 1e-3, 1.0), (4, 3e-3, 0.1)]
PBT = [(3, 1e-3, 1.0), (4, 3e-3, 0.1), (5, 2e-3, 0.5), (6, 5e-4, 2.0)]
LOSS_RTOL = 2e-5
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
ZERO_GRAD = ("factor_encoder.portfolio.bias", "factor_predictor.key_bias")
ADAM_EPS = 1e-8      # the reference's Adam (`train/state.py`)


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=30, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    arrays = {"values": jp.values, "valid": jp.valid,
              "dates": jp.dates.values.astype("datetime64[D]"),
              "instruments": np.asarray(jp.instruments)}
    return jp, arrays


def _jconfig(jp, save_dir, checkpoint_every=0) -> jconfig.Config:
    d = [str(x.date()) for x in jp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[21],
                                val_start_time=d[22], val_end_time=d[29], pad_multiple=4),
        train=jconfig.TrainConfig(num_epochs=2, lr=1e-3, seed=3, days_per_step=2,
                                  checkpoint_every=checkpoint_every, recover_after=0,
                                  save_dir=str(save_dir)))


def _jlanes(cfg, lanes):
    return [dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, kl_weight=klw),
        train=dataclasses.replace(cfg.train, seed=seed, lr=lr,
                                  run_name=f"{cfg.train.run_name}_lane{i}"))
        for i, (seed, lr, klw) in enumerate(lanes)]


def _jmesh():
    return JMesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "stock"))


def _lane_params(state, lanes: int) -> list:
    return [{k: v.numpy() for k, v in flax_to_torch(junstack(state.params, i)).items()}
            for i in range(lanes)]


def _assert_params(got: dict, want: list, lr_sum: float, noise: dict, what: str):
    """`got` (stacked) against `want` (per lane): PARAM_TOL, the ZERO_GRAD
    leaves within `lr_sum`, the first-step noise elements within 2 lr."""
    lr = max(lr for _, lr, _ in PBT) * 1.25
    for i, lane in enumerate(want):
        for name, w in lane.items():
            g = got[name][i]
            if name in ZERO_GRAD:
                assert np.abs(g - w).max() <= lr_sum, f"{what} lane {i} {name}"
                continue
            signal = ~noise[name]
            np.testing.assert_allclose(g[signal], w[signal],
                                       err_msg=f"{what} lane {i} {name}", **PARAM_TOL)
            assert np.all(np.abs(g - w)[~signal] <= 2 * lr), f"{what} lane {i} {name}"


def _first_step_noise(arrays, cfg_dict, weights, lanes, tmp) -> dict:
    """{name: elements whose gradient in some lane's first step (its solo
    run's, from its weights) is within 10 Adam eps of zero}."""
    import torch

    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    _, cfgs = lane_configs(cfg_dict, lanes, str(tmp))
    noise: dict = {}
    for (seed, _, _), cfg in zip(lanes, cfgs):
        tr = Trainer(cfg, PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4,
                                       device="cpu"), device="cpu")
        state = tr.init_state()
        state.model.load_state_dict({k: torch.as_tensor(v) for k, v in weights[seed].items()})
        train_step(state, tr.ds, tr._order(tr.train_days, True, 0)[0], guard=True)
        for name, p in state.model.named_parameters():
            small = np.abs(p.grad.numpy()) <= 10 * ADAM_EPS
            noise[name] = noise.get(name, small) | small
    return noise


def _losses(history) -> np.ndarray:
    return np.asarray([[train, val] for train, val in history], np.float64)


@pytest.fixture(scope="module")
def weights(panels, tmp_path_factory):
    """Each seed's initial Flax weights (the JAX fleet's init), as arrays."""
    jp, _ = panels
    jft = JFleetTrainer(_jconfig(jp, tmp_path_factory.mktemp("jinit")),
                        JPanelDataset(jp, seq_len=T, pad_multiple=4),
                        seeds=[s for s, _, _ in PBT], logger=JMetricsLogger(echo=False))
    return {s: w for s, w in zip([s for s, _, _ in PBT],
                                 _lane_params(jft.init_fleet_state(), len(PBT)))}


def _one_process(arrays, cfg_dict, weights, tmp) -> dict:
    """The hyper-fleet and the PBT in this process, without a mesh."""
    ds = lambda: PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4,  # noqa: E731
                              device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FleetTrainer, "init_lane_state", FleetTrainer.init_lane_state)
        start_from(weights)
        cfg, lanes = lane_configs(cfg_dict, HYPER, str(tmp / "hyper"))
        trainer = FleetTrainer(cfg, ds(), lane_configs=lanes, device="cpu")
        hyper = fleet_result(trainer, *trainer.fit())
        cfg, lanes = lane_configs(cfg_dict, PBT, str(tmp / "pbt"), checkpoint_every=1)
        _, res = pbt_fit(cfg, ds(), lanes, generations=2, epochs_per_generation=1,
                         device="cpu")
    return {"hyper": hyper, "pbt": pbt_result(res)}


class TestLanesOverData:
    """A world of 2 on the 2 x 1 mesh: the hyper-fleet (a lane a rank) and
    the PBT (two lanes a rank; winners and losers on either)."""

    @pytest.fixture(scope="class")
    def world(self, panels, weights, tmp_path_factory):
        jp, arrays = panels
        tmp = tmp_path_factory.mktemp("lanes")
        jcfg = _jconfig(jp, tmp / "jax_hyper")
        jft = JFleetTrainer(jcfg, JPanelDataset(jp, seq_len=T, pad_multiple=4),
                            lane_configs=_jlanes(jcfg, HYPER), mesh=_jmesh(),
                            logger=JMetricsLogger(echo=False))
        jstate, jout = jft.fit()
        jax_hyper = {"history": [(h["train_loss"], h["val_loss"]) for h in jout["history"]],
                     "final": _lane_params(jstate, len(HYPER)),
                     "best_val": np.asarray(jout["best_val"])}
        pcfg = _jconfig(jp, tmp / "jax_pbt", checkpoint_every=1)
        jstate, jres = jpbt_fit(pcfg, JPanelDataset(jp, seq_len=T, pad_multiple=4),
                                _jlanes(pcfg, PBT), 2, 1, mesh=_jmesh(),
                                logger=JMetricsLogger(echo=False))
        jax_pbt = {"generations": jres["generations"],
                   "scalars": [(c.train.lr, c.model.kl_weight) for c in jres["lane_configs"]],
                   "best_val": np.asarray(jres["best_val"]),
                   "final": _lane_params(jres["state"], len(PBT))}
        cfg_dict = tconfig.Config.from_dict(jcfg.to_dict()).to_dict()
        ranks = run_world(2, mesh_fleets, tmp, arrays, cfg_dict, weights, HYPER, PBT,
                          str(tmp / "port"), timeout=240)
        return {"jax_hyper": jax_hyper, "jax_pbt": jax_pbt, "ranks": ranks,
                "one": _one_process(arrays, cfg_dict, weights, tmp / "one"),
                "noise": _first_step_noise(arrays, cfg_dict, weights, PBT, tmp / "noise"),
                "lr_sum": max(lr for _, lr, _ in PBT) * 1.25 * 2 * 11}

    def test_hyper_fleet_one_lane_a_rank_matches_jax(self, world):
        """Each rank trains its one lane with the lane-stacked step and its
        run-time scalars; the records, best_val and the gathered parameters
        are the whole fleet's on both ranks, bitwise; they match the JAX
        hyper-fleet on the same mesh and the port's one-process fleet."""
        ranks = [r["hyper"] for r in world["ranks"]]
        assert all(r["hyper"] for r in ranks)
        assert [r["lanes"] for r in ranks] == [(0, 1), (1, 2)]
        for key in ("final_params", "best_params"):
            assert_ranks_bitwise(ranks, key)
        assert all(r["history"] == ranks[0]["history"] for r in ranks)
        np.testing.assert_array_equal(ranks[1]["best_val"], ranks[0]["best_val"])
        got, want, one = ranks[0], world["jax_hyper"], world["one"]["hyper"]
        # the config hash in a label covers the save_dir, which differs
        def labels(r):
            return [[lbl.rsplit(" cfg=", 1)[0] for lbl in row] for row in r["labels"]]

        assert [len(row) for row in got["labels"]] == [2, 2]
        assert labels(got) == labels(one)
        assert got["lr"] == one["lr"]
        for other, what in ((want, "jax"), (one, "one process")):
            np.testing.assert_allclose(_losses(got["history"]), _losses(other["history"]),
                                       rtol=LOSS_RTOL, err_msg=what)
            np.testing.assert_allclose(got["best_val"], other["best_val"], rtol=LOSS_RTOL)
        noise = world["noise"]
        _assert_params(got["final_params"], want["final"], world["lr_sum"], noise, "jax")
        _assert_params(got["final_params"],
                       [{n: p[i] for n, p in one["final_params"].items()} for i in range(2)],
                       world["lr_sum"], noise, "one process")


    def test_pbt_matches_jax_and_one_process(self, world):
        """Every rank ranks the whole population and takes the same
        exploit: winners, exploited lanes and scalars equal the JAX PBT's
        on the mesh and the port's in one process."""
        ranks = [r["unbroken"] for r in world["ranks"]]
        assert ranks[0]["generations"] == ranks[1]["generations"]
        assert ranks[0]["scalars"] == ranks[1]["scalars"]
        assert_ranks_bitwise(ranks, "best_params")
        got, want, one = ranks[0], world["jax_pbt"], world["one"]["pbt"]
        assert got["generations"][0]["exploited"]
        for other in (want["generations"], one["generations"]):
            for g, w in zip(got["generations"], other, strict=True):
                np.testing.assert_allclose(g["fitness"], w["fitness"], rtol=LOSS_RTOL)
                assert g["winners"] == w["winners"]
                assert [(e["lane"], e["from"], e["perturb_factor"]) for e in g["exploited"]] \
                    == [(e["lane"], e["from"], e["perturb_factor"]) for e in w["exploited"]]
        assert got["scalars"] == pytest.approx(want["scalars"], rel=1e-12)
        assert got["scalars"] == one["scalars"]
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["best_val"], one["best_val"], rtol=LOSS_RTOL)
        # each rank's state holds its two lanes of the four
        state = {n: np.concatenate([r["state"][n] for r in ranks]) for n in got["state"]}
        _assert_params(state, want["final"], world["lr_sum"], world["noise"], "jax")
        _assert_params(state, [{n: p[i] for n, p in one["state"].items()} for i in range(4)],
                       world["lr_sum"], world["noise"], "one process")
        # the fitness vector was gathered over 'data' by the collectives
        assert got["comms"]["all-gather@data"]["calls"] > 0

    def test_pbt_resumed_on_the_mesh_is_bitwise_the_unbroken_run(self, world):
        """Stopped after generation 0 (the state file written by world rank
        0) and resumed: the same generation 1, parameters and scalars."""
        for r in world["ranks"]:
            a, b = r["unbroken"], r["resumed"]
            assert [g["generation"] for g in b["generations"]] == [1]
            assert b["generations"] == a["generations"][1:]
            assert b["scalars"] == a["scalars"]
            np.testing.assert_array_equal(b["best_val"], a["best_val"])
            for key in ("state", "best_params"):
                for name, p in a[key].items():
                    np.testing.assert_array_equal(b[key][name], p, err_msg=name)


class TestHierarchicalFleet:
    """A world of 4: seeds [3, 4] at days_per_step 2 on 'host' 2 x 'data' 2
    x 'stock' 1 and on 'host' 2 x 'data' 1 x 'stock' 2."""

    SEEDS = [3, 4]

    @pytest.fixture(scope="class")
    def world(self, panels, weights, tmp_path_factory):
        jp, arrays = panels
        tmp = tmp_path_factory.mktemp("hier")
        jcfg = _jconfig(jp, tmp / "jax")
        mesh = jhier(JMeshConfig(stock_axis=1), devices=jax.devices()[:4], num_hosts=2)
        jstate, jout = JFleetTrainer(jcfg, JPanelDataset(jp, seq_len=T, pad_multiple=4),
                                     seeds=self.SEEDS, mesh=mesh,
                                     logger=JMetricsLogger(echo=False)).fit()
        cfg_dict = tconfig.Config.from_dict(jcfg.to_dict()).to_dict()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(FleetTrainer, "init_lane_state", FleetTrainer.init_lane_state)
            start_from(weights)
            cfg = tconfig.Config.from_dict(cfg_dict)
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, save_dir=str(tmp / "one")))
            plain = FleetTrainer(cfg, PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4,
                                                   device="cpu"),
                                 seeds=self.SEEDS, device="cpu")
            one = fleet_result(plain, *plain.fit())
        ranks = run_world(4, hier_fleets, tmp, arrays, cfg_dict, weights, self.SEEDS,
                          str(tmp / "port"), timeout=240)
        return {"jax": {"history": [(h["train_loss"], h["val_loss"])
                                    for h in jout["history"]],
                        "final": _lane_params(jstate, 2),
                        "best_val": np.asarray(jout["best_val"])},
                "one": one, "ranks": ranks,
                "noise": _first_step_noise(arrays, cfg_dict, weights,
                                           [(s, 1e-3, 1.0) for s in self.SEEDS],
                                           tmp / "noise"),
                "lr_sum": 1e-3 * 2 * 11}

    @pytest.mark.parametrize("key,lanes", [("2x2x1", [(0, 1), (1, 2), (0, 1), (1, 2)]),
                                           ("2x1x2", [(0, 2)] * 4)],
                             ids=["a_lane_a_rank", "lanes_stacked"])
    def test_the_ranks_agree_and_the_days_split_over_host(self, world, key, lanes):
        runs = [r[key] for r in world["ranks"]]
        assert [r["lanes"] for r in runs] == lanes
        for name in ("final_params", "best_params"):
            assert_ranks_bitwise(runs, name)
        assert all(r["history"] == runs[0]["history"] for r in runs)
        assert runs[0]["day_axis"] == "host" and runs[0]["grad_axis"] == "host/stock"
        by_axis = runs[0]["comms"]["bytes_by_axis"]
        assert by_axis["host"] > 0 and by_axis["host/stock"] > 0
        assert ("stock" in by_axis) == key.endswith("x2")

    @pytest.mark.parametrize("key", ["2x2x1", "2x1x2"], ids=["a_lane_a_rank", "lanes_stacked"])
    def test_tracks_the_plain_fleet(self, world, key):
        got, one = world["ranks"][0][key], world["one"]
        np.testing.assert_allclose(_losses(got["history"]), _losses(one["history"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["best_val"], one["best_val"], rtol=LOSS_RTOL)
        _assert_params(got["final_params"],
                       [{n: p[i] for n, p in one["final_params"].items()} for i in range(2)],
                       world["lr_sum"], world["noise"], "one process")

    def test_a_lane_a_rank_matches_the_jax_fleet_on_the_mesh(self, world):
        got, want = world["ranks"][0]["2x2x1"], world["jax"]
        np.testing.assert_allclose(_losses(got["history"]), _losses(want["history"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        _assert_params(got["final_params"], want["final"], world["lr_sum"], world["noise"],
                       "jax")
