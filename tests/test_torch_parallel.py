"""The port's mesh training against the JAX package's, and its partition
rules, composition validator and shard balance against the JAX tables.

The mesh runs are gloo worlds spawned by `tests/torch_dist_rig.py` (one
world per class: 2 ranks for the 2 x 1 and 1 x 2 meshes, 4 for 2 x 2); the
JAX side runs the JAX `Trainer` on a mesh of the same shape over this
process's virtual CPU devices (`tests/conftest.py`). Weights are the JAX
init carried over with `params.flax_to_torch`; dropout 0 and the NLL loss,
so no framework's noise enters. Tolerances:

- one update's gradients rtol 1e-5 / atol 1e-6 (the GRU's weights 2e-5 /
  5e-6); the parameters after it at the same tolerances where the JAX
  gradient exceeds the atol. Adam's first step moves an element by
  lr * g / (|g| + eps): by +-lr whatever |g| is, so an element whose
  gradient is rounding noise (the portfolio bias: a softmax over stocks
  does not depend on it) moves by the sign of that noise in either
  package; those elements are left out, and counted;
- an epoch's losses against the port's serial trainer: rtol 2e-5;
- the ranks' parameters: bit for bit;
- the composed pins (`TestComposedOracles`): bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.models.factorvae import day_forward
from factorvae_tpu.parallel import compose as jcompose
from factorvae_tpu.parallel import partition as jpartition
from factorvae_tpu.train.loop import make_step_fns
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.parallel import compose, partition
from factorvae_tpu_torch.parallel.mesh import AbstractMesh, single_device_mesh
from factorvae_tpu_torch.parallel.partition import P
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer
from torch_dist_rig import (
    assert_ranks_bitwise,
    composed_oracles,
    in_sequence,
    mesh_fit,
    mesh_update,
    run_world,
)

C, T, H, K, M = 6, 5, 8, 4, 10
DAYS = [3, 7, 20, -1]          # one padded update of 4 days
TOL = dict(rtol=1e-5, atol=1e-6)
GRU_TOL = dict(rtol=2e-5, atol=5e-6)


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=30, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    arrays = {"values": jp.values, "valid": jp.valid,
              "dates": jp.dates.values.astype("datetime64[D]"),
              "instruments": np.asarray(jp.instruments)}
    return jp, arrays


def _jconfig(jp, save_dir, days_per_step=4, epochs=2) -> jconfig.Config:
    d = [str(x.date()) for x in jp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[21],
                                val_start_time=d[22], val_end_time=d[29], pad_multiple=4),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=3,
                                  days_per_step=days_per_step, checkpoint_every=0,
                                  recover_after=0, save_dir=str(save_dir)))


def _jax_update(jp, tmp_path, dp, sp):
    """(weights, grads, params after) of the JAX Trainer's first update of
    DAYS on a (dp, sp) mesh; the gradients from `jax.value_and_grad` of the
    same loss (GSPMD's partitioning keeps the program's value)."""
    jcfg = _jconfig(jp, tmp_path / f"jax_{dp}x{sp}")
    jds = JPanelDataset(jp, seq_len=T, pad_multiple=4)
    mesh = JMesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp), ("data", "stock"))
    tr = JTrainer(jcfg, jds, mesh=mesh)
    state = tr.init_state()
    weights = flax_to_torch(state.params)
    params = state.params
    fns = make_step_fns(day_forward(jcfg.model, train=True),
                        day_forward(jcfg.model, train=False), tr.tx, T)
    days = jnp.asarray(DAYS, jnp.int32)
    panel = (jds.values, jds.last_valid, jds.next_valid)
    model = day_forward(jcfg.model, train=True)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        x, y, mask = fns.batch_for(days, panel)
        day_w = (days >= 0).astype(jnp.float32)
        out = model.apply(p, x, y, mask, rngs={"sample": key, "dropout": key})
        return jnp.sum(out.loss * day_w) / jnp.maximum(jnp.sum(day_w), 1.0)

    grads = flax_to_torch(jax.jit(jax.grad(loss_fn))(params))
    state, _ = tr._train_epoch(state, jnp.asarray([DAYS], jnp.int32))
    after = flax_to_torch(state.params)
    return ({k: v.numpy() for k, v in weights.items()}, grads, after)


def _check_update(got, want_grads, want_params, lr=1e-3):
    """The gradients, and the parameters where the JAX gradient exceeds the
    atol; the rest moved by at most lr either way in both packages, so they
    differ by at most 2 lr. Returns the share of such elements."""
    small = total = 0
    for name, g in got["grads"].items():
        tol = GRU_TOL if "gru" in name else TOL
        np.testing.assert_allclose(g, want_grads[name].numpy(), err_msg=name, **tol)
        signal = np.abs(want_grads[name].numpy()) > tol["atol"]
        small += int((~signal).sum())
        total += signal.size
        np.testing.assert_allclose(got["params"][name][signal],
                                   want_params[name].numpy()[signal], err_msg=name, **tol)
        gap = np.abs(got["params"][name] - want_params[name].numpy())[~signal]
        assert np.all(gap <= 2 * lr * (1 + 1e-4)), name
    return small / total


def _serial_losses(arrays, jp, tmp_path):
    cfg = tconfig.Config.from_dict(_jconfig(jp, tmp_path / "serial").to_dict())
    from torch_dist_rig import _panel

    ds = PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4, device="cpu")
    _, out = Trainer(cfg, ds, device="cpu").fit()
    return ([h["train_loss"] for h in out["history"]],
            [h["val_loss"] for h in out["history"]])


def _check_fit(results, key, serial):
    assert_ranks_bitwise([r[key] for r in results], "params")
    got = results[0][key]
    np.testing.assert_allclose(got["train_loss"], serial[0], rtol=2e-5)
    np.testing.assert_allclose(got["val_loss"], serial[1], rtol=2e-5)
    for r in results[1:]:
        assert r[key]["train_loss"] == got["train_loss"]


class TestTwoRankMeshes:
    """A world of 2: the 2 x 1 and 1 x 2 meshes."""

    SHAPES = [(2, 1), (1, 2)]

    @pytest.fixture(scope="class")
    def world(self, panels, tmp_path_factory):
        jp, arrays = panels
        tmp = tmp_path_factory.mktemp("two")
        jax_runs = {s: _jax_update(jp, tmp, *s) for s in self.SHAPES}
        weights = jax_runs[self.SHAPES[0]][0]
        cfg = tconfig.Config.from_dict(_jconfig(jp, tmp / "port").to_dict()).to_dict()
        results = run_world(2, in_sequence, tmp, [
            (mesh_update, (arrays, cfg, weights, DAYS, self.SHAPES)),
            (mesh_fit, (arrays, cfg, self.SHAPES, str(tmp / "fit")))])
        return jax_runs, [r[0] for r in results], [r[1] for r in results], \
            _serial_losses(arrays, jp, tmp)

    @pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "1x2"])
    def test_one_update_matches_the_jax_trainer_on_the_mesh(self, world, shape):
        jax_runs, updates, _, _ = world
        key = f"{shape[0]}x{shape[1]}"
        assert_ranks_bitwise([u[key] for u in updates], "params")
        assert_ranks_bitwise([u[key] for u in updates], "grads")
        _, grads, after = jax_runs[shape]
        assert _check_update(updates[0][key], grads, after) < 0.5
        # each 'stock' rank held its half of the 12 padded rows
        assert updates[0][key]["rows"] == 12 // shape[1]
        assert updates[0][key]["days"] == 3.0

    @pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "1x2"])
    def test_an_epoch_tracks_the_serial_trainer(self, world, shape):
        _, _, fits, serial = world
        _check_fit(fits, f"{shape[0]}x{shape[1]}", serial)
        comms = fits[0][f"{shape[0]}x{shape[1]}"]["comms"]
        assert comms["ops_by_kind"]["all-reduce"] > 0
        assert ("stock" in comms["bytes_by_axis"]) == (shape[1] > 1)
        assert ("all-gather" in comms["ops_by_kind"]) == (shape[1] > 1)


class TestFourRankMeshes:
    """A world of 4: the 2 x 2 mesh's update and epoch, and the composed
    pins (`TestComposedOracles` of the JAX package)."""

    @pytest.fixture(scope="class")
    def world(self, panels, tmp_path_factory):
        jp, arrays = panels
        tmp = tmp_path_factory.mktemp("four")
        jax_run = _jax_update(jp, tmp, 2, 2)
        cfg = tconfig.Config.from_dict(_jconfig(jp, tmp / "port").to_dict())
        composed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, days_per_step=2), data=dataclasses.replace(
            cfg.data, stream_chunk_days=4)).to_dict()
        results = run_world(4, in_sequence, tmp, [
            (mesh_update, (arrays, cfg.to_dict(), jax_run[0], DAYS, [(2, 2)])),
            (mesh_fit, (arrays, cfg.to_dict(), [(2, 2)], str(tmp / "fit"))),
            (composed_oracles, (arrays, composed_cfg, str(tmp / "composed")))],
            timeout=180)
        return jax_run, results, _serial_losses(arrays, jp, tmp), arrays["valid"]

    def test_one_update_matches_the_jax_trainer_on_the_mesh(self, world):
        jax_run, results, _, _ = world
        updates = [r[0]["2x2"] for r in results]
        assert_ranks_bitwise(updates, "params")
        assert _check_update(updates[0], jax_run[1], jax_run[2]) < 0.5
        assert updates[0]["rows"] == 6

    def test_an_epoch_tracks_the_serial_trainer(self, world):
        _, results, serial, _ = world
        _check_fit([r[1] for r in results], "2x2", serial)

    def test_mesh_stream_is_bitwise_mesh_hbm(self, world):
        _, results, _, valid = world
        for r in results:
            hbm, stream = r[2]["hbm"], r[2]["stream"]
            for name in hbm["params"]:
                np.testing.assert_array_equal(hbm["params"][name], stream["params"][name])
            np.testing.assert_array_equal(hbm["scores"], stream["scores"])
            # finite exactly where a stock has a row; the padding NaN
            assert np.array_equal(np.isfinite(hbm["scores"][:, :11]), valid)
            assert np.isnan(hbm["scores"][:, 11:]).all()

    def test_mesh_fleet_stream_is_bitwise_mesh_fleet_hbm(self, world):
        _, results, _, _ = world
        for r in results:
            hbm, stream = r[2]["hbm"], r[2]["stream"]
            for key in ("fleet_params", "best_params"):
                for name in hbm[key]:
                    np.testing.assert_array_equal(hbm[key][name], stream[key][name])
            np.testing.assert_array_equal(hbm["best_val"], stream["best_val"])
            assert hbm["history"] == stream["history"]
        # lanes over 'data': ranks (0, 1) hold lane 0, ranks (2, 3) lane 1
        assert [r[2]["hbm"]["lanes"] for r in results] == [(0, 1), (0, 1), (1, 2), (1, 2)]
        assert_ranks_bitwise([r[2]["hbm"] for r in results], "best_params")


class TestComposedOracles:
    def test_fleet_s1_on_1x1_mesh_bitwise_serial_trainer(self, panels, tmp_path):
        jp, arrays = panels
        from torch_dist_rig import _panel

        cfg = tconfig.Config.from_dict(_jconfig(jp, tmp_path / "t", days_per_step=2)
                                       .to_dict())
        ds = PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4, device="cpu")
        st_t, out_t = Trainer(cfg, ds, device="cpu").fit()
        fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=str(tmp_path / "f")))
        ds2 = PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4, device="cpu")
        st_f, out_f = FleetTrainer(fcfg, ds2, seeds=[3], device="cpu",
                                   mesh=single_device_mesh()).fit()
        for name, p in st_t.model.named_parameters():
            assert torch.equal(p, st_f.params[name][0]), name
        assert out_t["best_val"] == float(out_f["best_val"][0])


class TestPartitionRules:
    """The port's rule tables are the JAX package's, matched over the
    port's state names."""

    @staticmethod
    def _state(lanes=None):
        from factorvae_tpu_torch.config import ModelConfig

        cfg = ModelConfig(num_features=C, hidden_size=H, num_factors=K, num_portfolios=M,
                          seq_len=T)
        return partition.abstract_state_tree(cfg, "cpu", mixed=True, lanes=lanes)

    def test_tables_equal_the_jax_tables(self):
        for mine, theirs in ((partition.TRAIN_STATE_RULES, jpartition.TRAIN_STATE_RULES),
                             (partition.FLEET_STATE_RULES, jpartition.FLEET_STATE_RULES),
                             (partition.PANEL_RULES, jpartition.PANEL_RULES)):
            assert [(r, tuple(s)) for r, s in mine] == [(r, tuple(s)) for r, s in theirs]

    def test_first_matching_rule_wins_and_scalars_never_partition(self):
        tree = {"a": {"kernel": np.zeros((4, 4))}, "scalar": np.zeros(()),
                "one": np.zeros((1,))}
        specs = partition.match_partition_rules([(r"a/kernel", P("stock")),
                                                 (r".*", P("data"))], tree)
        assert specs["a"]["kernel"] == P("stock")
        assert specs["scalar"] == P() and specs["one"] == P()
        specs2 = partition.match_partition_rules([(r".*", P("data")),
                                                  (r"a/kernel", P("stock"))], tree)
        assert specs2["a"]["kernel"] == P("data")

    def test_unmatched_leaf_is_an_error_naming_the_path(self):
        tree = {"a": {"kernel": np.zeros((4, 4))}, "mystery": np.zeros((2, 2))}
        with pytest.raises(ValueError, match="no partition rule matches leaf 'mystery'"):
            partition.match_partition_rules([(r"a/", P("data"))], tree)
        with pytest.raises(ValueError) as port_err:
            partition.match_partition_rules([(r"a/", P("data"))], tree)
        with pytest.raises(ValueError) as jax_err:
            jpartition.match_partition_rules([(r"a/", JP("data"))], tree)
        assert str(port_err.value) == str(jax_err.value)

    def test_state_rules_cover_the_real_state_trees(self):
        """Every leaf of a real TrainState and FleetState resolves; the
        stacked specs are the serial ones with the seed axis in front."""
        from factorvae_tpu_torch.config import ModelConfig, TrainConfig
        from factorvae_tpu_torch.train.fleet import stack_states
        from factorvae_tpu_torch.train.trainer import init_train_state

        mcfg = ModelConfig(num_features=C, hidden_size=H, num_factors=K, num_portfolios=M,
                           seq_len=T)
        states = [init_train_state(mcfg, TrainConfig(seed=s), 10, "cpu") for s in (0, 1)]
        serial = partition.state_partition_specs(partition.state_tree(states[0]))
        stacked = partition.state_partition_specs(
            partition.state_tree(stack_states(states)), stacked=True)
        flat_s = partition.tree_leaves(serial)
        flat_f = partition.tree_leaves(stacked)
        assert [n for n, _ in flat_s] == [n for n, _ in flat_f]
        assert {n.split("/")[0] for n, _ in flat_s} == {"step", "rng", "params", "opt_state"}
        for (_, s), (name, f) in zip(flat_s, flat_f):
            assert f == P("data", *s), name
        assert partition.tree_leaves(self._state()) and partition.tree_leaves(self._state(2))

    def test_panel_specs_match_the_rule_table(self):
        assert partition.panel_partition_specs() == (P("stock", None, None),
                                                     P(None, "stock"), P(None, "stock"))
        assert partition.panel_partition_specs(stacked=True) == (
            P("data", "stock", None, None), P("data", None, "stock"),
            P("data", None, "stock"))


class TestComposeValidate:
    """The port's validator gives the JAX validator's one-line messages."""

    @staticmethod
    def _pair(dp, sp):
        return (AbstractMesh((dp, sp)),
                JMesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp), ("data", "stock")))

    @pytest.mark.parametrize("kw", [
        dict(days_per_step=3), dict(num_seeds=3), dict(num_seeds=3, hyper=True),
        dict(residency="disk"), dict(residency="stream", stream_chunk_days=0),
        dict(num_seeds=0), dict(days_per_step=2), dict(num_seeds=4),
        dict(num_seeds=2, residency="stream")],
        ids=["days", "seeds", "hyper", "residency", "chunk", "empty", "ok_days",
             "ok_fleet", "ok_triple"])
    def test_same_verdict_and_message_as_jax(self, kw):
        mine, theirs = self._pair(2, 2)

        def outcome(fn, mesh):
            try:
                fn(mesh=mesh, **kw)
                return None
            except ValueError as e:
                return type(e).__name__, str(e)

        assert outcome(compose.validate, mine) == outcome(jcompose.validate, theirs)

    def test_uneven_stock_split_fails_in_the_validator(self):
        mine, _ = self._pair(1, 2)
        with pytest.raises(compose.CompositionError,
                           match=r"invalid parallel composition \[mesh\]: the cross-section "
                                 r"of 11 stocks not divisible by the 'stock' axis \(2"):
            compose.validate(mesh=mine, n_stocks=11)
        compose.validate(mesh=mine, n_stocks=12)
        assert tconfig.stock_pad_multiple(8, 3) == 24

    def test_shape_enumerations_equal_jax(self):
        for n in (1, 2, 4, 8):
            assert compose.mesh_shape_candidates(n) == jcompose.mesh_shape_candidates(n)
        for dps, dp in ((1, 1), (1, 2), (8, 4), (3, 2)):
            assert (compose.compatible_days_per_step(dps, dp)
                    == jcompose.compatible_days_per_step(dps, dp))


class TestShardBalance:
    """The byte bill against the JAX numbers on the same trees."""

    @pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
    def test_device_bytes_equal_jax(self, shape):
        rng = np.random.default_rng(0)
        tree = {"values": rng.normal(size=(10, 7, 3)).astype(np.float32),
                "last_valid": np.zeros((7, 10), np.int32),
                "next_valid": np.zeros((7, 10), np.int32),
                "params": {"w": np.zeros((6, 5), np.float32), "b": np.zeros(5, np.float32)}}
        rules = partition.PANEL_RULES + [(r"^params/", P("data"))]
        jrules = jpartition.PANEL_RULES + [(r"^params/", JP("data"))]
        mine = partition.device_bytes(AbstractMesh(shape),
                                      partition.match_partition_rules(rules, tree), tree)
        jmesh = JMesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                      ("data", "stock"))
        theirs = jpartition.device_bytes(
            jmesh, jpartition.match_partition_rules(jrules, tree), tree)
        np.testing.assert_array_equal(mine, theirs)

    def test_shard_balance_block_of_a_stream_panel_equals_jax(self, panels):
        from factorvae_tpu.obs.memory import shard_balance_block as jblock

        from factorvae_tpu_torch.obs.memory import shard_balance_block
        from torch_dist_rig import _panel

        jp, arrays = panels
        ds = PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4, device="cpu",
                          residency="stream")
        jds = JPanelDataset(jp, seq_len=T, pad_multiple=4, residency="stream")
        jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "stock"))
        mine = shard_balance_block(AbstractMesh((2, 2)), dataset=ds)
        theirs = jblock(jmesh, dataset=jds)
        assert mine == theirs
