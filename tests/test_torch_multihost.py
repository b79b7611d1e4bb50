"""Process wiring of the port (`parallel/multihost.py`), hierarchical
meshes, shard/gather, a mesh run's resume, and the CLI under torchrun.

The world of 4 is spawned by `tests/torch_dist_rig.py` (gloo); the CLI runs
under `python -m torch.distributed.run` with 2 ranks on the CPU and is held
against a single-process run's scores CSV (rtol 1e-5). The hierarchical
mesh's messages are the JAX `make_hierarchical_mesh`'s; its fit tracks the
port's serial trainer at the trainer's rtol 2e-5; a resumed mesh run is
bitwise the unbroken one (rank 0 reads the checkpoint and broadcasts it).
"""

from __future__ import annotations

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from factorvae_tpu.config import MeshConfig as JMeshConfig
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.parallel.mesh import make_hierarchical_mesh as jhier
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.config import MeshConfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.parallel import multihost
from factorvae_tpu_torch.parallel.mesh import AbstractMesh, make_hierarchical_mesh
from factorvae_tpu_torch.parallel.partition import P
from factorvae_tpu_torch.train.trainer import Trainer
from torch_dist_rig import _panel, assert_ranks_bitwise, multihost_cases, run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, H, K, M = 6, 5, 8, 4, 10


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=30, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    arrays = {"values": jp.values, "valid": jp.valid,
              "dates": jp.dates.values.astype("datetime64[D]"),
              "instruments": np.asarray(jp.instruments)}
    return jp, arrays


def _config(jp, save_dir) -> tconfig.Config:
    d = [str(x.date()) for x in jp.dates]
    return tconfig.Config(
        model=tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[21],
                                val_start_time=d[22], val_end_time=d[29], pad_multiple=4),
        train=tconfig.TrainConfig(num_epochs=2, lr=1e-3, seed=3, days_per_step=2,
                                  checkpoint_every=0, recover_after=0,
                                  save_dir=str(save_dir)))


class TestEnvironment:
    def test_torchrun_environment_and_backends(self, monkeypatch):
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
            monkeypatch.delenv(k, raising=False)
        assert not multihost.in_multihost_env()
        assert multihost.maybe_initialize() is False          # no-op, no group
        assert multihost.process_info()["process_count"] == 1
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert not multihost.in_multihost_env()
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        assert multihost.in_multihost_env()
        assert multihost.default_backend("cuda") == "nccl"
        assert multihost.default_backend("cpu") == "gloo"
        with pytest.raises(ValueError, match="backend 'mpi'"):
            multihost.maybe_initialize(backend="mpi", init_method="file:///nonexistent")

    def test_global_put_takes_this_ranks_slice(self):
        class Rank(AbstractMesh):
            def __init__(self, coords):
                super().__init__((2, 2))
                self.coords = coords

        x = np.arange(4 * 6 * 3).reshape(4, 6, 3)
        for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
            d, s = coords
            got = multihost.global_put(x, Rank(coords), P("data", "stock"))
            np.testing.assert_array_equal(got, x[2 * d:2 * d + 2, 3 * s:3 * s + 3])
            # a dimension over both axes: shard 2 * d + s of 4, major axis first
            joint = multihost.global_put(x, Rank(coords), P(("data", "stock")))
            np.testing.assert_array_equal(joint, x[2 * d + s:2 * d + s + 1])

    @pytest.mark.parametrize("kw", [dict(num_hosts=3), dict(num_hosts=8),
                                    dict(num_hosts=2, data_axis=3)],
                             ids=["hosts", "stock_split", "data_axis"])
    def test_hierarchical_mesh_errors_equal_jax(self, kw):
        """The shape errors, raised before any group is made."""
        cfg = dict(stock_axis=2, data_axis=kw.pop("data_axis", -1))
        with pytest.raises(ValueError) as mine:
            make_hierarchical_mesh(MeshConfig(**cfg), devices=range(8), **kw)
        with pytest.raises(ValueError) as theirs:
            jhier(JMeshConfig(**cfg), devices=jax.devices()[:8], **kw)
        assert str(mine.value) == str(theirs.value)


class TestFourRanks:
    @pytest.fixture(scope="class")
    def world(self, panels, tmp_path_factory):
        jp, arrays = panels
        tmp = tmp_path_factory.mktemp("mh")
        results = run_world(4, multihost_cases, tmp, arrays,
                            _config(jp, tmp / "cfg").to_dict(), str(tmp / "runs"),
                            timeout=180)
        ds = PanelDataset(_panel(arrays), seq_len=T, pad_multiple=4, device="cpu")
        _, serial = Trainer(_config(jp, tmp / "serial"), ds, device="cpu").fit()
        return results, [h["train_loss"] for h in serial["history"]]

    def test_process_info_and_the_hierarchical_layout(self, world):
        results, _ = world
        assert [r["info"]["process_index"] for r in results] == [0, 1, 2, 3]
        assert all(r["info"]["process_count"] == 4 and r["info"]["backend"] == "gloo"
                   for r in results)
        assert results[0]["hier"]["shape"] == {"host": 2, "data": 1, "stock": 2}
        assert [r["hier"]["coords"] for r in results] == [(0, 0, 0), (0, 0, 1), (1, 0, 0),
                                                          (1, 0, 1)]
        # 'stock' groups stay inside a host; the batch axes cross them
        assert [r["hier"]["stock_ranks"] for r in results] == [(0, 1), (0, 1), (2, 3),
                                                               (2, 3)]
        assert results[0]["hier"]["batch"] == ("host/data", (0, 2))
        assert results[1]["hier"]["batch"] == ("host/data", (1, 3))

    def test_hierarchical_fit_tracks_the_serial_trainer(self, world):
        results, serial = world
        for r in results:
            assert r["hier"]["train_loss"] == results[0]["hier"]["train_loss"]
        np.testing.assert_allclose(results[0]["hier"]["train_loss"], serial, rtol=2e-5)

    def test_shard_and_gather_roundtrip(self, world):
        results, _ = world
        w = np.arange(32, dtype=np.float32).reshape(4, 8)
        b = np.arange(4, dtype=np.float32)
        for rank, r in enumerate(results):
            d, s = divmod(rank, 2)
            np.testing.assert_array_equal(r["shard"]["w"], w[2 * d:2 * d + 2, 4 * s:4 * s + 4])
            np.testing.assert_array_equal(r["shard"]["b"], b[2 * s:2 * s + 2])
            np.testing.assert_array_equal(r["gather"]["w"], w)
            np.testing.assert_array_equal(r["gather"]["b"], b)

    def test_a_resumed_mesh_run_is_bitwise_the_unbroken_one(self, world):
        results, _ = world
        for r in results:
            runs = r["resume"]
            for name, p in runs["unbroken"]["params"].items():
                np.testing.assert_array_equal(runs["resumed"]["params"][name], p)
            assert runs["resumed"]["history"] == runs["unbroken"]["history"][1:]
            assert runs["unbroken"]["files"] == runs["resumed"]["files"]
        assert_ranks_bitwise([r["resume"]["resumed"] for r in results], "params")


class TestCliUnderTorchrun:
    def test_two_ranks_write_the_single_process_csv(self, panels, tmp_path):
        """`--mesh --mesh_stock 2` on 2 ranks (gloo, --device cpu) scores
        within rtol 1e-5 of one process without a mesh; only rank 0 writes."""
        jp, _ = panels
        from factorvae_tpu_torch.data.panel import panel_to_frame, Panel

        tp = Panel(values=jp.values, valid=jp.valid,
                   dates=jp.dates.values.astype("datetime64[D]"),
                   instruments=np.asarray(jp.instruments))
        path = str(tmp_path / "panel.pkl")
        panel_to_frame(tp).to_pickle(path)
        d = [str(x.date()) for x in jp.dates]

        def argv(out):
            return ["--dataset", path, "--num_latent", str(C), "--hidden_size", str(H),
                    "--num_factor", str(K), "--num_portfolio", str(M), "--seq_len", str(T),
                    "--start_time", d[0], "--fit_end_time", d[21], "--val_start_time",
                    d[22], "--val_end_time", d[29], "--score_start", d[10], "--score_end",
                    d[29], "--num_epochs", "1", "--lr", "1e-3", "--seed", "3",
                    "--days_per_step", "2", "--deterministic_scores",
                    "--save_dir", str(tmp_path / out / "models"),
                    "--score_dir", str(tmp_path / out / "scores"), "--device", "cpu"]

        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
        run = dict(cwd=REPO, env=env, capture_output=True, text=True)
        single = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.cli",
                                 *argv("single")], timeout=120, **run)
        assert single.returncode == 0, single.stderr
        multi = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "2", "-m", "factorvae_tpu_torch.cli",
                                *argv("multi"), "--mesh", "--mesh_stock", "2"],
                               timeout=180, **run)
        assert multi.returncode == 0, multi.stderr[-4000:]
        assert multi.stdout.count("[scores]") == 1          # rank 0 alone logs

        def read(out):
            (name,) = os.listdir(tmp_path / out / "scores")
            with open(tmp_path / out / "scores" / name) as fh:
                return list(csv.reader(fh))

        a, b = read("single"), read("multi")
        assert a[0] == b[0] and len(a) == len(b) > 10
        assert [r[:2] for r in a] == [r[:2] for r in b]
        np.testing.assert_allclose(np.asarray([float(r[2]) for r in b[1:]]),
                                   np.asarray([float(r[2]) for r in a[1:]]), rtol=1e-5,
                                   atol=1e-6)
