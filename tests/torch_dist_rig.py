"""Spawned gloo worlds for the port's parallel tests (imports no JAX).

`run_world(world, fn, tmp_path, *args)` starts `world` processes with
`torch.multiprocessing`'s spawn, each joining one gloo process group through
a `file://` rendezvous under `tmp_path` (no fixed port, so xdist workers
never collide), with one intra-op thread. Each runs `fn(rank, *args)` (a
module-level function, importable by name in the child) and sends its
result back; results must be picklable without shared memory (numpy, not
torch tensors: `to_numpy`). A rank that raises sends its traceback, which
fails the test; a world that does not finish within `timeout` seconds is
killed and fails the test instead of stalling the suite. The ranks run at
a lower scheduling priority (nice 10), so that a world of 4 in one xdist
worker does not starve the timing-sensitive tests of the others.
"""

from __future__ import annotations

import os
import queue
import traceback

import numpy as np


def _worker(rank, world, init, q, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.nice(10)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        try:
            q.put((rank, "ok", fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:      # noqa: BLE001 - the parent reports it
        q.put((rank, "error", traceback.format_exc()))


def run_world(world: int, fn, tmp_path, *args, timeout: float = 120.0) -> list:
    """[fn's result on rank r for r in range(world)]."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_path), f"rdv_{os.getpid()}_{id(fn)}")
    procs = [ctx.Process(target=_worker, args=(r, world, init, q, fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, kind, value = q.get(timeout=timeout)
            (results.__setitem__(rank, value) if kind == "ok"
             else errors.append(f"rank {rank}:\n{value}"))
            if errors:
                break
    except queue.Empty:
        errors.append(f"the world of {world} did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def to_numpy(tree):
    """Tensors in nested dicts/lists/tuples as numpy copies."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def assert_ranks_bitwise(results, key=None) -> None:
    """Every rank's `results[r][key]` (a dict of arrays) equal to rank 0's,
    bit for bit."""
    first = results[0] if key is None else results[0][key]
    for r, res in enumerate(results[1:], 1):
        other = res if key is None else res[key]
        assert set(other) == set(first)
        for name in first:
            np.testing.assert_array_equal(other[name], first[name],
                                          err_msg=f"rank {r} {name}")


# ---- worker bodies (each runs on every rank of a world) ---------------------


def collective_cases(rank, inputs: dict) -> dict:
    """Every collective op and the ring on a (1, world) mesh: each rank takes
    its rows of the whole inputs; returns its outputs (and the gradients
    of a replicated loss) as numpy."""
    import torch

    from factorvae_tpu_torch.parallel import collective_ops as co
    from factorvae_tpu_torch.parallel.mesh import STOCK_AXIS, make_mesh
    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.parallel.ring import (
        predictor_prior_ring,
        ring_cross_section_attention,
    )

    import torch.distributed as dist

    mesh = make_mesh(MeshConfig(stock_axis=dist.get_world_size()))
    ax = mesh.axis(STOCK_AXIS)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    n = t["x"].shape[0] // ax.size
    rows = slice(ax.index * n, (ax.index + 1) * n)
    co.reset_comm_counts()
    out = {}
    x = t["x"][rows].clone().requires_grad_(True)
    y = co.pmax_masked_softmax(x, t["mask"][rows], ax, dim=0)
    out["softmax"] = y
    loss = torch.sum(t["c"] * co.all_gather_stocks(y, ax, dim=0))
    loss.backward()
    out["softmax_grad"] = x.grad / ax.size
    out["matvec"] = co.psum_matvec(t["w"][rows], t["v"][rows], ax)
    out["mean"] = co.psum_masked_mean(t["v"][rows], t["vmask"][rows], ax)
    out["mse"] = co.psum_masked_mse(t["v"][rows], t["target"][rows], t["vmask"][rows], ax)
    out["mean_all_masked"] = co.psum_masked_mean(t["v"][rows],
                                                 torch.zeros(n, dtype=torch.bool), ax)
    g = t["w"][rows].clone().requires_grad_(True)
    gathered = co.all_gather_stocks(g, ax, dim=0)
    out["gather"] = gathered
    torch.sum(t["gw"] * gathered).backward()
    out["gather_grad"] = g.grad / ax.size
    for name, mask in (("ring", t["rmask"]), ("ring_masked", torch.zeros_like(t["rmask"]))):
        out[name] = ring_cross_section_attention(t["q"], t["keys"][rows], t["vals"][rows],
                                                 mask[rows], ax)
    out["ring_guard"] = ring_cross_section_attention(
        t["q"], t["keys_inf"][rows], t["vals"][rows], t["rmask"][rows], ax,
        guard_nonfinite=True)
    pred = {k[len("pred."):]: v for k, v in t.items() if k.startswith("pred.")}
    for name, lat in (("prior", t["latent"]), ("prior_nan", t["latent_nan"])):
        mu, sigma = predictor_prior_ring(pred, lat[rows], t["lmask"][rows], ax,
                                         cfg=_Slope(float(inputs["slope"])))
        out[name] = torch.stack([mu, sigma])
    counts = co.comm_counts()
    out = to_numpy(out)
    out["counts"] = {f"{k}@{a}": v for (k, a), v in counts.items()}
    return out


class _Slope:
    def __init__(self, slope):
        self.leaky_relu_slope = slope


def _panel(arrays: dict):
    from factorvae_tpu_torch.data.panel import Panel

    return Panel(values=arrays["values"], valid=arrays["valid"], dates=arrays["dates"],
                 instruments=arrays["instruments"])


def _config(cfg_dict: dict, **train):
    import dataclasses

    from factorvae_tpu_torch.config import Config

    cfg = Config.from_dict(cfg_dict)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def mesh_update(rank, arrays: dict, cfg_dict: dict, weights: dict, days, shapes) -> dict:
    """One update of the batch `days` on each (data, stock) mesh of `shapes`
    from the same weights: per mesh this rank's reduced gradients, its
    parameters after the update and the step's loss sum (the whole
    update's, from the epoch finalizer's reduction)."""
    import torch

    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.parallel.mesh import make_mesh
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    out = {}
    for dp, sp in shapes:
        mesh = make_mesh(MeshConfig(stock_axis=sp))
        assert dict(mesh.shape) == {"data": dp, "stock": sp}
        cfg = _config(cfg_dict, days_per_step=len(days))
        ds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                          pad_multiple=cfg.data.pad_multiple, device="cpu")
        tr = Trainer(cfg, ds, device="cpu", mesh=mesh)
        state = tr.init_state()
        state.model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
        aux = train_step(state, tr.ds, torch.as_tensor(days), guard=True, mesh=tr.mesh_step)
        aux = tr.mesh_step.reduce_sums(aux)
        out[f"{dp}x{sp}"] = {
            "grads": to_numpy({n: p.grad for n, p in state.model.named_parameters()}),
            "params": to_numpy(dict(state.model.named_parameters())),
            "loss_sum": float(aux["loss_sum"]), "days": float(aux["days"]),
            "rows": ds.values.shape[0],
        }
    return out


def mesh_fit(rank, arrays: dict, cfg_dict: dict, shapes, save_root: str) -> dict:
    """`Trainer.fit` on each (data, stock) mesh of `shapes`: per mesh the
    epochs' losses, the final parameters and the comms block."""
    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.parallel.mesh import make_mesh
    from factorvae_tpu_torch.train.trainer import Trainer

    out = {}
    for dp, sp in shapes:
        mesh = make_mesh(MeshConfig(stock_axis=sp))
        cfg = _config(cfg_dict, save_dir=os.path.join(save_root, f"{dp}x{sp}"))
        ds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                          pad_multiple=cfg.data.pad_multiple, device="cpu")
        tr = Trainer(cfg, ds, device="cpu", mesh=mesh)
        state, fit = tr.fit()
        out[f"{dp}x{sp}"] = {
            "train_loss": [h["train_loss"] for h in fit["history"]],
            "val_loss": [h["val_loss"] for h in fit["history"]],
            "params": to_numpy(dict(state.model.named_parameters())),
            "comms": tr.comms_block(),
        }
    return out


def composed_oracles(rank, arrays: dict, cfg_dict: dict, save_root: str) -> dict:
    """The composed pins on a 2 x 2 mesh, per residency: a Trainer (its
    parameters and sampled scores) and an S = 2 seed fleet (its final
    parameters, best parameters, best_val and history)."""
    import dataclasses

    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.parallel.mesh import make_mesh
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.trainer import Trainer

    out = {}
    for res in ("hbm", "stream"):
        mesh = make_mesh(MeshConfig(stock_axis=2))
        cfg = _config(cfg_dict, save_dir=os.path.join(save_root, "t", res))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, panel_residency=res))
        ds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                          pad_multiple=cfg.data.pad_multiple, device="cpu", residency=res)
        state, _ = Trainer(cfg, ds, device="cpu", mesh=mesh).fit()
        scores = predict_panel(state.model, cfg, ds, ds.split_days(None, None),
                               stochastic=True, mesh=mesh)
        fcfg = _config(cfg_dict, save_dir=os.path.join(save_root, "f", res), num_epochs=3,
                       days_per_step=1)
        fcfg = dataclasses.replace(fcfg, data=dataclasses.replace(fcfg.data,
                                                                  panel_residency=res))
        fds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                           pad_multiple=cfg.data.pad_multiple, device="cpu", residency=res)
        fleet = FleetTrainer(fcfg, fds, seeds=[3, 4], device="cpu", mesh=make_mesh(
            MeshConfig(stock_axis=2)))
        fstate, fout = fleet.fit()
        out[res] = {
            "params": to_numpy(dict(state.model.named_parameters())),
            "scores": scores,
            "fleet_params": to_numpy(fstate.params),
            "best_params": to_numpy(fout["best_params"]),
            "best_val": np.asarray(fout["best_val"]),
            "history": [(h["train_loss"], h["val_loss"]) for h in fout["history"]],
            "lanes": (fleet.lanes.start, fleet.lanes.stop),
        }
    return out


def in_sequence(rank, calls) -> list:
    """Several worker bodies on one world, in order: [(fn, args), ...] ->
    [fn(rank, *args), ...]."""
    return [fn(rank, *args) for fn, args in calls]


def multihost_cases(rank, arrays: dict, cfg_dict: dict, save_root: str) -> dict:
    """On a world of 4: the hierarchical mesh of 2 simulated hosts (its
    axes, a fit on it), a shard/gather round trip on the 2 x 2 mesh, and a
    2-epoch fit on the 2 x 2 mesh against 1 epoch plus a resume."""
    import torch

    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.parallel import multihost
    from factorvae_tpu_torch.parallel.mesh import make_hierarchical_mesh, make_mesh
    from factorvae_tpu_torch.parallel.partition import (
        P,
        make_shard_and_gather_fns,
        match_partition_rules,
    )
    from factorvae_tpu_torch.train.trainer import Trainer

    out = {"info": multihost.process_info()}
    hmesh = make_hierarchical_mesh(MeshConfig(stock_axis=2), num_hosts=2)
    out["hier"] = {"shape": dict(hmesh.shape), "coords": hmesh.coords,
                   "stock_ranks": hmesh.axis("stock").ranks,
                   "batch": (hmesh.batch_axis().name, hmesh.batch_axis().ranks)}
    cfg = _config(cfg_dict, save_dir=os.path.join(save_root, "hier"))
    ds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                      pad_multiple=cfg.data.pad_multiple, device="cpu")
    _, fit = Trainer(cfg, ds, device="cpu", mesh=hmesh).fit()
    out["hier"]["train_loss"] = [h["train_loss"] for h in fit["history"]]

    mesh = make_mesh(MeshConfig(stock_axis=2))
    tree = {"w": np.arange(32, dtype=np.float32).reshape(4, 8),
            "b": np.arange(4, dtype=np.float32)}
    specs = match_partition_rules([(r"w", P("data", "stock")), (r"b", P("stock"))], tree)
    shard_fns, gather_fns = make_shard_and_gather_fns(mesh, specs)
    local = {k: shard_fns[k](torch.as_tensor(v)) for k, v in tree.items()}
    out["shard"] = {k: to_numpy(v) for k, v in local.items()}
    out["gather"] = {k: gather_fns[k](v) for k, v in local.items()}

    runs = {}
    for name, plan in (("unbroken", [(2, False)]), ("resumed", [(1, False), (2, True)])):
        rcfg = _config(cfg_dict, save_dir=os.path.join(save_root, name), checkpoint_every=1,
                       num_epochs=2)
        for epochs, resume in plan:
            rds = PanelDataset(_panel(arrays), seq_len=rcfg.data.seq_len,
                               pad_multiple=rcfg.data.pad_multiple, device="cpu")
            tr = Trainer(rcfg, rds, device="cpu", mesh=make_mesh(MeshConfig(stock_axis=2)))
            state, fit = tr.fit(resume=resume, num_epochs=epochs)
        runs[name] = {"params": to_numpy(dict(state.model.named_parameters())),
                      "history": [(h["epoch"], h["train_loss"]) for h in fit["history"]],
                      "files": sorted(os.listdir(os.path.join(
                          rcfg.train.save_dir, rcfg.checkpoint_name() + "_ckpt")))}
    out["resume"] = runs
    return out


# ---- fleets on every mesh: hyper-fleets, PBT, the hierarchical fleet ------------


def lane_configs(cfg_dict: dict, lanes, save_dir: str, **train) -> tuple:
    """(base Config, lane Configs) of a hyper-fleet: `lanes` is [(seed, lr,
    kl_weight), ...], each lane tagged with its own run_name; `train`
    overrides the base's train fields."""
    import dataclasses

    cfg = _config(cfg_dict, save_dir=save_dir, **train)
    out = [dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, kl_weight=float(klw)),
        train=dataclasses.replace(cfg.train, seed=int(seed), lr=float(lr),
                                  run_name=f"{cfg.train.run_name}_lane{i}"))
        for i, (seed, lr, klw) in enumerate(lanes)]
    return cfg, out


def start_from(weights: dict) -> None:
    """Every port fleet lane of this process starts from its seed's
    weights (`weights[seed]`, name -> array)."""
    import torch

    from factorvae_tpu_torch.train.fleet import FleetTrainer

    init = FleetTrainer.init_lane_state

    def patched(self, i):
        st = init(self, i)
        st.model.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in weights[self.seeds[i]].items()})
        return st

    FleetTrainer.init_lane_state = patched


def fleet_result(trainer, state, out) -> dict:
    """A FleetTrainer's fit as numpy: the whole fleet's history, best_val,
    best and final parameters; this rank's lanes and its comms block."""
    return {"history": [(h["train_loss"], h["val_loss"]) for h in out["history"]],
            "lr": [h["lr"] for h in out["history"]],
            "labels": [h["lane_labels"] for h in out["history"]],
            "best_val": np.asarray(out["best_val"]),
            "best_params": to_numpy(out["best_params"]),
            "final_params": to_numpy(out["final_params"]),
            "lanes": (trainer.lanes.start, trainer.lanes.stop)}


def pbt_result(res: dict) -> dict:
    return {"generations": [{k: v for k, v in g.items() if k != "lane_labels"}
                            for g in res["generations"]],
            "scalars": [(c.train.lr, c.model.kl_weight) for c in res["lane_configs"]],
            "best_val": np.asarray(res["best_val"]),
            "best_params": to_numpy(res["best_params"]),
            "state": to_numpy(res["state"].params)}


def mesh_fleets(rank, arrays: dict, cfg_dict: dict, weights: dict, hyper_lanes,
                pbt_lanes, save_root: str) -> dict:
    """On a world of 2, the 2 x 1 mesh (one lane a 'data' rank for the
    hyper-fleet): a hyper-fleet's fit, a PBT of 2 generations, and the same
    PBT stopped after generation 0 and resumed."""
    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.obs.comms import comms_block
    from factorvae_tpu_torch.parallel.collective_ops import comm_counts, reset_comm_counts
    from factorvae_tpu_torch.parallel.mesh import make_mesh
    from factorvae_tpu_torch.train.fleet import FleetTrainer
    from factorvae_tpu_torch.train.pbt import pbt_fit

    start_from(weights)

    def ds():
        return PanelDataset(_panel(arrays), seq_len=cfg_dict["data"]["seq_len"],
                            pad_multiple=cfg_dict["data"]["pad_multiple"], device="cpu")

    out = {}
    cfg, lanes = lane_configs(cfg_dict, hyper_lanes, os.path.join(save_root, "hyper"))
    mesh = make_mesh(MeshConfig(stock_axis=1))
    reset_comm_counts()
    trainer = FleetTrainer(cfg, ds(), lane_configs=lanes, device="cpu", mesh=mesh)
    state, fit = trainer.fit()
    out["hyper"] = fleet_result(trainer, state, fit)
    out["hyper"]["hyper"] = trainer.hyper
    out["hyper"]["comms"] = comms_block(comm_counts(), mesh=mesh,
                                        steps=trainer.steps_per_epoch * cfg.train.num_epochs,
                                        steps_per_epoch=trainer.steps_per_epoch)
    for name, plan in (("unbroken", [dict()]),
                       ("resumed", [dict(stop_after=0), dict(resume=True)])):
        pcfg, plane = lane_configs(cfg_dict, pbt_lanes, os.path.join(save_root, name),
                                   checkpoint_every=1)
        reset_comm_counts()
        for extra in plan:
            _, res = pbt_fit(pcfg, ds(), plane, generations=2, epochs_per_generation=1,
                             device="cpu", mesh=mesh, **extra)
        out[name] = pbt_result(res)
        out[name]["comms"] = {f"{k}@{a}": v for (k, a), v in comm_counts().items()}
    return out


def hier_fleets(rank, arrays: dict, cfg_dict: dict, weights: dict, seeds,
                save_root: str) -> dict:
    """On a world of 4, a seed fleet on two hierarchical meshes: 'host' 2 x
    'data' 2 x 'stock' 1 (a lane a rank, days over 'host') and 'host' 2 x
    'data' 1 x 'stock' 2 (both lanes stacked on every rank, days over
    'host', rows over 'stock')."""
    from factorvae_tpu_torch.config import MeshConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.obs.comms import comms_block
    from factorvae_tpu_torch.parallel.collective_ops import comm_counts, reset_comm_counts
    from factorvae_tpu_torch.parallel.mesh import make_hierarchical_mesh
    from factorvae_tpu_torch.train.fleet import FleetTrainer

    start_from(weights)
    out = {}
    for sp in (1, 2):
        mesh = make_hierarchical_mesh(MeshConfig(stock_axis=sp), num_hosts=2)
        key = "x".join(str(mesh.shape[a]) for a in ("host", "data", "stock"))
        cfg = _config(cfg_dict, save_dir=os.path.join(save_root, key))
        ds = PanelDataset(_panel(arrays), seq_len=cfg.data.seq_len,
                          pad_multiple=cfg.data.pad_multiple, device="cpu")
        reset_comm_counts()
        trainer = FleetTrainer(cfg, ds, seeds=seeds, device="cpu", mesh=mesh)
        state, fit = trainer.fit()
        out[key] = fleet_result(trainer, state, fit)
        out[key]["comms"] = comms_block(comm_counts(), mesh=mesh,
                                        steps=trainer.steps_per_epoch * cfg.train.num_epochs,
                                        steps_per_epoch=trainer.steps_per_epoch)
        out[key]["day_axis"] = trainer.mesh_step.day_axis.name
        out[key]["grad_axis"] = trainer.mesh_step.grad_axis.name
    return out


def autotune_mesh(rank, shape: dict, out: str, argv) -> dict:
    """`autotune --mesh` on this world (the races' times agreed over the
    ranks): its exit code, and rank 0's table."""
    import json

    from factorvae_tpu_torch import autotune

    autotune.SHAPES["tiny"] = shape
    rc = autotune.main(["--config", "tiny", "--mesh", "--out", out, *argv])
    rows = None
    if rank == 0 and rc == 0:
        with open(out) as fh:
            rows = json.load(fh)["rows"]
    return {"rc": rc, "rows": rows}
