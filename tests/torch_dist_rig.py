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
