"""Example: cross-section ('stock'-axis) sharding with explicit collectives on
the PyTorch port (`examples/sharded_cross_section.py` through
`factorvae_tpu_torch.parallel`).

Two ranks in one gloo world split the stock axis of a mesh and run the
port's distributed primitives, the ones the mesh trainer calls:

  1. the masked softmax over the sharded stock axis (pmax/psum),
  2. the distributed portfolio reduction W^T y,
  3. ring attention over the sharded cross-section (the ring's shifts).

Each result is held against the same function on the whole cross-section
on one rank. On the GPU both ranks share it; on the CPU (--cpu) they run on
the host. Prints each difference, then one JSON line of them; exits 1 if a
difference is above its tolerance.

Run:  python examples/torch_sharded_cross_section.py [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

import numpy as np

WORLD = 2
N, M, H, K = 64, 6, 8, 4          # stocks, portfolios, hidden, heads
TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    return {"weights": rng.normal(size=(N, M)).astype(np.float32),
            "returns": (rng.normal(size=(N,)) * 0.02).astype(np.float32),
            "mask": rng.random(N) > 0.1,
            "q": rng.normal(size=(K, H)).astype(np.float32),
            "keys": rng.normal(size=(N, H)).astype(np.float32),
            "vals": rng.normal(size=(N, H)).astype(np.float32)}


def _rank(rank: int, init: str, device: str, q) -> None:
    """One rank: its slice of the stocks through the three primitives, and
    on rank 0 the unsharded versions, sent back through `q`."""
    try:
        import torch
        import torch.distributed as dist

        from factorvae_tpu_torch.config import MeshConfig
        from factorvae_tpu_torch.ops.masked import masked_softmax
        from factorvae_tpu_torch.parallel.collective_ops import (
            comm_counts,
            pmax_masked_softmax,
            psum_matvec,
        )
        from factorvae_tpu_torch.parallel.mesh import make_mesh
        from factorvae_tpu_torch.parallel.ring import ring_cross_section_attention

        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=init, world_size=WORLD, rank=rank)
        mesh = make_mesh(MeshConfig(stock_axis=WORLD))
        stock = mesh.axis("stock")
        t = {k: torch.from_numpy(v).to(device) for k, v in _inputs().items()}
        lo, hi = stock.index * N // stock.size, (stock.index + 1) * N // stock.size
        local = {k: t[k][lo:hi] for k in ("weights", "returns", "mask", "keys", "vals")}

        # 1) the encoder's softmax over stocks, each rank holding its slice
        w_dist = pmax_masked_softmax(local["weights"], local["mask"][:, None], stock, dim=0)
        # 2) portfolio returns y_p = W^T y, summed over the ranks
        y_p = psum_matvec(w_dist, torch.where(local["mask"], local["returns"], 0.0), stock)
        # 3) K queries over the sharded cross-section, chunks passed round the ring
        ctx = ring_cross_section_attention(t["q"], local["keys"], local["vals"],
                                           local["mask"], stock)
        out = {"softmax": w_dist.cpu().numpy(), "portfolio": y_p.cpu().numpy(),
               "ring": ctx.cpu().numpy(),
               "comms": {f"{kind} over {axis}": c for (kind, axis), c in comm_counts().items()},
               "device": str(w_dist.device), "slice": [lo, hi]}
        if rank == 0:
            w_ref = masked_softmax(t["weights"], t["mask"][:, None], dim=0)
            s = torch.clamp(t["q"] @ t["keys"].T / torch.sqrt(torch.tensor(H + 1e-6)), min=0)
            p = masked_softmax(s, t["mask"][None, :], dim=1)
            out["reference"] = {
                "softmax": w_ref.cpu().numpy(),
                "portfolio": (w_ref.T @ torch.where(t["mask"], t["returns"], 0.0)).cpu().numpy(),
                "ring": (p @ torch.where(t["mask"][:, None], t["vals"], 0.0)).cpu().numpy()}
        dist.destroy_process_group()
        q.put((rank, "ok", out))
    except BaseException:      # noqa: BLE001 - the parent reports it
        q.put((rank, "error", traceback.format_exc()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch.multiprocessing as mp

    device = "cpu" if args.cpu else "cuda"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="factorvae_sharded_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, init, device, q)) for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            got = dict((rank, (kind, value)) for rank, kind, value in
                       (q.get(timeout=300) for _ in procs))
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
    failed = {r: v for r, (kind, v) in got.items() if kind != "ok"}
    if failed:
        for r, tb in failed.items():
            print(f"rank {r} failed:\n{tb}", file=sys.stderr)
        return 1
    ranks = [got[r][1] for r in range(WORLD)]
    ref = ranks[0]["reference"]
    print(f"mesh: {WORLD} ranks on {ranks[0]['device']} over axis 'stock' (gloo)")
    err = {
        "softmax": float(np.max(np.abs(np.concatenate([r["softmax"] for r in ranks])
                                       - ref["softmax"]))),
        "portfolio": max(float(np.max(np.abs(r["portfolio"] - ref["portfolio"])))
                         for r in ranks),
        "ring": max(float(np.max(np.abs(r["ring"] - ref["ring"]))) for r in ranks)}
    print("softmax max|delta|:", err["softmax"])
    print("portfolio returns:", np.round(ranks[0]["portfolio"], 5),
          "max|delta|:", err["portfolio"])
    print("ring attention context:", ranks[0]["ring"].shape, "max|delta|:", err["ring"])
    ok = all(e <= TOL for e in err.values()) and all(
        np.isfinite(r[k]).all() for r in ranks for k in ("softmax", "portfolio", "ring"))
    print(json.dumps({"ok": bool(ok), "device": ranks[0]["device"], "world": WORLD,
                      "max_abs_err": err, "tolerance": TOL, "comms": ranks[0]["comms"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
