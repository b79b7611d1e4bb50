#!/usr/bin/env python3
"""Split the wide attention kernels (K4 and K5 above H = 64) into their
phases, in cycles, and K5's launch into its kernels, on one GPU.

    python3 scripts/torch_attention_phases.py [--tree DIR] [--hidden 128,256]
        [--seed 0] [--out FILE]

For each hidden size of --hidden, at the flagship widths (N = 304 with 300
stocks, K = 96; the inputs of scripts/torch_attention_times.py, from
--seed): K4 at one day and at a 32-day chunk, K5 at one day and at 8 days.

`kernels_us`: torch.profiler's device microseconds per call of each CUDA
kernel the tree's wrapper launches (its own libraries, untouched).

`cycles`: clock64 marks at the phase boundaries of the CTA that takes day
0's first heads (thread 0 of block (0, 0); the marks sum into a device
array and are divided by the calls). `attention_fwd.cu` and
`attention_bwd.cu` of the tree at DIR are copied into a temporary directory
with the marks' definitions put in front, built with nvcc beside the tree's
headers, and loaded in place of the tree's libraries, so the wrapper's own
launch path runs them. A source that carries `ATTN_PHASE(i)` calls (the
wide design with clusters: the day kernel's phases) is marked there; one
without (the design with one CTA per day and group of heads that forms u,
the scores, P and the context itself) gets its marks at fixed anchors.
`graph_ms` is the instrumented call's CUDA-graph time, beside the phases'
sum. The marks cost a few cycles each. Prints one JSON line with the card's
`nvidia-smi` name and power limit; exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

from torch_attention_times import SHAPES, _inputs, _kernel_us
from torch_kernel_digest import emit, graph_ms, nvidia_smi, use_tree

SLOTS = 16
DEFINITIONS = f"""// clock64 phase marks (scripts/torch_attention_phases.py)
__device__ unsigned long long g_attn_phase[{SLOTS}];
#define ATTN_PHASE_START long long attn_phase_t_ = clock64();
#define ATTN_PHASE(i) do {{ if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {{ \\
    const long long attn_now_ = clock64(); g_attn_phase[i] += attn_now_ - attn_phase_t_; \\
    attn_phase_t_ = attn_now_; }} }} while (0)
"""
ACCESSOR = f"""
extern "C" int attention_phases(unsigned long long* out, int zero) {{
  if (zero) {{
    unsigned long long z[{SLOTS}] = {{0}};
    return (int)cudaMemcpyToSymbol(g_attn_phase, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, g_attn_phase, sizeof(g_attn_phase));
}}
"""

# the phases of the design whose sources carry ATTN_PHASE(i): the wide day
# kernels (a cluster per day and group of heads, a column slice of the
# rows each)
CLUSTER_PHASES = {
    "attention_fwd": ("compact", "stage", "partials", "exchange", "softmax", "P"),
    "attention_bwd": ("compact", "stage", "partials", "exchange", "softmax", "dz", "lz/la"),
}
# the design with one CTA per (day, group of heads) forming u, the scores,
# P and the context itself: (phase, the line after which its mark goes;
# "^" in front: before which)
SINGLE_CTA = {
    "attention_fwd": (
        ("start", "  const Layout L = layout(n, h, group, staged, false);\n"),
        ("compact", "  const int nv = compact_rows(mask + (size_t)day * n, n, idx);\n"),
        ("stage", "  const bool flagged = stage_rows(lat, idx, nv, h, staged, smem + L.rows);\n"),
        ("u", "q + (size_t)head0 * h, gn, h, L.gp, smem + L.u, smem + L.c);\n"),
        ("scores", "  row_dots(rows, nv, h, smem + L.u, smem + L.c, gn, L.gp, sc, L.ldn);\n"),
        ("softmax", "               sqrtf((float)h + 1e-6f), ok, smem + L.sa);\n"),
        ("P", "  column_sums(rows, nv, h, smem + L.at, L.gt, gn, smem + L.part, smem + L.p, h);\n"),
        ("ctx", "               smem + L.sa, ok, gn, h, smem + L.part, out_g);\n"),
    ),
    "attention_bwd": (
        ("start", "  const Layout L = layout(n, h, group, staged, true);\n"),
        ("compact", "  const int nv = compact_rows(mask + (size_t)day * n, n, idx);\n"),
        ("stage", "  const bool flagged = stage_rows(lat, idx, nv, h, staged, smem + L.rows);\n"),
        ("u", "q + (size_t)head0 * h, gn, h, L.gp, smem + L.u, smem + L.c);\n"),
        ("scores", "  row_dots(rows, nv, h, smem + L.u, smem + L.c, gn, L.gp, sc, L.ldn);\n"),
        ("softmax", "  fold_softmax(sc, a, L.ldn, smem + L.at, L.gt, nv, idx, keep_g, n, gn, "
                    "scale, ok, sa);\n"),
        ("w", "dctx + bk0 * h, gn, h, L.gp, w, smem + L.cw);\n"),
        ("da", "  row_dots(rows, nv, h, w, smem + L.cw, gn, L.gp, d, L.ldn);\n"),
        ("dz", "^  column_sums(rows, nv, h, dt, L.gt, gn, smem + L.part, vec, 3 * h);"),
        ("lz/la", "  column_sums(rows, nv, h, smem + L.at, L.gt, gn, smem + L.part, vec + h, "
                  "3 * h);  // la\n"),
    ),
}


def instrument(name: str, src: str) -> tuple:
    """(the marked source, its phase names): ATTN_PHASE's definitions in
    front; at the anchors too for a source without marks. Raises if an
    anchor is not found exactly once."""
    if "ATTN_PHASE(" in src:
        return DEFINITIONS + src + ACCESSOR, CLUSTER_PHASES[name]
    names = []
    for phase, anchor in SINGLE_CTA[name]:
        line = "  ATTN_PHASE_START\n" if phase == "start" else f"  ATTN_PHASE({len(names)});\n"
        before = anchor.startswith("^")
        anchor = anchor.lstrip("^")
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {name}.cu: {anchor!r}")
        src = src.replace(anchor, line + anchor if before else anchor + line)
        if phase != "start":
            names.append(phase)
    return DEFINITIONS + src + ACCESSOR, tuple(names)


def build(torch, tree: str, tmp: str) -> dict:
    """{library: (ctypes library, phase names)} of the instrumented copies."""
    from factorvae_tpu_torch import _build

    csrc = os.path.join(os.path.abspath(tree), "factorvae_tpu_torch", "csrc")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, out = {}, {}
    for name in ("attention_fwd", "attention_bwd"):
        with open(os.path.join(csrc, f"{name}.cu")) as fh:
            src, names = instrument(name, fh.read())
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}_phases.so")
        with open(cu, "w") as fh:
            fh.write(src)
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *flags, "-I", csrc, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, names)
    for name, (proc, so, names) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the marked {name}.cu:\n{log}")
        lib = ctypes.CDLL(so)
        lib.attention_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out[name] = (lib, names)
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--hidden", default="128,256", help="comma-separated hidden sizes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also append the JSON line here")
    args = p.parse_args(argv)
    torch = use_tree(args, "torch_attention_phases")
    if torch is None:
        return 1
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import attention as mod

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("attention_fwd", "attention_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = {}
    for h in (int(x) for x in args.hidden.split(",")):
        for label, (kind, b) in SHAPES.items():
            latent, mask, weights, keep, dctx = _inputs(torch, gen, b, h=h)
            if kind == "fwd":
                def call(a=(latent, mask, *weights)):
                    return mod.attention_fwd(*a)
            else:
                def call(a=(latent, mask, *weights, dctx), kp=keep):
                    return mod.attention_bwd(*a, keep=kp)
            cases[f"{label}_H{h}"] = (kind, call, mod._group(latent, weights[0].shape[0]))
    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": nvidia_smi(), "cases": {}}
    for key, (_, call, group) in cases.items():
        out["cases"][key] = {"heads_per_cta": group, "graph_ms": graph_ms(torch, call),
                             "kernels_us": _kernel_us(torch, call)}
    reps = 10
    with tempfile.TemporaryDirectory(prefix="attention_phases_") as tmp:
        libs = build(torch, args.tree, tmp)
        for name, (lib, _) in libs.items():
            _build._loaded[name] = lib      # the wrapper launches the marked copy
        for key, (kind, call, _) in cases.items():
            lib, names = libs["attention_fwd" if kind == "fwd" else "attention_bwd"]
            call()
            torch.cuda.synchronize()
            lib.attention_phases(None, 1)
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * SLOTS)()
            lib.attention_phases(ctypes.addressof(cycles), 0)
            per_call = {p: cycles[i] / reps for i, p in enumerate(names)}
            out["cases"][key].update({"cycles": per_call, "cycles_sum": sum(per_call.values()),
                                      "marked_graph_ms": graph_ms(torch, call)})
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
