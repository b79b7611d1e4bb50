#!/usr/bin/env python3
"""Split one step of the wide GRU walk (`csrc/gru_bwd.cu`, H > 64) into its
phases, in cycles, on one GPU.

    python3 scripts/torch_gru_walk_phases.py [--tree DIR] [--seed 0] [--out FILE]

Copies `gru_bwd.cu` of the tree at DIR into a temporary directory, adds a
clock64 mark at each phase boundary of `gru_walk_wide_kernel`'s step (thread
0 of CTA 0, the cluster's first tile; the marks sum into a device array),
builds the copy with nvcc beside the tree's headers and calls its
`gru_walk` through ctypes at H = 256 (every wide tile over 8 CTAs) and H =
128 (16- and 32-row tiles over 4), N = 304, T = 20. Per step: `gates` (the
gate VJP, dxi and dg_n stored, dg split), `load+sync` (the next step's
residual loads issued, the CTA barrier), `product` (dg . Wh^T on the tensor
cores), `waitB` (every peer has read this CTA's last partials), `storeP`,
`barrierA` (every partial whole), `dsmem` (the peers' partials summed) and
`arriveB`. The marks cost a few cycles each, so the phases sum to a little
more than the kernel's own step; `ms` is the instrumented launch's CUDA-
event time. The kernel in the package is never touched. Prints one JSON
line with the card's `nvidia-smi` name and power limit; exits 1 without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

from torch_kernel_digest import emit, nvidia_smi, parse_args, use_tree

SHAPES = ((256, (32, 8)), (256, (24, 8)), (256, (16, 8)), (128, (16, 4)), (128, (32, 4)))
PHASES = ("gates", "load+sync", "product", "waitB", "storeP", "barrierA", "dsmem", "arriveB")
# (anchor in the source, the line put before it)
MARKS = (
    ("      load_step(t - 1);\n      __syncthreads();      // dg is whole\n", "      mark(0);\n"),
    ("      // P = Wh[:, this CTA's columns] . dg^T, into registers\n", "      mark(1);\n"),
    ("      cluster_wait();       // B: every peer has read this CTA's last P\n",
     "      mark(2);\n"),
    ("      cluster_arrive();     // A: every P is whole after the wait\n", "      mark(4);\n"),
    ("      if (on) {             // dh_prev of this thread's items", "      mark(5);\n"),
    ("      cluster_arrive();     // B: this CTA has read its peers' P\n", "      mark(6);\n"),
)


def instrument(src: str) -> str:
    """The wide walk with the phase marks (a copy; raises if the source no
    longer has the anchors)."""
    def put(before: str, line: str, text: str) -> str:
        if text.count(before) != 1:
            raise RuntimeError(f"anchor not found once in gru_bwd.cu: {before!r}")
        return text.replace(before, line + before)

    src = src.replace('#include "gru_common.cuh"\n',
                      '#include "gru_common.cuh"\n__device__ unsigned long long g_prof[8];\n', 1)
    src = put("    for (int t = t_len - 1;; --t) {\n      // the gate VJP",
              "    const bool prof = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&"
              " k == 0;\n    long long tp = clock64();\n    auto mark = [&](int i) {\n"
              "      if (prof) { const long long n = clock64(); g_prof[i] += n - tp; tp = n; }\n"
              "    };\n", src)
    for before, line in MARKS:
        src = put(before, line, src)
    src = src.replace("      cluster_wait();       // B: every peer has read this CTA's last P\n",
                      "      cluster_wait();       // B: every peer has read this CTA's last P\n"
                      "      mark(3);\n", 1)
    src = src.replace("      cluster_arrive();     // B: this CTA has read its peers' P\n",
                      "      cluster_arrive();     // B: this CTA has read its peers' P\n"
                      "      mark(7);\n", 1)
    return src + ('\nextern "C" int gru_prof(unsigned long long* out, int zero) {\n'
                  '  if (zero) {\n    unsigned long long z[8] = {0};\n'
                  '    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n  }\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n')


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    torch = use_tree(args, "torch_gru_walk_phases")
    if torch is None:
        return 1
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import gru

    csrc = os.path.join(os.path.abspath(args.tree), "factorvae_tpu_torch", "csrc")
    with open(os.path.join(csrc, "gru_bwd.cu")) as fh:
        src = instrument(fh.read())
    _build.build(("gru_fwd",))
    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": nvidia_smi(), "shapes": {}}
    with tempfile.TemporaryDirectory(prefix="walk_phases_") as tmp:
        cu, so = os.path.join(tmp, "walk_phases.cu"), os.path.join(tmp, "libwalk_phases.so")
        with open(cu, "w") as fh:
            fh.write(src)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build.nvcc_path(), *flags, "-I", csrc, "-o", so, cu], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        lib.gru_walk.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.gru_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        n, t, reps = 304, 20, 10
        for h, (rows, cluster) in SHAPES:
            xi = torch.randn(n, t, 3 * h, device="cuda", generator=gen) * 0.5
            wh = (torch.rand(h, 3 * h, device="cuda", generator=gen) * 2 - 1) / h ** 0.5
            bh = (torch.rand(3 * h, device="cuda", generator=gen) * 2 - 1) / h ** 0.5
            dh = torch.randn(n, h, device="cuda", generator=gen) * 0.1
            _, hseq, gseq = gru.gru_fwd_residuals(xi, wh, bh)
            dxi, dgn = torch.empty_like(xi), torch.empty_like(hseq)

            def call():
                err = lib.gru_walk(xi.data_ptr(), wh.data_ptr(), hseq.data_ptr(),
                                   gseq.data_ptr(), dh.data_ptr(), dxi.data_ptr(),
                                   dgn.data_ptr(), n, t, h, rows, cluster, 1,
                                   torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"gru_walk at H={h}, {rows}x{cluster}: cudaError {err}")

            call()
            torch.cuda.synchronize()
            lib.gru_prof(None, 1)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            cycles = (ctypes.c_ulonglong * 8)()
            lib.gru_prof(ctypes.addressof(cycles), 0)
            per_step = {p: cycles[i] / reps / (t - 1) for i, p in enumerate(PHASES)}
            want = gru.gru_walk_plain(xi, wh, hseq, gseq, dh)
            out["shapes"][f"H{h}_{rows}x{cluster}"] = {
                "ms": start.elapsed_time(end) / reps, "cycles_per_step": per_step,
                "step_cycles": sum(per_step.values()),
                "max_abs_err": max(float((dxi - want[0]).abs().max()),
                                   float((dgn - want[1]).abs().max()))}
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
