"""Hidden sizes above 64 on the port, against the JAX package, on the CPU.

The CUDA kernels take every H <= 256 (`ops.kernels.MAX_HIDDEN`); on the CPU
the wrappers run their plain versions, which take any H. These tests hold
those plain versions at H in {65, 96, 128} against the Pallas kernels in
interpret mode (K1; K2 at T <= 24 and K3's segmented kernel at T = 30; K4
and K5 with a NaN day and a +inf day), the port's `Trainer` at H = 96
against the JAX `Trainer`, `grid_sweep` over a hidden-size bucket {8, 72}
against the JAX `grid_sweep`, the launch rule and the refusal at the new
maximum, K1's and the walk's own launch rules above H = 64 and their
persistent clusters' tile assignment, the attention kernels' wide rule,
the kernel names by which chip_smoke.py books the GRU and attention
kernels' traced launches, the CLI at H = 96,
and an exported program at H = 96 (its registered ops traced through
their fake functions). Inputs come from numpy.

Tolerances are the repo's oracle ones: f32 at rtol 1e-5 / atol 1e-6; the
GRU's weight gradients, summed over every row and step, at rtol 2e-5 /
atol 5e-6; per-epoch losses at rtol 2e-5 (`tests/test_torch_train.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import panel_to_frame as jpanel_to_frame
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.eval.sweep import grid_sweep as jgrid_sweep
from factorvae_tpu.ops.pallas.attention import multihead_cross_section_attention
from factorvae_tpu.ops.pallas.attention_grad import fused_attention
from factorvae_tpu.ops.pallas.gru import _SEG_MAX, gru_scan
from factorvae_tpu.train.fleet import FleetTrainer as JFleetTrainer
from factorvae_tpu.train.fleet import unstack_state as junstack
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import cli
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval import sweep
from factorvae_tpu_torch.ops.kernels import MAX_HIDDEN, hidden_refusal
from factorvae_tpu_torch.ops.kernels import gru as gru_module
from factorvae_tpu_torch.ops.kernels.attention import (
    GROUPS,
    MAX_GROUP_ROWS,
    attention,
    attention_fwd,
    wide_cluster,
    wide_launch_group,
)
from factorvae_tpu_torch.ops.kernels.gru import (
    FWD_ROWS,
    WALK_ROWS,
    WIDE_UNITS,
    fwd_clusters,
    fwd_launch_shape,
    fwd_resident,
    fwd_smem_bytes,
    fwd_tiles,
    gru,
    gru_fwd,
    launch_shape,
    smem_bytes,
    walk_launch_shape,
    walk_resident,
    walk_shapes,
    walk_smem_bytes,
)
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils.logging import MetricsLogger

TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=2e-5, atol=5e-6)
LOSS_RTOL = 2e-5
WIDE = (65, 96, 128)
H100_SMS = 132


def _np(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- K1, K2, K3 -------------------------------------------------------------


@pytest.mark.parametrize("t", [8, _SEG_MAX + 6], ids=["K2", "K3"])
@pytest.mark.parametrize("h", WIDE)
def test_gru_plain_matches_pallas_at_wide_h(h, t):
    """K1's plain version and the differentiable `gru` (the residual variant
    then the walk and dWh) against the Pallas `gru_scan` and its VJP (K2's
    kernel at T = 8, K3's segmented kernel at T = 30)."""
    rng = np.random.default_rng(h + t)
    n = 5
    xi = (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bh = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    dh = rng.normal(size=(n, h)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (xi, wh, bh)]
    want_h = np.asarray(gru_scan(*jargs))
    want = jax.grad(lambda *a: jnp.sum(gru_scan(*a) * jnp.asarray(dh)),
                    argnums=(0, 1, 2))(*jargs)
    tx, tw, tb, tdh = _np(xi, wh, bh, dh)
    np.testing.assert_allclose(gru_fwd(tx, tw, tb).numpy(), want_h, **TOL)
    leaves = [a.clone().requires_grad_() for a in (tx, tw, tb)]
    grads = torch.autograd.grad(gru(*leaves), leaves, tdh)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(grads[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SUM_TOL)


# ---- K4, K5 -----------------------------------------------------------------


def _attention_args(rng, b, n, k, h):
    latent = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    q = rng.normal(size=(k, h)).astype(np.float32)
    wk, bk, wv, bv = ((rng.normal(size=s) / np.sqrt(h)).astype(np.float32)
                      for s in ((k, h, h), (k, h), (k, h, h), (k, h)))
    latent[1, 3, 0] = np.nan                  # day 1: the guard zeroes it
    latent[2, 4, 1] = np.inf                  # day 2: +inf in a valid row
    mask[1, 3] = mask[2, 4] = True
    return latent, mask, q, wk, bk, wv, bv


@pytest.mark.parametrize("h", WIDE)
def test_attention_plain_matches_pallas_at_wide_h(h):
    """K4's and K5's plain versions, through the differentiable `attention`,
    against the Pallas forward kernel and the VJP of `fused_attention`
    (its backward kernel), day by day; the poisoned days give zero."""
    rng = np.random.default_rng(h)
    b, n, k = 3, 10, 4
    latent, mask, q, wk, bk, wv, bv = _attention_args(rng, b, n, k, h)
    dctx = rng.normal(size=(b, k, h)).astype(np.float32)
    want_ctx, want_grads = [], []
    for d in range(b):
        jw = [jnp.asarray(a) for a in (q, wk, bk, wv, bv)]
        want_ctx.append(np.asarray(multihead_cross_section_attention(
            jnp.asarray(latent[d]), jnp.asarray(mask[d]), *jw)))

        def f(lat, *w, d=d):
            return fused_attention(lat, jnp.asarray(mask[d], jnp.float32), *w, None)

        _, vjp = jax.vjp(f, jnp.asarray(latent[d]), *jw)
        want_grads.append([np.asarray(g) for g in vjp(jnp.asarray(dctx[d]))])
    t = _np(latent, mask, q, wk, bk, wv, bv, dctx)
    np.testing.assert_allclose(attention_fwd(*t[:7]).numpy(), np.stack(want_ctx), **TOL)
    leaves = [a.clone().requires_grad_() for a in (t[0], *t[2:7])]
    out = attention(leaves[0], t[1], *leaves[1:])
    assert (out[1] == 0).all() and (out[2] == 0).all() and (out[0] != 0).any()
    grads = torch.autograd.grad(out, leaves, t[7])
    # day 0 is the clean one: the Pallas kernel zeroes a guarded head by a
    # multiply, so its poisoned days leak NaN into the weight gradients,
    # where the port selects and adds exactly zero
    np.testing.assert_allclose(grads[0].numpy()[0], want_grads[0][0], **TOL)
    assert (grads[0].numpy()[1:] == 0).all()
    for i, g in enumerate(grads[1:], start=1):
        np.testing.assert_allclose(g.numpy(), want_grads[0][i], **TOL)


# ---- the launch rule and the refusal -----------------------------------------


@pytest.mark.parametrize("h", [65, 96, 128, 129, 200, 256])
@pytest.mark.parametrize("n,lanes", [(1, 1), (304, 1), (304, 4), (2432, 1), (9728, 1)])
def test_launch_shape_rule_at_wide_h(n, lanes, h):
    """Above H = 64 the walk's own rule: a tile of WALK_ROWS over a cluster
    whose CTAs own at most WIDE_UNITS units (4 CTAs up to H = 128, 8 above),
    a shape `walk_shapes` lists, its wide layout within an H100's block;
    the shared rule of H <= 64 refuses the width."""
    rows, cluster = walk_launch_shape(n, h, H100_SMS, lanes)
    assert rows in WALK_ROWS and cluster == (4 if h <= 128 else 8)
    assert -(-h // cluster) <= WIDE_UNITS and (rows, cluster) in walk_shapes(h)
    assert walk_smem_bytes(h, rows, cluster) <= gru_module.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="walk_launch_shape"):
        launch_shape(n, h, H100_SMS, lanes)


def test_launch_shape_rule_keeps_the_tuned_shapes_up_to_h64():
    """The <= 64 class picks what it did before clusters of 8 existed, and
    ends there: above it each kernel has its own rule."""
    assert launch_shape(304, 64, H100_SMS) == (8, 4)
    assert launch_shape(9728, 64, H100_SMS) == (16, 1)
    assert launch_shape(5, 64, H100_SMS) == (8, 4)
    with pytest.raises(ValueError):
        smem_bytes(65, 16, 4)
    assert max(c for h in range(1, 65) for n in (1, 40, 304)
               for _, c in [launch_shape(n, h, H100_SMS)]) == 4


def test_walk_rule_is_launch_shape_up_to_h64():
    """Up to H = 64 the walk's rule returns the shapes the kernels were
    tuned under (`launch_shape`, K1's too), and `walk_shapes` lists every
    shape that rule can pick."""
    for h in range(1, 65):
        shapes = walk_shapes(h)
        for n in (1, 5, 40, 304, 1001, 9728):
            for lanes in (1, 3, 8):
                got = walk_launch_shape(n, h, H100_SMS, lanes)
                assert got == launch_shape(n, h, H100_SMS, lanes), (h, n, lanes)
                assert got in shapes


WALK_WIDE = (65, 96, 128, 200, 256)


@pytest.mark.parametrize("h", WALK_WIDE)
def test_walk_rule_fits_a_block_at_wide_h(h):
    """Above H = 64, for 1 to 40 lanes and N from one row to a 32-day chunk,
    the walk's rule picks a shape whose wide layout (the Python copy of
    `walk_wide_smem_floats`) fits 227 KB, with at least one cluster
    resident; at H = 256 that admits 32-row tiles (the layout of the walk
    up to H = 64, taken there, fitted only 8-row ones)."""
    for lanes in range(1, 41):
        for n in (1, 304, 2432, 9728):
            rows, c = walk_launch_shape(n, h, H100_SMS, lanes)
            assert walk_smem_bytes(h, rows, c) <= gru_module.SMEM_PER_BLOCK == 232_448
            assert walk_resident(h, rows, c, H100_SMS) >= 1
    assert (32, 8) in walk_shapes(256) and walk_smem_bytes(256, 32, 8) == 166_400


@pytest.mark.parametrize("lanes", [1, 2, 40])
@pytest.mark.parametrize("n", [1, 5, 304, 2432, 9728])
@pytest.mark.parametrize("h", [96, 256])
def test_walk_persistent_clusters_run_every_tile_once(h, n, lanes):
    """The wide walk's persistent loop (`wide_tile` over `fwd_clusters` of
    the resident clusters) at the rule's shape: every row of every lane in
    exactly one tile of one cluster of that lane."""
    rows, c = walk_launch_shape(n, h, H100_SMS, lanes)
    tiles = -(-n // rows)
    per_lane = fwd_clusters(tiles, lanes, walk_resident(h, rows, c, H100_SMS))
    owner = {}
    for lane in range(lanes):
        for cl in range(per_lane):
            for tile in fwd_tiles(cl, per_lane, tiles):
                for r in range(tile * rows, min(n, (tile + 1) * rows)):
                    assert (lane, r) not in owner
                    owner[(lane, r)] = cl
    assert len(owner) == lanes * n


FWD_WIDE = (65, 96, 128, 192, 256)


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 304, 9728])
@pytest.mark.parametrize("h", FWD_WIDE)
def test_forward_rule_at_wide_h(h, n, lanes):
    """K1's own rule above H = 64: a tile of FWD_ROWS over a cluster whose
    CTAs own at most WIDE_UNITS units, its forward layout within an H100's
    block; the persistent clusters of each lane run every row of that lane
    once, and no tile takes rows of two lanes."""
    rows, c = fwd_launch_shape(n, h, H100_SMS, lanes)
    assert rows in FWD_ROWS and c in gru_module.CLUSTERS
    assert -(-h // c) <= WIDE_UNITS and c <= h
    assert fwd_smem_bytes(h, rows, c) <= gru_module.SMEM_PER_BLOCK
    tiles = -(-n // rows)
    per_lane = fwd_clusters(tiles, lanes, fwd_resident(h, rows, c, H100_SMS))
    assert 1 <= per_lane <= tiles
    owner = {}
    for lane in range(lanes):
        for cl in range(per_lane):
            for tile in fwd_tiles(cl, per_lane, tiles):
                first, stop = tile * rows, min(n, (tile + 1) * rows)
                assert 0 <= first < stop <= n          # inside its lane's rows
                for r in range(lane * n + first, lane * n + stop):
                    assert r not in owner
                    owner[r] = (lane, tile)
    assert sorted(owner) == list(range(lanes * n))


def test_forward_rule_is_launch_shape_up_to_h64():
    """Up to H = 64 the forward's rule returns the shapes the kernels were
    tuned under, the walk's (`launch_shape`)."""
    for h in range(1, 65):
        for n in (1, 5, 40, 304, 1001, 9728):
            for lanes in (1, 3, 8):
                assert (fwd_launch_shape(n, h, H100_SMS, lanes)
                        == launch_shape(n, h, H100_SMS, lanes)), (h, n, lanes)


def test_forward_rule_weighs_the_resident_clusters_it_is_given():
    """Above H = 64 the rule asks `resident` for each tile of FWD_ROWS at
    its cluster (on the card the library's count, `_fwd_shape`), and
    without it counts the CTAs an H100's shared memory holds: 2 a SM of 64
    rows at H = 128 (66 clusters of 4), 1 at H = 256 (16 of 8). Few
    resident clusters favour wide tiles (fewer rounds), many the narrowest
    (every tile at once, the cheapest step)."""
    assert fwd_resident(128, 64, 4, H100_SMS) == 66
    assert fwd_resident(256, 64, 8, H100_SMS) == 16
    asked = []

    def one(rows, c):
        asked.append((rows, c))
        return 1

    assert fwd_launch_shape(304, 128, H100_SMS, 1, resident=one) == (64, 4)
    assert sorted(asked) == sorted((rows, 4) for rows in FWD_ROWS)
    assert fwd_launch_shape(304, 128, H100_SMS, 1, resident=lambda r, c: 10 ** 6) == (16, 4)
    assert fwd_launch_shape(304, 128, H100_SMS, 2, resident=lambda r, c: 0) == (64, 4)
    assert (fwd_launch_shape(9728, 256, H100_SMS)
            == fwd_launch_shape(9728, 256, H100_SMS, resident=lambda r, c: fwd_resident(
                256, r, c, H100_SMS)))


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::gru_fwd_kernel<16, true, false>(float const*)",
     "gru_fwd_residuals"),
    ("void (anonymous namespace)::gru_fwd_kernel<8, false, true>(float const*)", "gru_fwd"),
    ("void (anonymous namespace)::gru_fwd_wide_kernel<64, 4, true>(float const*)",
     "gru_fwd_residuals"),
    ("void (anonymous namespace)::gru_fwd_wide_kernel<16, 8, false>(float const*)",
     "gru_fwd")])
def test_trace_patterns_name_both_forward_kernels(name, wrapper):
    """chip_smoke.py books a traced K1 launch to its wrapper by the kernel's
    demangled name: the residual flag is the second template argument of
    the kernel up to H = 64 and the last of the wide one, and each name
    matches its wrapper's pattern and no other wrapper's."""
    import re

    from chip_smoke import KERNEL_FUNCTIONS

    hits = [w for w, patterns in KERNEL_FUNCTIONS.items()
            if any(re.search(p, name) for p in patterns)]
    assert hits == [wrapper]


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::gru_walk_kernel<8, true>(float const*)", "gru_bwd"),
    ("void (anonymous namespace)::gru_walk_wide_kernel<32, 2>(float const*)", "gru_bwd"),
    ("void (anonymous namespace)::gru_walk_wide_kernel<16, 1>(float const*)", "gru_bwd"),
    ("(anonymous namespace)::gru_dwh_kernel(float const*, float const*)", "gru_dwh"),
    ("(anonymous namespace)::gru_dwh_wide_kernel(float const*, float const*)", "gru_dwh"),
    ("(anonymous namespace)::gru_dwh_reduce_kernel(float const*, int)", "gru_dwh")])
def test_trace_patterns_name_the_backward_kernels(name, wrapper):
    """chip_smoke.py books a traced walk or dWh launch to its wrapper by the
    kernel's demangled name, up to H = 64 and above it (the wide walk, the
    tensor-core dWh): each name matches its wrapper's patterns and no other
    wrapper's, and the first pattern, which counts launches, matches the
    walk and dWh kernels but not dWh's reduce."""
    import re

    from chip_smoke import KERNEL_FUNCTIONS

    hits = [w for w, patterns in KERNEL_FUNCTIONS.items()
            if any(re.search(p, name) for p in patterns)]
    assert hits == [wrapper]
    first = bool(re.search(KERNEL_FUNCTIONS[wrapper][0], name))
    assert first == ("reduce" not in name)


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::attention_fwd_kernel<2>(float const*)", "attention_fwd"),
    ("void (anonymous namespace)::attention_fwd_wide_kernel<8>(float const*)", "attention_fwd"),
    ("void (anonymous namespace)::attention_fwd_prep_kernel<4>(float const*)", "attention_fwd"),
    ("(anonymous namespace)::attention_fwd_ctx_kernel(float const*, int)", "attention_fwd"),
    ("void (anonymous namespace)::attention_bwd_head_kernel<2>(float const*)", "attention_bwd"),
    ("void (anonymous namespace)::attention_bwd_head_wide_kernel<8>(float const*)",
     "attention_bwd"),
    ("void (anonymous namespace)::attention_bwd_prep_kernel<8>(float const*)", "attention_bwd"),
    ("(anonymous namespace)::attention_bwd_weights_kernel(float const*, int)", "attention_bwd"),
    ("void (anonymous namespace)::attention_bwd_latent_kernel<64>(float const*)",
     "attention_bwd"),
    ("(anonymous namespace)::attention_bwd_latent_wide_kernel(float const*, int)",
     "attention_bwd")])
def test_trace_patterns_name_the_attention_kernels(name, wrapper):
    """chip_smoke.py books a traced K4 or K5 launch to its wrapper by the
    kernel's demangled name, up to H = 64 and above it (the prep kernels,
    the wide day kernels, K4's context kernel, K5's wide latent pass): each
    name matches its wrapper's patterns and no other wrapper's, and the
    first pattern, which counts launches, matches exactly the one kernel
    each launch runs once (the day kernel), not the others."""
    import re

    from chip_smoke import KERNEL_FUNCTIONS

    hits = [w for w, patterns in KERNEL_FUNCTIONS.items()
            if any(re.search(p, name) for p in patterns)]
    assert hits == [wrapper]
    first = bool(re.search(KERNEL_FUNCTIONS[wrapper][0], name))
    assert first == any(day in name for day in ("attention_fwd_kernel",
                                                "attention_fwd_wide_kernel",
                                                "attention_bwd_head_kernel",
                                                "attention_bwd_head_wide_kernel"))


@pytest.mark.parametrize("h", [65, 96, 128, 129, 200, 256])
@pytest.mark.parametrize("b", [1, 2, 8, 32])
def test_wide_attention_rule(b, h):
    """Above H = 64 the attention kernels' own rule: clusters of 2 CTAs up
    to H = 128 and 4 above (a function of H alone), and the largest group of
    GROUPS whose grid has a CTA for every SM with G * N <= MAX_GROUP_ROWS,
    else one head a cluster."""
    n, k = 304, 96
    ctas = wide_cluster(h)
    assert ctas == (2 if h <= 128 else 4)
    g = wide_launch_group(b, k, n, h, H100_SMS)

    def fills(x):
        return b * -(-k // x) * ctas >= H100_SMS

    assert g in GROUPS and g * n <= MAX_GROUP_ROWS
    assert g == 1 or fills(g)
    assert not any(fills(x) for x in GROUPS if x > g and x * n <= MAX_GROUP_ROWS)


def test_wide_attention_rule_at_the_flagship_shapes():
    """At one training day 2 heads a cluster at H = 256 and 1 at H = 128,
    192 CTAs each (more than the 96 heads), groups of 8 at 8 days and at a
    32-day serving chunk; a pure function of (days, K, N, H, SMs)."""
    assert [wide_launch_group(b, 96, 304, 256, H100_SMS) for b in (1, 8, 32)] == [2, 8, 8]
    assert [wide_launch_group(b, 96, 304, 128, H100_SMS) for b in (1, 8, 32)] == [1, 8, 8]
    for h in (128, 256):
        g = wide_launch_group(1, 96, 304, h, H100_SMS)
        assert -(-96 // g) * wide_cluster(h) > 96
    assert wide_launch_group(32, 96, 70, 256, 16) == 16
    assert wide_launch_group(1, 4, 5200, 256, H100_SMS) == 1


@pytest.mark.parametrize("tiles,resident,lanes", [
    (1, 16, 1), (5, 16, 1), (15, 16, 1), (16, 16, 1), (17, 16, 1), (152, 16, 1),
    (153, 16, 1), (19, 33, 3), (304, 16, 40), (7, 1, 1)])
def test_persistent_clusters_run_every_tile_once(tiles, resident, lanes):
    """The persistent loop's assignment (`fwd_tiles`, mirrored by
    `wide_tile` in csrc/gru_fwd.cu) at tile counts below, equal to and above
    the clusters: every tile of a lane runs once, the clusters' rounds
    differ by at most one, and with a ragged last tile (N = tiles * 64 - 3)
    every row lies in exactly one tile."""
    per = fwd_clusters(tiles, lanes, resident)
    assert per == min(tiles, max(1, resident // lanes))
    ran = [t for cl in range(per) for t in fwd_tiles(cl, per, tiles)]
    assert sorted(ran) == list(range(tiles))
    rounds = [len(fwd_tiles(cl, per, tiles)) for cl in range(per)]
    assert max(rounds) == -(-tiles // per) and max(rounds) - min(rounds) <= 1
    n, rows = tiles * 64 - 3, 64
    covered = [r for t in ran for r in range(t * rows, min(n, (t + 1) * rows))]
    assert sorted(covered) == list(range(n))


def test_refusal_moves_to_the_new_maximum():
    assert MAX_HIDDEN == 256
    for h in (64, 65, 96, 128, 256):
        assert hidden_refusal(h, "cuda") is None
    refused = hidden_refusal(257, "cuda")
    assert refused is not None and "Limits" in refused and "256" in refused
    assert hidden_refusal(1024, "cpu") is None


# ---- the trainer, the sweep and the CLI ---------------------------------------

C, T, K, M = 6, 5, 4, 10


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


def _jcfg(tp, save_dir, hidden, epochs=2) -> jconfig.Config:
    d = [str(x)[:10] for x in tp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=hidden, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=3, checkpoint_every=0,
                                  recover_after=0, save_dir=str(save_dir)))


def _port(jcfg: jconfig.Config, save_dir) -> tconfig.Config:
    cfg = tconfig.Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              save_dir=str(save_dir)))


def test_trainer_at_h96_tracks_the_jax_trainer(panels, tmp_path):
    """Two epochs at H = 96 from the same weights: per-epoch train and val
    losses within rtol 2e-5, the same steps."""
    jp, tp = panels
    jcfg = _jcfg(tp, tmp_path / "jax", 96)
    jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
    jstate = jtr.init_state()
    weights = flax_to_torch(jstate.params)
    _, jout = jtr.fit(state=jstate)
    tr = Trainer(_port(jcfg, tmp_path / "port"), PanelDataset(tp, seq_len=T, device="cpu"),
                 device="cpu")
    state = tr.init_state()
    state.model.load_state_dict(weights)
    _, out = tr.fit(state=state)
    got = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
    want = [(r["train_loss"], r["val_loss"]) for r in jout["history"]]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert [r["step"] for r in out["history"]] == [r["step"] for r in jout["history"]]


def test_grid_sweep_over_hidden_sizes_matches_jax(panels, tmp_path, monkeypatch):
    """`grid_sweep` over hidden_size {8, 72} x lr {1e-3, 3e-3}: two shape
    buckets, each a 2-lane hyper-fleet, every lane from the JAX lane's
    initial weights; the frame (best val, Rank-IC) and the per-epoch lane
    losses equal the JAX sweep's."""
    jp, tp = panels
    d = [str(x)[:10] for x in tp.dates]
    start, end = d[5], d[35]
    points = [{"hidden_size": h, "lr": lr} for h in (8, 72) for lr in (1e-3, 3e-3)]
    jcfg = _jcfg(tp, tmp_path / "jax", 8, epochs=1)
    jds = JPanelDataset(jp, seq_len=T)
    jlog = str(tmp_path / "jax.jsonl")
    want = jgrid_sweep(jcfg, jds, points, score_start=start, score_end=end,
                       logger=JMetricsLogger(jsonl_path=jlog, echo=False))

    inits = {}

    def jax_init(hidden, seed):
        if (hidden, seed) not in inits:
            c = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                                    hidden_size=hidden))
            ft = JFleetTrainer(c, jds, seeds=[seed], logger=JMetricsLogger(echo=False))
            inits[hidden, seed] = flax_to_torch(junstack(ft.init_fleet_state().params, 0))
        return inits[hidden, seed]

    init = FleetTrainer.init_lane_state

    def patched(self, i):
        st = init(self, i)
        st.model.load_state_dict(jax_init(self.model_cfg.hidden_size, self.seeds[i]))
        return st

    monkeypatch.setattr(FleetTrainer, "init_lane_state", patched)
    log = str(tmp_path / "port.jsonl")
    logger = MetricsLogger(jsonl_path=log, echo=False)
    got = sweep.grid_sweep(_port(jcfg, tmp_path / "port"),
                           PanelDataset(tp, seq_len=T, device="cpu"), points,
                           score_start=start, score_end=end, logger=logger, device="cpu")
    logger.finish()
    assert list(got.index) == list(want.index)
    assert got.attrs["summary"]["best_label"] == want.attrs["summary"]["best_label"]
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[["rank_ic", "rank_ic_ir"]], want[["rank_ic", "rank_ic_ir"]],
                               rtol=1e-4, atol=1e-5)

    def epochs(path):
        with open(path) as fh:
            return [e for e in map(json.loads, fh) if e["event"] == "fleet_epoch"]

    got_e, want_e = epochs(log), epochs(jlog)
    assert len(got_e) == len(want_e) == 2              # one epoch of each bucket
    for g, w in zip(got_e, want_e):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)


def test_cli_at_h96_on_the_cpu(panels, tmp_path):
    """The experiment CLI takes --hidden_size 96 (and would on --device
    cuda): it trains, scores and writes the CSV and its Rank-IC."""
    jp, tp = panels
    path = str(tmp_path / "panel.pkl")
    jpanel_to_frame(jp).to_pickle(path)
    d = [str(x.date()) for x in jp.dates]
    argv = ["--dataset", path, "--num_latent", str(C), "--hidden_size", "96",
            "--num_factor", str(K), "--num_portfolio", str(M), "--seq_len", str(T),
            "--start_time", d[0], "--fit_end_time", d[24], "--val_start_time", d[25],
            "--val_end_time", d[35], "--score_start", d[10], "--score_end", d[35],
            "--num_epochs", "1", "--seed", "3", "--run_name", "wide",
            "--save_dir", str(tmp_path / "models"), "--score_dir", str(tmp_path / "scores"),
            "--metrics_jsonl", str(tmp_path / "run.jsonl"), "--device", "cpu"]
    for device in ("cuda", "cpu"):
        args = cli.build_parser().parse_args(argv[:-2] + ["--device", device])
        assert cli._hidden_size(args) == 96 and hidden_refusal(96, device) is None
    assert cli.main(argv) == 0
    with open(tmp_path / "run.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    assert [e["event"] for e in events].count("epoch") == 1
    scores = [e for e in events if e["event"] == "scores"]
    assert scores and np.isfinite(scores[0]["rank_ic"])
    (csv_name,) = os.listdir(tmp_path / "scores")
    with open(tmp_path / "scores" / csv_name) as fh:
        assert fh.readline().strip() == "datetime,instrument,score,LABEL0"
        assert len(fh.readlines()) > 0


def test_exported_program_at_h96_scores_as_the_model(panels):
    """`eval/export_aot.py` traces the registered ops (`gru_fwd`,
    `attention_fwd`) at H = 96 through their fake functions, for the cuda
    and the cpu platform; the program scores a day as `predict_panel` does."""
    from factorvae_tpu_torch.eval.export_aot import export_prediction, load_exported
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model

    _, tp = panels
    cfg = tconfig.Config(model=tconfig.ModelConfig(num_features=C, hidden_size=96,
                                                   num_factors=K, num_portfolios=M,
                                                   seq_len=T))
    ds = PanelDataset(tp, seq_len=T, device="cpu")
    model = load_model(cfg, device="cpu")
    cuda_blob = export_prediction(model, cfg, ds.n_max, platform="cuda")
    art = load_exported(export_prediction(model, cfg, ds.n_max, platform="cpu"))
    ops = {str(n.target) for n in art.program.graph.nodes if n.op == "call_function"}
    assert {"factorvae_tpu_torch.gru_fwd.default",
            "factorvae_tpu_torch.attention_fwd.default"} <= ops
    day = 20
    x, _, mask = ds.gather(torch.tensor([day]))
    got = art.call(x, mask)
    want = predict_panel(model, cfg, ds, np.array([day]), stochastic=False)
    np.testing.assert_allclose(got.nan_to_num().numpy(), np.nan_to_num(want), **TOL)
    assert torch.equal(load_exported(cuda_blob, device="cpu").call(x, mask).nan_to_num(),
                       got.nan_to_num())
