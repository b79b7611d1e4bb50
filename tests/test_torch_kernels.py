"""The port's GRU (K1 forward, K2/K3 backward) and K-head attention (K4
forward, K5 backward) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tier-1
parity tests run them. Inputs come from numpy. Tolerance: f32 with
rtol=1e-5, atol=1e-6, the repo's torch-oracle tolerance; the GRU's weight
gradients, which sum over every row and step, at rtol=2e-5, atol=5e-6:
tightened from the JAX package's own kernel-vs-scan limit (rtol=2e-4,
atol=1e-5, `tests/test_pallas_gru.py`) after readings of at most 1.7e-6
absolute at these shapes. The
CUDA kernels themselves are held against the plain versions on the card by
`tests/test_torch_cuda.py` and by chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu.ops.pallas.attention import multihead_cross_section_attention
from factorvae_tpu.ops.pallas.attention_grad import fused_attention
from factorvae_tpu.ops.pallas.gru import _SEG_MAX, _segment_len, gru_scan
from factorvae_tpu_torch.ops.kernels.attention import (
    attention,
    attention_bwd,
    attention_bwd_plain,
    attention_fwd,
    attention_fwd_plain,
    launch_group,
)
from factorvae_tpu_torch.ops.kernels import gru as gru_module
from factorvae_tpu_torch.ops.masked import masked_softmax as torch_masked_softmax
from factorvae_tpu_torch.ops.kernels.gru import (
    gru,
    gru_bwd,
    gru_bwd_plain,
    gru_dwh,
    gru_dwh_plain,
    gru_fwd,
    gru_fwd_plain,
    gru_fwd_residuals,
    gru_walk_plain,
    launch_shape,
)

TOL = dict(rtol=1e-5, atol=1e-6)
H100_SMS = 132           # streaming multiprocessors of an H100 SXM
SUM_TOL = dict(rtol=2e-5, atol=5e-6)


def _gru_args(rng, n, t, h):
    xi = (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(h, 3 * h)) * 0.3).astype(np.float32)
    bh = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    return xi, wh, bh


class TestGruForward:
    @pytest.mark.parametrize("n,t,h", [(6, 8, 4), (13, 6, 8), (5, 20, 12)])
    def test_plain_matches_pallas_gru_scan(self, rng, n, t, h):
        xi, wh, bh = _gru_args(rng, n, t, h)
        want = np.asarray(gru_scan(jnp.asarray(xi), jnp.asarray(wh), jnp.asarray(bh)))
        got = gru_fwd_plain(*map(torch.from_numpy, (xi, wh, bh))).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_wrapper_on_cpu_runs_the_plain_version(self, rng):
        xi, wh, bh = map(torch.from_numpy, _gru_args(rng, 7, 5, 4))
        before = gru_fwd.launches
        out = gru_fwd(xi, wh, bh)
        assert torch.equal(out, gru_fwd_plain(xi, wh, bh))
        assert gru_fwd.launches == before       # counts kernel launches only

    def test_wrapper_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            gru_fwd(torch.zeros(2, 3, 7), torch.zeros(2, 6), torch.zeros(6))
        with pytest.raises(ValueError):
            gru_fwd(torch.zeros(2, 3, 6), torch.zeros(3, 6), torch.zeros(6))


def _jax_gru_grads(xi, wh, bh, dh):
    """jax.grad of the Pallas gru_scan (its custom VJP: `_bwd_full` for
    T <= 24, `_bwd_segmented` above), as numpy."""
    f = lambda *a: jnp.sum(gru_scan(*a) * jnp.asarray(dh))  # noqa: E731
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(xi), jnp.asarray(wh), jnp.asarray(bh))]


def _check_gru_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)           # dxi
    for g, w in zip(got[1:], want[1:]):                          # dWh, db
        np.testing.assert_allclose(g, w, **SUM_TOL)


class TestGruBackward:
    # K2's shapes (T <= 24), then K3's (T > 24: the segmented TPU kernel,
    # the shapes of tests/test_pallas_gru.py)
    SHAPES = [(6, 8, 4), (13, 6, 8), (5, 20, 12), (72, 60, 8), (10, 50, 4), (6, 58, 4)]

    @pytest.mark.parametrize("n,t,h", SHAPES)
    def test_plain_and_function_backward_match_pallas(self, rng, n, t, h):
        assert (t > _SEG_MAX) == (_segment_len(t) < t)
        xi, wh, bh = _gru_args(rng, n, t, h)
        dh = rng.normal(size=(n, h)).astype(np.float32)
        want = _jax_gru_grads(xi, wh, bh, dh)
        tx, tw, tb, tdh = map(torch.from_numpy, (xi, wh, bh, dh))
        _check_gru_grads([g.numpy() for g in gru_bwd_plain(tx, tw, tb, tdh)], want)
        leaves = [a.clone().requires_grad_() for a in (tx, tw, tb)]
        grads = torch.autograd.grad(gru(*leaves), leaves, tdh)
        _check_gru_grads([g.numpy() for g in grads], want)

    def test_wrapper_on_cpu_runs_the_plain_version(self, rng):
        xi, wh, bh = map(torch.from_numpy, _gru_args(rng, 7, 5, 4))
        dh = torch.randn(7, 4)
        before = gru_bwd.launches
        for a, b in zip(gru_bwd(xi, wh, bh, dh), gru_bwd_plain(xi, wh, bh, dh)):
            assert torch.equal(a, b)
        assert gru_bwd.launches == before
        with pytest.raises(ValueError, match="dh"):
            gru_bwd(xi, wh, bh, torch.zeros(7, 5))


def unit_ranges(h_dim, cluster):
    """The hidden units [u0, u1) of each CTA of a cluster, as the kernels
    split them (`csrc/gru_common.cuh:unit_begin`)."""
    return [(r * h_dim // cluster, (r + 1) * h_dim // cluster) for r in range(cluster)]


def _numpy_recurrence(xi, wh, bh):
    """The recurrence step by step in float64 numpy: (h, h before each step,
    g = h . Wh + b of each step)."""
    n, t_len, h3 = xi.shape
    hd = h3 // 3
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    h = np.zeros((n, hd))
    hseq, gseq = np.zeros((n, t_len, hd)), np.zeros((n, t_len, h3))
    for t in range(t_len):
        g = h @ wh.astype(np.float64) + bh
        hseq[:, t], gseq[:, t] = h, g
        x = xi[:, t].astype(np.float64)
        r = sig(x[:, :hd] + g[:, :hd])
        z = sig(x[:, hd:2 * hd] + g[:, hd:2 * hd])
        nn_ = np.tanh(x[:, 2 * hd:] + r * g[:, 2 * hd:])
        h = (1 - z) * nn_ + z * h
    return h, hseq, gseq


class TestGruResiduals:
    """The residual form of K1 and the walk from its residuals (K2/K3), the
    dWh/db reduction, and the launch-shape rule of both kernels."""

    @pytest.mark.parametrize("n,t,h", TestGruBackward.SHAPES)
    def test_plain_residuals_match_a_numpy_recurrence(self, rng, n, t, h):
        xi, wh, bh = _gru_args(rng, n, t, h)
        got = gru_fwd_plain(*map(torch.from_numpy, (xi, wh, bh)), keep_residuals=True)
        want = _numpy_recurrence(xi, wh, bh)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        assert torch.equal(got[0], gru_fwd_plain(*map(torch.from_numpy, (xi, wh, bh))))

    @pytest.mark.parametrize("n,t,h", TestGruBackward.SHAPES)
    def test_plain_bwd_from_residuals_matches_recompute_and_pallas(self, rng, n, t, h):
        xi, wh, bh = _gru_args(rng, n, t, h)
        dh = rng.normal(size=(n, h)).astype(np.float32)
        tx, tw, tb, tdh = map(torch.from_numpy, (xi, wh, bh, dh))
        _, hseq, gseq = gru_fwd_plain(tx, tw, tb, keep_residuals=True)
        got = gru_bwd_plain(tx, tw, tb, tdh, residuals=(hseq, gseq))
        for a, b in zip(got, gru_bwd_plain(tx, tw, tb, tdh)):
            assert torch.equal(a, b)
        _check_gru_grads([g.numpy() for g in got], _jax_gru_grads(xi, wh, bh, dh))

    @pytest.mark.parametrize("n,t,h", TestGruBackward.SHAPES)
    def test_plain_dwh_matches_einsum(self, rng, n, t, h):
        # what the kernel is given: the residuals and the walk's outputs of a
        # recurrence (the inputs of the Pallas-VJP test above)
        xi, wh, bh = map(torch.from_numpy, _gru_args(rng, n, t, h))
        _, hs, gs = gru_fwd_plain(xi, wh, bh, keep_residuals=True)
        dx, dn = gru_walk_plain(xi, wh, hs, gs, torch.from_numpy(
            rng.normal(size=(n, h)).astype(np.float32)))
        hseq, dxi, dgn = hs.numpy(), dx.numpy(), dn.numpy()
        dg = jnp.concatenate([jnp.asarray(dxi[..., :2 * h]), jnp.asarray(dgn)], axis=-1)
        want_w = np.asarray(jnp.einsum("nth,ntj->hj", jnp.asarray(hseq), dg))
        want_b = np.asarray(jnp.einsum("ntj->j", dg))
        got_w, got_b = gru_dwh_plain(*map(torch.from_numpy, (hseq, dxi, dgn)))
        np.testing.assert_allclose(got_w.numpy(), want_w, **SUM_TOL)
        np.testing.assert_allclose(got_b.numpy(), want_b, **SUM_TOL)
        before = gru_dwh.launches
        for a, b in zip(gru_dwh(*map(torch.from_numpy, (hseq, dxi, dgn))), (got_w, got_b)):
            assert torch.equal(a, b)
        assert gru_dwh.launches == before
        with pytest.raises(ValueError, match="gru_dwh"):
            gru_dwh(*map(torch.from_numpy, (hseq, dxi[..., :-1], dgn)))

    def test_wrappers_on_cpu_run_the_plain_versions(self, rng):
        xi, wh, bh = map(torch.from_numpy, _gru_args(rng, 7, 5, 4))
        dh = torch.randn(7, 4)
        before = gru_fwd_residuals.launches, gru_bwd.launches
        res = gru_fwd_residuals(xi, wh, bh)
        for a, b in zip(res, gru_fwd_plain(xi, wh, bh, keep_residuals=True)):
            assert torch.equal(a, b)
        got = gru_bwd(xi, wh, bh, dh, residuals=res[1:])
        for a, b in zip(got, gru_bwd_plain(xi, wh, bh, dh)):
            assert torch.equal(a, b)
        assert (gru_fwd_residuals.launches, gru_bwd.launches) == before
        with pytest.raises(ValueError, match="hseq"):
            gru_bwd(xi, wh, bh, dh, residuals=(res[1][:, :-1], res[2]))

    @pytest.mark.parametrize("n,h", [(304, 64), (304, 60), (2432, 64), (9728, 64),
                                     (333, 37), (301, 64), (5, 4), (40, 2), (1, 1)])
    def test_launch_shape_rule(self, n, h):
        rows, cluster = launch_shape(n, h, H100_SMS)
        assert rows in gru_module.TILE_ROWS and cluster in gru_module.CLUSTERS
        assert cluster <= h
        grid = -(-n // rows) * cluster
        if n >= 304:                           # one flagship training day or more
            assert grid >= H100_SMS
        if -(-n // 16) >= H100_SMS:             # the card is full without a cluster
            assert (rows, cluster) == (16, 1)
        ranges = unit_ranges(h, cluster)
        assert ranges[0][0] == 0 and ranges[-1][1] == h
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
        widths = [u1 - u0 for u0, u1 in ranges]
        assert min(widths) >= 1 and max(widths) - min(widths) <= 1

    @pytest.mark.parametrize("n,t,h", [(304, 4, 64), (301, 5, 64), (333, 4, 37),
                                       (45, 6, 37), (5, 3, 4)])
    def test_tiled_cluster_split_computes_the_same_function(self, rng, n, t, h):
        """The kernels' decomposition, written out: row tiles of the rule's
        size, each CTA of a cluster computing g for its units' three gate
        columns from the full h and h' for its units; the pieces assembled
        are the plain recurrence, ragged last tile and uneven units
        included."""
        xi, wh, bh = map(torch.from_numpy, _gru_args(rng, n, t, h))
        rows, cluster = launch_shape(n, h, H100_SMS)
        out = torch.empty(n, h)
        for r0 in range(0, n, rows):
            x = xi[r0:r0 + rows]
            hcur = torch.zeros(x.shape[0], h)
            for step in range(t):
                hnext = torch.empty_like(hcur)
                for u0, u1 in unit_ranges(h, cluster):
                    cols = [c for gate in range(3) for c in range(gate * h + u0, gate * h + u1)]
                    g = hcur @ wh[:, cols] + bh[cols]
                    xs = x[:, step, cols]
                    w = u1 - u0
                    rg = torch.sigmoid(xs[:, :w] + g[:, :w])
                    zg = torch.sigmoid(xs[:, w:2 * w] + g[:, w:2 * w])
                    ng = torch.tanh(xs[:, 2 * w:] + rg * g[:, 2 * w:])
                    hnext[:, u0:u1] = (1 - zg) * ng + zg * hcur[:, u0:u1]
                hcur = hnext
            out[r0:r0 + rows] = hcur
        np.testing.assert_allclose(out.numpy(), gru_fwd_plain(xi, wh, bh).numpy(), **TOL)

    @pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_needs_grad",
                                      "training"])
    def test_function_keeps_residuals_only_for_a_backward(self, rng, monkeypatch, mode):
        calls = []
        real = gru_module.gru_fwd_residuals
        monkeypatch.setattr(gru_module, "gru_fwd_residuals",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        xi, wh, bh = (torch.from_numpy(a).requires_grad_(mode != "no_input_needs_grad")
                      for a in _gru_args(rng, 6, 5, 4))
        if mode == "no_grad":
            with torch.no_grad():
                out = gru(xi, wh, bh)
        elif mode == "inference_mode":
            with torch.inference_mode():
                out = gru(xi, wh, bh)
        else:
            out = gru(xi, wh, bh)
        assert torch.equal(out.detach(), gru_fwd_plain(xi.detach(), wh.detach(), bh.detach()))
        if mode != "training":
            assert calls == [] and out.grad_fn is None
            return
        assert calls == [1] and len(out.grad_fn.saved_tensors) == 5
        dh = torch.randn(6, 4)
        grads = torch.autograd.grad(out, (xi, wh, bh), dh)
        for g, w in zip(grads, gru_bwd_plain(xi.detach(), wh.detach(), bh.detach(), dh)):
            assert torch.equal(g, w)


def _att_args(rng, b, n, k, h):
    latent = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.25
    q = rng.normal(size=(k, h)).astype(np.float32)
    wk = (rng.normal(size=(k, h, h)) / np.sqrt(h)).astype(np.float32)
    bk = (rng.normal(size=(k, h)) * 0.1).astype(np.float32)
    wv = (rng.normal(size=(k, h, h)) / np.sqrt(h)).astype(np.float32)
    bv = (rng.normal(size=(k, h)) * 0.1).astype(np.float32)
    return latent, mask, q, wk, bk, wv, bv


def _pallas_days(latent, mask, q, wk, bk, wv, bv, keep=None):
    """The JAX kernel, one day at a time, (B, K, H)."""
    out = []
    for d in range(latent.shape[0]):
        out.append(np.asarray(multihead_cross_section_attention(
            jnp.asarray(latent[d]), jnp.asarray(mask[d]), jnp.asarray(q),
            jnp.asarray(wk), jnp.asarray(bk), jnp.asarray(wv), jnp.asarray(bv),
            dropout_mask=None if keep is None else jnp.asarray(keep[d]))))
    return np.stack(out)


def _plain(latent, mask, q, wk, bk, wv, bv, keep=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (latent, mask, q, wk, bk, wv, bv)]
    kp = None if keep is None else torch.from_numpy(keep)
    return attention_fwd(*t, keep=kp).numpy()


class TestAttentionForward:
    B, N, K, H = 3, 10, 4, 8

    @pytest.mark.parametrize("case", ["masked_rows", "all_masked_day",
                                      "nonfinite_row", "keep_mask"])
    def test_plain_matches_pallas_kernel(self, rng, case):
        latent, mask, q, wk, bk, wv, bv = _att_args(rng, self.B, self.N, self.K, self.H)
        keep = None
        if case == "all_masked_day":
            mask[1] = False
        elif case == "nonfinite_row":
            latent[2, 3, 0] = np.nan
            latent[0, 5, 1] = np.inf
            mask[2, 3] = mask[0, 5] = True
        elif case == "keep_mask":
            keep = ((rng.random((self.B, self.K, self.N)) > 0.2) / 0.8).astype(np.float32)
        args = (latent, mask, q, wk, bk, wv, bv)
        got, want = _plain(*args, keep=keep), _pallas_days(*args, keep=keep)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
        if case == "all_masked_day":
            assert (got[1] == 0).all()
        if case == "nonfinite_row":
            assert (got[2] == 0).all() and (got[0] == 0).all()
            assert (got[1] != 0).any()

    def test_plain_matches_xla_einsum_path(self, rng):
        """The same function as the JAX predictor's einsum path (attention
        kernel off), which the guard tests of the JAX package pin."""
        latent, mask, q, wk, bk, wv, bv = _att_args(rng, self.B, self.N, self.K, self.H)
        keys = jnp.einsum("bnh,khj->bknj", latent, wk) + bk[None, :, None, :]
        values = jnp.einsum("bnh,khj->bknj", latent, wv) + bv[None, :, None, :]
        s = jax.nn.relu(jnp.einsum("kh,bknh->bkn", q, keys)
                        / jnp.sqrt(jnp.float32(self.H) + 1e-6))
        from factorvae_tpu.ops.masked import masked_softmax

        attn = masked_softmax(s, jnp.asarray(mask)[:, None, :], axis=-1)
        want = np.asarray(jnp.einsum("bkn,bknh->bkh", attn, values))
        np.testing.assert_allclose(_plain(latent, mask, q, wk, bk, wv, bv), want, **TOL)

    def test_wrapper_validates_inputs(self, rng):
        latent, mask, q, wk, bk, wv, bv = (
            torch.from_numpy(np.ascontiguousarray(a))
            for a in _att_args(rng, 2, 5, 3, 4))
        with pytest.raises(ValueError):
            attention_fwd(latent, mask[:, :4], q, wk, bk, wv, bv)
        with pytest.raises(TypeError):
            attention_fwd(latent, mask.float(), q, wk, bk, wv, bv)
        before = attention_fwd.launches
        out = attention_fwd(latent, mask, q, wk, bk, wv, bv)
        assert torch.equal(out, attention_fwd_plain(latent, mask, q, wk, bk, wv, bv))
        assert attention_fwd.launches == before


def _jax_attention_grads(latent, mask, q, wk, bk, wv, bv, dctx, keep=None):
    """jax.vjp of the Pallas fused_attention (its backward is `_bwd_pallas`),
    one day at a time: per-day (dlatent, dq, dWk, dbk, dWv, dbv)."""
    out = []
    for d in range(latent.shape[0]):
        def f(lat, q_, wk_, bk_, wv_, bv_):
            return fused_attention(lat, jnp.asarray(mask[d], jnp.float32), q_, wk_, bk_,
                                   wv_, bv_, None if keep is None else jnp.asarray(keep[d]))
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (latent[d], q, wk, bk, wv, bv)))
        out.append([np.asarray(g) for g in vjp(jnp.asarray(dctx[d]))])
    return out


class TestAttentionBackward:
    B, N, K, H = 3, 10, 4, 8

    @pytest.mark.parametrize("case", ["masked_rows", "all_masked_day",
                                      "nonfinite_row", "keep_mask"])
    def test_plain_and_function_backward_match_pallas(self, rng, case):
        latent, mask, q, wk, bk, wv, bv = _att_args(rng, self.B, self.N, self.K, self.H)
        dctx = rng.normal(size=(self.B, self.K, self.H)).astype(np.float32)
        keep, bad_day = None, None
        if case == "all_masked_day":
            mask[1] = False
        elif case == "nonfinite_row":
            latent[2, 3, 0] = np.nan
            mask[2, 3] = True
            bad_day = 2
        elif case == "keep_mask":
            keep = ((rng.random((self.B, self.K, self.N)) > 0.2) / 0.8).astype(np.float32)
        per_day = _jax_attention_grads(latent, mask, q, wk, bk, wv, bv, dctx, keep)
        days = [d for d in range(self.B) if d != bad_day]
        if bad_day is not None:
            # the Pallas kernel zeroes a guarded head by multiplying, so the
            # NaN row leaks into dq, dWk and dWv through 0 * NaN; the port
            # selects, and the guarded day adds exactly zero
            assert (per_day[bad_day][0] == 0).all()
            assert not all(np.isfinite(g).all() for g in per_day[bad_day])
        want_latent = np.stack([per_day[d][0] for d in range(self.B)])
        want_w = [sum(per_day[d][i] for d in days) for i in range(1, 6)]

        t = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (latent, mask, q, wk, bk, wv, bv, dctx)]
        kp = None if keep is None else torch.from_numpy(keep)
        plain = attention_bwd_plain(*t, keep=kp)
        leaves = [a.clone().requires_grad_() for a in (t[0], *t[2:7])]
        keep_leaf = None if kp is None else kp.clone().requires_grad_()
        out = attention(leaves[0], t[1], *leaves[1:], keep=keep_leaf)
        inputs = leaves + ([keep_leaf] if keep_leaf is not None else [])
        grads = torch.autograd.grad(out, inputs, t[7], allow_unused=True)
        if keep_leaf is not None:
            assert grads[-1] is None                   # the keep-mask gets none
        for got in (plain, grads[:6]):
            got = [g.numpy() for g in got]
            assert all(np.isfinite(g).all() for g in got)
            np.testing.assert_allclose(got[0][days], want_latent[days], **TOL)
            for g, w in zip(got[1:], want_w):
                np.testing.assert_allclose(g, w, **TOL)
            if bad_day is not None:
                assert (got[0][bad_day] == 0).all()
            if case == "all_masked_day":
                assert (got[0][1] == 0).all()

    def test_wrapper_on_cpu_runs_the_plain_version(self, rng):
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in _att_args(rng, 2, 5, 3, 4)]
        dctx = torch.randn(2, 3, 4)
        before = attention_bwd.launches
        for a, b in zip(attention_bwd(*args, dctx), attention_bwd_plain(*args, dctx)):
            assert torch.equal(a, b)
        assert attention_bwd.launches == before
        with pytest.raises(ValueError, match="dctx"):
            attention_bwd(*args, torch.zeros(2, 3, 5))


def _folded_attention(latent, mask, q, wk, bk, wv, bv, keep=None, exact_path=True):
    """The algebra of the CUDA attention kernels (csrc/attention_fwd.cu) in
    torch, (B, K, H): the key and value products folded into the scores
    s = (L . u + c) / sqrt(H + 1e-6), u = Wk . q, c = bk . q, and the context
    (a^T L) . Wv + bv sum(a). Its finiteness rule: with `exact_path`, a day
    with a non-finite element in a valid latent row takes the form as written
    (`attention_fwd_plain`), as the kernels' exact path does; without it,
    every day is folded."""
    lat, m, q, wk, bk, wv, bv = (torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (latent, mask, q, wk, bk, wv, bv))
    kp = None if keep is None else torch.from_numpy(keep)
    scale = torch.sqrt(torch.tensor(float(lat.shape[-1])) + 1e-6)
    u = torch.einsum("khj,kj->kh", wk, q)
    c = (bk * q).sum(-1)
    lat0 = torch.where(m[..., None], lat, 0.0)
    s = (torch.einsum("bnh,kh->bkn", lat0, u) + c[None, :, None]) / scale
    if kp is not None:
        s = s * kp
    r = torch.relu(s)
    valid = m[:, None, :]
    bad = torch.any(~torch.isfinite(torch.where(valid, r, 0.0)), dim=-1, keepdim=True)
    a = torch.where(bad, 0.0, torch_masked_softmax(r, valid, dim=-1))
    ctx = (torch.einsum("bkh,khj->bkj", torch.einsum("bkn,bnh->bkh", a, lat0), wv)
           + bv[None] * a.sum(-1, keepdim=True))
    ctx = torch.where(bad, 0.0, ctx)
    if exact_path:
        flagged = ~torch.isfinite(lat0).all(dim=2).all(dim=1)
        if flagged.any():
            ctx[flagged] = attention_fwd_plain(lat[flagged], m[flagged], q, wk, bk, wv, bv,
                                               None if kp is None else kp[flagged])
    return ctx.numpy()


def _inf_days(rng, latent, mask, q, wk):
    """Rows holding +inf (day 1) and -inf (day 2) in the column where the
    folded score L . (Wk q) is -inf on some head, while the score as written,
    (L . Wk) . q, sums infinities of both signs (NaN: the head is guarded)."""
    u = np.einsum("khj,kj->kh", wk, q)
    latent[1, 4, u.min(axis=0).argmin()] = np.inf
    latent[2, 6, u.max(axis=0).argmax()] = -np.inf
    mask[1, 4] = mask[2, 6] = True
    return (1, 2)


class TestAttentionFold:
    """The folded algebra of the CUDA kernels and its finiteness rule
    against the Pallas kernel (interpret mode)."""
    B, N, K, H = 4, 12, 4, 8

    @pytest.mark.parametrize("case", ["masked_rows", "all_masked_day", "keep_mask",
                                      "nan_row"])
    def test_fold_matches_pallas_kernel(self, rng, case):
        latent, mask, q, wk, bk, wv, bv = _att_args(rng, self.B, self.N, self.K, self.H)
        keep = None
        if case == "all_masked_day":
            mask[1] = False
        elif case == "keep_mask":
            keep = ((rng.random((self.B, self.K, self.N)) > 0.2) / 0.8).astype(np.float32)
        elif case == "nan_row":
            latent[3, 2, 5] = np.nan
            mask[3, 2] = True
        args = (latent, mask, q, wk, bk, wv, bv)
        want = _pallas_days(*args, keep=keep)
        np.testing.assert_allclose(_folded_attention(*args, keep=keep), want, **TOL)
        # NaN propagates alike in both forms: the bare fold guards it too
        np.testing.assert_allclose(_folded_attention(*args, keep=keep, exact_path=False),
                                   want, **TOL)
        if case == "nan_row":
            assert (want[3] == 0).all() and (want[0] != 0).any()

    @pytest.mark.parametrize("with_keep", [False, True], ids=["no_keep", "keep_mask"])
    def test_fold_needs_the_exact_path_on_an_infinite_row(self, rng, with_keep):
        latent, mask, q, wk, bk, wv, bv = _att_args(rng, self.B, self.N, self.K, self.H)
        days = _inf_days(rng, latent, mask, q, wk)
        keep = None
        if with_keep:
            keep = ((rng.random((self.B, self.K, self.N)) > 0.2) / 0.8).astype(np.float32)
            keep[:, :, [4, 6]] = 1.25           # the poisoned rows' scores are kept
        args = (latent, mask, q, wk, bk, wv, bv)
        want = _pallas_days(*args, keep=keep)
        assert all((want[d] == 0).all() for d in days)     # the reference guards them
        bare = _folded_attention(*args, keep=keep, exact_path=False)
        for d in days:                          # the bare fold misses a head there
            assert not np.isfinite(bare[d]).all()
        got = _folded_attention(*args, keep=keep)
        np.testing.assert_allclose(got, want, **TOL)
        assert np.isfinite(got).all()


@pytest.mark.parametrize("b,n,k,want", [(1, 304, 96, 1), (8, 304, 96, 8), (32, 304, 96, 8),
                                        (4, 800, 60, 4), (1, 3000, 8, 1), (3, 70, 6, 4)])
def test_attention_launch_rule(b, n, k, want):
    """Heads per CTA on an H100: one per CTA at one flagship day; grouped at
    8 days and at a serving chunk, the grid keeping a CTA for every head of
    a day; at most MAX_GROUP_ROWS rows of per-head arrays."""
    g = launch_group(b, k, n, H100_SMS)
    assert g == want
    assert b * -(-k // g) >= min(k, H100_SMS) or g == 1
