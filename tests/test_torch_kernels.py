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
)
from factorvae_tpu_torch.ops.kernels.gru import (
    gru,
    gru_bwd,
    gru_bwd_plain,
    gru_fwd,
    gru_fwd_plain,
)

TOL = dict(rtol=1e-5, atol=1e-6)
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
