"""The port's K1 (GRU forward) and K4 (K-head attention forward) against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tier-1
parity tests run them. Inputs come from numpy. Tolerance: f32 with
rtol=1e-5, atol=1e-6, the repo's torch-oracle tolerance. The CUDA kernels
themselves are held against the plain versions on the card by
`tests/test_torch_cuda.py` and by chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu.ops.pallas.attention import multihead_cross_section_attention
from factorvae_tpu.ops.pallas.gru import gru_scan
from factorvae_tpu_torch.ops.kernels.attention import attention_fwd, attention_fwd_plain
from factorvae_tpu_torch.ops.kernels.gru import gru_fwd, gru_fwd_plain

TOL = dict(rtol=1e-5, atol=1e-6)


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
