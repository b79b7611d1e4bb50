"""The port's explicit collectives and ring attention against the JAX
package's `shard_map` functions on the same mesh shape.

One gloo world of 4 ranks (`tests/torch_dist_rig.py`) runs every case on a
1 x 4 ('data', 'stock') mesh, each rank holding 4 of 16 rows; the JAX side
runs the same numpy inputs through `shard_map` on a 4-device 'stock' mesh of
this process's virtual CPU devices. Tolerances rtol 1e-5 / atol 1e-6
(f32 sums in another order); zero contexts and masked means exactly.

The adjoints: each case's loss is a replicated value (every rank computes
it whole from the all-gathered output), so with the true adjoints each rank
holds 4 times its rows' gradient; that over 4 is held against the autograd
gradient of the port's unsharded op (`ops.masked.masked_softmax`) and
against the loss's own weights for the gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from factorvae_tpu.config import ModelConfig as JModelConfig
from factorvae_tpu.models.predictor import FactorPredictor
from factorvae_tpu.parallel.collective_ops import (
    all_gather_stocks,
    pmax_masked_softmax,
    psum_masked_mean,
    psum_masked_mse,
    psum_matvec,
)
from factorvae_tpu.parallel.compat import shard_map
from factorvae_tpu.parallel.ring import predictor_prior_ring, ring_cross_section_attention
from factorvae_tpu_torch.ops.masked import masked_softmax as tmasked_softmax
from torch_dist_rig import collective_cases, run_world

WORLD, N, H, K = 4, 16, 8, 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    mask = rng.random((N, 1)) > 0.3
    mask[4:8] = False                                   # rank 1's shard fully masked
    vmask = rng.random(N) > 0.3
    vmask[8:12] = False
    rmask = rng.random(N) > 0.25
    rmask[12:16] = False
    rmask[1] = True
    keys = rng.normal(size=(N, H)).astype(f32)
    keys_inf = keys.copy()
    keys_inf[1, 2] = np.inf                             # a valid row: the heads whose q[:, 2] > 0
    latent = rng.normal(size=(N, H)).astype(f32)
    latent_nan = latent.copy()
    latent_nan[5, 3] = np.nan                           # a valid stock goes NaN
    lmask = np.ones(N, bool)
    lmask[9] = False
    q = rng.normal(size=(K, H)).astype(f32)
    q[:, 2] = [0.7, -0.4, 0.3]                          # heads 0 and 2 see +inf, head 1 -inf
    return {
        "x": rng.normal(size=(N, 3)).astype(f32), "mask": mask,
        "c": rng.normal(size=(N, 3)).astype(f32),
        "w": rng.normal(size=(N, 3)).astype(f32), "v": rng.normal(size=N).astype(f32),
        "vmask": vmask, "target": rng.normal(size=N).astype(f32),
        "gw": rng.normal(size=(N, 3)).astype(f32),
        "q": q, "keys": keys, "keys_inf": keys_inf,
        "vals": rng.normal(size=(N, H)).astype(f32), "rmask": rmask,
        "latent": latent, "latent_nan": latent_nan, "lmask": lmask,
    }


def _predictor_params(inputs, slope):
    """JAX FactorPredictor weights, and the same under the port's names
    (a Dense kernel (in, out) is the port's weight (out, in))."""
    cfg = JModelConfig(num_features=8, hidden_size=H, num_factors=K, num_portfolios=6,
                       seq_len=4, leaky_relu_slope=slope)
    params = FactorPredictor(cfg).init(jax.random.PRNGKey(0), jnp.asarray(inputs["latent"]),
                                       jnp.asarray(inputs["lmask"]))
    p = params["params"]
    port = {f"pred.{k}": np.asarray(p[k]) for k in
            ("query", "key_kernel", "key_bias", "value_kernel", "value_bias")}
    for name in ("proj", "mu", "sigma"):
        port[f"pred.{name}.weight"] = np.asarray(p[name]["Dense_0"]["kernel"]).T.copy()
        port[f"pred.{name}.bias"] = np.asarray(p[name]["Dense_0"]["bias"])
    return cfg, params, port


class TestCollectivesAgainstShardMap:
    @pytest.fixture(scope="class")
    def world(self, tmp_path_factory):
        inputs = _inputs()
        slope = 0.2
        jcfg, jparams, port = _predictor_params(inputs, slope)
        results = run_world(WORLD, collective_cases, tmp_path_factory.mktemp("coll"),
                            {**inputs, **port, "slope": np.float32(slope)})
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("stock",))
        return inputs, results, mesh, (jcfg, jparams)

    @staticmethod
    def _sm(mesh, fn, in_specs, out_specs):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))

    @staticmethod
    def _rows(results, key):
        return np.concatenate([r[key] for r in results], axis=0)

    @staticmethod
    def _replicated(results, key, exact=True):
        """Rank 0's value of a replicated output, after checking the other
        ranks': bit for bit where every rank reduces in one order (the
        all-reduces), within TOL for the ring, whose ranks fold the chunks
        starting each from its own."""
        for r in results[1:]:
            if exact:
                np.testing.assert_array_equal(r[key], results[0][key])
            else:
                np.testing.assert_allclose(r[key], results[0][key], **TOL)
        return results[0][key]

    def test_masked_softmax_and_its_adjoint(self, world):
        inputs, results, mesh, _ = world
        f = self._sm(mesh, lambda x, m: pmax_masked_softmax(x, m, "stock", axis=0),
                     (JP("stock", None), JP("stock", None)), JP("stock", None))
        want = np.asarray(f(jnp.asarray(inputs["x"]), jnp.asarray(inputs["mask"])))
        got = self._rows(results, "softmax")
        np.testing.assert_allclose(got, want, **TOL)
        assert np.all(got[4:8] == 0.0)                 # the masked shard
        x = torch.as_tensor(inputs["x"]).requires_grad_(True)
        torch.sum(torch.as_tensor(inputs["c"])
                  * tmasked_softmax(x, torch.as_tensor(inputs["mask"]), dim=0)).backward()
        np.testing.assert_allclose(self._rows(results, "softmax_grad"), x.grad.numpy(), **TOL)

    def test_matvec_and_masked_means(self, world):
        inputs, results, mesh, _ = world
        mv = self._sm(mesh, lambda w, v: psum_matvec(w, v, "stock"),
                      (JP("stock", None), JP("stock")), JP())
        np.testing.assert_allclose(
            self._replicated(results, "matvec"),
            np.asarray(mv(jnp.asarray(inputs["w"]), jnp.asarray(inputs["v"]))), **TOL)
        mean = self._sm(mesh, lambda x, m: psum_masked_mean(x, m, "stock"),
                        (JP("stock"), JP("stock")), JP())
        mse = self._sm(mesh, lambda p, t, m: psum_masked_mse(p, t, m, "stock"),
                       (JP("stock"), JP("stock"), JP("stock")), JP())
        v, vm = jnp.asarray(inputs["v"]), jnp.asarray(inputs["vmask"])
        np.testing.assert_allclose(self._replicated(results, "mean"),
                                   np.asarray(mean(v, vm)), **TOL)
        np.testing.assert_allclose(self._replicated(results, "mse"),
                                   np.asarray(mse(v, jnp.asarray(inputs["target"]), vm)),
                                   **TOL)
        assert self._replicated(results, "mean_all_masked") == 0.0
        assert float(mean(v, jnp.zeros(N, bool))) == 0.0

    def test_all_gather_and_its_adjoint(self, world):
        inputs, results, mesh, _ = world
        f = self._sm(mesh, lambda x: all_gather_stocks(x, "stock"), (JP("stock", None),),
                     JP())
        want = np.asarray(f(jnp.asarray(inputs["w"])))
        np.testing.assert_array_equal(self._replicated(results, "gather"), want)
        # the loss sum(gw * gather(w)): its gradient is gw, each rank its rows
        np.testing.assert_allclose(self._rows(results, "gather_grad"), inputs["gw"], **TOL)

    def test_ring_attention_with_a_masked_shard_and_a_nonfinite_head(self, world):
        inputs, results, mesh, _ = world
        q = jnp.asarray(inputs["q"])

        def ring(keys, mask, guard=False):
            f = self._sm(mesh, lambda kl, vl, ml: ring_cross_section_attention(
                q, kl, vl, ml, "stock", guard_nonfinite=guard),
                (JP("stock", None), JP("stock", None), JP("stock")), JP())
            return np.asarray(f(jnp.asarray(keys), jnp.asarray(inputs["vals"]),
                                jnp.asarray(mask)))

        np.testing.assert_allclose(self._replicated(results, "ring", exact=False),
                                   ring(inputs["keys"], inputs["rmask"]), **TOL)
        np.testing.assert_array_equal(self._replicated(results, "ring_masked"),
                                      np.zeros((K, H), np.float32))
        guarded = self._replicated(results, "ring_guard", exact=False)
        want = ring(inputs["keys_inf"], inputs["rmask"], guard=True)
        np.testing.assert_allclose(guarded, want, **TOL)
        bad = inputs["q"][:, 2] > 0
        assert bad.any() and (~bad).any()
        assert np.all(guarded[bad] == 0.0) and np.all(np.isfinite(guarded))

    def test_predictor_prior_ring_and_its_nonfinite_guard(self, world):
        inputs, results, mesh, (jcfg, jparams) = world
        prior = jax.jit(lambda lat, m: predictor_prior_ring(jparams, lat, m, mesh, "stock",
                                                            cfg=jcfg))
        for key, lat in (("prior", "latent"), ("prior_nan", "latent_nan")):
            mu, sigma = prior(jnp.asarray(inputs[lat]), jnp.asarray(inputs["lmask"]))
            got = self._replicated(results, key, exact=False)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, np.stack([np.asarray(mu), np.asarray(sigma)]),
                                       **TOL)

    def test_each_op_counts_its_calls_and_bytes_on_the_stock_axis(self, world):
        _, results, _, _ = world
        counts = self._replicated_counts(results)
        assert set(counts) == {"all-reduce@stock", "all-gather@stock",
                               "collective-permute@stock"}
        # the gathers: softmax's output, the gathered w; 16 rows x 3 f32 each
        assert counts["all-gather@stock"] == {"calls": 2, "bytes": 2 * N * 3 * 4}
        # the ring: 3 shifts (keys, values, mask) per fold-and-rotate, 3 of
        # them, in each of the 5 ring calls
        assert counts["collective-permute@stock"]["calls"] == 5 * 3 * (WORLD - 1)
        assert counts["all-reduce@stock"]["calls"] > 0

    @staticmethod
    def _replicated_counts(results):
        for r in results[1:]:
            assert r["counts"] == results[0]["counts"]
        return results[0]["counts"]
