"""Fused multi-chain sweep vs C independent single-chain sweeps.

The strided sweep (ops/strided.py) carries a leading chain axis; all chains
share the visit order and Gram blocks.  Fed the same state and the same
position-indexed variates, it must reproduce C single-chain sweeps chain
by chain: exact labels and counts, floats to reassociation tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import BayesRConfig, ChainConfig, GroupsConfig, \
    SpikeSlabSampler, simulate
from bayesrrcpp_tpu.ops import block_sweep as bs

CVA = np.array([0.001, 0.01, 0.1])


def _mc_vs_single(sim, cva, g_assign=None, C=3, iters=2):
    kw = {} if g_assign is None else dict(g_assign=g_assign)
    cfg = (BayesRConfig(block_size=32) if g_assign is None
           else GroupsConfig(block_size=32))
    s = SpikeSlabSampler(sim.X, sim.Y, cva, cfg, dtype=jnp.float32,
                         jacobi_blocks=3, **kw)
    d = s.data
    B, nb, Mpad = s.B, s.nb, s.Mpad

    rng = np.random.default_rng(0)
    sts = [s.init(jax.random.PRNGKey(100 + c)) for c in range(C)]
    stack = lambda f: jnp.stack([f(st) for st in sts])
    eps, beta, labels = stack(lambda t: t.eps), stack(lambda t: t.beta), \
        stack(lambda t: t.labels)
    pi, sE, sGG = stack(lambda t: t.pi), stack(lambda t: t.sigmaE), \
        stack(lambda t: t.sigmaGG)

    for it in range(iters):
        rho, inner = bs.strided_orders(jax.random.PRNGKey(7 + it), nb, B,
                                       s.jacobi)
        p = jnp.asarray(rng.uniform(size=(C, Mpad)).astype(np.float32))
        z = jnp.asarray(rng.normal(size=(C, Mpad)).astype(np.float32))
        mc = s._sweep(d, eps, beta, labels, rho, inner, p, z, pi, sE, sGG)
        for c in range(C):
            res = s._sweep(d, eps[c:c + 1], beta[c:c + 1],
                           labels[c:c + 1], rho, inner, p[c:c + 1],
                           z[c:c + 1], pi[c:c + 1], sE[c:c + 1],
                           sGG[c:c + 1])
            np.testing.assert_array_equal(
                np.asarray(mc.labels)[c], np.asarray(res.labels)[0],
                err_msg=f"labels diverged chain {c} iter {it}")
            np.testing.assert_allclose(np.asarray(mc.beta)[c],
                                       np.asarray(res.beta)[0],
                                       rtol=2e-5, atol=1e-7)
            np.testing.assert_allclose(np.asarray(mc.eps)[c],
                                       np.asarray(res.eps)[0],
                                       rtol=2e-5, atol=2e-6)
            np.testing.assert_array_equal(np.asarray(mc.v)[c],
                                          np.asarray(res.v)[0])
            np.testing.assert_allclose(
                np.asarray(mc.beta_acum)[c], np.asarray(res.beta_acum)[0],
                rtol=2e-5, atol=1e-8)
        eps, beta, labels = mc.eps, mc.beta, mc.labels


def test_mc_equals_single_ungrouped():
    sim = simulate.simulate_bayesr(seed=81, N=160, M=96, n_causal=12, h2=0.5)
    _mc_vs_single(sim, CVA)


@pytest.mark.slow
def test_mc_equals_single_groups():
    sim = simulate.simulate_bayesr(seed=82, N=140, M=64, n_causal=8, h2=0.5,
                                   n_groups=2)
    _mc_vs_single(sim, np.tile(CVA, (2, 1)), g_assign=sim.g_assign, C=2)


@pytest.mark.slow
def test_mc_fused_full_chain_recovery():
    """run_chains: chains are independent, finite, and recover the
    simulated effects."""
    sim = simulate.simulate_bayesr(seed=83, N=250, M=96, n_causal=12, h2=0.6)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=32),
                         dtype=jnp.float32)
    assert s.supports_fused_chains
    _, out = s.run_chains(jax.random.PRNGKey(3), 3,
                          ChainConfig(120, 60, 4))
    beta = np.asarray(out["beta"])          # (n_emits, C, M)
    assert beta.shape[1] == 3
    assert np.isfinite(beta).all()
    bh = beta.mean(axis=0)
    for c in range(3):
        r = np.corrcoef(sim.beta_true, bh[c])[0, 1]
        assert r > 0.6, f"chain {c} recovery corr {r}"
    assert not np.allclose(bh[0], bh[1])


@pytest.mark.slow
def test_mc_fold_affine_int8():
    """Quantized no-missing X: fused MC == dense MC on the same matrix."""
    rng = np.random.default_rng(84)
    N, M = 150, 64
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(float)
    means = dosage.mean(axis=0)
    sds = dosage.std(axis=0, ddof=1)
    dense = (dosage - means) / sds
    y = dense @ np.where(rng.random(M) < 0.1, 0.3, 0.0) + rng.normal(0, 0.7, N)

    cfg = BayesRConfig(block_size=32)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="int8",
                           dtype=jnp.float32)
    assert s_q._x_fold and s_q.supports_fused_chains
    C = 2
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    st_d = jax.vmap(s_d.init)(keys)
    st_q = jax.vmap(s_q.init)(keys)
    for _ in range(2):
        st_d, st_q = s_d.step_chains(st_d), s_q.step_chains(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(np.asarray(st_d.eps), np.asarray(st_q.eps),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.slow
def test_mc_quantized_missing_falls_back():
    """int8 with missing calls runs fused chains like every other
    storage; the scan reference has no chain axis."""
    rng = np.random.default_rng(85)
    dosage = rng.binomial(2, 0.4, size=(60, 32)).astype(float)
    dosage[0, 0] = np.nan
    y = rng.normal(size=60)
    s = SpikeSlabSampler(dosage, y, CVA, BayesRConfig(block_size=16),
                         x_dtype="int8", dtype=jnp.float32)
    assert s.supports_fused_chains and not s._x_fold
    _, out = s.run_chains(jax.random.PRNGKey(0), 2, ChainConfig(6, 2, 2))
    assert np.isfinite(np.asarray(out["beta"])).all()
    s_scan = SpikeSlabSampler(np.nan_to_num(dosage), y, CVA,
                              BayesRConfig(block_size=16), backend="scan")
    with pytest.raises(ValueError):
        s_scan.run_chains(jax.random.PRNGKey(0), 2, ChainConfig(4, 2, 1))


def test_hs_mc_equals_single():
    """Fused multi-chain horseshoe == C single-chain horseshoe sweeps."""
    from bayesrrcpp_tpu import HorseshoeConfig, HorseshoeSampler

    sim = simulate.simulate_bayesr(seed=86, N=140, M=64, n_causal=8, h2=0.5)
    s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(A=0.05, block_size=32),
                         dtype=jnp.float32, jacobi_blocks=2)
    d = s.data
    B, nb, Mpad = s.B, s.nb, s.Mpad
    C = 3
    rng = np.random.default_rng(1)
    eps = jnp.stack([s.init(jax.random.PRNGKey(c)).eps for c in range(C)])
    beta = rng.normal(0, 0.05, (C, Mpad)).astype(np.float32)
    beta[:, s.M:] = 0.0
    beta = jnp.asarray(beta)
    f32 = lambda *shape, lo=0.5, hi=2.0: jnp.asarray(
        rng.uniform(lo, hi, shape).astype(np.float32))
    lam, tau, c2 = f32(C, Mpad), f32(C, lo=0.01, hi=0.1), f32(C)
    sE = f32(C, lo=0.3, hi=0.8)
    z = jnp.asarray(rng.normal(size=(C, Mpad)).astype(np.float32))

    rho, inner = bs.strided_orders(jax.random.PRNGKey(11), nb, B, s.jacobi)
    eps_mc, beta_mc = s._sweep(d, eps, beta, rho, inner, z, lam, tau, c2, sE)
    for c in range(C):
        sl = slice(c, c + 1)
        eps_1, beta_1 = s._sweep(d, eps[sl], beta[sl], rho, inner, z[sl],
                                 lam[sl], tau[sl], c2[sl], sE[sl])
        np.testing.assert_allclose(np.asarray(beta_mc)[c],
                                   np.asarray(beta_1)[0],
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(eps_mc)[c],
                                   np.asarray(eps_1)[0],
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.slow
def test_hs_mc_full_chain():
    from bayesrrcpp_tpu import HorseshoeConfig, HorseshoeSampler

    sim = simulate.simulate_bayesr(seed=87, N=200, M=64, n_causal=8, h2=0.6)
    s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(A=0.05, block_size=32),
                         dtype=jnp.float32)
    assert s.supports_fused_chains
    _, out = s.run_chains(jax.random.PRNGKey(4), 3, ChainConfig(80, 40, 4))
    beta = np.asarray(out["beta"])
    assert beta.shape[1] == 3 and np.isfinite(beta).all()
    assert not np.allclose(beta[:, 0], beta[:, 1])
