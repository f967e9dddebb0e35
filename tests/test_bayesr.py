"""End-to-end tests of the BayesR spike-and-slab samplers.

Follows the verification strategy the reference implies (SURVEY.md section 4):
simulation-recovery (effect slope ~ 1, variance components near truth,
reference: src/BayesRv2.cpp:297-331) plus the framework's own stronger
invariant -- the Gram-blocked fast sweep must equal the direct sequential
sweep bitwise-modulo-reassociation under a shared permutation and PRNG key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import (BayesRConfig, ChainConfig, GroupsConfig,
                            SpikeSlabSampler, simulate)

CVA = np.array([0.0001, 0.001, 0.01])


@pytest.fixture(scope="module")
def sim():
    return simulate.simulate_bayesr(seed=7, N=800, M=300, n_causal=40, h2=0.5)


def _make(sim, backend, dtype=jnp.float64, **kw):
    cfg = kw.pop("config", BayesRConfig(block_size=64))
    return SpikeSlabSampler(sim.X, sim.Y, CVA, cfg, backend=backend,
                            dtype=dtype, **kw)


def test_blocked_equals_scan_single_iteration(sim):
    """Gram-trick exactness: same key, same blocked permutation -> same state."""
    s_blocked = _make(sim, "blocked")
    s_scan = _make(sim, "scan", permutation="blocked")
    key = jax.random.PRNGKey(0)
    st_b = s_blocked.init(key)
    st_s = s_scan.init(key)
    for _ in range(3):
        st_b = s_blocked.step(st_b)
        st_s = s_scan.step(st_s)
    np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_s.beta),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_s.eps),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(st_b.labels), np.asarray(st_s.labels))
    np.testing.assert_allclose(float(st_b.sigmaE), float(st_s.sigmaE), rtol=1e-8)
    np.testing.assert_allclose(float(st_b.sigmaGG[0]), float(st_s.sigmaGG[0]),
                               rtol=1e-8)


def test_residual_invariant(sim):
    """eps must always equal Y - mu - X beta (rank-1 bookkeeping is exact)."""
    s = _make(sim, "blocked")
    st = s.init(jax.random.PRNGKey(1))
    for _ in range(5):
        st = s.step(st)
    eps_direct = (sim.Y - float(st.mu)
                  - sim.X @ np.asarray(st.beta)[: s.M])
    np.testing.assert_allclose(np.asarray(st.eps), eps_direct, atol=1e-8)


@pytest.mark.slow
def test_recovery_ungrouped(sim):
    """Posterior means recover simulated effects (vignette-style check,
    reference: src/BayesRv2.cpp:320-330)."""
    s = _make(sim, "blocked")
    chain = ChainConfig(max_iterations=600, burn_in=300, thinning=2)
    _, out = s.run(jax.random.PRNGKey(2), chain)
    beta_hat = out["beta"].mean(axis=0)
    slope = np.polyfit(sim.beta_true, beta_hat, 1)[0]
    assert 0.6 < slope < 1.3
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.8
    # residual variance should approach the simulated noise level
    sigmaE_hat = out["sigmaE"].mean()
    noise_var = np.var(sim.Y - sim.X @ sim.beta_true)
    assert sigmaE_hat == pytest.approx(noise_var, rel=0.35)
    # emission schema sanity
    assert out["iteration"][0] == 300
    assert np.all(np.diff(out["iteration"]) == 2)
    assert out["comp"].shape[1] == s.M
    assert out["epsilon"].shape[1] == s.N


@pytest.mark.slow
def test_groups_with_fixed_effects():
    sim = simulate.simulate_bayesr(seed=11, N=700, M=240, n_causal=30, h2=0.5,
                                   n_groups=2, n_fixed=3)
    # slab variances scaled to the simulated per-effect variance (h2/n_causal);
    # with the vignette's tiny cva the grouped prior over-shrinks this recipe
    cva = np.tile(CVA * 10.0, (2, 1))
    s = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=64),
                         g_assign=sim.g_assign, fixed=sim.fixed,
                         backend="blocked", dtype=jnp.float64)
    chain = ChainConfig(max_iterations=500, burn_in=250, thinning=2)
    _, out = s.run(jax.random.PRNGKey(3), chain)
    beta_hat = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.75
    alpha_hat = out["alpha"].mean(axis=0)
    np.testing.assert_allclose(alpha_hat, sim.alpha_true, atol=0.15)
    assert out["sigmaG"].shape[1] == 2
    assert out["sigmaF"].ndim == 1


def test_groups_blocked_equals_scan():
    sim = simulate.simulate_bayesr(seed=13, N=300, M=150, n_causal=20, h2=0.4,
                                   n_groups=3, n_fixed=2)
    cva = np.tile(CVA, (3, 1))
    kw = dict(g_assign=sim.g_assign, fixed=sim.fixed, dtype=jnp.float64)
    s_b = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=32),
                           backend="blocked", **kw)
    s_s = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=32),
                           backend="scan", permutation="blocked", **kw)
    key = jax.random.PRNGKey(4)
    st_b, st_s = s_b.init(key), s_s.init(key)
    for _ in range(3):
        st_b, st_s = s_b.step(st_b), s_s.step(st_s)
    np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_s.beta),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st_b.alpha), np.asarray(st_s.alpha),
                               rtol=1e-8)
    np.testing.assert_array_equal(np.asarray(st_b.labels), np.asarray(st_s.labels))


def test_warm_restart_contract(sim):
    """init_from consumes a previous chain's last sample (BRV2Grstart,
    src/BRv2Grstart.cpp:77,157-165) and the chain continues sensibly."""
    s = _make(sim, "blocked")
    st = s.init(jax.random.PRNGKey(5))
    for _ in range(20):
        st = s.step(st)
    st2 = s.init_from(
        jax.random.PRNGKey(6),
        mu=float(st.mu), beta=np.asarray(st.beta)[: s.M],
        sigmaE=float(st.sigmaE), sigmaGG=np.asarray(st.sigmaGG),
        epsilon=np.asarray(st.eps),
        components=np.asarray(st.labels)[: s.M])
    np.testing.assert_allclose(np.asarray(st2.beta), np.asarray(st.beta))
    st3 = s.step(st2)
    assert np.isfinite(float(st3.sigmaE))
    assert float(st3.sigmaE) < 2.0 * np.var(sim.Y)


def test_checkpoint_resume_bitwise(sim):
    """Unlike the reference (which loses RNG state on restart), resuming from
    the state pytree is bitwise exact."""
    s = _make(sim, "blocked")
    st = s.init(jax.random.PRNGKey(8))
    for _ in range(4):
        st = s.step(st)
    snapshot = jax.tree.map(np.asarray, st)
    for _ in range(3):
        st = s.step(st)
    resumed = jax.tree.map(jnp.asarray, snapshot)
    resumed = type(st)(*resumed)
    for _ in range(3):
        resumed = s.step(resumed)
    np.testing.assert_array_equal(np.asarray(st.beta), np.asarray(resumed.beta))
    np.testing.assert_array_equal(np.asarray(st.eps), np.asarray(resumed.eps))


@pytest.mark.slow
def test_single_slab_component():
    """K=2 (one slab) -- the reference's own smoke config uses cva=0.5 scalar
    (src/BayesRv2.cpp:309,315); exercises the K-1==1 shapes in every backend."""
    sim = simulate.simulate_bayesr(seed=77, N=300, M=96, n_causal=12, h2=0.5)
    cva = np.array([0.5])
    results = {}
    for name, backend, perm in [("scan", "scan", None),
                                ("scan-blocked", "scan", "blocked"),
                                ("blocked", "blocked", None)]:
        s = SpikeSlabSampler(sim.X, sim.Y, cva, BayesRConfig(block_size=32),
                             backend=backend, permutation=perm,
                             dtype=jnp.float32)
        st = s.init(jax.random.PRNGKey(0))
        for _ in range(3):
            st = s.step(st)
        results[name] = st
        assert np.isfinite(np.asarray(st.beta)).all()
        assert set(np.unique(np.asarray(st.labels))) <= {0, 1}
    # blocked permutation backends must agree
    np.testing.assert_array_equal(
        np.asarray(results["blocked"].labels),
        np.asarray(results["scan-blocked"].labels))
    np.testing.assert_allclose(np.asarray(results["blocked"].beta),
                               np.asarray(results["scan-blocked"].beta),
                               rtol=2e-4, atol=2e-6)

    # recovery with the single-component prior
    s = SpikeSlabSampler(sim.X, sim.Y, cva, BayesRConfig(block_size=32),
                         dtype=jnp.float64)
    chain = ChainConfig(max_iterations=400, burn_in=200, thinning=2)
    _, out = s.run(jax.random.PRNGKey(1), chain)
    corr = np.corrcoef(sim.beta_true, out["beta"].mean(axis=0))[0, 1]
    assert corr > 0.8


def test_large_nb_rounds_to_8_aligned_block_count():
    """At >=64 blocks Mpad rounds the block count up to a multiple of 8
    (ops/strided.plan_mpad, kept so host pre-padding stays compatible);
    extra padded markers must stay inert."""
    sim = simulate.simulate_bayesr(seed=9, N=120, M=521, n_causal=30, h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=8),
                         backend="blocked", dtype=jnp.float64)
    assert s.Mpad == 576 and s.nb == 72       # ceil(521/8)=66 -> 72 blocks
    st = s.init(jax.random.PRNGKey(0))
    for _ in range(2):
        st = s.step(st)
    beta = np.asarray(st.beta)
    assert np.isfinite(beta).all()
    assert (beta[521:] == 0).all()            # padding never activates
    assert np.asarray(st.labels)[521:].max() == 0
