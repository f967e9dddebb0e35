"""Exact-residual refresh (ChainConfig.eps_refresh_every).

The f32 engine maintains eps by rank-1 updates; refresh_eps recomputes
eps = Y - mu - X beta (- F alpha) with one fresh X pass so long chains
can bound drift (the f64 reference accrues none, src/BayesRv2.cpp:60).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import (BayesRConfig, ChainConfig, GroupsConfig,
                            HorseshoeConfig, HorseshoeSampler,
                            SpikeSlabSampler, simulate)

CVA = np.array([0.001, 0.01, 0.1])


def test_refresh_eps_matches_direct_dense():
    sim = simulate.simulate_bayesr(seed=11, N=200, M=96, n_causal=10,
                                   h2=0.5, n_groups=2, n_fixed=2)
    cva = np.tile(CVA, (2, 1))
    s = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=16),
                         g_assign=sim.g_assign, fixed=sim.fixed,
                         dtype=jnp.float32)
    st = s.init(jax.random.PRNGKey(0))
    for _ in range(3):
        st = s.step(st)
    st_r = s.refresh_eps(st)
    beta = np.asarray(st.beta)[: s.M]
    direct = (sim.Y - float(st.mu) - sim.X @ beta
              - sim.fixed @ np.asarray(st.alpha))
    np.testing.assert_allclose(np.asarray(st_r.eps), direct, atol=1e-4)
    # the refresh must agree with the tracked residual (drift is tiny
    # after 3 iterations)
    np.testing.assert_allclose(np.asarray(st_r.eps), np.asarray(st.eps),
                               atol=1e-3)


def test_refresh_eps_matches_direct_packed_missing():
    rng = np.random.default_rng(13)
    N, M = 200, 96
    dos = rng.integers(0, 3, size=(N, M)).astype(float)
    dos[rng.random((N, M)) < 0.03] = np.nan
    dos[0, :] = 1.0
    means = np.nanmean(dos, 0)
    sds = np.nanstd(dos, 0, ddof=1)
    Xs = np.where(np.isnan(dos), 0.0, (dos - means) / sds)
    Y = Xs[:, 0] * 0.5 + rng.normal(0, 1, N)
    s = SpikeSlabSampler(dos, Y, CVA, BayesRConfig(block_size=16),
                         x_dtype="2bit", dtype=jnp.float32)
    st = s.init(jax.random.PRNGKey(1))
    for _ in range(2):
        st = s.step(st)
    st_r = s.refresh_eps(st)
    beta = np.asarray(st.beta)[: s.M]
    direct = Y - float(st.mu) - Xs @ beta
    n_perm = np.asarray(s.data.n_perm)
    eps_o = np.zeros(s.Npad, np.float32)
    eps_o[n_perm] = np.asarray(st_r.eps)
    np.testing.assert_allclose(eps_o[: s.N], direct, atol=1e-4)
    # pad lanes stay exactly zero
    assert np.all(np.asarray(st_r.eps)[~np.asarray(s.data.row_valid)] == 0)


def test_chain_with_refresh_runs_and_recovers():
    sim = simulate.simulate_bayesr(seed=17, N=400, M=160, n_causal=16,
                                   h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         dtype=jnp.float32)
    chain = ChainConfig(150, 75, 5, eps_refresh_every=20)
    st, out = s.run(jax.random.PRNGKey(7), chain)
    bh = out["beta"].mean(axis=0)
    assert np.corrcoef(sim.beta_true, bh)[0, 1] > 0.8
    # the final state's residual is exact to refresh tolerance
    beta = np.asarray(st.beta)[: s.M]
    direct = sim.Y - float(st.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st.eps), direct, atol=1e-3)


def test_horseshoe_refresh_matches_direct():
    sim = simulate.simulate_bayesr(seed=19, N=200, M=96, n_causal=10,
                                   h2=0.5)
    h = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16),
                         dtype=jnp.float32)
    st = h.init(jax.random.PRNGKey(2))
    for _ in range(3):
        st = h.step(st)
    st_r = h.refresh_eps(st)
    beta = np.asarray(st.beta)[: h.M]
    direct = sim.Y - float(st.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st_r.eps), direct, atol=1e-4)


def test_refresh_chain_batched():
    sim = simulate.simulate_bayesr(seed=23, N=150, M=64, n_causal=8,
                                   h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         dtype=jnp.float32)
    st = jax.vmap(s.init)(jax.random.split(jax.random.PRNGKey(3), 2))
    st = s.step_chains(st)
    st_r = s.refresh_eps(st)
    for c in range(2):
        beta = np.asarray(st.beta)[c, : s.M]
        direct = sim.Y - float(st.mu[c]) - sim.X @ beta
        np.testing.assert_allclose(np.asarray(st_r.eps)[c], direct,
                                   atol=1e-4)


@pytest.mark.slow
def test_sharded_refresh_matches_direct():
    from bayesrrcpp_tpu.parallel.mesh import make_mesh
    from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler

    sim = simulate.simulate_bayesr(seed=29, N=200, M=128, n_causal=10,
                                   h2=0.5)
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, CVA,
                                BayesRConfig(block_size=16),
                                make_mesh(2, 2), dtype=jnp.float32)
    st = s.init(jax.random.PRNGKey(4))
    for _ in range(2):
        st = s.step(st)
    st_r = s.refresh_eps(st)
    beta = np.asarray(st.beta)[: s.M]
    direct = sim.Y - float(st.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st_r.eps)[: s.N], direct,
                               atol=1e-4)
    # chain-batched sharded refresh
    stc = s.init_chains(jax.random.PRNGKey(5), 2)
    stc_r = s.refresh_eps(stc)
    for c in range(2):
        beta = np.asarray(stc.beta)[c, : s.M]
        direct = sim.Y - float(stc.mu[c]) - sim.X @ beta
        np.testing.assert_allclose(np.asarray(stc_r.eps)[c, : s.N], direct,
                                   atol=1e-4)


@pytest.mark.slow
def test_sharded_packed_refresh_matches_direct():
    from bayesrrcpp_tpu.parallel.mesh import make_mesh
    from bayesrrcpp_tpu.parallel.sharded import (ShardedHorseshoeSampler,
                                                 ShardedSpikeSlabSampler)

    rng = np.random.default_rng(31)
    N, M = 200, 128
    dos = rng.integers(0, 3, size=(N, M)).astype(float)
    dos[rng.random((N, M)) < 0.03] = np.nan
    dos[0, :] = 1.0
    means = np.nanmean(dos, 0)
    sds = np.nanstd(dos, 0, ddof=1)
    Xs = np.where(np.isnan(dos), 0.0, (dos - means) / sds)
    Y = Xs[:, 0] * 0.5 + rng.normal(0, 1, N)
    s = ShardedSpikeSlabSampler(dos, Y, CVA, BayesRConfig(block_size=16),
                                make_mesh(2, 1),
                                x_dtype="2bit", dtype=jnp.float32)
    st = s.init(jax.random.PRNGKey(6))
    st = s.step(st)
    st_r = s.refresh_eps(st)
    beta = np.asarray(st.beta)[: s.M]
    direct = Y - float(st.mu) - Xs @ beta
    from bayesrrcpp_tpu.parallel.distributed import replicate
    n_perm = np.asarray(replicate(s.data.n_perm, s.mesh))
    eps_o = np.zeros(s.Npad, np.float32)
    eps_o[n_perm] = np.asarray(st_r.eps)
    np.testing.assert_allclose(eps_o[: s.N], direct, atol=1e-4)

    from bayesrrcpp_tpu import HorseshoeConfig
    h = ShardedHorseshoeSampler(dos, Y, HorseshoeConfig(block_size=16),
                                make_mesh(2, 1),
                                x_dtype="2bit", dtype=jnp.float32)
    hst = h.init(jax.random.PRNGKey(7))
    hst = h.step(hst)
    hst_r = h.refresh_eps(hst)
    beta = np.asarray(hst.beta)[: h.M]
    direct = Y - float(hst.mu) - Xs @ beta
    eps_o = np.zeros(h.Npad, np.float32)
    eps_o[n_perm] = np.asarray(hst_r.eps)
    np.testing.assert_allclose(eps_o[: h.N], direct, atol=1e-4)
