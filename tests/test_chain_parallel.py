"""Chains-over-devices (parallel/chains.py) on the virtual 8-device mesh.

Shard g of a chain-parallel run must reproduce an UNSHARDED fused
multi-chain run over that shard's key slice exactly (chains never interact
and each shard's marker order comes from its first local chain).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import BayesRConfig, ChainConfig, SpikeSlabSampler, simulate
from bayesrrcpp_tpu.parallel.chains import ChainParallelRunner, chain_mesh


def test_chain_parallel_matches_per_shard_fused():
    sim = simulate.simulate_bayesr(seed=91, N=160, M=64, n_causal=8, h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, np.array([0.001, 0.01, 0.1]),
                         BayesRConfig(block_size=32),
                         dtype=jnp.float32)
    mesh = chain_mesh(2)
    runner = ChainParallelRunner(s, mesh)

    key = jax.random.PRNGKey(5)
    n_chains, D = 4, 2
    state = runner.init(key, n_chains)
    state = runner._steps(state, s.data, 2)
    beta_sh = np.asarray(state.beta)          # (4, Mpad)

    # reference: unsharded fused runs over each shard's key slice
    keys = jax.random.split(key, n_chains)
    for g in range(D):
        sl = slice(g * 2, (g + 1) * 2)
        st = jax.vmap(s.init)(keys[sl])
        for _ in range(2):
            st = s.step_chains(st)
        np.testing.assert_allclose(beta_sh[sl], np.asarray(st.beta),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"shard {g} diverged")


@pytest.mark.slow
def test_chain_parallel_full_run():
    sim = simulate.simulate_bayesr(seed=92, N=200, M=64, n_causal=8, h2=0.6)
    s = SpikeSlabSampler(sim.X, sim.Y, np.array([0.001, 0.01, 0.1]),
                         BayesRConfig(block_size=32),
                         dtype=jnp.float32)
    runner = ChainParallelRunner(s, chain_mesh(4))
    _, out = runner.run(jax.random.PRNGKey(6), 8, ChainConfig(40, 20, 4))
    beta = np.asarray(out["beta"])            # (emits, 8, M)
    assert beta.shape[1] == 8
    assert np.isfinite(beta).all()
    assert not np.allclose(beta[:, 0], beta[:, 5])
