"""Packed eps-layout consistency at Npad > 2048.

Packed storage keeps eps/Y in the ``genotypes._lane_perm`` individual
permutation (GLOBAL plane-major: position k*Nw + w holds individual
16*w + k), and the X pass pairs eps viewed as (16, Nw) with the words'
bit-planes.  Any other pairing silently scrambles the X<->Y association,
and at N = 2048 (one 2048-lane tile) several wrong layouts coincide with
the right one.  These tests pin the invariant that exposes a mispairing --
the tracked eps must equal the exact residual recompute
eps = Y - mu - X beta -- at N = 4096, across J and storage cases.  A
mispairing shows up as O(1) relative error after one iteration; genuine
f32 rank-1 drift is ~1e-6 over these chain lengths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import (BayesRConfig, HorseshoeConfig, HorseshoeSampler,
                            SpikeSlabSampler)
from bayesrrcpp_tpu.simulate import (packed_word_stats, random_packed_words,
                                     random_packed_words_missing)

CVA = np.array([0.0001, 0.001, 0.01])
N, M = 4096, 2048


def _packed_inputs(seed, missing=False, signal=False):
    key = jax.random.PRNGKey(seed)
    kx, kc, kb = jax.random.split(key, 3)
    gen = random_packed_words_missing if missing else random_packed_words
    XT = gen(kx, M, N // 16)
    if signal:
        from bayesrrcpp_tpu.ops.genotypes import xbeta_packed

        means, sds = packed_word_stats(M)
        bt = jnp.zeros((M,), jnp.float32).at[
            jax.random.choice(kb, M, (32,), replace=False)].set(0.25)
        g = xbeta_packed(XT, jnp.asarray(means, jnp.float32),
                         jnp.asarray(1.0 / sds, jnp.float32), bt, 256, N)
        Y = g + jax.random.normal(kc, (N,), jnp.float32) * 0.7
        return XT, Y, np.asarray(bt)
    return XT, jax.random.normal(kc, (N,), jnp.float32), None


def _rel_eps_err(smp, st):
    ex = smp.refresh_eps(st)
    num = float(jnp.linalg.norm((st.eps - ex.eps).astype(jnp.float32)))
    den = float(jnp.linalg.norm(ex.eps.astype(jnp.float32)))
    return num / max(den, 1e-30)


@pytest.mark.parametrize("jb,missing", [
    (None, False),   # auto plan: J=8 blocks of 32
    (None, True),    # exact decode of missing calls
    (4, False),
    (4, True),
    (1, False),      # serial anchor
])
def test_bayesr_packed_eps_consistent_4096(jb, missing):
    XT, Y, _ = _packed_inputs(3, missing=missing)
    smp = SpikeSlabSampler(XT, Y, CVA, BayesRConfig(block_size=256),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M),
                           dtype=jnp.float32, jacobi_blocks=jb)
    st = smp.init(jax.random.PRNGKey(1))
    st = smp._run_steps(st, smp.data, 3)
    assert _rel_eps_err(smp, st) < 1e-4


@pytest.mark.parametrize("missing", [False, True])
def test_horseshoe_packed_eps_consistent_4096(missing):
    XT, Y, _ = _packed_inputs(5, missing=missing)
    smp = HorseshoeSampler(XT, Y, HorseshoeConfig(block_size=256),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M),
                           dtype=jnp.float32)
    st = smp.init(jax.random.PRNGKey(2))
    st = smp._run_steps(st, smp.data, 3)
    assert _rel_eps_err(smp, st) < 1e-4


@pytest.mark.parametrize("C", [2, 8])
def test_bayesr_packed_mc_eps_consistent_4096(C):
    XT, Y, _ = _packed_inputs(7)
    smp = SpikeSlabSampler(XT, Y, CVA, BayesRConfig(block_size=256),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M),
                           dtype=jnp.float32, jacobi_blocks=4)
    st = jax.vmap(smp.init)(jax.random.split(jax.random.PRNGKey(3), C))
    for _ in range(2):
        st = smp.step_chains(st)
    assert _rel_eps_err(smp, st) < 1e-4


def test_hs_packed_mc8_eps_consistent_4096():
    XT, Y, _ = _packed_inputs(9)
    smp = HorseshoeSampler(XT, Y, HorseshoeConfig(block_size=256),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M),
                           dtype=jnp.float32, jacobi_blocks=4)
    st = jax.vmap(smp.init)(jax.random.split(jax.random.PRNGKey(4), 8))
    for _ in range(2):
        st = smp.step_chains(st)
    assert _rel_eps_err(smp, st) < 1e-4


def test_sharded_packed_eps_consistent_4096():
    from bayesrrcpp_tpu.parallel.mesh import make_mesh
    from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler

    XT, Y, _ = _packed_inputs(11)
    smp = ShardedSpikeSlabSampler(XT, Y, CVA, BayesRConfig(block_size=256),
                                  make_mesh(2, 1),
                                  transposed=True, dtype=jnp.float32,
                                  x_dtype="2bit", has_missing=False,
                                  x_stats=packed_word_stats(M))
    st = smp.init(jax.random.PRNGKey(5))
    for _ in range(2):
        st = smp.step(st)
    assert _rel_eps_err(smp, st) < 1e-4


@pytest.mark.slow
def test_packed_t_signal_recovery_4096():
    """End-to-end statistical validity past the 2048-lane boundary: with
    a mispaired layout the X<->Y association is destroyed and the sampler
    recovers nothing; the planted signal must come back through the auto
    plan at N=4096."""
    XT, Y, bt = _packed_inputs(13, signal=True)
    smp = SpikeSlabSampler(XT, Y, CVA, BayesRConfig(block_size=256),
                           transposed=True, x_dtype="2bit",
                           x_stats=packed_word_stats(M),
                           dtype=jnp.float32)
    assert smp.jacobi > 1        # a Jacobi plan, not the J=1 anchor
    st = smp.init(jax.random.PRNGKey(6))
    st = smp._run_steps(st, smp.data, 60)
    bhat = np.zeros(M)
    for _ in range(40):
        st = smp._run_steps(st, smp.data, 1)
        bhat += np.asarray(st.beta)[:M] / 40.0
    corr = np.corrcoef(bhat, bt)[0, 1]
    assert corr > 0.8, f"posterior-mean beta lost the signal (corr={corr:.3f})"
