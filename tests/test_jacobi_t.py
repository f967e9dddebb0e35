"""Strided-rounds sweep (ops/strided.py) against its plain references.

Exactness strategy: the strided sweep sweeps the SAME marker partition as
the plain block-Jacobi oracle (ops/block_sweep.bayesr_jacobi_sweep) run with
``block_order = strided_border(rho, J)``, and both read the position-indexed
p/z streams in visit order, so the oracle pins it exactly: labels and v
bit-equal, floats to reassociation tolerance.

The chain axis must equal C independent single-chain sweeps with the same
per-chain streams (labels and v exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import BayesRConfig, ChainConfig, HorseshoeConfig, \
    HorseshoeSampler, SpikeSlabSampler, simulate
from bayesrrcpp_tpu.ops import block_sweep as bs
from bayesrrcpp_tpu.ops.strided import (bayesr_strided_sweep,
                                        horseshoe_strided_sweep, jacobi_plan,
                                        planned_mpad)
from test_jacobi import _hs_sweep_args, _nomissing_dosage, _sweep_args, CVA

_E = jnp.zeros((0,))


def _dense(XT):
    return (XT, _E, _E, _E)


def _ss(XT, gram, xsq, eps, beta, labels, rho, inner, p, z, pi, cva,
        sigmaE, sigmaGG, gas, valid, J):
    """Single-chain strided sweep on dense X."""
    out = bayesr_strided_sweep(
        _dense(XT), gram, xsq, eps[None], beta[None], labels[None], rho,
        inner, p[None], z[None], pi[None], cva, sigmaE[None],
        sigmaGG[None], gas, valid, J=J)
    return jax.tree.map(lambda a: a[0], out)


def _hs(XT, gram, xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE,
        valid, J):
    e, b = horseshoe_strided_sweep(
        _dense(XT), gram, xsq, eps[None], beta[None], rho, inner, z[None],
        lam[None], tau[None], c2[None], sigmaE[None], valid, J=J)
    return e[0], b[0]


@pytest.mark.parametrize("J,G,B,M", [(1, 1, 16, 128), (4, 1, 16, 128),
                                     (2, 3, 16, 128), (16, 2, 8, 256)])
def test_t_kernel_equals_oracle(J, G, B, M):
    args = list(_sweep_args(21 + J, N=96, M=M, B=B, G=G))
    nb = M // B
    rho, inner = bs.strided_orders(jax.random.PRNGKey(7 + J), nb, B, J)
    args_o = list(args)
    args_o[6], args_o[7] = bs.strided_border(rho, J), inner
    ref = bs.bayesr_jacobi_sweep(*args_o, J=J)
    out = _ss(*(args[:6] + [rho, inner] + args[8:]), J=J)
    np.testing.assert_array_equal(np.asarray(ref.labels),
                                  np.asarray(out.labels))
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(out.beta),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ref.eps), np.asarray(out.eps),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ref.v), np.asarray(out.v))
    np.testing.assert_allclose(np.asarray(ref.beta_acum),
                               np.asarray(out.beta_acum), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("J", [2, 8])
def test_hs_t_kernel_equals_oracle(J):
    args = list(_hs_sweep_args(51 + J, N=96, M=128, B=16))
    rho, inner = bs.strided_orders(jax.random.PRNGKey(3 + J), 8, 16, J)
    args_o = list(args)
    args_o[5], args_o[6] = bs.strided_border(rho, J), inner
    eps_r, beta_r = bs.horseshoe_jacobi_sweep(*args_o, J=J)
    eps_o, beta_o = _hs(*(args[:5] + [rho, inner] + args[7:]), J=J)
    np.testing.assert_allclose(np.asarray(beta_r), np.asarray(beta_o),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(eps_r), np.asarray(eps_o),
                               rtol=2e-4, atol=2e-5)


def _mc_args(seed, N, M, B, G, C):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    eps = jnp.asarray(rng.standard_normal((C, N)).astype(np.float32))
    beta = jnp.zeros((C, M), jnp.float32).at[:, 3].set(0.25)
    labels = jnp.zeros((C, M), jnp.int32).at[:, 3].set(2)
    p = jnp.asarray(rng.uniform(0, 1, (C, M)).astype(np.float32))
    z = jnp.asarray(rng.normal(0, 1, (C, M)).astype(np.float32))
    pi = jnp.asarray(rng.dirichlet([5, 2, 2, 1], (C, G)).astype(np.float32))
    cva = jnp.tile(jnp.asarray([[0.001, 0.01, 0.1]], jnp.float32), (G, 1))
    sigmaE = jnp.asarray(rng.uniform(0.5, 1.0, C).astype(np.float32))
    sigmaGG = jnp.asarray(rng.uniform(0.02, 0.1, (C, G)).astype(np.float32))
    gas = jnp.asarray(np.arange(M) % G, jnp.int32)
    valid = jnp.ones(M, bool)
    return (XT, gram, xsq, eps, beta, labels, p, z, pi, cva, sigmaE,
            sigmaGG, gas, valid)


@pytest.mark.parametrize("J,G,C", [(4, 1, 2), (2, 3, 4)])
def test_mc_t_equals_single_chain_runs(J, G, C):
    """The chain axis == C independent single-chain sweeps with the same
    streams (labels/v exact)."""
    (XT, gram, xsq, eps, beta, labels, p, z, pi, cva, sigmaE,
     sigmaGG, gas, valid) = _mc_args(11 + J + C, 96, 128, 16, G, C)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(9 + J), 8, 16, J)
    out = bayesr_strided_sweep(
        _dense(XT), gram, xsq, eps, beta, labels, rho, inner, p, z,
        pi, cva, sigmaE, sigmaGG, gas, valid, J=J)
    for c in range(C):
        ref = _ss(XT, gram, xsq, eps[c], beta[c], labels[c], rho, inner,
                  p[c], z[c], pi[c], cva, sigmaE[c], sigmaGG[c], gas, valid,
                  J=J)
        np.testing.assert_array_equal(np.asarray(ref.labels),
                                      np.asarray(out.labels[c]))
        np.testing.assert_allclose(np.asarray(ref.beta),
                                   np.asarray(out.beta[c]),
                                   rtol=3e-4, atol=3e-6)
        np.testing.assert_allclose(np.asarray(ref.eps),
                                   np.asarray(out.eps[c]),
                                   rtol=3e-4, atol=3e-5)
        np.testing.assert_array_equal(np.asarray(ref.v),
                                      np.asarray(out.v[c]))


@pytest.mark.slow
def test_mc_t_group_split_equals_single_runs():
    """C=8 chains must equal 8 independent runs."""
    C, J, G = 8, 8, 2
    (XT, gram, xsq, eps, beta, labels, p, z, pi, cva, sigmaE,
     sigmaGG, gas, valid) = _mc_args(77, 96, 256, 8, G, C)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(17), 32, 8, J)
    out = bayesr_strided_sweep(
        _dense(XT), gram, xsq, eps, beta, labels, rho, inner, p, z,
        pi, cva, sigmaE, sigmaGG, gas, valid, J=J)
    for c in range(C):
        ref = _ss(XT, gram, xsq, eps[c], beta[c], labels[c], rho, inner,
                  p[c], z[c], pi[c], cva, sigmaE[c], sigmaGG[c], gas, valid,
                  J=J)
        np.testing.assert_array_equal(np.asarray(ref.labels),
                                      np.asarray(out.labels[c]))
        np.testing.assert_allclose(np.asarray(ref.beta),
                                   np.asarray(out.beta[c]),
                                   rtol=3e-4, atol=3e-6)


@pytest.mark.slow
@pytest.mark.parametrize("x_dtype", ["int8", "2bit"])
def test_t_fold_quantized_equals_dense(x_dtype):
    """Folded quantized sweep == dense sweep (same chain keys)."""
    dosage, dense, y = _nomissing_dosage(41, 150, 96)
    cfg = BayesRConfig(block_size=16)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype=x_dtype,
                           dtype=jnp.float32, jacobi_blocks=3)
    assert s_q._x_fold
    key = jax.random.PRNGKey(42)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(float(st_d.sigmaE), float(st_q.sigmaE),
                               rtol=2e-4)


@pytest.mark.slow
def test_mc_t_fold_quantized_equals_dense():
    """Fused multi-chain folded 2-bit == dense, through step_chains."""
    dosage, dense, y = _nomissing_dosage(41, 150, 96)
    cfg = BayesRConfig(block_size=16)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    C = 3
    ks = jax.random.split(jax.random.PRNGKey(42), C)
    st_d = jax.vmap(s_d.init)(ks)
    st_q = jax.vmap(s_q.init)(ks)
    for _ in range(3):
        st_d, st_q = s_d.step_chains(st_d), s_q.step_chains(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)


@pytest.mark.slow
def test_hs_t_fold_quantized_equals_dense():
    dosage, dense, y = _nomissing_dosage(43, 150, 96)
    cfg = HorseshoeConfig(block_size=16)
    h_d = HorseshoeSampler(dense, y, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    h_q = HorseshoeSampler(dosage, y, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    assert h_q._x_fold
    key = jax.random.PRNGKey(44)
    st_d, st_q = h_d.init(key), h_q.init(key)
    for _ in range(3):
        st_d, st_q = h_d.step(st_d), h_q.step(st_q)
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(float(st_d.sigmaE), float(st_q.sigmaE),
                               rtol=2e-4)


@pytest.mark.slow
def test_t_sampler_recovery():
    """Statistical validation of the strided-rounds Markov kernel: effect
    recovery on the embedded-smoke recipe (src/BayesRv2.cpp:298-315
    scaled down), the standard the sharded block-Jacobi sampler is held
    to."""
    sim = simulate.simulate_bayesr(seed=77, N=400, M=160, n_causal=16,
                                   h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         dtype=jnp.float32, jacobi_blocks=5)
    _, out = s.run(jax.random.PRNGKey(7), ChainConfig(150, 75, 5))
    bh = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, bh)[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()


def test_auto_jacobi_plan_selection():
    """Pin the auto plan at the shapes that matter, so a selection change
    is visible in review."""
    # biobank headline M: J=128 blocks of 32, a 4096-marker window
    assert jacobi_plan(503_808, 512) == (128, 32)
    # dense bench shape
    assert jacobi_plan(49_152, 512) == (128, 32)
    # one slice of the 4-card config 5 (M=1M over 4): padding unavoidable
    assert jacobi_plan(250_000, 512) == (128, 32)
    # vignette scale: padding unavoidable, largest window under M/8
    assert jacobi_plan(10_000, 512) == (32, 32)
    # tiny M: no window -> J=1 (exact sequential) at the caller's B
    assert jacobi_plan(96, 128) == (1, 128)


def test_strided_border_is_permutation():
    rho, inner = bs.strided_orders(jax.random.PRNGKey(0), 24, 8, 4)
    border = np.asarray(bs.strided_border(rho, 4))
    assert sorted(border.tolist()) == list(range(24))
    inn = np.asarray(inner)
    assert inn.shape == (24, 8)
    assert all(sorted(r.tolist()) == list(range(8)) for r in inn)


def test_planned_mpad_matches_sampler():
    """Drift guard: planned_mpad (used by host loaders to pre-pad packed
    words) must equal the Mpad the auto-plan sampler actually picks."""
    rng = np.random.default_rng(0)
    for M in (96, 100, 1024, 2048, 10_000, 49_152):
        N = 64
        X = rng.standard_normal((N, M)).astype(np.float32)
        Y = rng.standard_normal(N).astype(np.float32)
        s = SpikeSlabSampler(X, Y, CVA, BayesRConfig(), dtype=jnp.float32)
        assert s.Mpad == planned_mpad(M), (M, s.Mpad, planned_mpad(M))


@pytest.mark.parametrize("C", [2, 4])
def test_hs_mc_t_equals_single_chain_runs(C):
    """Multi-chain horseshoe sweep == C independent single-chain runs."""
    rng = np.random.default_rng(23 + C)
    N, M, B, J = 96, 128, 16, 4
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    eps = jnp.asarray(rng.standard_normal((C, N)).astype(np.float32))
    beta = jnp.zeros((C, M), jnp.float32).at[:, 3].set(0.25)
    z = jnp.asarray(rng.normal(0, 1, (C, M)).astype(np.float32))
    lam = jnp.asarray(rng.uniform(0.1, 2.0, (C, M)).astype(np.float32))
    tau = jnp.asarray(rng.uniform(0.01, 0.1, C).astype(np.float32))
    c2 = jnp.asarray(rng.uniform(1.0, 2.0, C).astype(np.float32))
    sigmaE = jnp.asarray(rng.uniform(0.5, 1.0, C).astype(np.float32))
    valid = jnp.ones(M, bool)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(13), M // B, B, J)
    eps_o, beta_o = horseshoe_strided_sweep(
        _dense(XT), gram, xsq, eps, beta, rho, inner, z, lam, tau, c2,
        sigmaE, valid, J=J)
    for c in range(C):
        e_r, b_r = _hs(XT, gram, xsq, eps[c], beta[c], rho, inner, z[c],
                       lam[c], tau[c], c2[c], sigmaE[c], valid, J=J)
        np.testing.assert_allclose(np.asarray(b_r), np.asarray(beta_o[c]),
                                   rtol=3e-4, atol=3e-6)
        np.testing.assert_allclose(np.asarray(e_r), np.asarray(eps_o[c]),
                                   rtol=3e-4, atol=3e-5)


# ------------------------------------------------------ missing calls

def _missing_dosage(seed, N, M, frac=0.03):
    """Dosage matrix with sparse NaN missing calls plus its exact dense
    equivalent (standardized, missing -> 0 = mean imputation -- the same
    decode the X pass applies)."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.2, 0.8, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    mask = rng.random(dosage.shape) < frac
    mask[0, :] = False  # keep every marker observed at least once
    dosage[mask] = np.nan
    means = np.nanmean(dosage, axis=0)
    sds = np.nanstd(dosage, axis=0, ddof=1)
    dense = np.where(np.isnan(dosage), 0.0, (dosage - means) / sds)
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = dense @ beta_t + rng.normal(0, 0.7, N)
    return dosage, dense, y


@pytest.mark.slow
@pytest.mark.parametrize("jacobi", [1, 3])
def test_t_missing_packed_equals_dense(jacobi):
    """2-bit packed X WITH missing calls must equal the dense sampler on
    the exact mean-imputed standardized matrix, at J=1 and J>1."""
    dosage, dense, y = _missing_dosage(83, 150, 96)
    cfg = BayesRConfig(block_size=16)
    kw = {"jacobi_blocks": jacobi}
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32, **kw)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32, **kw)
    assert not s_q._x_fold
    assert s_q.jacobi == jacobi  # no silent fallback to J=1
    key = jax.random.PRNGKey(42)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(float(st_d.sigmaE), float(st_q.sigmaE),
                               rtol=2e-4)
    # eps pad lanes must stay exactly zero (miss mode: pads decode to 0)
    pad_lanes = ~np.asarray(s_q.data.row_valid)
    assert np.all(np.asarray(st_q.eps)[pad_lanes] == 0.0)


@pytest.mark.slow
def test_mc_t_missing_packed_equals_dense():
    """Fused multi-chain sweep with packed-missing X == dense, through
    step_chains (supports_fused_chains includes missing calls)."""
    dosage, dense, y = _missing_dosage(85, 150, 96)
    cfg = BayesRConfig(block_size=16)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    assert s_q.supports_fused_chains
    C = 3
    ks = jax.random.split(jax.random.PRNGKey(47), C)
    st_d = jax.vmap(s_d.init)(ks)
    st_q = jax.vmap(s_q.init)(ks)
    for _ in range(3):
        st_d, st_q = s_d.step_chains(st_d), s_q.step_chains(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)


@pytest.mark.slow
def test_hs_t_missing_packed_equals_dense():
    dosage, dense, y = _missing_dosage(87, 150, 96)
    cfg = HorseshoeConfig(block_size=16)
    h_d = HorseshoeSampler(dense, y, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    h_q = HorseshoeSampler(dosage, y, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    assert not h_q._x_fold and h_q.jacobi == 3
    key = jax.random.PRNGKey(48)
    st_d, st_q = h_d.init(key), h_q.init(key)
    for _ in range(3):
        st_d, st_q = h_d.step(st_d), h_q.step(st_q)
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(float(st_d.sigmaE), float(st_q.sigmaE),
                               rtol=2e-4)


@pytest.mark.slow
def test_hs_mc_t_missing_packed_equals_dense():
    dosage, dense, y = _missing_dosage(89, 150, 96)
    cfg = HorseshoeConfig(block_size=16)
    h_d = HorseshoeSampler(dense, y, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    h_q = HorseshoeSampler(dosage, y, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    assert h_q.supports_fused_chains
    C = 2
    ks = jax.random.split(jax.random.PRNGKey(51), C)
    st_d = jax.vmap(h_d.init)(ks)
    st_q = jax.vmap(h_q.init)(ks)
    for _ in range(3):
        st_d, st_q = h_d.step_chains(st_d), h_q.step_chains(st_q)
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("frac_missing", [0.0, 0.03])
def test_mc8_wide_packed_equals_dense(frac_missing):
    """C=8 fused chains (one X read per round for all chains) must equal
    the dense sampler, in both folded and missing modes."""
    if frac_missing:
        dosage, dense, y = _missing_dosage(91, 150, 96, frac=frac_missing)
    else:
        dosage, dense, y = _nomissing_dosage(91, 150, 96)
    cfg = BayesRConfig(block_size=16)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    C = 8
    ks = jax.random.split(jax.random.PRNGKey(53), C)
    st_d = jax.vmap(s_d.init)(ks)
    st_q = jax.vmap(s_q.init)(ks)
    for _ in range(2):
        st_d, st_q = s_d.step_chains(st_d), s_q.step_chains(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(st_d.sigmaE),
                               np.asarray(st_q.sigmaE), rtol=2e-4)


@pytest.mark.slow
def test_hs_mc8_wide_equals_single_runs():
    """C=8 fused horseshoe chains == 8 independent single-chain runs."""
    rng = np.random.default_rng(61)
    N, M, B, J, C = 96, 256, 8, 8, 8
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    eps = jnp.asarray(rng.standard_normal((C, N)).astype(np.float32))
    beta = jnp.zeros((C, M), jnp.float32).at[:, 3].set(0.25)
    z = jnp.asarray(rng.normal(0, 1, (C, M)).astype(np.float32))
    lam = jnp.asarray(rng.uniform(0.1, 2.0, (C, M)).astype(np.float32))
    tau = jnp.asarray(rng.uniform(0.01, 0.1, C).astype(np.float32))
    c2 = jnp.asarray(rng.uniform(1.0, 2.0, C).astype(np.float32))
    sigmaE = jnp.asarray(rng.uniform(0.5, 1.0, C).astype(np.float32))
    valid = jnp.ones(M, bool)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(29), M // B, B, J)
    eps_o, beta_o = horseshoe_strided_sweep(
        _dense(XT), gram, xsq, eps, beta, rho, inner, z, lam, tau, c2,
        sigmaE, valid, J=J)
    for c in range(C):
        e_r, b_r = _hs(XT, gram, xsq, eps[c], beta[c], rho, inner, z[c],
                       lam[c], tau[c], c2[c], sigmaE[c], valid, J=J)
        np.testing.assert_allclose(np.asarray(b_r), np.asarray(beta_o[c]),
                                   rtol=3e-4, atol=3e-6)
        np.testing.assert_allclose(np.asarray(e_r), np.asarray(eps_o[c]),
                                   rtol=3e-4, atol=3e-5)


@pytest.mark.slow
def test_hs_mc8_wide_packed_equals_dense():
    """C=8 fused horseshoe chains, packed and folded, through
    step_chains == dense."""
    dosage, dense, y = _nomissing_dosage(95, 150, 96)
    cfg = HorseshoeConfig(block_size=16)
    h_d = HorseshoeSampler(dense, y, cfg, dtype=jnp.float32,
                           jacobi_blocks=3)
    h_q = HorseshoeSampler(dosage, y, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    C = 8
    ks = jax.random.split(jax.random.PRNGKey(59), C)
    st_d = jax.vmap(h_d.init)(ks)
    st_q = jax.vmap(h_q.init)(ks)
    for _ in range(2):
        st_d, st_q = h_d.step_chains(st_d), h_q.step_chains(st_q)
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-5)
