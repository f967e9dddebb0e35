"""Strided sweep on quantized storage vs the plain oracle on decoded X.

The strided sweep (ops/strided.py) decodes int8 codes or 2-bit words in its
X pass (ops/xpass.py); the plain block-Jacobi oracle
(ops/block_sweep.bayesr_jacobi_sweep) runs on the decoded f32 matrix in
original individual order.  Both use the same Gram blocks, so labels must
match exactly and floats to reassociation tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import BayesRConfig, ChainConfig, GroupsConfig, \
    HorseshoeConfig, HorseshoeSampler, SpikeSlabSampler, simulate
from bayesrrcpp_tpu.ops import block_sweep as bs
from bayesrrcpp_tpu.ops import genotypes
from bayesrrcpp_tpu.ops.strided import (bayesr_strided_sweep,
                                        horseshoe_strided_sweep)

CVA = np.array([0.001, 0.01, 0.1])


def _sweep_args(seed, N, M, B, G=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    nb = M // B
    eps = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    beta = jnp.zeros(M, jnp.float32).at[3].set(0.25)
    labels = jnp.zeros(M, jnp.int32).at[3].set(2)
    border, inner = bs.block_orders(jax.random.PRNGKey(seed), nb, B)
    p = jax.random.uniform(jax.random.PRNGKey(seed + 1), (M,), jnp.float32)
    z = jax.random.normal(jax.random.PRNGKey(seed + 2), (M,), jnp.float32)
    pi = jnp.tile(jnp.asarray([[0.5, 0.2, 0.2, 0.1]], jnp.float32), (G, 1))
    cva = jnp.tile(jnp.asarray([CVA], jnp.float32), (G, 1))
    sigmaE = jnp.float32(0.8)
    sigmaGG = jnp.linspace(0.03, 0.08, G).astype(jnp.float32)
    gas = jnp.asarray(np.arange(M) % G, jnp.int32)
    valid = jnp.ones(M, bool)
    return (XT, gram, xsq, eps, beta, labels, border, inner, p, z,
            pi, cva, sigmaE, sigmaGG, gas, valid)


class _Stored:
    """Quantized storage of a random dosage matrix, its exact decoded f32
    equivalent (original individual order) and the lane permutation."""

    def __init__(self, seed, N, M, B, x_dtype, missing):
        rng = np.random.default_rng(seed)
        dos = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
            float)
        if missing:
            dos[rng.random(dos.shape) < 0.05] = np.nan
            dos[0] = 1.0
        if x_dtype == "2bit":
            q = genotypes.quantize_packed(dos, False, None, B, M, N,
                                          prepacked=False)
            self.perm = np.asarray(q.n_perm)
        else:
            q = genotypes.quantize_int8(dos, False, None, B, M)
            self.perm = np.arange(N)
        self.q, self.kind, self.N = q, x_dtype, N
        self.fold = not q.has_missing
        assert self.fold == (not missing)
        m, sc = np.asarray(q.x_mean), np.asarray(q.x_scale)
        x = np.where(np.isnan(dos), 0.0, (dos - m) * sc)
        self.XT = jnp.asarray(x.T, jnp.float32)              # (M, N)

    def xs(self):
        q = self.q
        return (q.XT, q.x_mean, q.x_scale, q.row_valid)

    def to_store(self, eps):
        """(N,) original order -> stored lanes (padded, permuted)."""
        out = np.zeros(self.q.Npad, np.float32)
        out[: self.N] = eps
        return jnp.asarray(out[self.perm])

    def from_store(self, eps):
        out = np.zeros(self.q.Npad, np.float32)
        out[self.perm] = np.asarray(eps)
        return out[: self.N]


def _stored_args(st, seed, B, G):
    M = st.XT.shape[0]
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(st.N).astype(np.float32)
    beta = jnp.zeros(M, jnp.float32).at[3].set(0.25)
    labels = jnp.zeros(M, jnp.int32).at[3].set(2)
    p = jax.random.uniform(jax.random.PRNGKey(seed + 1), (M,), jnp.float32)
    z = jax.random.normal(jax.random.PRNGKey(seed + 2), (M,), jnp.float32)
    pi = jnp.tile(jnp.asarray([[0.5, 0.2, 0.2, 0.1]], jnp.float32), (G, 1))
    cva = jnp.tile(jnp.asarray([CVA], jnp.float32), (G, 1))
    gas = jnp.asarray(np.arange(M) % G, jnp.int32)
    return (eps, beta, labels, p, z, pi, cva, jnp.float32(0.8),
            jnp.linspace(0.03, 0.08, G).astype(jnp.float32), gas,
            jnp.ones(M, bool))


@pytest.mark.parametrize("J,G", [(4, 1), (2, 3), (8, 1)])
def test_jacobi_kernel_equals_oracle(J, G):
    """2-bit words (folded when G == 1, with missing calls otherwise) vs
    the oracle on the decoded matrix."""
    B, M = 16, 128
    st = _Stored(21 + J, 150, M, B, "2bit", missing=G > 1)
    eps, beta, labels, p, z, pi, cva, sE, sGG, gas, valid = _stored_args(
        st, 21 + J, B, G)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(J), M // B, B, J)
    ref = bs.bayesr_jacobi_sweep(
        st.XT, st.q.gram, st.q.xsq, jnp.asarray(eps), beta, labels,
        bs.strided_border(rho, J), inner, p, z, pi, cva, sE, sGG, gas, valid,
        J=J)
    out = bayesr_strided_sweep(
        st.xs(), st.q.gram, st.q.xsq, st.to_store(eps)[None], beta[None],
        labels[None], rho, inner, p[None], z[None], pi[None], cva, sE[None],
        sGG[None], gas, valid, J=J, kind=st.kind, fold=st.fold)
    np.testing.assert_array_equal(np.asarray(ref.labels),
                                  np.asarray(out.labels[0]))
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(out.beta[0]),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ref.eps), st.from_store(out.eps[0]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ref.v), np.asarray(out.v[0]))
    np.testing.assert_allclose(np.asarray(ref.beta_acum),
                               np.asarray(out.beta_acum[0]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("missing", [False, True])
def test_jacobi_j1_equals_blocked(missing):
    """int8 codes at J=1 (sequential block order) must equal the plain
    blocked sweep on the decoded matrix."""
    B, M = 16, 96
    st = _Stored(31, 80, M, B, "int8", missing=missing)
    eps, beta, labels, p, z, pi, cva, sE, sGG, gas, valid = _stored_args(
        st, 31, B, 1)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(3), M // B, B, 1)
    ref = bs.bayesr_block_sweep(
        st.XT, st.q.gram, st.q.xsq, jnp.asarray(eps), beta, labels, rho,
        inner, p, z, pi, cva, sE, sGG, gas, valid)
    out = bayesr_strided_sweep(
        st.xs(), st.q.gram, st.q.xsq, st.to_store(eps)[None], beta[None],
        labels[None], rho, inner, p[None], z[None], pi[None], cva, sE[None],
        sGG[None], gas, valid, J=1, kind=st.kind, fold=st.fold)
    np.testing.assert_array_equal(np.asarray(ref.labels),
                                  np.asarray(out.labels[0]))
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(out.beta[0]),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ref.eps), st.from_store(out.eps[0]),
                               rtol=2e-4, atol=2e-5)


def _nomissing_dosage(seed, N, M):
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.2, 0.8, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    means = dosage.mean(axis=0)
    sds = dosage.std(axis=0, ddof=1)
    dense = (dosage - means) / sds
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = dense @ beta_t + rng.normal(0, 0.7, N)
    return dosage, dense, y


@pytest.mark.parametrize("x_dtype", ["int8", "2bit"])
@pytest.mark.slow
def test_jacobi_fold_quantized_equals_dense(x_dtype):
    """Folded quantized Jacobi == dense Jacobi (same chain keys)."""
    dosage, dense, y = _nomissing_dosage(41, 150, 96)
    cfg = BayesRConfig(block_size=16)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg,
                           dtype=jnp.float32, jacobi_blocks=3)
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
def test_jacobi_sampler_recovery():
    """Statistical validation of the J>1 Markov kernel: effect recovery on
    the embedded-smoke recipe (src/BayesRv2.cpp:298-315 scaled down),
    matching the standard the sharded block-Jacobi sampler is held to."""
    sim = simulate.simulate_bayesr(seed=77, N=400, M=160, n_causal=16,
                                   h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=16),
                         dtype=jnp.float32, jacobi_blocks=5)
    _, out = s.run(jax.random.PRNGKey(7), ChainConfig(150, 75, 5))
    bh = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, bh)[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()


def _hs_sweep_args(seed, N, M, B):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    nb = M // B
    eps = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    beta = jnp.zeros(M, jnp.float32).at[3].set(0.25)
    border, inner = bs.block_orders(jax.random.PRNGKey(seed), nb, B)
    z = jax.random.normal(jax.random.PRNGKey(seed + 2), (M,), jnp.float32)
    lam = jnp.asarray(rng.uniform(0.1, 2.0, M).astype(np.float32))
    tau = jnp.float32(0.05)
    c2 = jnp.float32(1.5)
    sigmaE = jnp.float32(0.8)
    valid = jnp.ones(M, bool)
    return (XT, gram, xsq, eps, beta, border, inner, z,
            lam, tau, c2, sigmaE, valid)


def _hs_stored_args(st, seed):
    M = st.XT.shape[0]
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(st.N).astype(np.float32)
    beta = jnp.zeros(M, jnp.float32).at[3].set(0.25)
    z = jax.random.normal(jax.random.PRNGKey(seed + 2), (M,), jnp.float32)
    lam = jnp.asarray(rng.uniform(0.1, 2.0, M).astype(np.float32))
    return (eps, beta, z, lam, jnp.float32(0.05), jnp.float32(1.5),
            jnp.float32(0.8), jnp.ones(M, bool))


def _hs_check(st, J, seed, B):
    M = st.XT.shape[0]
    eps, beta, z, lam, tau, c2, sE, valid = _hs_stored_args(st, seed)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(seed), M // B, B, J)
    if J == 1:
        eps_r, beta_r = bs.horseshoe_block_sweep(
            st.XT, st.q.gram, st.q.xsq, jnp.asarray(eps), beta, rho, inner,
            z, lam, tau, c2, sE, valid)
    else:
        eps_r, beta_r = bs.horseshoe_jacobi_sweep(
            st.XT, st.q.gram, st.q.xsq, jnp.asarray(eps), beta,
            bs.strided_border(rho, J), inner, z, lam, tau, c2, sE, valid,
            J=J)
    eps_o, beta_o = horseshoe_strided_sweep(
        st.xs(), st.q.gram, st.q.xsq, st.to_store(eps)[None], beta[None],
        rho, inner, z[None], lam[None], tau[None], c2[None], sE[None],
        valid, J=J, kind=st.kind, fold=st.fold)
    np.testing.assert_allclose(np.asarray(beta_r), np.asarray(beta_o[0]),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(eps_r), st.from_store(eps_o[0]),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("J", [2, 4])
def test_hs_jacobi_kernel_equals_oracle(J):
    """Horseshoe on 2-bit words with missing calls vs the oracle."""
    _hs_check(_Stored(51 + J, 150, 128, 16, "2bit", missing=True), J,
              51 + J, 16)


def test_hs_jacobi_j1_equals_blocked():
    """J=1 on folded int8 codes: must equal the plain blocked sweep."""
    _hs_check(_Stored(61, 80, 96, 16, "int8", missing=False), 1, 61, 16)


@pytest.mark.slow
def test_hs_jacobi_fold_quantized_equals_dense():
    """Folded 2-bit horseshoe Jacobi == dense Jacobi (same keys)."""
    dosage, dense, y = _nomissing_dosage(43, 150, 96)
    cfg = HorseshoeConfig(block_size=16)
    s_d = HorseshoeSampler(dense, y, cfg,
                           dtype=jnp.float32, jacobi_blocks=3)
    s_q = HorseshoeSampler(dosage, y, cfg, x_dtype="2bit",
                           dtype=jnp.float32, jacobi_blocks=3)
    assert s_q._x_fold
    key = jax.random.PRNGKey(44)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(float(st_d.sigmaE), float(st_q.sigmaE),
                               rtol=2e-4)


@pytest.mark.slow
def test_hs_jacobi_sampler_recovery():
    """Statistical validation of the J>1 horseshoe Markov kernel on the
    embedded-smoke recipe (src/HorseshoeR.cpp:305-325 scaled down)."""
    sim = simulate.simulate_bayesr(seed=79, N=400, M=160, n_causal=16,
                                   h2=0.5)
    A = (1.0 / np.sqrt(400)) * 16.0 / (160 - 16.0)
    s = HorseshoeSampler(sim.X, sim.Y, HorseshoeConfig(block_size=16, A=A),
                         dtype=jnp.float32, jacobi_blocks=5)
    _, out = s.run(jax.random.PRNGKey(8), ChainConfig(150, 75, 5))
    bh = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, bh)[0, 1]
    assert corr > 0.8, corr
    assert np.isfinite(out["sigmaE"]).all()


def test_jacobi_groups_grouped_hypers():
    """Grouped variant under Jacobi: per-group v/bacc bookkeeping stays
    exact vs the oracle (covered above) and the chain runs end to end."""
    sim = simulate.simulate_bayesr(seed=78, N=200, M=96, n_causal=10,
                                   h2=0.5, n_groups=3)
    cva = np.tile(CVA, (3, 1))
    s = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=16),
                         dtype=jnp.float32, g_assign=sim.g_assign,
                         jacobi_blocks=2)
    st = s.init(jax.random.PRNGKey(9))
    for _ in range(5):
        st = s.step(st)
    assert np.isfinite(np.asarray(st.beta)).all()
    assert float(jnp.sum(st.pi)) > 0
