"""The blocked sampler (strided sweep) in f32 against its references.

The blocked backend must reproduce the sequential scan backend under the
same block-restricted order (both exact Gibbs; only float-op ordering
differs, so f32 comparisons use tight-but-not-bitwise tolerances), and
quantized storage must reproduce dense storage of the same standardized
matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import BayesRConfig, GroupsConfig, SpikeSlabSampler, simulate

CVA = np.array([0.001, 0.01, 0.1])


def _pair(sim, config, **kw):
    a = SpikeSlabSampler(sim.X, sim.Y, kw.pop("cva", CVA), config,
                         backend="scan", permutation="blocked",
                         dtype=jnp.float32, **kw)
    b = SpikeSlabSampler(sim.X, sim.Y, kw.pop("cva2", CVA), config,
                         backend="blocked", dtype=jnp.float32, **kw)
    return a, b


def test_pallas_equals_blocked_ungrouped():
    sim = simulate.simulate_bayesr(seed=61, N=200, M=128, n_causal=16, h2=0.5)
    s_b, s_p = _pair(sim, BayesRConfig(block_size=32))
    key = jax.random.PRNGKey(0)
    st_b, st_p = s_b.init(key), s_p.init(key)
    for i in range(3):
        st_b, st_p = s_b.step(st_b), s_p.step(st_p)
        np.testing.assert_array_equal(np.asarray(st_b.labels),
                                      np.asarray(st_p.labels),
                                      err_msg=f"labels diverged at iter {i}")
        np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_p.beta),
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_p.eps),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(float(st_b.sigmaE), float(st_p.sigmaE),
                                   rtol=1e-4)


@pytest.mark.slow
def test_pallas_equals_blocked_groups():
    sim = simulate.simulate_bayesr(seed=62, N=160, M=96, n_causal=12, h2=0.5,
                                   n_groups=3)
    cva = np.tile(CVA, (3, 1))
    kw = dict(g_assign=sim.g_assign)
    s_b = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=32),
                           backend="scan", permutation="blocked",
                           dtype=jnp.float32, **kw)
    s_p = SpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=32),
                           dtype=jnp.float32, **kw)
    key = jax.random.PRNGKey(1)
    st_b, st_p = s_b.init(key), s_p.init(key)
    for _ in range(2):
        st_b, st_p = s_b.step(st_b), s_p.step(st_p)
    np.testing.assert_array_equal(np.asarray(st_b.labels), np.asarray(st_p.labels))
    np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_p.beta),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(st_b.sigmaGG), np.asarray(st_p.sigmaGG),
                               rtol=2e-4)


def test_pallas_padding_path():
    """M not a block multiple: padded markers must stay untouched."""
    sim = simulate.simulate_bayesr(seed=63, N=100, M=50, n_causal=8, h2=0.5)
    s = SpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=32),
                         dtype=jnp.float32)
    st = s.init(jax.random.PRNGKey(2))
    for _ in range(3):
        st = s.step(st)
    assert np.all(np.asarray(st.beta)[50:] == 0.0)
    assert np.all(np.asarray(st.labels)[50:] == 0)
    eps_direct = sim.Y - float(st.mu) - sim.X @ np.asarray(st.beta)[:50]
    np.testing.assert_allclose(np.asarray(st.eps), eps_direct, atol=1e-3)


@pytest.mark.slow
def test_pallas_equals_blocked_horseshoe():
    from bayesrrcpp_tpu import HorseshoeConfig, HorseshoeSampler

    sim = simulate.simulate_bayesr(seed=64, N=160, M=96, n_causal=12, h2=0.5)
    cfg = HorseshoeConfig(A=0.05, block_size=32)
    s_b = HorseshoeSampler(sim.X, sim.Y, cfg, backend="scan",
                           permutation="blocked", dtype=jnp.float32)
    s_p = HorseshoeSampler(sim.X, sim.Y, cfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(5)
    st_b, st_p = s_b.init(key), s_p.init(key)
    for _ in range(3):
        st_b, st_p = s_b.step(st_b), s_p.step(st_p)
    np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_p.beta),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_p.eps),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(st_b.tau), float(st_p.tau), rtol=2e-4)


@pytest.mark.slow
def test_quantized_int8_equals_dense():
    """int8 decode in the X pass == dense f32 on the same standardized
    matrix."""
    rng = np.random.default_rng(65)
    N, M = 150, 64
    freqs = rng.uniform(0.15, 0.85, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    dosage[rng.random(dosage.shape) < 0.01] = np.nan  # sparse missingness
    means = np.nanmean(dosage, axis=0)
    sds = np.nanstd(dosage, axis=0, ddof=1)
    dense = np.where(np.isnan(dosage), 0.0, (dosage - means) / sds)

    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = dense @ beta_t + rng.normal(0, 0.7, N)

    cfg = BayesRConfig(block_size=32)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="int8",
                           dtype=jnp.float32)
    key = jax.random.PRNGKey(6)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(st_d.eps), np.asarray(st_q.eps),
                               rtol=2e-4, atol=2e-5)
    # memory layout really is int8
    assert s_q.data.XT.dtype == jnp.int8


def test_packed_2bit_equals_dense():
    """2-bit packed decode == dense f32 (permutation-invariant)."""
    rng = np.random.default_rng(66)
    N, M = 150, 64
    freqs = rng.uniform(0.15, 0.85, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    dosage[rng.random(dosage.shape) < 0.01] = np.nan
    means = np.nanmean(dosage, axis=0)
    sds = np.nanstd(dosage, axis=0, ddof=1)
    dense = np.where(np.isnan(dosage), 0.0, (dosage - means) / sds)

    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = dense @ beta_t + rng.normal(0, 0.7, N)

    cfg = BayesRConfig(block_size=32)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32)
    s_p = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32)
    assert s_p.data.XT.dtype == jnp.int32
    assert s_p.Npad == 2048
    key = jax.random.PRNGKey(7)
    st_d, st_p = s_d.init(key), s_p.init(key)
    for _ in range(3):
        st_d, st_p = s_d.step(st_d), s_p.step(st_p)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_p.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_p.beta),
                               rtol=3e-4, atol=3e-6)
    # packed eps is permuted+padded; un-permute to compare
    eps_o = np.zeros(s_p.Npad, np.float32)
    eps_o[np.asarray(s_p.data.n_perm)] = np.asarray(st_p.eps)
    np.testing.assert_allclose(np.asarray(st_d.eps), eps_o[:N],
                               rtol=3e-4, atol=3e-5)
    # emission path un-permutes internally
    row = jax.jit(lambda st: s_p._emit_one(st, s_p.data))(st_p)
    np.testing.assert_allclose(np.asarray(row["epsilon"]), eps_o[:N],
                               atol=1e-6)


def _nomissing_dosage(seed, N, M):
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.15, 0.85, M)
    dosage = rng.binomial(2, freqs, size=(N, M)).astype(float)
    means = dosage.mean(axis=0)
    sds = dosage.std(axis=0, ddof=1)
    dense = (dosage - means) / sds
    beta_t = np.zeros(M)
    beta_t[rng.choice(M, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = dense @ beta_t + rng.normal(0, 0.7, N)
    return dosage, dense, y


@pytest.mark.slow
def test_fold_affine_int8_equals_dense():
    """No-missing data takes the folded X pass; it must match the dense
    f32 sweep (standardization applied after the code sums)."""
    dosage, dense, y = _nomissing_dosage(68, 150, 64)
    cfg = BayesRConfig(block_size=32)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32)
    s_q = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="int8",
                           dtype=jnp.float32)
    assert s_q._x_fold is True
    key = jax.random.PRNGKey(12)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(np.asarray(st_d.eps), np.asarray(st_q.eps),
                               rtol=3e-4, atol=3e-5)


def test_fold_affine_2bit_equals_dense():
    dosage, dense, y = _nomissing_dosage(69, 150, 80)  # M%32 != 0: pads too
    cfg = BayesRConfig(block_size=32)
    s_d = SpikeSlabSampler(dense, y, CVA, cfg, dtype=jnp.float32)
    s_p = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32)
    assert s_p._x_fold is True
    key = jax.random.PRNGKey(13)
    st_d, st_p = s_d.init(key), s_p.init(key)
    for _ in range(3):
        st_d, st_p = s_d.step(st_d), s_p.step(st_p)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_p.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_p.beta),
                               rtol=3e-4, atol=3e-6)
    # padded/permuted eps lanes must be zeroed between calls; compare real
    eps_o = np.zeros(s_p.Npad, np.float32)
    eps_o[np.asarray(s_p.data.n_perm)] = np.asarray(st_p.eps)
    np.testing.assert_allclose(np.asarray(st_d.eps), eps_o[:150],
                               rtol=3e-4, atol=3e-5)
    # pad lanes exactly zero after the sweep (maintained invariant)
    pad_lanes = ~np.asarray(s_p.data.row_valid)
    assert np.all(np.asarray(st_p.eps)[pad_lanes] == 0.0)


def test_missing_data_disables_fold():
    rng = np.random.default_rng(70)
    dosage = rng.binomial(2, 0.4, size=(60, 32)).astype(float)
    dosage[0, 0] = np.nan
    y = rng.normal(size=60)
    s = SpikeSlabSampler(dosage, y, CVA, BayesRConfig(block_size=16),
                         x_dtype="int8", dtype=jnp.float32)
    assert s._x_fold is False
    st = s.step(s.init(jax.random.PRNGKey(14)))
    assert np.isfinite(np.asarray(st.beta)).all()


@pytest.mark.slow
def test_prepacked_words_equal_host_packed():
    """Device-resident pre-packed words (the chunked Gram/stats build) must
    reproduce the host-packed 2-bit path exactly: same gram/xsq and
    identical chain steps."""
    rng = np.random.default_rng(71)
    N, M = 2048, 64
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(float)
    means = dosage.mean(axis=0)
    sds = dosage.std(axis=0, ddof=1)
    y = rng.normal(size=N)

    cfg = BayesRConfig(block_size=32)
    s_h = SpikeSlabSampler(dosage, y, CVA, cfg, x_dtype="2bit",
                           dtype=jnp.float32)
    # pack on the test side: 16 consecutive codes per int32 word along N
    codes = dosage.T.astype(np.uint64)           # (M, N)
    shifts = (2 * np.arange(16, dtype=np.uint64))[None, None, :]
    words = (codes.reshape(M, N // 16, 16) << shifts).sum(axis=2)
    words = jnp.asarray(words.astype(np.uint32).view(np.int32))
    s_p = SpikeSlabSampler(words, y, CVA, cfg, x_dtype="2bit",
                           transposed=True, x_stats=(means, sds),
                           dtype=jnp.float32)
    assert s_p._prepacked
    # f32 with different summation orders (whole-N matmul vs 16 bit-plane
    # matmuls): agreement to ~1e-4 relative
    np.testing.assert_allclose(np.asarray(s_h.data.gram),
                               np.asarray(s_p.data.gram), rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(np.asarray(s_h.data.xsq),
                               np.asarray(s_p.data.xsq), rtol=1e-4)
    assert s_h._x_fold == s_p._x_fold
    key = jax.random.PRNGKey(15)
    st_h, st_p = s_h.init(key), s_p.init(key)
    for _ in range(2):
        st_h, st_p = s_h.step(st_h), s_p.step(st_p)
    np.testing.assert_array_equal(np.asarray(st_h.labels),
                                  np.asarray(st_p.labels))
    np.testing.assert_allclose(np.asarray(st_h.beta), np.asarray(st_p.beta),
                               rtol=2e-4, atol=2e-6)
