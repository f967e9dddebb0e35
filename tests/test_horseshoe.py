"""End-to-end tests of the regularized-horseshoe sampler (C4).

Mirrors the reference's embedded smoke recipe (src/HorseshoeR.cpp:304-331):
sparse effects, dense shrinkage recovery, plus the blocked-vs-scan exactness
invariant shared with the mixture samplers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesrrcpp_tpu import ChainConfig, HorseshoeConfig, HorseshoeSampler, simulate


def _hs_config(N, M, n_causal):
    # the reference smoke script's hyper recipe (src/HorseshoeR.cpp:315-323)
    A = (1.0 / np.sqrt(N)) * n_causal / (M - n_causal)
    return HorseshoeConfig(A=A, v0E=0.001, s02E=0.001, vL=1.0, vT=1.0,
                           c2=1.0, vC=10.0, sC=10.0, block_size=64)


@pytest.fixture(scope="module")
def sim():
    return simulate.simulate_bayesr(seed=21, N=600, M=400, n_causal=30, h2=0.5)


def test_blocked_equals_scan(sim):
    cfg = _hs_config(600, 400, 30)
    s_b = HorseshoeSampler(sim.X, sim.Y, cfg, backend="blocked", dtype=jnp.float64)
    s_s = HorseshoeSampler(sim.X, sim.Y, cfg, backend="scan",
                           permutation="blocked", dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    st_b, st_s = s_b.init(key), s_s.init(key)
    for _ in range(3):
        st_b, st_s = s_b.step(st_b), s_s.step(st_s)
    np.testing.assert_allclose(np.asarray(st_b.beta), np.asarray(st_s.beta),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st_b.eps), np.asarray(st_s.eps),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(st_b.tau), float(st_s.tau), rtol=1e-8)


def test_residual_invariant(sim):
    cfg = _hs_config(600, 400, 30)
    s = HorseshoeSampler(sim.X, sim.Y, cfg, backend="blocked", dtype=jnp.float64)
    st = s.init(jax.random.PRNGKey(1))
    for _ in range(5):
        st = s.step(st)
    eps_direct = sim.Y - float(st.mu) - sim.X @ np.asarray(st.beta)[: s.M]
    np.testing.assert_allclose(np.asarray(st.eps), eps_direct, atol=1e-8)


@pytest.mark.slow
def test_recovery(sim):
    cfg = _hs_config(600, 400, 30)
    s = HorseshoeSampler(sim.X, sim.Y, cfg, backend="blocked", dtype=jnp.float64)
    chain = ChainConfig(max_iterations=800, burn_in=400, thinning=2)
    _, out = s.run(jax.random.PRNGKey(2), chain)
    beta_hat = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.8
    slope = np.polyfit(sim.beta_true, beta_hat, 1)[0]
    assert 0.5 < slope < 1.3
    assert out["lambda"].shape[1] == s.M
    assert np.all(out["tau"] > 0)
    sigmaE_hat = out["sigmaE"].mean()
    noise_var = np.var(sim.Y - sim.X @ sim.beta_true)
    assert sigmaE_hat == pytest.approx(noise_var, rel=0.4)


def test_multi_chain(sim):
    cfg = _hs_config(600, 400, 30)
    s = HorseshoeSampler(sim.X, sim.Y, cfg, backend="blocked",
                         dtype=jnp.float64)
    chain = ChainConfig(max_iterations=200, burn_in=100, thinning=4)
    states, out = s.run_chains(jax.random.PRNGKey(9), 3, chain)
    n_emits = len(list(chain.emit_iterations()))
    assert out["beta"].shape == (n_emits, 3, s.M)
    assert not np.allclose(out["beta"][:, 0], out["beta"][:, 1])
    assert np.isfinite(out["tau"]).all()


# ---------------------------------------------------------------- quantized X


@pytest.fixture(scope="module")
def dosage_sim():
    rng = np.random.default_rng(31)
    N, M = 320, 96
    dos = rng.integers(0, 3, size=(N, M)).astype(float)
    Xs = (dos - dos.mean(0)) / dos.std(0, ddof=1)
    beta_true = np.zeros(M)
    beta_true[:8] = rng.normal(0, 0.6, 8)
    Y = Xs @ beta_true + rng.normal(0, 1, N)
    return dos, Xs, Y, beta_true


@pytest.mark.parametrize("x_dtype", ["int8", "2bit"])
def test_quantized_matches_dense(dosage_sim, x_dtype):
    """int8 / 2-bit packed X (in-kernel decode) must sample the same
    posterior as dense standardized X under the same key."""
    dos, Xs, Y, beta_true = dosage_sim
    cfg = _hs_config(*dos.shape, 8)
    chain = ChainConfig(60, 20, 4)
    _, out_d = HorseshoeSampler(Xs, Y, cfg).run(
        jax.random.PRNGKey(0), chain)
    s_q = HorseshoeSampler(dos, Y, cfg, x_dtype=x_dtype)
    assert s_q._x_fold  # no missing calls -> folded X pass
    _, out_q = s_q.run(jax.random.PRNGKey(0), chain)
    bd, bq = out_d["beta"].mean(0), out_q["beta"].mean(0)
    assert np.isfinite(bq).all()
    # decode quantization error only (stats in f32)
    assert np.abs(bd - bq).max() < 5e-2
    assert np.corrcoef(bq[:8], beta_true[:8])[0, 1] > 0.8


def test_quantized_with_missing(dosage_sim):
    """Missing calls take the exact decode (mean imputation in-decode)."""
    dos, _, Y, beta_true = dosage_sim
    rng = np.random.default_rng(5)
    dosm = dos.copy()
    dosm[rng.random(dos.shape) < 0.05] = np.nan
    cfg = _hs_config(*dos.shape, 8)
    s = HorseshoeSampler(dosm, Y, cfg, x_dtype="2bit")
    assert not s._x_fold
    _, out = s.run(jax.random.PRNGKey(1), ChainConfig(60, 20, 4))
    bh = out["beta"].mean(0)
    assert np.isfinite(bh).all()
    assert np.corrcoef(bh[:8], beta_true[:8])[0, 1] > 0.75
    assert out["epsilon"].shape[1] == dos.shape[0]  # un-permuted true N


def test_prepacked_words(dosage_sim, tmp_path):
    """read_bed_packed words drive the sampler without host densification."""
    from bayesrrcpp_tpu.io import bed as bedio

    dos, _, Y, _ = dosage_sim
    pre = str(tmp_path / "hs")
    bedio.write_bed(pre, dos)
    pb = bedio.read_bed_packed(pre)
    cfg = _hs_config(*dos.shape, 8)
    chain = ChainConfig(40, 10, 3)
    s_pp = HorseshoeSampler(jnp.asarray(pb.words), Y, cfg, x_dtype="2bit",
                            transposed=True, x_stats=(pb.means, pb.sds),
                            n_individuals=pb.n)
    _, out_pp = s_pp.run(jax.random.PRNGKey(2), chain)
    _, out_host = HorseshoeSampler(dos, Y, cfg, x_dtype="2bit").run(
        jax.random.PRNGKey(2), chain)
    assert np.abs(out_pp["beta"].mean(0)
                  - out_host["beta"].mean(0)).max() < 2e-3
    # quantized X supports fused multi-chain steps
    assert s_pp.supports_fused_chains
    _, mc = s_pp.run_chains(jax.random.PRNGKey(3), 2, ChainConfig(16, 8, 2))
    assert mc["beta"].shape[1] == 2 and np.isfinite(mc["beta"]).all()


def test_fused_chains_quantized(dosage_sim):
    """Fused multi-chain with folded quantized X: all chains share one
    X read per round; the posterior must agree with independent
    single-chain runs."""
    dos, _, Y, _ = dosage_sim
    cfg = _hs_config(*dos.shape, 8)
    s = HorseshoeSampler(dos, Y, cfg, x_dtype="2bit")
    assert s.supports_fused_chains
    chain = ChainConfig(60, 20, 2)
    runs = [s.run(k, chain)[1]["beta"]
            for k in jax.random.split(jax.random.PRNGKey(0), 4)]
    _, out_f = s.run_chains(jax.random.PRNGKey(0), 4, chain)
    bv = np.mean([b.mean(0) for b in runs], axis=0)
    bf = out_f["beta"].mean((0, 1))
    assert np.isfinite(bf).all()
    # different (equally valid) RNG assignment -> same posterior
    assert np.corrcoef(bv, bf)[0, 1] > 0.95
