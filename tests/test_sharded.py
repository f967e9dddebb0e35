"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates the scaling design of parallel/sharded.py:
- the "n" (individual) axis is mathematically exact: a (1, Dn) mesh chain
  matches the (1, 1) chain to float-reassociation tolerance;
- the "m" (marker) axis is block-Jacobi across slices: validated by the
  residual bookkeeping invariant and posterior recovery at Dm > 1.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bayesrrcpp_tpu import BayesRConfig, ChainConfig, GroupsConfig, simulate
from bayesrrcpp_tpu.parallel.mesh import make_mesh
from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler

CVA = np.array([0.001, 0.01, 0.1])


@pytest.fixture(scope="module")
def sim():
    return simulate.simulate_bayesr(seed=31, N=300, M=160, n_causal=20, h2=0.5)


def _sampler(sim, m, n, **kw):
    cfg = kw.pop("config", BayesRConfig(block_size=32))
    return ShardedSpikeSlabSampler(sim.X, sim.Y, kw.pop("cva", CVA), cfg,
                                   make_mesh(m, n), dtype=jnp.float64, **kw)


def test_n_axis_exact(sim):
    """Row sharding only reassociates dot products: (1,4) == (1,1)."""
    s1 = _sampler(sim, 1, 1)
    s4 = _sampler(sim, 1, 4)
    key = jax.random.PRNGKey(0)
    st1, st4 = s1.init(key), s4.init(key)
    for _ in range(3):
        st1, st4 = s1.step(st1), s4.step(st4)
    np.testing.assert_allclose(np.asarray(st1.beta), np.asarray(st4.beta),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(st1.eps)[: s1.N],
                               np.asarray(st4.eps)[: s4.N],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(st1.labels), np.asarray(st4.labels))


def test_residual_invariant_2d_mesh(sim):
    """eps == Y - mu - X beta holds exactly on a full (2,4) mesh."""
    s = _sampler(sim, 2, 4)
    st = s.init(jax.random.PRNGKey(1))
    for _ in range(4):
        st = s.step(st)
    beta = np.asarray(st.beta)[: s.M]
    eps_direct = sim.Y - float(st.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st.eps)[: s.N], eps_direct, atol=1e-8)
    # padded residual rows must stay identically zero
    assert np.all(np.asarray(st.eps)[s.N:] == 0.0)


@pytest.mark.slow
def test_recovery_model_parallel(sim):
    """Block-Jacobi across 4 m-slices preserves the posterior (statistical)."""
    s = _sampler(sim, 4, 2)
    chain = ChainConfig(max_iterations=500, burn_in=250, thinning=2)
    _, out = s.run(jax.random.PRNGKey(2), chain)
    beta_hat = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.8
    sigmaE_hat = out["sigmaE"].mean()
    noise_var = np.var(sim.Y - sim.X @ sim.beta_true)
    assert sigmaE_hat == pytest.approx(noise_var, rel=0.4)
    assert out["beta"].shape[1] == s.M
    assert out["epsilon"].shape[1] == s.N


@pytest.mark.slow
def test_groups_fixed_effects_sharded():
    sim = simulate.simulate_bayesr(seed=33, N=250, M=120, n_causal=15, h2=0.5,
                                   n_groups=2, n_fixed=2)
    cva = np.tile(CVA, (2, 1))
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, cva, GroupsConfig(block_size=32),
                                make_mesh(2, 2), g_assign=sim.g_assign,
                                fixed=sim.fixed, dtype=jnp.float64)
    chain = ChainConfig(max_iterations=300, burn_in=150, thinning=2)
    _, out = s.run(jax.random.PRNGKey(3), chain)
    alpha_hat = out["alpha"].mean(axis=0)
    np.testing.assert_allclose(alpha_hat, sim.alpha_true, atol=0.2)
    assert np.isfinite(out["beta"]).all()


@pytest.mark.slow
def test_pallas_sharded_recovery(sim):
    """f32 strided sweeps on an (m, 1) mesh: posterior holds."""
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=32),
                                make_mesh(4, 1), dtype=jnp.float32)
    chain = ChainConfig(max_iterations=400, burn_in=200, thinning=2)
    _, out = s.run(jax.random.PRNGKey(5), chain)
    beta_hat = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.8
    # residual bookkeeping under per-round psums: the sweep tracks eps in
    # f32, so after 5 iterations the drift vs the f64 direct residual is
    # O(iters * eps_f32 * |eps|) ~ 5e-7 here (measured, 3 seeds); 1e-5
    # gives a 20x margin while still catching any real bookkeeping bug
    # (round-1/2 bound was 5e-3 -- 4 orders looser than reality)
    st, _ = s.run(jax.random.PRNGKey(6), ChainConfig(5, 1, 1), collect=False)
    beta = np.asarray(st.beta)[: s.M]
    eps_direct = sim.Y - float(st.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st.eps)[: s.N], eps_direct,
                               atol=1e-5)


@pytest.mark.slow
def test_sharded_horseshoe(sim):
    from bayesrrcpp_tpu import HorseshoeConfig
    from bayesrrcpp_tpu.parallel.sharded import ShardedHorseshoeSampler

    cfg = HorseshoeConfig(A=0.05, block_size=32)
    for mesh, dt in [(make_mesh(2, 2), jnp.float64),
                     (make_mesh(4, 1), jnp.float32)]:
        s = ShardedHorseshoeSampler(sim.X, sim.Y, cfg, mesh, dtype=dt)
        chain = ChainConfig(max_iterations=300, burn_in=150, thinning=3)
        _, out = s.run(jax.random.PRNGKey(7), chain)
        beta_hat = out["beta"].mean(axis=0)
        corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
        assert corr > 0.75, (dt, corr)
        assert np.all(out["tau"] > 0)
        st, _ = s.run(jax.random.PRNGKey(8), ChainConfig(4, 1, 1),
                      collect=False)
        eps_direct = sim.Y - float(st.mu) - sim.X @ np.asarray(st.beta)[: s.M]
        # f32 drift is ~5e-7 at this scale (see
        # test_pallas_sharded_recovery); 1e-5 keeps a 20x margin
        np.testing.assert_allclose(np.asarray(st.eps)[: s.N], eps_direct,
                                   atol=1e-5 if dt == jnp.float32
                                   else 1e-8)


@pytest.fixture(scope="module")
def wide_sim():
    """Enough markers that each of 2 m-slices plans J > 1 (2048 each)."""
    return simulate.simulate_bayesr(seed=35, N=64, M=4096, n_causal=20,
                                    h2=0.5)


def test_jacobi_n_axis_exact(wide_sim):
    """Row sharding at J > 1: the (2, 2) mesh matches the (2, 1) mesh --
    the n axis only reassociates the r psum and the rank-B update."""
    sim = wide_sim
    s22, s21 = _sampler(sim, 2, 2), _sampler(sim, 2, 1)
    assert s22.jacobi == s21.jacobi == 8
    key = jax.random.PRNGKey(0)
    st22, st21 = s22.init(key), s21.init(key)
    for _ in range(2):
        st22, st21 = s22.step(st22), s21.step(st21)
    np.testing.assert_array_equal(np.asarray(st22.labels),
                                  np.asarray(st21.labels))
    np.testing.assert_allclose(np.asarray(st22.beta), np.asarray(st21.beta),
                               rtol=1e-8, atol=1e-10)
    beta = np.asarray(st22.beta)[: s22.M]
    eps_direct = sim.Y - float(st22.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st22.eps)[: s22.N], eps_direct,
                               atol=1e-8)


def test_horseshoe_jacobi_n_axis_exact(wide_sim):
    from bayesrrcpp_tpu import HorseshoeConfig
    from bayesrrcpp_tpu.parallel.sharded import ShardedHorseshoeSampler

    sim = wide_sim
    cfg = HorseshoeConfig(A=0.05, block_size=32)
    mk = lambda m, n: ShardedHorseshoeSampler(
        sim.X, sim.Y, cfg, make_mesh(m, n), dtype=jnp.float64)
    s22, s21 = mk(2, 2), mk(2, 1)
    assert s22.jacobi == 8
    key = jax.random.PRNGKey(0)
    st22, st21 = s22.init(key), s21.init(key)
    for _ in range(2):
        st22, st21 = s22.step(st22), s21.step(st21)
    np.testing.assert_allclose(np.asarray(st22.beta), np.asarray(st21.beta),
                               rtol=1e-8, atol=1e-10)
    beta = np.asarray(st22.beta)[: s22.M]
    eps_direct = sim.Y - float(st22.mu) - sim.X @ beta
    np.testing.assert_allclose(np.asarray(st22.eps)[: s22.N], eps_direct,
                               atol=1e-8)


@pytest.mark.slow
def test_pallas_split_recovery(sim):
    """Posterior recovery through a full (2,2)-mesh f32 chain."""
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=32),
                                make_mesh(2, 2), dtype=jnp.float32)
    chain = ChainConfig(max_iterations=400, burn_in=200, thinning=2)
    _, out = s.run(jax.random.PRNGKey(5), chain)
    beta_hat = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim.beta_true, beta_hat)[0, 1]
    assert corr > 0.8, corr


# ------------------------------------------------------------ packed 2-bit X


@pytest.fixture(scope="module")
def dosage_sim():
    rng = np.random.default_rng(41)
    N, M = 300, 256
    dos = rng.integers(0, 3, size=(N, M)).astype(float)
    dos[rng.random((N, M)) < 0.03] = np.nan
    Xs = np.where(np.isnan(dos), np.nanmean(dos, 0)[None, :], dos)
    Xs = (Xs - Xs.mean(0)) / Xs.std(0, ddof=1)
    beta_true = np.zeros(M)
    beta_true[:10] = rng.normal(0, 0.5, 10)
    Y = Xs @ beta_true + rng.normal(0, 1, N)
    return dos, Y, beta_true


def test_sharded_packed_bayesr(dosage_sim):
    """2-bit packed X column-sharded over an (m, 1) mesh: per-slice stats
    built inside shard_map, decoding sweeps, un-permuted emission."""
    dos, Y, beta_true = dosage_sim
    cva = np.array([1e-4, 1e-3, 1e-2])
    s = ShardedSpikeSlabSampler(dos, Y, cva, BayesRConfig(block_size=32),
                                make_mesh(4, 1),
                                x_dtype="2bit")
    assert s.Npad == 2048 and not s._x_fold  # missing calls present
    _, out = s.run(jax.random.PRNGKey(0), ChainConfig(60, 20, 4))
    bh = out["beta"].mean(0)
    assert np.isfinite(bh).all()
    assert np.corrcoef(bh[:10], beta_true[:10])[0, 1] > 0.85
    assert out["epsilon"].shape[1] == dos.shape[0]


def test_sharded_packed_prepacked_words(dosage_sim, tmp_path):
    """read_bed_packed words shard directly (host never densifies) and match
    the host-dosage packed path bit-for-bit."""
    from bayesrrcpp_tpu.io import bed as bedio

    dos, Y, _ = dosage_sim
    pre = str(tmp_path / "sb")
    bedio.write_bed(pre, dos)
    pb = bedio.read_bed_packed(pre)
    cva = np.array([1e-4, 1e-3, 1e-2])
    chain = ChainConfig(40, 10, 3)
    mesh = make_mesh(4, 1)
    s_host = ShardedSpikeSlabSampler(dos, Y, cva, BayesRConfig(block_size=32),
                                     mesh, x_dtype="2bit")
    s_pp = ShardedSpikeSlabSampler(
        pb.words, Y, cva, BayesRConfig(block_size=32), mesh, x_dtype="2bit", transposed=True,
        x_stats=(pb.means, pb.sds), n_individuals=pb.n,
        has_missing=pb.has_missing)
    _, out_h = s_host.run(jax.random.PRNGKey(1), chain)
    _, out_p = s_pp.run(jax.random.PRNGKey(1), chain)
    assert np.abs(out_h["beta"].mean(0) - out_p["beta"].mean(0)).max() < 2e-3


def test_sharded_int8_bayesr(dosage_sim):
    """int8 codes column-sharded over an (m, 1) mesh (storage-mode parity
    with the single-device sampler): per-slice stats inside shard_map,
    decoding sweeps, and a 3-step match against the dense sharded chain
    under the same keys."""
    dos, Y, beta_true = dosage_sim
    Xs = np.where(np.isnan(dos), np.nanmean(dos, 0)[None, :], dos)
    Xs = (Xs - np.nanmean(dos, 0)) / np.nanstd(
        np.where(np.isnan(dos), np.nanmean(dos, 0)[None, :], dos), 0, ddof=1)
    cva = np.array([1e-4, 1e-3, 1e-2])
    mesh = make_mesh(4, 1)
    s_i = ShardedSpikeSlabSampler(dos, Y, cva, BayesRConfig(block_size=32),
                                  mesh, x_dtype="int8")
    assert s_i._has_missing and not s_i._x_fold
    _, out = s_i.run(jax.random.PRNGKey(0), ChainConfig(60, 20, 4))
    bh = out["beta"].mean(0)
    assert np.isfinite(bh).all()
    assert np.corrcoef(bh[:10], beta_true[:10])[0, 1] > 0.85

    # missing-free data: int8 fold chain matches the dense chain stepwise
    rng = np.random.default_rng(43)
    dos2 = rng.integers(0, 3, size=(200, 96)).astype(float)
    dense2 = (dos2 - dos2.mean(0)) / dos2.std(0, ddof=1)
    Y2 = dense2[:, 0] + rng.normal(0, 1, 200)
    s_d = ShardedSpikeSlabSampler(dense2, Y2, cva, BayesRConfig(block_size=16),
                                  mesh, dtype=jnp.float32)
    s_q = ShardedSpikeSlabSampler(dos2, Y2, cva, BayesRConfig(block_size=16),
                                  mesh, x_dtype="int8")
    assert s_q._x_fold
    key = jax.random.PRNGKey(1)
    st_d, st_q = s_d.init(key), s_q.init(key)
    for _ in range(3):
        st_d, st_q = s_d.step(st_d), s_q.step(st_q)
    np.testing.assert_array_equal(np.asarray(st_d.labels),
                                  np.asarray(st_q.labels))
    np.testing.assert_allclose(np.asarray(st_d.beta), np.asarray(st_q.beta),
                               rtol=3e-4, atol=3e-6)


def test_sharded_int8_horseshoe(dosage_sim):
    from bayesrrcpp_tpu.config import HorseshoeConfig
    from bayesrrcpp_tpu.parallel.sharded import ShardedHorseshoeSampler

    dos, Y, beta_true = dosage_sim
    N, M = dos.shape
    A = (1.0 / np.sqrt(N)) * 10 / (M - 10)
    s = ShardedHorseshoeSampler(dos, Y, HorseshoeConfig(A=A, block_size=32),
                                make_mesh(4, 1),
                                x_dtype="int8")
    _, out = s.run(jax.random.PRNGKey(2), ChainConfig(80, 30, 4))
    bh = out["beta"].mean(0)
    assert np.isfinite(bh).all()
    assert np.corrcoef(bh[:10], beta_true[:10])[0, 1] > 0.85


def test_sharded_packed_horseshoe(dosage_sim):
    from bayesrrcpp_tpu.config import HorseshoeConfig
    from bayesrrcpp_tpu.parallel.sharded import ShardedHorseshoeSampler

    dos, Y, beta_true = dosage_sim
    N, M = dos.shape
    A = (1.0 / np.sqrt(N)) * 10 / (M - 10)
    s = ShardedHorseshoeSampler(dos, Y, HorseshoeConfig(A=A, block_size=32),
                                make_mesh(4, 1),
                                x_dtype="2bit")
    _, out = s.run(jax.random.PRNGKey(2), ChainConfig(80, 30, 4))
    bh = out["beta"].mean(0)
    assert np.isfinite(bh).all()
    assert np.corrcoef(bh[:10], beta_true[:10])[0, 1] > 0.85


def test_sharded_run_chains_fused(sim):
    """Fused multi-chain x column sharding: C chains swept by one strided
    sweep per slice on an (m, 1) mesh."""
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, CVA, BayesRConfig(block_size=32),
                                make_mesh(4, 1), dtype=jnp.float32)
    chain = ChainConfig(max_iterations=120, burn_in=60, thinning=3)
    _, out = s.run_chains(jax.random.PRNGKey(11), 3, chain)
    assert out["beta"].shape[1] == 3           # chain axis
    bh = out["beta"].mean(axis=(0, 1))         # pool chains
    corr = np.corrcoef(sim.beta_true, bh[: s.M])[0, 1]
    assert corr > 0.75, corr
    # chains are genuinely distinct
    assert np.std(out["sigmaE"], axis=1).max() > 0
    # residual bookkeeping per chain
    st = s.init_chains(jax.random.PRNGKey(12), 2)
    st = s.step_chains(st)
    beta = np.asarray(st.beta)[:, : s.M]
    for c in range(2):
        eps_direct = sim.Y - float(st.mu[c]) - sim.X @ beta[c]
        np.testing.assert_allclose(np.asarray(st.eps)[c, : s.N], eps_direct,
                                   atol=2e-3)


def test_sharded_sink_and_emit_epsilon_symmetry(sim, tmp_path):
    """Both sharded drivers expose the same observability surface
    (round-3 VERDICT #5): CSV sink + on_chunk + emit_epsilon=False --
    at pod scale the full-N epsilon emission is the cost SURVEY section 5
    makes optional."""
    import csv

    from bayesrrcpp_tpu import HorseshoeConfig
    from bayesrrcpp_tpu.io.sink import CSVSink
    from bayesrrcpp_tpu.parallel.sharded import ShardedHorseshoeSampler

    chain = ChainConfig(6, 2, 2)
    seen = {"ss": 0, "hs": 0}

    s = ShardedSpikeSlabSampler(
        sim.X, sim.Y, CVA, BayesRConfig(block_size=32, emit_epsilon=False),
        make_mesh(2, 2), dtype=jnp.float64)
    sink = CSVSink(str(tmp_path / "ss.csv"), "bayesr", M=s.M, N=s.N,
                   emit_epsilon=False)
    _, out = s.run(jax.random.PRNGKey(3), chain, sink=sink,
                   on_chunk=lambda *a, **k: seen.__setitem__(
                       "ss", seen["ss"] + 1))
    sink.close()
    assert out["epsilon"].shape[1] == 0
    rows = list(csv.reader(open(tmp_path / "ss.csv")))
    assert len(rows) == 3 and len(rows[1]) == len(rows[0])
    assert seen["ss"] >= 1

    h = ShardedHorseshoeSampler(
        sim.X, sim.Y, HorseshoeConfig(block_size=32, emit_epsilon=False),
        make_mesh(2, 2), dtype=jnp.float64)
    hsink = CSVSink(str(tmp_path / "hs.csv"), "horseshoe", M=h.M, N=h.N,
                    emit_epsilon=False)
    _, hout = h.run(jax.random.PRNGKey(4), chain, sink=hsink,
                    on_chunk=lambda *a, **k: seen.__setitem__(
                        "hs", seen["hs"] + 1))
    hsink.close()
    assert hout["epsilon"].shape[1] == 0
    hrows = list(csv.reader(open(tmp_path / "hs.csv")))
    assert len(hrows) == 3 and len(hrows[1]) == len(hrows[0])
    assert seen["hs"] >= 1


@pytest.mark.slow
def test_sharded_t_kernel_recovery():
    """(m, 1) slices at a scale where each slice plans J > 1: the strided
    local sweep recovers effects and keeps the residual invariant."""
    # N << M is deliberately underpowered; the easier signal (few strong
    # causals) keeps the recovery check meaningful at test runtimes (the
    # serial local sweep scores ~the same on the harder variant)
    sim2 = simulate.simulate_bayesr(seed=91, N=320, M=4096, n_causal=16,
                                    h2=0.8)
    s = ShardedSpikeSlabSampler(sim2.X, sim2.Y, CVA,
                                BayesRConfig(block_size=32),
                                make_mesh(2, 1),
                                dtype=jnp.float32)
    assert s.jacobi > 1, "expected a Jacobi plan at this scale"
    st = s.init(jax.random.PRNGKey(2))
    for _ in range(3):
        st = s.step(st)
    beta = np.asarray(st.beta)[: s.M]
    eps_direct = sim2.Y - float(st.mu) - sim2.X @ beta
    np.testing.assert_allclose(np.asarray(st.eps)[: s.N], eps_direct,
                               atol=2e-3, rtol=1e-4)
    _, out = s.run(jax.random.PRNGKey(3), ChainConfig(120, 60, 5))
    bh = out["beta"].mean(axis=0)
    corr = np.corrcoef(sim2.beta_true, bh)[0, 1]
    assert corr > 0.75, corr


@pytest.mark.slow
def test_sharded_t_kernel_packed():
    """2-bit packed X through the sharded strided sweep (folded)."""
    rng = np.random.default_rng(93)
    N, M = 320, 4096   # per-shard 2048: the t-plan engagement point
    dosage = rng.binomial(2, rng.uniform(0.2, 0.8, M), size=(N, M)).astype(
        float)
    means = dosage.mean(axis=0)
    sds = dosage.std(axis=0, ddof=1)
    dense = (dosage - means) / sds
    bt = np.zeros(M)
    bt[rng.choice(M, 40, replace=False)] = rng.normal(0, 0.25, 40)
    y = dense @ bt + rng.normal(0, 0.7, N)
    s = ShardedSpikeSlabSampler(dosage, y, CVA, BayesRConfig(block_size=32),
                                make_mesh(2, 1),
                                x_dtype="2bit", dtype=jnp.float32)
    assert s.jacobi > 1 and s._x_fold
    _, out = s.run(jax.random.PRNGKey(5), ChainConfig(120, 60, 5))
    bh = out["beta"].mean(axis=0)
    corr = np.corrcoef(bt, bh)[0, 1]
    assert corr > 0.75, corr
    assert np.isfinite(out["sigmaE"]).all()


# ------------------------------------------------ fused multi-chain

def test_mc_t_rounds_driver_equals_per_chain():
    """The sharded run_chains unit of work -- one chain-axis strided sweep
    per m-slice with psum'd residual updates, inside shard_map -- must
    equal C independent single-chain sweeps with the same streams."""
    from jax.sharding import PartitionSpec as P

    from bayesrrcpp_tpu.ops import block_sweep as bs
    from bayesrrcpp_tpu.ops.strided import bayesr_strided_sweep
    from bayesrrcpp_tpu.ops.sweep import SweepResult

    rng = np.random.default_rng(91)
    N, M, B, J, G, C, K = 96, 256, 8, 4, 2, 3, 4
    X = rng.standard_normal((N, M)).astype(np.float32)
    XT = jnp.asarray(X.T)
    xsq = jnp.sum(XT * XT, axis=1)
    gram = bs.gram_blocks(XT, B)
    nb = M // B
    nr = nb // J
    eps = jnp.asarray(rng.standard_normal((C, N)).astype(np.float32))
    beta = jnp.zeros((C, M), jnp.float32).at[:, 5].set(0.3)
    labels = jnp.zeros((C, M), jnp.int32)
    p = jnp.asarray(rng.uniform(0, 1, (C, M)).astype(np.float32))
    z = jnp.asarray(rng.normal(0, 1, (C, M)).astype(np.float32))
    pi = jnp.asarray(rng.dirichlet([5, 2, 2, 1], (C, G)).astype(np.float32))
    cva = jnp.tile(jnp.asarray([CVA], jnp.float32), (G, 1))
    sigmaE = jnp.asarray(rng.uniform(0.5, 1.0, C).astype(np.float32))
    sigmaGG = jnp.asarray(rng.uniform(0.02, 0.1, (C, G)).astype(np.float32))
    gas = jnp.asarray(np.arange(M) % G, jnp.int32)
    valid = jnp.ones(M, bool)
    mesh = make_mesh(2, 1)
    nb_loc = nb // 2
    rho, inner = bs.strided_orders(jax.random.PRNGKey(5), nb_loc, B, J)
    e = jnp.zeros((0,), jnp.float32)

    def sweep(eps, beta, labels, p, z, pi, sE, sGG, XT, gram, xsq, gas, vd):
        def local(eps, beta, labels, p, z, XT, gram, xsq, gas, vd):
            return bayesr_strided_sweep(
                (XT, e, e, e), gram, xsq, eps, beta, labels, rho, inner, p, z,
                pi, cva, sE, sGG, gas, vd, J=J,
                reduce_r=lambda r: jax.lax.psum(r, "n"),
                reduce_eps=lambda u: jax.lax.psum(u, "m"))

        m, c = P(None, "m"), P("m")
        f = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), m, m, m, m, c, c, c, c, c),
            out_specs=SweepResult(P(), m, m, P(), P()), check_vma=False)
        return f(eps, beta, labels, p, z, XT, gram, xsq, gas, vd)

    out = sweep(eps, beta, labels, p, z, pi, sigmaE, sigmaGG, XT, gram, xsq,
                gas, valid)
    for c in range(C):
        sl = slice(c, c + 1)
        one = sweep(eps[sl], beta[sl], labels[sl], p[sl], z[sl], pi[sl],
                    sigmaE[sl], sigmaGG[sl], XT, gram, xsq, gas, valid)
        np.testing.assert_array_equal(np.asarray(one[2])[0],
                                      np.asarray(out[2])[c])
        np.testing.assert_allclose(np.asarray(one[1])[0],
                                   np.asarray(out[1])[c],
                                   rtol=3e-4, atol=3e-6)
        np.testing.assert_allclose(np.asarray(one[0])[0],
                                   np.asarray(out[0])[c],
                                   rtol=3e-4, atol=3e-5)


@pytest.mark.slow
def test_sharded_run_chains_fused_t():
    """run_chains on a marker shape large enough for J > 1 per slice:
    recovery + per-chain residual bookkeeping."""
    sim = simulate.simulate_bayesr(seed=57, N=260, M=4096, n_causal=30,
                                   h2=0.5)
    s = ShardedSpikeSlabSampler(sim.X, sim.Y, CVA,
                                BayesRConfig(block_size=32),
                                make_mesh(2, 1), dtype=jnp.float32)
    assert s.jacobi > 1  # the fused path under test
    chain = ChainConfig(max_iterations=100, burn_in=50, thinning=5)
    _, out = s.run_chains(jax.random.PRNGKey(21), 2, chain)
    assert out["beta"].shape[1] == 2
    bh = out["beta"].mean(axis=(0, 1))
    corr = np.corrcoef(sim.beta_true, bh[: s.M])[0, 1]
    assert corr > 0.7, corr
    assert np.std(out["sigmaE"], axis=1).max() > 0  # chains distinct
    st = s.init_chains(jax.random.PRNGKey(22), 2)
    st = s.step_chains(st)
    beta = np.asarray(st.beta)[:, : s.M]
    for c in range(2):
        eps_direct = sim.Y - float(st.mu[c]) - sim.X @ beta[c]
        np.testing.assert_allclose(np.asarray(st.eps)[c, : s.N],
                                   eps_direct, atol=2e-3)


@pytest.mark.slow
def test_sharded_packed_missing_keeps_jacobi_t():
    """Packed X with missing calls keeps J > 1 per slice (exact decode);
    the residual invariant pins exactness."""
    rng = np.random.default_rng(73)
    N, M = 260, 4096   # per-shard 2048: the t-plan engagement point
    dos = rng.integers(0, 3, size=(N, M)).astype(float)
    dos[rng.random((N, M)) < 0.02] = np.nan
    dos[0, :] = 1.0  # keep every marker observed
    means = np.nanmean(dos, 0)
    sds = np.nanstd(dos, 0, ddof=1)
    Xs = np.where(np.isnan(dos), 0.0, (dos - means[None, :]) / sds[None, :])
    beta_true = np.zeros(M)
    beta_true[:20] = rng.normal(0, 0.5, 20)
    Y = Xs @ beta_true + rng.normal(0, 1, N)
    s = ShardedSpikeSlabSampler(dos, Y, CVA, BayesRConfig(block_size=32),
                                make_mesh(2, 1), dtype=jnp.float32, x_dtype="2bit")
    assert not s._x_fold and s.jacobi > 1
    st = s.init(jax.random.PRNGKey(3))
    for _ in range(3):
        st = s.step(st)
    # un-permute eps and check the residual invariant against the exact
    # mean-imputed standardized matrix
    n_perm = np.asarray(s.data.n_perm)
    eps_o = np.zeros(s.Npad, np.float32)
    eps_o[n_perm] = np.asarray(st.eps)
    beta = np.asarray(st.beta)[: s.M]
    eps_direct = Y - float(st.mu) - Xs @ beta
    np.testing.assert_allclose(eps_o[: s.N], eps_direct, atol=2e-3)
