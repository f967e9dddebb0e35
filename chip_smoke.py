"""Smoke run of the samplers compiled on one GPU: the quickest proof that the
system starts on the card and gives the right answers there.

    python chip_smoke.py                # one card: phases 1-6 below
    python chip_smoke.py --four-cards   # four cards: legs (i)-(iii) only

One process uses the card(s).  Phases (any failure ends the run with a
non-zero exit; no phase carries on past an error):

1. device: platform, kind, count, the card's name and power limit, the JAX
   version and the matmul precision; exits unless the platform is ``gpu``;
2. X pass (ops/xpass.py) at N=100,352 over one 4,096-marker slab, with and
   without missing calls: every implementation against float64 NumPy on
   the decoded codes (relative L2 <= 1e-5), then each one's time;
3. one strided sweep against the plain oracle (ops/block_sweep.py) from a
   warm state at N=16,384 x M=49,152 (J=128, B=32), on dense f32 and on
   2-bit words with and without missing calls: labels equal, beta and eps
   to the CPU tests' tolerances;
4. the main path at full width through the public API, 2-bit words at
   N=100,352 x M=503,808: BayesR through ``run`` with a CSV sink, groups
   (G=4), horseshoe, 8 fused chains, and missing calls.  Each leg checks
   that sigmaE stays finite and below 2 over 8 iterations and that the
   tracked eps agrees with an exact recompute (relative error < 1e-4), and
   prints compile seconds and ms/iteration (informational, not the
   benchmark).  The BayesR leg also times the iteration with each X-pass
   implementation;
5. the CLI on a .bed written from a seed (checks the entry point, not the
   scale);
6. the ``gpu``-marked tests.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_BIO, M_BIO = 100_352, 503_808          # BASELINE.json config 4
N_ORACLE, M_ORACLE = 16_384, 49_152      # phase 3
N_POD, M_POD = 400_000, 1_000_000        # BASELINE.json config 5, leg (i)
N_CMP, M_CMP = 4_096, 65_536             # leg (ii)
CVA = (0.0001, 0.001, 0.01)


def log(*parts):
    print(*parts, flush=True)


def phase(name):
    log(f"== {name}")


def setup_jax(four_cards: bool):
    if four_cards:
        # four CPU devices beside the cards, for leg (ii)'s comparison
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, HERE)
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(HERE, ".jax_cache"))
    import bayesrrcpp_tpu  # noqa: F401  (sets the matmul precision)

    return jax


# ------------------------------------------------------------------ phase 1

def device_phase(jax):
    from bayesrrcpp_tpu.utils.device import device_record

    phase("device")
    rec = device_record()
    log(f"platform={rec['platform']} kind={rec['kind']} "
        f"count={rec['count']}")
    log(f"card: {rec['card']}")
    log(f"jax {jax.__version__}, matmul precision "
        f"{jax.config.jax_default_matmul_precision}")
    if rec["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX found {rec['platform']!r}")
    return rec


def timed(fn, *args, reps=5):
    """Median wall seconds of fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


# ------------------------------------------------------------------ phase 2

def xpass_phase(jax, card):
    import jax.numpy as jnp
    import numpy as np

    from bayesrrcpp_tpu.ops import xpass
    from bayesrrcpp_tpu.simulate import (packed_word_stats,
                                         random_packed_words,
                                         random_packed_words_missing)

    phase(f"X pass: each implementation vs float64 NumPy (N={N_BIO:,}, "
          f"one 4,096-marker slab)")
    J, B, nr, slab = 128, 32, 2, 1
    M, Nw = J * B * nr, N_BIO // 16
    rows = ((np.arange(J)[:, None] * nr + slab) * B
            + np.arange(B)[None]).reshape(-1)
    means, sds = packed_word_stats(M)
    mean = jnp.asarray(means, jnp.float32)
    scale = jnp.asarray(1.0 / sds, jnp.float32)
    rv = jnp.ones((N_BIO,), bool)
    rng = np.random.default_rng(0)
    for missing in (False, True):
        gen = random_packed_words_missing if missing else random_packed_words
        words = gen(jax.random.PRNGKey(int(missing)), M, Nw)
        w_slab = np.asarray(words)[rows]
        for C in (1, 8):
            eps = rng.standard_normal((C, 16, Nw))
            d = rng.standard_normal((C, J * B))
            r64 = np.zeros((C, J * B))
            u64 = np.zeros((C, 16, Nw))
            for k in range(16):
                code = (w_slab >> (2 * k)) & 3
                x = np.where(code == 3, 0.0, (code - means[0]) / sds[0])
                r64 += eps[:, k] @ x.T
                u64[:, k] = d @ x
            eps_j = jnp.asarray(eps.reshape(C, -1), jnp.float32)
            d_j = jnp.asarray(d.reshape(C, J, B), jnp.float32)
            for impl in ("triton", "xla"):
                kw = dict(J=J, nr=nr, kind="2bit", fold=not missing,
                          impl=impl)
                dot = jax.jit(lambda w, e: xpass.x_dot(
                    w, mean, scale, slab, e, **kw))
                app = jax.jit(lambda w, dd: xpass.x_apply(
                    w, mean, scale, rv, slab, dd, **kw))
                r = np.asarray(dot(words, eps_j)).reshape(C, -1)
                u = np.asarray(app(words, d_j)).reshape(C, 16, Nw)
                er = np.linalg.norm(r - r64) / np.linalg.norm(r64)
                eu = np.linalg.norm(u - u64) / np.linalg.norm(u64)
                t_dot = timed(dot, words, eps_j)
                t_app = timed(app, words, d_j)
                gb = J * B * Nw * 4 / 1e9
                log(f"xpass missing={missing} C={C} impl={impl}: "
                    f"rel err r={er:.2e} update={eu:.2e}; "
                    f"dot {t_dot * 1e3:.3f} ms, update {t_app * 1e3:.3f} ms "
                    f"({gb:.3f} GB of words each) [{card}]")
                if not (er <= 1e-5 and eu <= 1e-5):
                    raise AssertionError(f"X pass error above 1e-5 ({impl})")


# ------------------------------------------------------------------ phase 3

def oracle_phase(jax):
    import jax.numpy as jnp
    import numpy as np

    from bayesrrcpp_tpu.ops import block_sweep as bs
    from bayesrrcpp_tpu.ops import genotypes, strided
    from bayesrrcpp_tpu.ops.xpass import xpass_impl
    from bayesrrcpp_tpu.simulate import (packed_word_stats,
                                         random_packed_words,
                                         random_packed_words_missing)

    N, M = N_ORACLE, M_ORACLE
    J, B = strided.jacobi_plan(M, 512)
    phase(f"strided sweep vs the plain oracle (N={N:,} x M={M:,}, "
          f"J={J}, B={B})")
    nb = M // B
    rng = np.random.default_rng(33)
    beta = (rng.normal(0, 0.05, M) * (rng.random(M) < 0.3)).astype(
        np.float32)
    labels = ((beta != 0) * rng.integers(1, 4, M)).astype(np.int32)
    beta, labels = jnp.asarray(beta), jnp.asarray(labels)
    eps_o = rng.standard_normal(N).astype(np.float32)
    p = jax.random.uniform(jax.random.PRNGKey(34), (M,), jnp.float32)
    z = jax.random.normal(jax.random.PRNGKey(35), (M,), jnp.float32)
    pi = jnp.asarray([[0.5, 0.2, 0.2, 0.1]], jnp.float32)
    cva = jnp.asarray([CVA], jnp.float32)
    sE, sGG = jnp.float32(0.8), jnp.asarray([0.05], jnp.float32)
    gas, valid = jnp.zeros(M, jnp.int32), jnp.ones(M, bool)
    rho, inner = bs.strided_orders(jax.random.PRNGKey(11), nb, B, J)
    oracle = jax.jit(lambda XT, gram, xsq, eps: bs.bayesr_jacobi_sweep(
        XT, gram, xsq, eps, beta, labels, bs.strided_border(rho, J), inner,
        p, z, pi, cva, sE, sGG, gas, valid, J=J))
    shifts = jnp.arange(16, dtype=jnp.int32) * 2

    for kind in ("dense", "2bit", "2bit-missing"):
        if kind == "dense":
            XT = jax.random.normal(jax.random.PRNGKey(1), (M, N), jnp.float32)
            xsq = jnp.sum(XT * XT, axis=1)
            gram = bs.gram_blocks(XT, B)
            e = jnp.zeros((0,))
            xs, store, perm, fold = (XT, e, e, e), "dense", None, False
            eps_s = jnp.asarray(eps_o)
        else:
            missing = kind.endswith("missing")
            gen = (random_packed_words_missing if missing
                   else random_packed_words)
            words = gen(jax.random.PRNGKey(2), M, N // 16)
            q = genotypes.quantize_packed(words, True, packed_word_stats(M),
                                          B, M, N, prepacked=True)
            assert q.has_missing == missing
            code = (words[:, :, None] >> shifts) & 3      # (M, Nw, 16)
            XT = jnp.where(code == 3, 0.0,
                           (code - q.x_mean[:, None, None])
                           * q.x_scale[:, None, None]).reshape(M, N)
            xsq, gram = q.xsq, q.gram
            xs = (q.XT, q.x_mean, q.x_scale, q.row_valid)
            store, perm, fold = "2bit", np.asarray(q.n_perm), not missing
            eps_s = jnp.asarray(eps_o[perm])
        ref = oracle(XT, gram, xsq, jnp.asarray(eps_o))
        out = jax.jit(lambda xs, gram, xsq, eps: strided.bayesr_strided_sweep(
            xs, gram, xsq, eps[None], beta[None], labels[None], rho, inner,
            p[None], z[None], pi[None], cva, sE[None], sGG[None], gas, valid,
            J=J, kind=store, fold=fold,
            impl=xpass_impl("gpu")))(xs, gram, xsq, eps_s)
        eps_out = np.asarray(out.eps[0])
        if perm is not None:
            tmp = np.zeros_like(eps_out)
            tmp[perm] = eps_out
            eps_out = tmp
        lab = float((np.asarray(ref.labels)
                     == np.asarray(out.labels[0])).mean())
        db = float(np.abs(np.asarray(ref.beta) - np.asarray(out.beta[0]))
                   .max())
        de = float(np.abs(np.asarray(ref.eps) - eps_out).max())
        log(f"oracle {kind}: labels agree {lab:.6f}, beta maxdiff {db:.2e}, "
            f"eps maxdiff {de:.2e}")
        np.testing.assert_array_equal(np.asarray(ref.labels),
                                      np.asarray(out.labels[0]))
        np.testing.assert_allclose(np.asarray(ref.beta),
                                   np.asarray(out.beta[0]),
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(np.asarray(ref.eps), eps_out,
                                   rtol=2e-4, atol=2e-5)
        del XT, gram, ref, out


# ------------------------------------------------------------------ phase 4

def biobank_inputs(jax, missing=False, key=0):
    """2-bit words at the biobank shape and a population-stats phenotype
    (h2 = 0.5 over 491 causal markers)."""
    import jax.numpy as jnp
    import numpy as np

    from bayesrrcpp_tpu.ops.genotypes import xbeta_packed
    from bayesrrcpp_tpu.simulate import (packed_word_stats,
                                         random_packed_words,
                                         random_packed_words_missing)

    kx, kb, kc = jax.random.split(jax.random.PRNGKey(key), 3)
    gen = random_packed_words_missing if missing else random_packed_words
    XT = gen(kx, M_BIO, N_BIO // 16)
    means, sds = packed_word_stats(M_BIO)
    bt = jnp.zeros((M_BIO,), jnp.float32).at[
        jax.random.choice(kb, M_BIO, (491,), replace=False)].set(
        jax.random.normal(kb, (491,)) * float(np.sqrt(0.5 / 491)))
    g = xbeta_packed(XT, jnp.asarray(means, jnp.float32),
                     jnp.asarray(1.0 / sds, jnp.float32), bt, 512, N_BIO)
    Y = g + jax.random.normal(kc, (N_BIO,), jnp.float32) * \
        jnp.sqrt(jnp.maximum(jnp.var(g), 1e-3))
    return XT, Y, (means, sds)


def check_c(jax, smp, st, label):
    """sigmaE finite and below 2; tracked eps vs exact recompute."""
    import jax.numpy as jnp
    import numpy as np

    sE = np.asarray(st.sigmaE)
    ex = smp.refresh_eps(st)
    num = jnp.linalg.norm((st.eps - ex.eps).reshape(-1, st.eps.shape[-1]),
                          axis=-1)
    den = jnp.linalg.norm(ex.eps.reshape(-1, st.eps.shape[-1]), axis=-1)
    rel = float(jnp.max(num / den))
    log(f"{label}: sigmaE {' '.join(f'{v:.4f}' for v in sE.ravel())}, "
        f"eps vs recompute rel err {rel:.2e}")
    if not (np.isfinite(sE).all() and (sE < 2.0).all()):
        raise AssertionError(f"{label}: sigmaE {sE}")
    if not rel < 1e-4:
        raise AssertionError(f"{label}: eps rel err {rel}")


def use_xpass(jax, smp, impl):
    """Switch a sampler's X-pass implementation (fresh jits: a jitted step
    reads the choice when it is traced)."""
    smp._xpass_impl = impl
    smp._run_steps = jax.jit(smp._run_steps_impl, static_argnums=(2,),
                             donate_argnums=(0,))
    smp._mc_run_steps = jax.jit(
        lambda s, d, n: jax.lax.fori_loop(
            0, n, lambda i, st: smp._mc_step_impl(st, d), s),
        static_argnums=(2,), donate_argnums=(0,))


def run_leg(jax, smp, label, card, chains=0, iters=8):
    """compile + first iteration, then timed iterations; check (c)."""
    if chains:
        st = jax.vmap(smp.init)(
            jax.random.split(jax.random.PRNGKey(1), chains))
        step = lambda s: smp._mc_run_steps(s, smp.data, 1)
    else:
        st = smp.init(jax.random.PRNGKey(1))
        step = lambda s: smp._run_steps(s, smp.data, 1)
    t0 = time.perf_counter()
    st = jax.block_until_ready(step(st))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        st = step(st)
    st = jax.block_until_ready(st)
    ms = 1e3 * (time.perf_counter() - t0) / (iters - 1)
    log(f"{label}: J={smp.jacobi} B={smp.B} compile+first {compile_s:.1f} s, "
        f"{ms:.1f} ms/iteration [{card}]")
    check_c(jax, smp, st, label)
    return ms


def main_path_phase(jax, card):
    import gc

    import numpy as np

    from bayesrrcpp_tpu import (BayesRConfig, ChainConfig, GroupsConfig,
                                HorseshoeConfig, HorseshoeSampler,
                                SpikeSlabSampler)
    from bayesrrcpp_tpu.io.sink import CSVSink

    phase(f"main path at N={N_BIO:,} x M={M_BIO:,} (2-bit words)")
    XT, Y, stats = biobank_inputs(jax)
    kw = dict(transposed=True, x_dtype="2bit", x_stats=stats)

    # BayesR: timed steps, then the same iteration with the plain XLA
    # X pass, then the driver with a CSV sink
    t0 = time.perf_counter()
    smp = SpikeSlabSampler(XT, Y, np.array(CVA), BayesRConfig(), **kw)
    jax.block_until_ready(smp.data.gram)
    log(f"bayesr setup (stats + Gram) {time.perf_counter() - t0:.1f} s")
    assert smp._xpass_impl == "triton"
    ms_triton = run_leg(jax, smp, "bayesr", card)
    use_xpass(jax, smp, "xla")
    ms_xla = run_leg(jax, smp, "bayesr (plain XLA X pass)", card, iters=4)
    log(f"iteration, 1 chain: triton X pass {ms_triton:.1f} ms, plain XLA "
        f"X pass {ms_xla:.1f} ms [{card}]")
    use_xpass(jax, smp, "triton")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "chain.csv")
        sink = CSVSink(path, "bayesr", M=smp.M, N=smp.N)
        chain = ChainConfig(max_iterations=8, burn_in=5, thinning=3)
        t0 = time.perf_counter()
        st, _ = smp.run(jax.random.PRNGKey(2), chain, sink=sink,
                        collect=False)
        sink.close()
        with open(path) as f:
            header = f.readline().rstrip("\n").split(",")
            rows = [ln.rstrip("\n").split(",") for ln in f]
    first = -(-chain.burn_in // chain.thinning) * chain.thinning
    log(f"bayesr run() with CSVSink: {len(rows)} rows of {len(header)} "
        f"columns, first iteration {rows[0][0]} (want {first}), "
        f"{time.perf_counter() - t0:.1f} s")
    assert rows and all(len(r) == len(header) for r in rows)
    assert int(float(rows[0][0])) == first
    check_c(jax, smp, st, "bayesr run()")
    del smp, st
    gc.collect()

    G = 4
    cva = np.tile(np.array(CVA), (G, 1)) * np.arange(1, G + 1)[:, None]
    smp = SpikeSlabSampler(XT, Y, cva, GroupsConfig(),
                           g_assign=np.arange(M_BIO) % G, **kw)
    run_leg(jax, smp, "groups (G=4)", card)
    del smp
    gc.collect()

    smp = HorseshoeSampler(XT, Y, HorseshoeConfig(), **kw)
    run_leg(jax, smp, "horseshoe", card)
    del smp
    gc.collect()

    smp = SpikeSlabSampler(XT, Y, np.array(CVA), BayesRConfig(), **kw)
    _, _ = smp.run_chains(jax.random.PRNGKey(3), 8,
                          ChainConfig(2, 1, 1), collect=False)
    ms_triton = run_leg(jax, smp, "run_chains x8", card, chains=8)
    use_xpass(jax, smp, "xla")
    ms_xla = run_leg(jax, smp, "8 chains (plain XLA X pass)", card,
                     chains=8, iters=3)
    log(f"iteration, 8 chains: triton X pass {ms_triton:.1f} ms, plain XLA "
        f"X pass {ms_xla:.1f} ms [{card}]")
    del smp, XT, Y
    gc.collect()

    XT, Y, stats = biobank_inputs(jax, missing=True, key=5)
    smp = SpikeSlabSampler(XT, Y, np.array(CVA), BayesRConfig(),
                           transposed=True, x_dtype="2bit", x_stats=stats)
    assert not smp._x_fold
    run_leg(jax, smp, "bayesr, 1.6% missing calls", card)
    del smp, XT, Y
    gc.collect()


# ------------------------------------------------------------------ phase 5

def cli_phase():
    import numpy as np

    from bayesrrcpp_tpu.cli import main as cli_main
    from bayesrrcpp_tpu.io.bed import write_bed

    phase("CLI on a seeded .bed")
    rng = np.random.default_rng(9)
    N, M = 400, 300
    dos = rng.binomial(2, rng.uniform(0.1, 0.9, M), (N, M)).astype(float)
    dos[rng.random(dos.shape) < 0.01] = np.nan
    y = np.nan_to_num(dos[:, :5] - 1.0).sum(axis=1) + rng.normal(0, 1, N)
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "smoke")
        write_bed(prefix, dos)
        np.savetxt(os.path.join(td, "y.txt"), y)
        out = os.path.join(td, "chain.csv")
        rc = cli_main(["bayesr", "--bed", prefix, "--pheno",
                       os.path.join(td, "y.txt"), "--out", out,
                       "--iterations", "20", "--burn-in", "10",
                       "--thinning", "2", "--x-dtype", "2bit"])
        lines = open(out).read().strip().splitlines()
    log(f"cli bayesr --x-dtype 2bit: rc={rc}, {len(lines) - 1} rows")
    assert rc == 0 and len(lines) - 1 == 5


# ------------------------------------------------------------------ phase 6

def gpu_tests_phase():
    import pytest

    phase("gpu-marked tests")
    os.environ["BAYESRRCPP_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-o", "addopts=", "-p",
                      "no:cacheprovider", "--rootdir", HERE,
                      os.path.join(HERE, "tests", "test_xpass.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc={rc})")


# ------------------------------------------------------------- four cards

def packed_words_sharded(jax, mesh, M, Mpad, N, key):
    """Missing-free 2-bit words generated on each card under a
    NamedSharding over "m" (no gather); pad markers all-missing, pad
    lanes code 0."""
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    Nw = -(-N // 2048) * 128

    def gen(k):
        w = jax.random.randint(k, (Mpad, Nw), -(2 ** 31), 2 ** 31 - 1,
                               jnp.int32)
        h = w & jnp.int32(np.uint32(0xAAAAAAAA).astype(np.int32))
        codes = h | (w & jnp.int32(0x55555555) & ~(h >> 1))
        codes = jnp.where(jnp.arange(Nw)[None, :] < N // 16, codes, 0)
        return jnp.where(jnp.arange(Mpad)[:, None] < M, codes, -1)

    return jax.jit(gen, out_shardings=NamedSharding(mesh, P("m")))(
        jax.random.PRNGKey(key))


def four_cards(jax, card):
    import gc

    import jax.numpy as jnp
    import numpy as np

    from bayesrrcpp_tpu import (BayesRConfig, GroupsConfig, SpikeSlabSampler)
    from bayesrrcpp_tpu.parallel.chains import ChainParallelRunner, chain_mesh
    from bayesrrcpp_tpu.parallel.mesh import make_mesh
    from bayesrrcpp_tpu.parallel.sharded import (ShardedSpikeSlabSampler,
                                                 _slice_plan)
    from bayesrrcpp_tpu.simulate import packed_word_stats

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found "
                         f"{len(jax.devices())}")
    G = 4
    cva = np.tile(np.array(CVA), (G, 1)) * np.arange(1, G + 1)[:, None]

    def sharded(mesh, M, N, key):
        _, _, Mpad = _slice_plan(M, 4, 512)
        words = packed_words_sharded(jax, mesh, M, Mpad, N, key)
        Y = jax.random.normal(jax.random.PRNGKey(key + 1), (N,), jnp.float32)
        return ShardedSpikeSlabSampler(
            words, np.asarray(Y), cva, GroupsConfig(), mesh,
            g_assign=np.arange(M) % G, x_dtype="2bit", transposed=True,
            x_stats=packed_word_stats(M), n_individuals=N,
            has_missing=False, n_markers=M)

    phase(f"(i) sharded BayesR with groups, 2-bit, (4,1) mesh, "
          f"N={N_POD:,} x M={M_POD:,}")
    t0 = time.perf_counter()
    smp = sharded(make_mesh(4, 1), M_POD, N_POD, 10)
    jax.block_until_ready(smp.data.gram)
    log(f"(i) setup {time.perf_counter() - t0:.1f} s, Mpad={smp.Mpad}, "
        f"J={smp.jacobi} B={smp.B}, words/card "
        f"{smp.data.XT.addressable_shards[0].data.nbytes / 1e9:.1f} GB")
    st = smp.init(jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    st = jax.block_until_ready(smp.step(st))
    log(f"(i) compile+first {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for _ in range(2):
        st = smp.step(st)
    st = jax.block_until_ready(st)
    log(f"(i) {1e3 * (time.perf_counter() - t0) / 2:.1f} ms/iteration "
        f"[4 x {card}]")
    check_c(jax, smp, st, "(i) sharded groups")
    del smp, st
    gc.collect()

    phase(f"(ii) (4,1) mesh of cards vs (4,1) mesh of CPU devices, "
          f"N={N_CMP:,} x M={M_CMP:,}")
    res = {}
    for name, devs in (("gpu", jax.devices()), ("cpu", jax.devices("cpu"))):
        smp = sharded(make_mesh(4, 1, devices=devs), M_CMP, N_CMP, 20)
        st = smp.step(smp.init(jax.random.PRNGKey(3)))
        res[name] = jax.tree.map(np.asarray, st)
        del smp, st
    a, b = res["gpu"], res["cpu"]
    lab = float((a.labels == b.labels).mean())
    log(f"(ii) labels agree {lab:.6f}, beta maxdiff "
        f"{np.abs(a.beta - b.beta).max():.2e}, eps maxdiff "
        f"{np.abs(a.eps - b.eps).max():.2e}")
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.beta, b.beta, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(a.eps, b.eps, rtol=2e-4, atol=2e-5)

    phase(f"(iii) ChainParallelRunner, 4 x 2 chains at N={N_BIO:,} x "
          f"M={M_BIO:,}")
    XT, Y, stats = biobank_inputs(jax)
    smp = SpikeSlabSampler(XT, Y, np.array(CVA), BayesRConfig(),
                           transposed=True, x_dtype="2bit", x_stats=stats)
    runner = ChainParallelRunner(smp, chain_mesh(4))
    key = jax.random.PRNGKey(5)
    t0 = time.perf_counter()
    state = jax.block_until_ready(runner._steps(runner.init(key, 8),
                                                smp.data, 1))
    log(f"(iii) 8 chains on 4 cards, compile + 1 iteration "
        f"{time.perf_counter() - t0:.1f} s")
    beta_sh, lab_sh = np.asarray(state.beta), np.asarray(state.labels)
    keys = jax.random.split(key, 8)
    for g in range(4):
        sl = slice(2 * g, 2 * g + 2)
        st = smp.step_chains(jax.vmap(smp.init)(keys[sl]))
        agree = float((lab_sh[sl] == np.asarray(st.labels)).mean())
        log(f"(iii) card {g}: labels agree {agree:.6f}, beta maxdiff "
            f"{np.abs(beta_sh[sl] - np.asarray(st.beta)).max():.2e}")
        np.testing.assert_array_equal(lab_sh[sl], np.asarray(st.labels))
        np.testing.assert_allclose(beta_sh[sl], np.asarray(st.beta),
                                   rtol=1e-5, atol=1e-7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card legs (i)-(iii)")
    args = ap.parse_args()
    jax = setup_jax(args.four_cards)
    rec = device_phase(jax)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(jax, rec["card"])
    else:
        xpass_phase(jax, rec["card"])
        oracle_phase(jax)
        main_path_phase(jax, rec["card"])
        cli_phase()
        gpu_tests_phase()
    log(f"all phases passed in {time.perf_counter() - t0:.0f} s; "
        f"card: {rec['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}}))


if __name__ == "__main__":
    main()
