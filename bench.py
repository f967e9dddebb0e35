"""Benchmark: Gibbs sweep throughput on the attached GPU.

Prints ONE JSON line:
  {"metric": "snp_updates_per_sec", "value": N, "unit": "SNP-updates/s",
   "vs_baseline": R, "suite": [...]}

The headline metric is SNP-updates/sec/card on the BASELINE.json north-star
config (N=100k x M=500k BayesR, 2-bit packed, single chain).  The reference
publishes no numbers (BASELINE.md), so ``vs_baseline`` is measured against a
faithful single-core CPU proxy of the reference's inner loop: one O(N) dot +
two O(N) axpys per marker in f64 NumPy/BLAS (the same memory-bound kernel the
Eigen reference executes, src/BayesRv2.cpp:191,201,243), measured on this
host at the same N.

The default is a SUITE sweep over the BASELINE.md configs (dense small,
packed biobank x{1,8} chains, horseshoe biobank) so regressions are
machine-checkable from the one JSON artifact; each entry reports its own
iter time / SNP-updates/s / compile time and the device it ran on.  With no
GPU the script exits with an error; a config that fails still gets a
record, and the exit code is then non-zero.

Single-config mode (old behavior): set BENCH_SUITE=0 and/or any of
BENCH_N, BENCH_M, BENCH_ITERS, BENCH_BLOCK, BENCH_XDTYPE, BENCH_CHAINS,
BENCH_SAMPLER, BENCH_DTYPE.
"""
import gc
import json
import os
import time

import numpy as np


def cpu_reference_rate(N: int, n_markers: int = 2000) -> float:
    """Measured single-core CPU proxy for the reference per-SNP update cost."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N,))
    eps = rng.normal(size=(N,))
    t0 = time.perf_counter()
    for _ in range(n_markers):
        y_tilde = eps + x * 0.1          # rank-1 exclusion (src/BayesRv2.cpp:191)
        num = x @ y_tilde                # dominant dot      (src/BayesRv2.cpp:201)
        eps = y_tilde - x * (num * 1e-9) # rank-1 inclusion  (src/BayesRv2.cpp:243)
    elapsed = time.perf_counter() - t0
    return n_markers / elapsed


def _write_ref_input(path, dims, arrays):
    import struct

    with open(path, "wb") as f:
        for d in dims:
            f.write(struct.pack("<q", int(d)))
        for a in arrays:
            f.write(np.asarray(a, np.float64).tobytes(order="F"))


def _time_ref(binary, inp, workdir, iters, extra_args):
    """Wall-clock one reference run of `iters` iterations with emission
    suppressed (thinning > iters -> no post-burn-in emissions, no CSV I/O;
    no GRAFT_TRACE in env -> no RNG tracing)."""
    import subprocess

    csv = os.path.join(workdir, "t.csv")
    env = {k: v for k, v in os.environ.items() if k != "GRAFT_TRACE"}
    env["OMP_NUM_THREADS"] = "2"
    args = [binary, inp, csv, str(iters), "1", "1000000"] + \
        [str(a) for a in extra_args]
    t0 = time.perf_counter()
    r = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-500:])
    return time.perf_counter() - t0


def measured_reference_rates():
    """SNP-updates/s of the COMPILED UNMODIFIED reference samplers
    (golden/build.py -O3 timing build; the same translation units the
    golden-parity tests pin bit-exactly) at BASELINE.md configs 1-3 scale.

    Per-run setup cost (input parse + init pass) is removed by differencing
    a long and a short chain.  The reference cannot represent the biobank
    headline config at all (dense f64 X, src/BayesRv2.cpp:60), so the
    headline ratio scales the measured rate linearly in N -- conservative,
    since the reference's per-update working set (3 O(N) f64 passes,
    src/BayesRv2.cpp:191,201,243) falls out of cache as N grows.

    Returns {sampler: {...}} or None when the toolchain/reference tree is
    unavailable (bench then falls back to the NumPy proxy)."""
    import sys
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "golden"))
    try:
        from build import build_all

        bins = build_all(opt=True)
    except Exception:
        return None
    if not bins:
        return None
    rng = np.random.default_rng(7)
    out = {}
    hyps = [0.01, 0.001, 0.001, 0.001, 0.001]   # sigma0, v0E, s02E, v0G, s02G
    # >= 10 iters: the reference's decile progress print divides by
    # max_iterations/10 in integer math (src/BayesRv2.cpp:173) -> SIGFPE
    # below 10
    lo_it, hi_it = 10, 30
    try:
        with tempfile.TemporaryDirectory() as td:
            # BASELINE.md config-true shapes (round-3 VERDICT #7): M=50k
            # rows anchor the headline ratio, and the GROUPS sampler (the
            # config-2/5 family) is timed directly at N=5k x M=50k x G=2
            for name, N, M in (("bayesr", 2000, 10000),
                               ("bayesr", 5000, 50000),
                               ("groups", 5000, 50000),
                               ("horseshoe", 2000, 50000)):
                if name not in bins:
                    continue
                X = rng.standard_normal((N, M))
                X = (X - X.mean(0)) / X.std(0, ddof=1)
                bt = np.zeros(M)
                bt[:100] = rng.normal(0, 0.07, 100)
                Y = X @ bt + rng.normal(0, 0.7, N)
                inp = os.path.join(td, f"{name}_{N}_{M}.bin")
                if name == "bayesr":
                    _write_ref_input(inp, (N, M, 3),
                                     (X, Y, np.array([0.001, 0.01, 0.1])))
                    extra = hyps
                elif name == "groups":
                    cva2 = np.array([[0.001, 0.01, 0.1],
                                     [0.002, 0.02, 0.2]])
                    gas = (np.arange(M) % 2).astype(float)
                    _write_ref_input(inp, (N, M, 2, 3, 0),
                                     (X, Y, cva2, gas,
                                      np.zeros((N, 0))))
                    extra = hyps
                else:
                    _write_ref_input(inp, (N, M), (X, Y))
                    A = (1.0 / np.sqrt(N)) * 100.0 / (M - 100.0)
                    extra = [A, 0.001, 0.001, 1.0, 1.0, 1.0, 10.0, 10.0]
                del X
                t_lo = _time_ref(bins[name], inp, td, lo_it, extra)
                t_hi = _time_ref(bins[name], inp, td, hi_it, extra)
                if t_hi - t_lo < 0.05:  # noisy box: the two-point
                    # difference lost the signal; retry once
                    t_lo = _time_ref(bins[name], inp, td, lo_it, extra)
                    t_hi = _time_ref(bins[name], inp, td, hi_it, extra)
                if t_hi - t_lo < 0.05:
                    # drop rather than emit garbage -- but say so, or a
                    # missing reference row is unexplainable (advisor)
                    import sys
                    print(f"bench: reference timing for {name} N={N} "
                          f"stayed noisy after retry; row dropped",
                          file=sys.stderr)
                    continue
                rate = M * (hi_it - lo_it) / max(t_hi - t_lo, 1e-9)
                out[f"{name}-N{N}-M{M}"] = {
                    "sampler": name, "N": N, "M": M,
                    "snp_updates_per_sec": round(rate, 1),
                    "iters_timed": hi_it - lo_it,
                    "platform": "cpu-reference(-O3)"}
    except Exception as e:
        out["error"] = repr(e)[:200]
    return out or None


def run_config(*, N, M, iters, B=512, x_dtype="dense", sampler="bayesr",
               chains=1, dtype_name="f32", label="", jacobi=None,
               missing=False, sharded=False, emit=False, vL=1.0):
    """Run one bench config; returns the result record."""
    import jax
    import jax.numpy as jnp

    from bayesrrcpp_tpu import BayesRConfig, SpikeSlabSampler

    from bayesrrcpp_tpu.utils.device import device_record

    device = device_record()
    dtype = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32

    key = jax.random.PRNGKey(0)
    kx, kb, kn, kc = jax.random.split(key, 4)

    t0 = time.perf_counter()
    extra = {}
    if x_dtype == "2bit":
        from bayesrrcpp_tpu.simulate import (packed_word_stats,
                                             random_packed_words,
                                             random_packed_words_missing)

        N = -(-N // 2048) * 2048
        if missing:
            # ~1.6% missing-at-random calls (real non-imputed .bed data):
            # the exact decode of the X pass
            XT = random_packed_words_missing(kx, M, N // 16)
        elif os.environ.get("BENCH_MISSING") == "1":  # 1/4 of calls missing
            XT = jax.random.randint(kx, (M, N // 16), -(2 ** 31),
                                    2 ** 31 - 1, jnp.int32)
        else:  # missing-free -> the folded X pass
            XT = random_packed_words(kx, M, N // 16)
        extra = dict(x_dtype="2bit", x_stats=packed_word_stats(M))
        Y = jax.random.normal(kc, (N,), jnp.float32)
    elif x_dtype == "int8":
        XT = jax.random.randint(kx, (M, N), 0, 3, dtype=jnp.int8)
        extra = dict(x_dtype="int8",
                     x_stats=(np.full(M, 1.0), np.full(M, np.sqrt(2 / 3))))
        Y = jax.random.normal(kc, (N,), jnp.float32)
    else:
        XT = jax.random.normal(kx, (M, N), jnp.float32)
        n_causal = max(1, M // 100)
        beta = jnp.where(jax.random.uniform(kb, (M,)) < n_causal / M,
                         jax.random.normal(kn, (M,)) * jnp.sqrt(0.5 / n_causal),
                         0.0)
        Y = beta @ XT + jax.random.normal(kc, (N,)) * jnp.sqrt(0.5)
    Y.block_until_ready()
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if sharded:
        # (m=1, n=1) mesh: the SHARDED driver's per-card rate; psum is
        # the identity
        from bayesrrcpp_tpu.parallel.mesh import make_mesh
        from bayesrrcpp_tpu.parallel.sharded import ShardedSpikeSlabSampler

        cva = np.array([0.0001, 0.001, 0.01], np.float64)
        smp = ShardedSpikeSlabSampler(
            XT, Y, cva, BayesRConfig(block_size=B), make_mesh(1, 1),
            transposed=True, dtype=dtype,
            has_missing=bool(missing), **extra)
        jax.block_until_ready(smp.data.gram)
        setup_s = time.perf_counter() - t0
        state = smp.init(jax.random.PRNGKey(1))
        run = lambda st: smp._get_run_steps(iters)(st, smp.data)
        sync = lambda st: float(np.asarray(st.sigmaE))
        t0 = time.perf_counter()
        state = run(state)
        sync(state)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = run(state)
        sync(state)
        elapsed = time.perf_counter() - t0
        rate = M * iters / elapsed
        rec = {"label": label, "snp_updates_per_sec": round(rate, 1),
               "N": N, "M": M, "iters": iters, "sampler": sampler,
               "x_dtype": x_dtype, "chains": 1, "sharded": True,
               "jacobi": smp.jacobi, "block_used": smp.B,
               "device": device,
               "iter_ms": round(1e3 * elapsed / iters, 1),
               "gibbs_iters_per_min": round(60 * iters / elapsed, 2),
               "gen_s": round(gen_s, 1), "gram_s": round(setup_s, 1),
               "compile_s": round(compile_s, 1)}
        del state, smp, XT, Y
        gc.collect()
        return rec
    if sampler == "horseshoe":
        from bayesrrcpp_tpu import HorseshoeConfig
        from bayesrrcpp_tpu.models.horseshoe import HorseshoeSampler

        smp = HorseshoeSampler(XT, Y, HorseshoeConfig(block_size=B, vL=vL),
                               transposed=True, dtype=jnp.float32,
                               jacobi_blocks=jacobi, **extra)
    elif sampler == "groups":
        # grouped-annotation variant (BASELINE config 2/5 family): 4
        # annotation groups with per-group sigmaG/pi (src/BayesRv2Groups.cpp)
        from bayesrrcpp_tpu import GroupsConfig

        cva = np.array([[0.0001, 0.001, 0.01],
                        [0.0002, 0.002, 0.02],
                        [0.0001, 0.001, 0.01],
                        [0.0005, 0.005, 0.05]], np.float64)  # (G, K-1)
        g_assign = (np.arange(M) % 4).astype(np.int32)
        smp = SpikeSlabSampler(XT, Y, cva, GroupsConfig(block_size=B),
                               g_assign=g_assign, transposed=True,
                               dtype=dtype, jacobi_blocks=jacobi, **extra)
    else:
        cva = np.array([0.0001, 0.001, 0.01], np.float64)
        smp = SpikeSlabSampler(
            XT, Y, cva,
            BayesRConfig(block_size=B, emit_epsilon=not emit),
            transposed=True, dtype=dtype, jacobi_blocks=jacobi, **extra)
    jax.block_until_ready(smp.data.gram)
    setup_s = time.perf_counter() - t0

    if emit:
        # END-TO-END chain with live emission: the reference's whole
        # deliverable is the thinned CSV stream
        # (src/BayesRv2.cpp:257-290); this times the full driver loop
        # with a CSV (native formatter) + npz tee sink, eps off.
        import tempfile

        from bayesrrcpp_tpu import ChainConfig
        from bayesrrcpp_tpu.io.sink import CSVSink, NpzSink, TeeSink

        chain = ChainConfig(max_iterations=iters, burn_in=10, thinning=10)

        def one_run():
            with tempfile.TemporaryDirectory() as td:
                sink = TeeSink(
                    CSVSink(os.path.join(td, "c.csv"), "bayesr", M=smp.M,
                            N=smp.N, emit_epsilon=False),
                    NpzSink(os.path.join(td, "c.npz")))
                t1 = time.perf_counter()
                # emit_chunk=8: enough pipeline stages that host
                # transfer+format+write overlap device compute
                smp.run(jax.random.PRNGKey(1), chain, sink=sink,
                        collect=False, emit_chunk=8)
                sink.close()
                el = time.perf_counter() - t1
                csv_mb = os.path.getsize(os.path.join(td, "c.csv")) / 2**20
                return el, csv_mb

        compile_s, _ = one_run()        # compile + first-touch
        elapsed, csv_mb = one_run()
        rate = M * iters / elapsed
        rec = {"label": label, "snp_updates_per_sec": round(rate, 1),
               "N": N, "M": M, "iters": iters, "sampler": sampler,
               "x_dtype": x_dtype, "chains": 1, "emission": True,
               "thinning": 10, "n_emits": len(list(chain.emit_iterations())),
               "csv_mb": round(csv_mb, 1),
               "jacobi": smp.jacobi, "block_used": smp.B,
               "device": device,
               "iter_ms": round(1e3 * elapsed / iters, 1),
               "gibbs_iters_per_min": round(60 * iters / elapsed, 2),
               "gen_s": round(gen_s, 1), "gram_s": round(setup_s, 1),
               "compile_s": round(compile_s, 1)}
        del smp, XT, Y
        gc.collect()
        return rec

    # BENCH_CHAINS > 1: fused multi-chain sweep (all chains share one X
    # read per round; SNP-updates count multiplies by the chain count)
    if chains > 1:
        state = jax.vmap(smp.init)(
            jax.random.split(jax.random.PRNGKey(1), chains))
        run = lambda st: smp._mc_run_steps(st, smp.data, iters)
        sync = lambda st: float(np.asarray(st.sigmaE)[0])
    else:
        state = smp.init(jax.random.PRNGKey(1))
        run = lambda st: smp._run_steps(st, smp.data, iters)
        sync = lambda st: float(np.asarray(st.sigmaE))
    # warmup / compile with the SAME static iteration count as the timed
    # call (a different count would recompile inside the timed region)
    t0 = time.perf_counter()
    state = run(state)
    sync(state)  # hard host sync
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = run(state)
    sync(state)  # hard host sync
    elapsed = time.perf_counter() - t0

    rate = M * iters * chains / elapsed
    rec = {"label": label or f"{sampler}-{x_dtype}-{N}x{M}x{chains}",
           "snp_updates_per_sec": round(rate, 1),
           "N": N, "M": M, "iters": iters, "block": B,
           "sampler": sampler, "x_dtype": x_dtype, "chains": chains,
           "jacobi": smp.jacobi, "block_used": smp.B,
           "device": device,
           "iter_ms": round(1e3 * elapsed / iters, 1),
           "gibbs_iters_per_min": round(60 * iters / elapsed, 2),
           "gen_s": round(gen_s, 1), "gram_s": round(setup_s, 1),
           "compile_s": round(compile_s, 1)}
    # release device memory before the next config
    del state, smp, XT, Y
    gc.collect()
    return rec


# BASELINE.md-derived suite
SUITE = [
    # jacobi=None -> ops.strided.jacobi_plan (J=128, B=32 at these scales)
    dict(label="dense-16kx49k", N=16_384, M=49_152, iters=10,
         x_dtype="dense"),
    # exact-sequential sweep (J=1) kept as the semantics anchor
    dict(label="biobank-packed-serial", N=100_352, M=503_808, iters=5,
         x_dtype="2bit", jacobi=1),
    dict(label="biobank-packed-auto", N=100_352, M=503_808, iters=10,
         x_dtype="2bit"),
    # ~1.6% missing-at-random calls, as in real (non-imputed) .bed data
    dict(label="biobank-packed-missing", N=100_352, M=503_808, iters=10,
         x_dtype="2bit", missing=True),
    # end-to-end chain with live CSV+npz emission, thinning 10
    dict(label="biobank-packed-emit", N=100_352, M=503_808, iters=300,
         x_dtype="2bit", emit=True),
    # SHARDED driver on a (1, 1) mesh: its per-card rate
    dict(label="biobank-sharded-m1", N=100_352, M=503_808, iters=10,
         x_dtype="2bit", sharded=True),
    # fused multi-chain sweep: all chains share the X read and the
    # rounds
    dict(label="biobank-packed-8chain", N=100_352, M=503_808, iters=5,
         x_dtype="2bit", chains=8),
    dict(label="biobank-horseshoe", N=100_352, M=503_808, iters=10,
         x_dtype="2bit", sampler="horseshoe"),
    # non-default local dof: vL=3 -> gamma shape 2, the exact
    # sum-of-exponentials path (no rejection sampler)
    dict(label="biobank-horseshoe-vL3", N=100_352, M=503_808, iters=10,
         x_dtype="2bit", sampler="horseshoe", vL=3.0),
    dict(label="biobank-horseshoe-8chain", N=100_352, M=503_808, iters=5,
         x_dtype="2bit", sampler="horseshoe", chains=8),
    dict(label="biobank-groups", N=100_352, M=503_808, iters=10,
         x_dtype="2bit", sampler="groups"),
]
HEADLINE = "biobank-packed-auto"


def use_compile_cache():
    """JAX reads JAX_COMPILATION_CACHE_DIR itself where it is set;
    otherwise keep the persistent cache at a fixed path in the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


def main():
    import sys

    import jax

    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")

    single_env = any(os.environ.get(k) for k in
                     ("BENCH_N", "BENCH_M", "BENCH_XDTYPE", "BENCH_CHAINS",
                      "BENCH_SAMPLER", "BENCH_ITERS"))
    suite_mode = os.environ.get("BENCH_SUITE",
                                "" if single_env else "1") == "1"

    if suite_mode:
        suite = []
        for cfg in SUITE:
            try:
                suite.append(run_config(**cfg))
            except Exception as e:  # record the failure, keep sweeping
                suite.append({"label": cfg["label"], "error": repr(e)[:300]})
        failed = any("error" in r for r in suite)
        head = next((r for r in suite if r.get("label") == HEADLINE
                     and "error" not in r), None)
        if head is None:  # headline OOM'd? fall back to the first success
            head = next((r for r in suite if "error" not in r), None)
        if head is None:
            print(json.dumps({"metric": "snp_updates_per_sec", "value": 0,
                              "unit": "SNP-updates/s", "vs_baseline": 0,
                              "suite": suite}))
            sys.exit(1)
        base = cpu_reference_rate(head["N"])
        ref = measured_reference_rates()
        vs = vs_kind = None
        anchor = next((ref[k] for k in ("bayesr-N5000-M50000",
                                        "bayesr-N2000-M10000")
                       if ref and k in ref), None)
        if anchor:
            # the reference cannot represent the headline config (dense f64
            # X, src/BayesRv2.cpp:60); scale its measured rate linearly in
            # N (per-update cost is 3 O(N) f64 passes, src/BayesRv2.cpp:
            # 191,201,243), anchored at the largest measured N
            ref_at_head = (anchor["snp_updates_per_sec"] * anchor["N"]
                           / head["N"])
            vs = round(head["snp_updates_per_sec"] / ref_at_head, 2)
            vs_kind = "measured-reference-scaled-N"
        if vs is None:
            vs, vs_kind = round(head["snp_updates_per_sec"] / base, 2), \
                "numpy-proxy"
        print(json.dumps({
            "metric": "snp_updates_per_sec",
            "value": head["snp_updates_per_sec"],
            "unit": "SNP-updates/s",
            "vs_baseline": vs,
            "vs_baseline_kind": vs_kind,
            "headline": head["label"],
            "cpu_proxy_rate": round(base, 1),
            "reference_measured": ref,
            "suite": suite,
        }))
        sys.exit(1 if failed else 0)

    # single-config mode (env-pinned config)
    N = int(os.environ.get("BENCH_N", 16_384))
    M = int(os.environ.get("BENCH_M", 49_152))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    rec = run_config(
        N=N, M=M, iters=iters,
        B=int(os.environ.get("BENCH_BLOCK", 512)),
        x_dtype=os.environ.get("BENCH_XDTYPE", "dense"),
        sampler=os.environ.get("BENCH_SAMPLER", "bayesr"),
        chains=int(os.environ.get("BENCH_CHAINS", 1)),
        jacobi=(int(os.environ["BENCH_JACOBI"])
                if os.environ.get("BENCH_JACOBI") else None),
        dtype_name=os.environ.get("BENCH_DTYPE", "f32"))
    base = cpu_reference_rate(rec["N"])
    rec["cpu_ref_rate"] = round(base, 1)
    print(json.dumps({
        "metric": "snp_updates_per_sec",
        "value": rec["snp_updates_per_sec"],
        "unit": "SNP-updates/s",
        "vs_baseline": round(rec["snp_updates_per_sec"] / base, 2),
        "config": rec,
    }))


if __name__ == "__main__":
    main()
