"""Command-line interface.

The reference is driven from R scripts; this CLI covers the same workflows
end-to-end from the shell, reading PLINK .bed or NumPy inputs:

    python -m bayesrrcpp_tpu bayesr    --bed data --pheno y.txt --out chain.csv
    python -m bayesrrcpp_tpu groups    --x X.npy --y y.npy --groups-file g.txt \
                                       --fixed F.npy --out chain.csv
    python -m bayesrrcpp_tpu horseshoe --x X.npy --y y.npy --out chain.csv
    python -m bayesrrcpp_tpu resume    --checkpoint ck.npz --x X.npy ...

Hyperparameter flags carry the reference names (v0E, s02E, v0G, s02G, cva...).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--bed", help="PLINK .bed/.bim/.fam prefix")
    p.add_argument("--pheno", help="phenotype file (.fam-style or 1 column)")
    p.add_argument("--x", help=".npy/.npz matrix of shape (N, M)")
    p.add_argument("--y", help=".npy phenotype vector")
    p.add_argument("--out", required=True, help="output CSV path")
    p.add_argument("--npz-out", help="also write a columnar .npz")
    p.add_argument("--checkpoint-out", help="write final state checkpoint")
    p.add_argument("--checkpoint-every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="also checkpoint to --checkpoint-out periodically "
                        "during the run (crash recovery; the reference has "
                        "no mid-chain recovery at all)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--burn-in", type=int, default=1000)
    p.add_argument("--thinning", type=int, default=5)
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--backend", choices=["auto", "blocked", "scan"],
                   default="auto")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--platform", choices=["default", "cpu", "gpu"],
                   default="default",
                   help="force the JAX platform (cpu is useful for small "
                        "runs on a machine with a GPU)")
    p.add_argument("--no-epsilon", action="store_true",
                   help="omit the per-sample residual vector from the output")
    p.add_argument("--no-standardize", action="store_true")
    p.add_argument("--x-dtype", choices=["dense", "int8", "2bit"],
                   default="dense",
                   help="genotype storage: dense f32, int8 codes, or 2-bit "
                        "packed words (0.25 B/genotype; biobank scale on "
                        "one chip).  With --bed, 2bit decodes straight to "
                        "the packed layout -- no dense X on the host")
    p.add_argument("--decode-threads", type=int, default=0,
                   help="threads for the native .bed decoder (0 = all)")
    p.add_argument("--chains", type=int, default=1,
                   help="run N chains fused in one kernel (one CSV per "
                        "chain, '.chainK' inserted before the extension)")


def _add_mixture(p):
    p.add_argument("--cva", default="0.0001,0.001,0.01",
                   help="slab variances, comma separated (reference cva)")
    p.add_argument("--v0E", type=float, default=0.001)
    p.add_argument("--s02E", type=float, default=0.001)
    p.add_argument("--v0G", type=float, default=0.001)
    p.add_argument("--s02G", type=float, default=0.001)
    p.add_argument("--sigma0", type=float, default=0.01)


def _load_xy(args):
    """Returns (X, Y, sampler_kwargs).  Quantized x-dtypes standardize
    inside the kernel, so X stays raw dosage codes (int8) or packed words
    (2bit); the packed .bed path never densifies on the host."""
    from .io import bed as bedio

    x_dtype = getattr(args, "x_dtype", "dense")
    kw = {} if x_dtype == "dense" else {"x_dtype": x_dtype}
    if args.bed:
        if not args.pheno:
            raise SystemExit("--pheno is required with --bed")
        Y = bedio.read_phenotype(args.pheno)
        if x_dtype == "2bit":
            import jax.numpy as jnp

            pb = bedio.read_bed_packed(args.bed, n_threads=args.decode_threads)
            if Y.shape[0] != pb.n:
                raise SystemExit(f"phenotype length {Y.shape[0]} != N {pb.n}")
            kw.update(transposed=True, x_stats=(pb.means, pb.sds),
                      n_individuals=pb.n)
            return jnp.asarray(pb.words), Y, kw
        data = bedio.read_bed(
            args.bed,
            standardize=x_dtype == "dense" and not args.no_standardize,
            impute_missing=x_dtype == "dense")
        X = data.X
    elif args.x and args.y:
        X = np.load(args.x)
        if hasattr(X, "files"):
            X = X[X.files[0]]
        Y = np.load(args.y)
        if x_dtype == "dense" and not args.no_standardize:
            sd = X.std(axis=0, ddof=1)
            sd[sd == 0] = 1.0
            X = (X - X.mean(axis=0)) / sd
    else:
        raise SystemExit("provide either --bed/--pheno or --x/--y")
    if Y.shape[0] != X.shape[0]:
        raise SystemExit(f"phenotype length {Y.shape[0]} != N {X.shape[0]}")
    return X, Y, kw


def _dtype(args):
    import jax.numpy as jnp

    return jnp.float64 if args.dtype == "f64" else jnp.float32


def _backend(args):
    return None if args.backend == "auto" else args.backend


def _wrap_sinks(args, sink):
    from .io.sink import NpzSink, TeeSink

    if args.npz_out:
        return TeeSink(sink, NpzSink(args.npz_out))
    return sink


def _progress(done, total):
    # decile progress prints, like the reference (src/BayesRv2.cpp:173-175)
    if total and done % max(1, total // 10) == 0:
        print(f"emitted {done}/{total} samples", flush=True)


def _compose_chunks(*fns):
    fns = [f for f in fns if f is not None]
    if not fns:
        return None
    if len(fns) == 1:
        return fns[0]

    def on_chunk(state, done):
        for f in fns:
            f(state, done)

    return on_chunk


def _hs_decile_printer(total):
    """Decile tau/eta/sigmaE progress prints, mirroring the reference's
    horseshoe observability (src/HorseshoeR.cpp:200-207)."""
    import numpy as np

    last = [0]

    def on_chunk(state, done):
        decile = done * 10 // max(1, total)
        if decile > last[0]:
            last[0] = decile
            tau = np.asarray(state.tau).reshape(-1)
            eta = np.asarray(state.eta).reshape(-1)
            sE = np.asarray(state.sigmaE).reshape(-1)
            fmt = lambda a: (f"{a[0]:.6g}" if a.size == 1 else
                             "[" + ",".join(f"{x:.4g}" for x in a) + "]")
            print(f"emitted {done}/{total}: tau {fmt(tau)} eta {fmt(eta)} "
                  f"sigmaE {fmt(sE)}", flush=True)

    return on_chunk


def _periodic_saver(args):
    """Time-throttled mid-chain checkpointer (atomic rename)."""
    if not (args.checkpoint_out and getattr(args, "checkpoint_every", 0) > 0):
        return None
    import os
    import time

    from .io.checkpoint import save_checkpoint

    # np.savez appends .npz when missing; normalize so the atomic rename
    # targets the same file the final save writes
    target = (args.checkpoint_out if args.checkpoint_out.endswith(".npz")
              else args.checkpoint_out + ".npz")
    last = [time.monotonic()]

    def on_chunk(state, done):
        now = time.monotonic()
        if now - last[0] >= args.checkpoint_every:
            tmp = target[:-4] + ".tmp.npz"
            save_checkpoint(tmp, state)
            os.replace(tmp, target)
            last[0] = now

    return on_chunk


def _run(sampler, args, chain, sink, extra_sinks, on_chunk=None):
    import jax

    sink = _wrap_sinks(args, sink)
    state, _ = sampler.run(jax.random.PRNGKey(args.seed), chain, sink=sink,
                           collect=False, progress=_progress,
                           on_chunk=_compose_chunks(_periodic_saver(args),
                                                    on_chunk))
    for s in extra_sinks:
        s.close()
    sink.close()
    if args.checkpoint_out:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, state)
    return state


def _run_chains(sampler, args, chain, schema, on_chunk=None, **sink_kw):
    import jax

    from .io.sink import ChainFanoutSink

    sink = ChainFanoutSink.csv(args.out, args.chains, schema, **sink_kw)
    state, _ = sampler.run_chains(jax.random.PRNGKey(args.seed), args.chains,
                                  chain, sink=sink, collect=False,
                                  progress=_progress,
                                  on_chunk=_compose_chunks(
                                      _periodic_saver(args), on_chunk))
    sink.close()
    if args.checkpoint_out:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, state)
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bayesrrcpp_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("bayesr", help="ungrouped BayesR spike-and-slab chain")
    _add_common(p1)
    _add_mixture(p1)

    p2 = sub.add_parser("groups", help="grouped BayesRR chain + fixed effects")
    _add_common(p2)
    _add_mixture(p2)
    p2.add_argument("--groups-file", required=True,
                    help="one int group id per marker (gAssign)")
    p2.add_argument("--fixed", help=".npy (N, F) fixed-effect covariates")

    p3 = sub.add_parser("horseshoe", help="regularized-horseshoe chain")
    _add_common(p3)
    p3.add_argument("--A", type=float, default=1.0)
    p3.add_argument("--v0E", type=float, default=0.001)
    p3.add_argument("--s02E", type=float, default=0.001)
    p3.add_argument("--vL", type=float, default=1.0)
    p3.add_argument("--vT", type=float, default=1.0)
    p3.add_argument("--c2", type=float, default=1.0)
    p3.add_argument("--vC", type=float, default=10.0)
    p3.add_argument("--sC", type=float, default=10.0)

    p4 = sub.add_parser("resume", help="resume a chain from a checkpoint")
    _add_common(p4)
    _add_mixture(p4)
    p4.add_argument("--checkpoint",
                    help="framework checkpoint (.npz): exact resume incl. "
                         "RNG key")
    p4.add_argument("--from-csv",
                    help="resume from the last row of a sample CSV, like "
                         "the reference's BRV2Grstart workflow "
                         "(pi re-drawn from component counts; RNG restarts "
                         "from --seed).  Horseshoe CSVs are detected by "
                         "their tau/lambda columns (eta/v/c2 re-drawn from "
                         "their conditionals).  Quantized --x-dtype runs "
                         "reconstruct missing epsilon columns from the "
                         "on-device genotype container")
    p4.add_argument("--groups-file")
    p4.add_argument("--fixed",
                    help=".npy (N, F) fixed-effect covariates; REQUIRED "
                         "when the CSV/checkpoint carries alpha columns")
    # horseshoe hyperparameters (used when the resumed chain is horseshoe)
    p4.add_argument("--A", type=float, default=1.0)
    p4.add_argument("--vL", type=float, default=1.0)
    p4.add_argument("--vT", type=float, default=1.0)
    p4.add_argument("--c2", type=float, default=1.0)
    p4.add_argument("--vC", type=float, default=10.0)
    p4.add_argument("--sC", type=float, default=10.0)

    p5 = sub.add_parser("summarize",
                        help="posterior summaries of saved chains (the "
                             "vignette's manual R post-processing)")
    p5.add_argument("--npz", action="append", required=True,
                    help="columnar chain output (--npz-out); repeat for "
                         "multi-chain R-hat/ESS")
    p5.add_argument("--x", help=".npy (N, M) standardized X for PVE")
    p5.add_argument("--y", help=".npy phenotype for PVE")
    p5.add_argument("--top", type=int, default=10,
                    help="print the top-K markers by inclusion probability")

    args = ap.parse_args(argv)

    if args.cmd == "summarize":
        return _summarize(args)

    if getattr(args, "platform", "default") != "default":
        import jax

        jax.config.update("jax_platforms", args.platform)

    from .config import BayesRConfig, ChainConfig, GroupsConfig, HorseshoeConfig
    from .io.sink import CSVSink
    from .models.bayesr import SpikeSlabSampler
    from .models.horseshoe import HorseshoeSampler

    X, Y, xkw = _load_xy(args)
    chain = ChainConfig(args.iterations, args.burn_in, args.thinning)
    dt = _dtype(args)
    emit_eps = not args.no_epsilon

    if args.cmd == "bayesr":
        cva = np.array([float(v) for v in args.cva.split(",")])
        cfg = BayesRConfig(sigma0=args.sigma0, v0E=args.v0E, s02E=args.s02E,
                           v0G=args.v0G, s02G=args.s02G,
                           block_size=args.block_size, emit_epsilon=emit_eps)
        s = SpikeSlabSampler(X, Y, cva, cfg, backend=_backend(args), dtype=dt,
                             **xkw)
        if args.chains > 1:
            _run_chains(s, args, chain, "bayesr", M=s.M, N=s.N,
                        emit_epsilon=emit_eps)
        else:
            sink = CSVSink(args.out, "bayesr", M=s.M, N=s.N,
                           emit_epsilon=emit_eps)
            _run(s, args, chain, sink, [])
    elif args.cmd == "groups":
        g_assign = np.loadtxt(args.groups_file, dtype=np.int32).reshape(-1)
        G = int(g_assign.max()) + 1
        cva_row = np.array([float(v) for v in args.cva.split(",")])
        cva = np.tile(cva_row, (G, 1))
        fixed = np.load(args.fixed) if args.fixed else None
        cfg = GroupsConfig(sigma0=args.sigma0, v0E=args.v0E, s02E=args.s02E,
                           v0G=args.v0G, s02G=args.s02G,
                           block_size=args.block_size, emit_epsilon=emit_eps)
        s = SpikeSlabSampler(X, Y, cva, cfg, g_assign=g_assign, fixed=fixed,
                             backend=_backend(args), dtype=dt, **xkw)
        if args.chains > 1:
            _run_chains(s, args, chain, "groups", M=s.M, N=s.N, groups=G,
                        F=s.F, emit_epsilon=emit_eps)
        else:
            sink = CSVSink(args.out, "groups", M=s.M, N=s.N, groups=G, F=s.F,
                           emit_epsilon=emit_eps)
            _run(s, args, chain, sink, [])
    elif args.cmd == "horseshoe":
        cfg = HorseshoeConfig(A=args.A, v0E=args.v0E, s02E=args.s02E,
                              vL=args.vL, vT=args.vT, c2=args.c2, vC=args.vC,
                              sC=args.sC, block_size=args.block_size,
                              emit_epsilon=emit_eps)
        s = HorseshoeSampler(X, Y, cfg, backend=_backend(args), dtype=dt,
                             **xkw)
        deciles = _hs_decile_printer(len(chain.emit_iterations()))
        if args.chains > 1:
            _run_chains(s, args, chain, "horseshoe", M=s.M, N=s.N,
                        emit_epsilon=emit_eps, on_chunk=deciles)
        else:
            sink = CSVSink(args.out, "horseshoe", M=s.M, N=s.N,
                           emit_epsilon=emit_eps)
            _run(s, args, chain, sink, [], on_chunk=deciles)
    elif args.cmd == "resume":
        import jax

        from .models.state import HorseshoeState

        if bool(args.checkpoint) == bool(args.from_csv):
            raise SystemExit("resume needs exactly one of --checkpoint / "
                             "--from-csv")
        quantized = bool(xkw.get("x_dtype"))
        state = None
        if args.checkpoint:
            from .io.checkpoint import load_checkpoint

            state = load_checkpoint(args.checkpoint)
            family = ("horseshoe" if isinstance(state, HorseshoeState)
                      else "mixture")
        else:
            from .io.resume import csv_schema

            family = csv_schema(args.from_csv)
            family = "mixture" if family == "mixture" else "horseshoe"

        if family == "horseshoe":
            cfg = HorseshoeConfig(A=args.A, v0E=args.v0E, s02E=args.s02E,
                                  vL=args.vL, vT=args.vT, c2=args.c2,
                                  vC=args.vC, sC=args.sC,
                                  block_size=args.block_size,
                                  emit_epsilon=emit_eps)
            s = HorseshoeSampler(X, Y, cfg, backend=_backend(args), dtype=dt,
                                 **xkw)
            if args.from_csv:
                from .io.resume import horseshoe_kwargs_from_csv

                kw = horseshoe_kwargs_from_csv(
                    args.from_csv, X=None if quantized else X, Y=Y,
                    xbeta=s.xbeta)
                state = s.init_from(jax.random.PRNGKey(args.seed), **kw)
            sink = CSVSink(args.out, "horseshoe", M=s.M, N=s.N,
                           emit_epsilon=emit_eps)
            state = state._replace(
                iteration=jax.numpy.zeros((), jax.numpy.int32))
            n_emits = len(chain.emit_iterations())
            _run_state(s, state, args, chain, sink,
                       on_chunk=_hs_decile_printer(n_emits))
            return 0

        if args.groups_file:
            g_assign = np.loadtxt(args.groups_file, dtype=np.int32).reshape(-1)
        else:
            g_assign = None
        fixed = np.load(args.fixed) if args.fixed else None
        if args.checkpoint:
            G = state.sigmaGG.shape[0]
            init_row = None
        else:
            from .io.resume import parse_last_row

            init_row = parse_last_row(args.from_csv)
            G = np.atleast_1d(init_row.get("sigmaG",
                                           np.array([np.nan]))).size
        cva_row = np.array([float(v) for v in args.cva.split(",")])
        cva = np.tile(cva_row, (G, 1))
        cfg = GroupsConfig(sigma0=args.sigma0, v0E=args.v0E, s02E=args.s02E,
                           v0G=args.v0G, s02G=args.s02G,
                           block_size=args.block_size, emit_epsilon=emit_eps)
        s = SpikeSlabSampler(X, Y, cva, cfg, g_assign=g_assign, fixed=fixed,
                             backend=_backend(args), dtype=dt,
                             variant="groups" if G > 1 else "bayesr", **xkw)
        if init_row is not None:
            from .io.resume import state_kwargs_from_csv

            init_kwargs = state_kwargs_from_csv(
                args.from_csv, X=None if quantized else X, Y=Y,
                fixed=fixed, xbeta=s.xbeta)
            state = s.init_from(jax.random.PRNGKey(args.seed), **init_kwargs)
        if state.alpha.shape[-1] != s.F:
            raise SystemExit(
                f"resumed state has {state.alpha.shape[-1]} fixed-effect "
                f"coefficients but the sampler was built with F={s.F}; "
                "pass the matching --fixed matrix")
        schema = ("groups" if s.F > 0
                  else ("grstart" if G > 1 else "bayesr"))
        sink = CSVSink(args.out, schema, M=s.M, N=s.N, groups=G, F=s.F,
                       emit_epsilon=emit_eps)
        state = state._replace(iteration=jax.numpy.zeros((), jax.numpy.int32))
        _run_state(s, state, args, chain, sink)
    return 0


def _summarize(args):
    import json

    from .utils import summary

    chains = [dict(np.load(p)) for p in args.npz]
    s0 = chains[0]
    out = {"n_samples": int(s0["mu"].shape[0]), "n_chains": len(chains)}
    for k in ("mu", "sigmaE", "sigmaF", "tau"):
        if k in s0:
            out[k + "_mean"] = float(np.mean([c[k].mean() for c in chains]))
    if "sigmaG" in s0:
        h2 = np.concatenate([summary.heritability_samples(c) for c in chains])
        out["h2_mean"] = float(h2.mean())
        out["h2_sd"] = float(h2.std(ddof=1)) if h2.size > 1 else 0.0
    if "comp" in s0:
        pip = np.mean([summary.inclusion_probabilities(c) for c in chains],
                      axis=0)
        top = np.argsort(-pip)[: args.top]
        out["top_markers"] = [{"index": int(i), "pip": round(float(pip[i]), 4)}
                              for i in top]
    if args.x and args.y:
        X = np.load(args.x)
        Y = np.load(args.y)
        merged = {"beta": np.concatenate([c["beta"] for c in chains], axis=0)}
        out["pve"] = round(summary.pve(merged, X, Y), 4)
    if len(chains) > 1:
        for k in ("sigmaE", "mu", "tau"):
            if k in s0:
                stacked = np.stack([c[k].reshape(-1) for c in chains], axis=1)
                out[f"rhat_{k}"] = round(float(summary.split_rhat(stacked)), 4)
                out[f"ess_{k}"] = round(float(summary.ess(stacked)), 1)
    print(json.dumps(out, indent=2))
    return 0


def _run_state(sampler, state, args, chain, sink, on_chunk=None):
    sink = _wrap_sinks(args, sink)
    state, _ = sampler.run(state, chain, sink=sink, collect=False,
                           progress=_progress,
                           on_chunk=_compose_chunks(_periodic_saver(args),
                                                    on_chunk))
    sink.close()
    if args.checkpoint_out:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint_out, state)
    return state


if __name__ == "__main__":
    sys.exit(main())
