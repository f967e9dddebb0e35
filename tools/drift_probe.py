"""Long-chain f32 residual drift at the biobank shape: run >= 1000 Gibbs
iterations of the packed headline config and periodically compare the
TRACKED eps (rank-B updates inside the sweep) against a fresh exact
recompute eps = Y - mu - X beta (the sampler's refresh_eps pass,
ops/genotypes.xbeta_packed).

The f64 reference accrues no meaningful drift (src/BayesRv2.cpp:60); the
f32 engine needs this measured bound + the optional
ChainConfig.eps_refresh_every mitigation.

Run on a GPU:  python tools/drift_probe.py [iters] [check_every]
Writes drift_curve.json (in the working directory) and prints the curve.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
import numpy as np                                             # noqa: E402


def main(iters=1000, check_every=100, N=100_352, M=503_808):
    from bayesrrcpp_tpu import BayesRConfig, SpikeSlabSampler
    from bayesrrcpp_tpu.simulate import (packed_word_stats,
                                         random_packed_words)

    from bayesrrcpp_tpu.ops.genotypes import xbeta_packed

    key = jax.random.PRNGKey(0)
    kx, kb, kc = jax.random.split(key, 3)
    XT = random_packed_words(kx, M, N // 16)
    # Y needs real signal: a no-signal chain can hit m0 == 0 and draw
    # sigmaG from an ~0-dof inv-scaled-chi^2 (NaN path)
    means, sds = packed_word_stats(M)
    n_causal = M // 500
    bt = jnp.zeros((M,), jnp.float32).at[
        jax.random.choice(kb, M, (n_causal,), replace=False)].set(
        jax.random.normal(kb, (n_causal,)) * float(np.sqrt(0.5 / n_causal)))
    g = xbeta_packed(XT, jnp.asarray(means, jnp.float32),
                     jnp.asarray(1.0 / sds, jnp.float32), bt, 512, N)
    Y = g + jax.random.normal(kc, (N,), jnp.float32) * \
        jnp.sqrt(jnp.maximum(jnp.var(g), 1e-3))
    smp = SpikeSlabSampler(XT, Y, np.array([0.0001, 0.001, 0.01]),
                           BayesRConfig(block_size=512), transposed=True,
                           x_dtype="2bit", x_stats=packed_word_stats(M))
    state = smp.init(jax.random.PRNGKey(1))
    curve = []
    t0 = time.perf_counter()
    for it in range(0, iters, check_every):
        state = smp._run_steps(state, smp.data, check_every)
        exact = smp.refresh_eps(state)
        num = float(jnp.linalg.norm(state.eps - exact.eps))
        den = float(jnp.linalg.norm(exact.eps))
        rel = num / max(den, 1e-30)
        curve.append({"iteration": it + check_every,
                      "rel_drift": rel,
                      "abs_drift": num})
        print(f"iter {it + check_every:5d}  rel drift {rel:.3e}  "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        # keep sweeping the TRACKED eps (drift accumulates undisturbed)
        state = state._replace(eps=state.eps)
    out = {"config": f"biobank packed N={N} M={M} f32",
           "iters": iters, "check_every": check_every, "curve": curve,
           "max_rel_drift": max(c["rel_drift"] for c in curve)}
    path = "drift_curve.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["curve"][-1]), "->", path)


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:]]
    main(*a)
