"""Fixed-strided-partition validation under LD.

The strided sweep's Jacobi randomization uses a FIXED strided block
partition (ops/strided.py): the same J*B markers are co-updated every
iteration, randomized only by round visit order and within-block
permutations.  The argument that this is statistically
benign -- same-round blocks sit ~M/J markers apart, far beyond any LD
correlation length -- carries real weight only under CORRELATED
genotypes, which the iid smoke recipes never test.

This tool generates AR(1)-correlated dosages (corr length ~1/(1-rho)),
runs the exact-sequential J=1 anchor and the auto Jacobi plan (2 chains
each), and compares posterior means, PVE, split-R-hat, and
lag-1-autocorrelation ESS per marker.

Run:  python tools/ld_validation.py [N] [M] [rho] [iters]
(defaults sized for a GPU; tests/test_ld_partition.py runs a reduced
shape on CPU with bound assertions.)
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                                             # noqa: E402


def ar1_dosages(seed, N, M, rho):
    """AR(1)-latent correlated dosage matrix: z_j = rho z_{j-1} + e,
    thresholded at allele-frequency quantiles into {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    z = np.empty((N, M), np.float32)
    z[:, 0] = rng.standard_normal(N)
    e = rng.standard_normal((N, M)).astype(np.float32)
    s = np.sqrt(1.0 - rho * rho)
    for j in range(1, M):
        z[:, j] = rho * z[:, j - 1] + s * e[:, j]
    freqs = rng.uniform(0.2, 0.8, M)
    # genotype = #(latent > per-marker quantile) under HWE-ish cutoffs
    zs = np.sort(z, axis=0)
    cols = np.arange(M)
    i1 = np.clip(((1.0 - freqs) * (N - 1)).astype(int), 0, N - 1)
    i2 = np.clip(((1.0 - freqs * freqs) * (N - 1)).astype(int), 0, N - 1)
    q1 = zs[i1, cols]
    q2 = zs[i2, cols]
    dos = (z > q1[None, :]).astype(np.float32) + \
        (z > q2[None, :]).astype(np.float32)
    return dos


def ess_lag1(samples):
    """Per-marker ESS from lag-1 autocorrelation: S*(1-r1)/(1+r1)."""
    x = samples - samples.mean(axis=0, keepdims=True)
    v = (x * x).mean(axis=0) + 1e-30
    r1 = (x[1:] * x[:-1]).mean(axis=0) / v
    r1 = np.clip(r1, -0.99, 0.99)
    S = samples.shape[0]
    return S * (1.0 - r1) / (1.0 + r1)


def split_rhat(chains):
    """(S, C, M) -> per-marker split-R-hat."""
    S, C, M = chains.shape
    half = S // 2
    seq = chains[:2 * half].reshape(2, half, C, M).transpose(1, 0, 2, 3)
    seq = seq.reshape(half, 2 * C, M)
    mean_c = seq.mean(axis=0)
    W = seq.var(axis=0, ddof=1).mean(axis=0) + 1e-30
    Bv = half * mean_c.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + Bv / half
    return np.sqrt(var_plus / W)


def run(N=8192, M=32_768, rho=0.9, iters=1500, seed=5, block=512):
    import jax
    import jax.numpy as jnp

    from bayesrrcpp_tpu import BayesRConfig, ChainConfig, SpikeSlabSampler

    dos = ar1_dosages(seed, N, M, rho)
    means = dos.mean(0)
    sds = np.maximum(dos.std(0, ddof=1), 1e-6)
    Xs = ((dos - means) / sds).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    n_causal = max(8, M // 200)
    # clustered causal markers so LD actually matters for the posterior
    starts = rng.choice(M - 8, n_causal // 4, replace=False)
    idx = np.unique(np.concatenate([starts + k for k in range(4)]))
    bt = np.zeros(M, np.float32)
    bt[idx] = rng.normal(0, np.sqrt(0.5 / idx.size), idx.size)
    g = Xs @ bt
    Y = g + rng.normal(0, np.sqrt(max(g.var(), 1e-6)), N).astype(np.float32)

    burn = iters // 3
    thin = 2
    chain = ChainConfig(iters, burn, thin)
    out = {}
    for name, kw in (("J1", dict(jacobi_blocks=1)), ("auto_t", {})):
        s = SpikeSlabSampler(Xs, Y, np.array([0.0001, 0.001, 0.01]),
                             BayesRConfig(block_size=block),
                             dtype=jnp.float32, **kw)
        _, res = s.run_chains(jax.random.PRNGKey(11), 2, chain)
        beta = np.asarray(res["beta"])          # (S, 2, M)
        bh = beta.mean(axis=(0, 1))
        gh = Xs @ bh
        pve = float(gh.var() / Y.var())
        rh = split_rhat(beta)
        ess = np.concatenate([ess_lag1(beta[:, c]) for c in range(2)])
        out[name] = {
            "jacobi": int(s.jacobi), "block": int(s.B),
            "posterior_mean": bh, "pve": pve,
            "rhat_q99": float(np.quantile(rh, 0.99)),
            "rhat_max": float(rh.max()),
            "ess_mean": float(ess.mean()),
            "ess_causal_mean": float(np.concatenate(
                [ess_lag1(beta[:, c])[idx] for c in range(2)]).mean()),
            "corr_true": float(np.corrcoef(bt, bh)[0, 1]),
        }
    a, b = out["J1"], out["auto_t"]
    cmp = {
        "pair_posterior_corr": float(np.corrcoef(
            a["posterior_mean"], b["posterior_mean"])[0, 1]),
        "pve_J1": a["pve"], "pve_auto": b["pve"],
        "pve_rel_diff": abs(a["pve"] - b["pve"]) / max(a["pve"], 1e-9),
        "ess_ratio_auto_vs_J1": b["ess_mean"] / max(a["ess_mean"], 1e-9),
        "ess_causal_ratio": b["ess_causal_mean"] / max(
            a["ess_causal_mean"], 1e-9),
        "rhat_q99_J1": a["rhat_q99"], "rhat_q99_auto": b["rhat_q99"],
        "corr_true_J1": a["corr_true"], "corr_true_auto": b["corr_true"],
        "config": {"N": N, "M": M, "rho": rho, "iters": iters,
                   "J_auto": b["jacobi"]},
    }
    for v in out.values():
        v.pop("posterior_mean")
    cmp["per_config"] = out
    return cmp


def main():
    a = sys.argv[1:]
    N = int(a[0]) if len(a) > 0 else 8192
    M = int(a[1]) if len(a) > 1 else 32_768
    rho = float(a[2]) if len(a) > 2 else 0.9
    iters = int(a[3]) if len(a) > 3 else 1500
    cmp = run(N=N, M=M, rho=rho, iters=iters)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ld_validation.json")
    with open(path, "w") as f:
        json.dump(cmp, f, indent=1)
    print(json.dumps({k: v for k, v in cmp.items() if k != "per_config"},
                     indent=1))
    print("wrote", path)


if __name__ == "__main__":
    main()
