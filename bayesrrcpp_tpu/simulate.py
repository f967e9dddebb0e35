"""Simulation recipes for tests and benchmarks.

Mirrors the generative recipes the reference uses as its de-facto test
fixtures: the embedded R smoke scripts (reference: src/BayesRv2.cpp:297-315,
src/HorseshoeR.cpp:304-325) and the vignette pipelines
(vignettes/BayesRR.Rmd:33-68): sparse normal effects on a standardized
N(0,1) genotype matrix with a chosen heritability.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SimData(NamedTuple):
    X: np.ndarray          # (N, M) standardized
    Y: np.ndarray          # (N,)
    beta_true: np.ndarray  # (M,)
    g_assign: Optional[np.ndarray]  # (M,) or None
    fixed: Optional[np.ndarray]     # (N, F) or None
    alpha_true: Optional[np.ndarray]
    h2: float              # realised proportion of variance explained


def _standardize(A):
    A = A - A.mean(axis=0)
    sd = A.std(axis=0, ddof=1)
    sd[sd == 0] = 1.0
    return A / sd


def simulate_bayesr(seed, N, M, n_causal, h2=0.5, n_groups=1, n_fixed=0,
                    dtype=np.float64) -> SimData:
    """Sparse-effects simulation (reference smoke recipe, src/BayesRv2.cpp:298-308)."""
    rng = np.random.default_rng(seed)
    beta = np.zeros(M)
    causal = rng.choice(M, size=n_causal, replace=False)
    beta[causal] = rng.normal(0.0, np.sqrt(h2 / n_causal), size=n_causal)
    X = _standardize(rng.normal(size=(N, M)))
    g = X @ beta
    var_g = g.var()
    noise = rng.normal(0.0, np.sqrt(max(var_g, 1e-12) * (1 - h2) / max(h2, 1e-12)),
                       size=N)
    Y = g + noise

    fixed = alpha_true = None
    if n_fixed > 0:
        fixed = _standardize(rng.normal(size=(N, n_fixed)))
        alpha_true = rng.normal(0.0, 0.3, size=n_fixed)
        Y = Y + fixed @ alpha_true
    g_assign = None
    if n_groups > 1:
        g_assign = rng.integers(0, n_groups, size=M).astype(np.int32)

    realised_h2 = var_g / Y.var()
    return SimData(X.astype(dtype), Y.astype(dtype), beta, g_assign,
                   None if fixed is None else fixed.astype(dtype),
                   alpha_true, float(realised_h2))


def random_packed_words(key, M, n_words):
    """(M, n_words) int32 of 2-bit genotype codes with NO missing calls.

    Each packed field gets hi-bit from one random stream and lo-bit from a
    second, with lo forced to 0 whenever hi is 1 -- codes land in {0, 1, 2}
    (P = 1/4, 1/4, 1/2), never the missing code 3.  Device-side and cheap;
    used by benchmarks so the missing-free X pass is exercised.
    Stats for decode: mean 1.25, sd sqrt(11/16).
    """
    import jax
    import jax.numpy as jnp

    def gen(key):
        w = jax.random.randint(key, (M, n_words), -(2 ** 31), 2 ** 31 - 1,
                               jnp.int32)
        hi_mask = jnp.int32(np.uint32(0xAAAAAAAA).astype(np.int32))
        lo_mask = jnp.int32(0x55555555)
        h = w & hi_mask                  # hi bit of each field
        l = w & lo_mask & ~(h >> 1)      # lo bit, forced 0 when hi is set
        return h | l

    # one fused elementwise program: peak memory ~2 buffers, not 4
    return jax.jit(gen)(key)


def packed_word_stats(M):
    """x_stats matching random_packed_words' code distribution."""
    return np.full(M, 1.25), np.full(M, float(np.sqrt(11.0 / 16.0)))


def random_packed_words_missing(key, M, n_words, levels: int = 6):
    """random_packed_words plus missing-at-random calls: each 2-bit field
    is forced to the missing code 3 with probability 2**-levels (~1.6% at
    the default -- the realistic non-imputed .bed missingness the
    fast-path bench config models).  Missing-at-random leaves the
    non-missing code distribution unchanged, so packed_word_stats still
    applies.  Fully fused elementwise generation (no extra biobank-sized
    temps)."""
    import jax
    import jax.numpy as jnp

    def gen(key):
        kw, km = jax.random.split(key)
        w = jax.random.randint(kw, (M, n_words), -(2 ** 31), 2 ** 31 - 1,
                               jnp.int32)
        hi_mask = jnp.int32(np.uint32(0xAAAAAAAA).astype(np.int32))
        lo_mask = jnp.int32(0x55555555)
        h = w & hi_mask
        l = w & lo_mask & ~(h >> 1)
        codes = h | l
        m = jnp.full((M, n_words), -1, jnp.int32)
        for i in range(levels):
            m = m & jax.random.randint(jax.random.fold_in(km, i),
                                       (M, n_words), -(2 ** 31),
                                       2 ** 31 - 1, jnp.int32)
        lo = m & lo_mask
        return codes | lo | (lo << 1)        # both bits set -> code 3

    return jax.jit(gen)(key)
