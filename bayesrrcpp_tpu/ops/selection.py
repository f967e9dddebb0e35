"""Spike-and-slab mixture component selection for one marker.

Vectorised re-derivation of the reference's per-marker categorical draw
(reference: src/BayesRv2.cpp:195-242; identical logic at
src/BayesRv2Groups.cpp:248-294 and src/BRv2Grstart.cpp:199-246), recast from a
branchy accumulate-and-break loop into branch-free cumulative comparisons so it
vectorises (over blocks and chains) and is usable inside ``lax.scan``.

Semantics reproduced exactly, including the quirks:

- overflow guard: the selection weight of candidate component k is zeroed when
  ``any |logL[1:] - logL[k]| > 700`` -- note the reference only compares the
  *slab* log-likelihoods against candidate k (src/BayesRv2.cpp:216, 235).
- no-selection edge case: if the uniform variate exceeds the final cumulative
  weight (possible when guards zero the weights), the reference's k-loop falls
  through without assigning: beta and the component label keep their previous
  values and no count is registered (src/BayesRv2.cpp:222-242).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SelectionResult(NamedTuple):
    beta_new: jax.Array     # scalar new effect (old value if nothing selected)
    label_new: jax.Array    # scalar int32 component label (old if nothing selected)
    count_onehot: jax.Array # (K,) 0/1 count contribution for the v vector
    delta: jax.Array        # beta_new - beta_old


def component_logL(pi_j, cva_j, muk_slab, num, xsq_j, sigmaE, sigmaG):
    """Per-component log marginal likelihood, reference: src/BayesRv2.cpp:207-211.

    pi_j: (K,) mixture probabilities for this marker's group.
    cva_j: (K-1,) slab variances.  muk_slab: (K-1,) conditional means.
    """
    # pi can underflow to exactly 0 out of the Dirichlet in low precision; the
    # f64 reference essentially never hits log(0).  Clamp to the smallest
    # normal so -inf never poisons the exp-difference sums with NaNs.
    tiny = jnp.finfo(pi_j.dtype).tiny
    logpi = jnp.log(jnp.maximum(pi_j, tiny))
    slab = (
        logpi[1:]
        - 0.5 * jnp.log((sigmaG / sigmaE) * xsq_j * cva_j + 1.0)
        + 0.5 * muk_slab * num / sigmaE
    )
    return jnp.concatenate([logpi[:1], slab])


def selection_weights(logL):
    """Cumulative selection weights A_k with the reference overflow guard.

    w_k = 0                                  if any |logL[1:] - logL[k]| > 700
        = 1 / sum_l exp(logL_l - logL_k)     otherwise
    A = cumsum(w); the sampler picks the first k with p <= A_k.
    """
    K = logL.shape[0]
    # D[k, i] = logL[1 + i] - logL[k]
    D = logL[1:][None, :] - logL[:, None]
    guard = jnp.any(jnp.abs(D) > 700.0, axis=1)
    # S[k] = sum_l exp(logL_l - logL_k); exp overflow -> inf -> weight 0,
    # matching the C++ f64 behaviour in spirit.
    S = jnp.sum(jnp.exp(logL[None, :] - logL[:, None]), axis=1)
    w = jnp.where(guard, jnp.zeros_like(S), 1.0 / S)
    return jnp.cumsum(w)


def select_component(p, z, num, xsq_j, pi_j, cva_j, sigmaE, sigmaG,
                     beta_old, label_old):
    """Draw the mixture label and effect for one marker.

    p: uniform(0,1) variate (the reference draws it via beta_rng(1,1) in C1/C3
    and R::runif in C2 -- the same law, src/BayesRv2.cpp:213).
    z: standard normal variate used iff a slab component is selected.
    num: X_j' y_tilde = X_j' eps + beta_old * xsq_j (src/BayesRv2.cpp:201).
    """
    K = pi_j.shape[0]
    denom = xsq_j + (sigmaE / sigmaG) / cva_j                 # (K-1,)
    muk_slab = num / denom                                     # (K-1,)
    logL = component_logL(pi_j, cva_j, muk_slab, num, xsq_j, sigmaE, sigmaG)
    A = selection_weights(logL)

    hit = p <= A
    any_hit = jnp.any(hit)
    k_sel = jnp.where(any_hit, jnp.argmax(hit), K).astype(jnp.int32)

    # beta draw: 0 for the spike, N(muk_k, sigmaE/denom_{k-1}) for slab k,
    # previous value if nothing was selected (src/BayesRv2.cpp:222-231).
    muk = jnp.concatenate([jnp.zeros_like(muk_slab[:1]), muk_slab])
    sd = jnp.sqrt(sigmaE / denom)
    sd_full = jnp.concatenate([jnp.zeros_like(sd[:1]), sd])
    k_idx = jnp.minimum(k_sel, K - 1)
    beta_drawn = muk[k_idx] + sd_full[k_idx] * z
    beta_new = jnp.where(k_sel == 0, jnp.zeros_like(beta_drawn),
                         jnp.where(any_hit, beta_drawn, beta_old))
    label_new = jnp.where(any_hit, k_sel, label_old)
    count_onehot = jnp.where(
        any_hit,
        (jnp.arange(K) == k_sel).astype(logL.dtype),
        jnp.zeros((K,), logL.dtype),
    )
    return SelectionResult(beta_new, label_new, count_onehot, beta_new - beta_old)
