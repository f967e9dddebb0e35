"""Sequential per-marker Gibbs sweeps as ``lax.scan`` (reference-exact path).

This is the direct transcription of the reference's hot marker loop
(reference: src/BayesRv2.cpp:186-245, src/BayesRv2Groups.cpp:232-298,
src/HorseshoeR.cpp:219-240): one O(N) dot product and one O(N) rank-1 residual
update per marker, sequential in the marker order because epsilon carries the
dependency.  It supports an *arbitrary* marker permutation and is the
correctness anchor the fast Gram-blocked sweep (ops/block_sweep.py) is tested
against; use it for parity runs and small problems.

Algebraic simplification vs the reference (exact in real arithmetic): the
reference materialises ``y_tilde = eps + X_j * beta_j`` and computes
``num = X_j . y_tilde`` (src/BayesRv2.cpp:191,201); we use
``num = X_j . eps + beta_j * xsq_j`` which avoids one O(N) pass, and fold the
two residual updates into ``eps += X_j * (beta_old - beta_new)``
(src/BayesRv2.cpp:243).

Layout: X is stored transposed, ``XT`` of shape (M, N), so each marker is a
contiguous row (a dynamic-slice instead of a strided column gather).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .selection import select_component


class SweepResult(NamedTuple):
    eps: jax.Array       # (N,) updated residuals
    beta: jax.Array      # (M,) updated effects
    labels: jax.Array    # (M,) int32 component labels
    v: jax.Array         # (G, K) per-group component counts
    beta_acum: jax.Array # (G,) per-group sum of squared freshly-drawn slab effects


def bayesr_sweep_scan(XT, xsq, eps, beta, labels, order, p_arr, z_arr,
                      pi, cva, sigmaE, sigmaGG, g_assign, valid):
    """One full spike-and-slab marker sweep in the given order.

    Works for both the ungrouped sampler (G=1, g_assign all zero) and the
    grouped one (per-marker gather of the pi row / cva row / sigmaG by
    g_assign, reference: src/BayesRv2Groups.cpp:235-240,259).

    pi: (G, K), cva: (G, K-1), sigmaGG: (G,).
    p_arr/z_arr: per-*position* uniform / normal variates, same length as
    ``order``.  ``valid`` masks out padding markers (no-op updates).
    """
    G, K = pi.shape
    v0 = jnp.zeros((G, K), eps.dtype)
    bacc0 = jnp.zeros((G,), eps.dtype)

    def body(carry, xs):
        eps, beta, labels = carry[0], carry[1], carry[2]
        v, bacc = carry[3], carry[4]
        j, p, z = xs
        g = g_assign[j]
        ok = valid[j]
        xj = XT[j]
        num = jnp.dot(xj, eps) + beta[j] * xsq[j]
        res = select_component(p, z, num, xsq[j], pi[g], cva[g],
                               sigmaE, sigmaGG[g], beta[j], labels[j])
        d = jnp.where(ok, res.delta, jnp.zeros_like(res.delta))
        eps = eps - xj * d
        beta = beta.at[j].set(jnp.where(ok, res.beta_new, beta[j]))
        labels = labels.at[j].set(jnp.where(ok, res.label_new, labels[j]))
        v = v.at[g].add(jnp.where(ok, res.count_onehot,
                                  jnp.zeros_like(res.count_onehot)))
        # betaAcum accumulates beta^2 only for freshly drawn slab effects
        # (reference: src/BayesRv2Groups.cpp:280).
        slab = jnp.sum(res.count_onehot[1:])
        bacc = bacc.at[g].add(
            jnp.where(ok, slab * res.beta_new * res.beta_new, 0.0))
        return (eps, beta, labels, v, bacc), None

    (eps, beta, labels, v, bacc), _ = lax.scan(
        body, (eps, beta, labels, v0, bacc0), (order, p_arr, z_arr))
    return SweepResult(eps, beta, labels, v, bacc)


def horseshoe_sweep_scan(XT, xsq, eps, beta, order, z_arr,
                         lam, tau, c2, sigmaE, valid):
    """One dense regularized-horseshoe marker sweep (src/HorseshoeR.cpp:219-240).

    Effective prior variance per marker is the regularised-horseshoe
    ``s_j = tau*c2*lambda_j / (tau*lambda_j + c2)``; the update is the dense
    conjugate draw ``beta_j = num/denom + sqrt(sigmaE/denom) * z`` with
    ``denom = xsq_j + sigmaE/s_j`` (src/HorseshoeR.cpp:234).  lambda is held
    fixed during the sweep (it is refreshed afterwards, src/HorseshoeR.cpp:242).
    """

    def body(carry, xs):
        eps, beta = carry
        j, z = xs
        xj = XT[j]
        num = jnp.dot(xj, eps) + beta[j] * xsq[j]
        s_j = tau * c2 * lam[j] / (tau * lam[j] + c2)
        denom = xsq[j] + sigmaE / s_j
        beta_new = num / denom + jnp.sqrt(sigmaE / denom) * z
        d = jnp.where(valid[j], beta_new - beta[j], jnp.zeros_like(beta_new))
        eps = eps - xj * d
        beta = beta.at[j].set(jnp.where(valid[j], beta_new, beta[j]))
        return (eps, beta), None

    (eps, beta), _ = lax.scan(body, (eps, beta), (order, z_arr))
    return eps, beta
