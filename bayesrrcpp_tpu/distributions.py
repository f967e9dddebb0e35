"""Distribution / RNG library for the BayesR engine.

Functional equivalents of the reference RNG free functions
(reference: src/distributions.h:8-18, src/distributions.cpp:12-65), rebuilt on
``jax.random`` with explicit splittable PRNG keys.  The reference draws from R's
global C RNG and *ignores* its ``seed`` argument entirely (no sampler body uses
it); here every draw is keyed, which makes chains bitwise reproducible and
trivially parallelisable over markers / chains / devices.

Parameterisation conventions (kept identical to the reference so hyperparameter
values carry over 1:1):

- ``norm_rng(key, mean, sigma2)``        -- **variance** (not sd) parameter
  (reference: src/distributions.cpp:37-39).
- ``gamma_rng(key, shape, scale)``       -- shape/scale (src/distributions.cpp:24-26).
- ``gamma_rate_rng(key, shape, rate)``   -- shape/rate  (src/distributions.cpp:30-32).
- ``inv_gamma_rng(key, shape, scale)``   -- InvGamma with standard *scale* param
  (src/distributions.cpp:21-23): X = scale / Gamma(shape, 1).
- ``inv_gamma_rate_rng(key, shape, rate)`` -- identical distribution to
  ``inv_gamma_rng`` (the reference's two code paths reduce to the same sampler,
  src/distributions.cpp:27-29); kept as a named alias for call-site parity.
- ``inv_scaled_chisq_rng(key, dof, scale)`` -- Inv-Scaled-chi^2(dof, scale) =
  InvGamma(dof/2, dof*scale/2) (src/distributions.cpp:34-36).
- ``dirichlet_rng(key, alpha)``          -- gamma-normalise construction
  (src/distributions.cpp:12-20).
- ``beta_rng(key, a, b)``                -- src/distributions.cpp:60-62.
- ``exp_rng(key, mean)``                 -- R's ``rexp`` *mean/scale* convention
  (src/distributions.cpp:63-65).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def norm_rng(key, mean, sigma2):
    """Normal draw parameterised by mean and VARIANCE sigma2."""
    mean = jnp.asarray(mean)
    return mean + jnp.sqrt(jnp.asarray(sigma2, mean.dtype)) * jax.random.normal(
        key, jnp.shape(mean), dtype=mean.dtype if mean.dtype.kind == "f" else None
    )


def gamma_rng(key, shape, scale):
    """Gamma draw with shape/scale parameterisation."""
    shape = jnp.asarray(shape, jnp.result_type(float, shape))
    return jax.random.gamma(key, shape) * scale


def gamma_rate_rng(key, shape, rate):
    """Gamma draw with shape/rate parameterisation."""
    shape = jnp.asarray(shape, jnp.result_type(float, shape))
    return jax.random.gamma(key, shape) / rate


def inv_gamma_rng(key, shape, scale):
    """Inverse-gamma draw: if G ~ Gamma(shape, rate=scale) then 1/G ~ InvGamma(shape, scale)."""
    shape = jnp.asarray(shape, jnp.result_type(float, shape))
    return jnp.asarray(scale) / jax.random.gamma(key, shape)


def inv_gamma_rate_rng(key, shape, rate):
    """Alias of :func:`inv_gamma_rng`; the reference's rate path samples the same law."""
    return inv_gamma_rng(key, shape, rate)


def inv_scaled_chisq_rng(key, dof, scale):
    """Scaled inverse chi-squared draw: InvGamma(dof/2, dof*scale/2)."""
    dof = jnp.asarray(dof, jnp.result_type(float, dof))
    return inv_gamma_rng(key, 0.5 * dof, 0.5 * dof * scale)


def dirichlet_rng(key, alpha):
    """Dirichlet draw via independent Gamma(alpha_i, 1) normalisation."""
    alpha = jnp.asarray(alpha, jnp.result_type(float, alpha))
    g = jax.random.gamma(key, alpha)
    return g / jnp.sum(g)


def beta_rng(key, a, b, dtype=jnp.float32):
    return jax.random.beta(key, a, b, dtype=dtype)


def exp_rng(key, mean=1.0):
    """Exponential draw with MEAN (scale) `mean`, matching R's rexp C convention."""
    return jax.random.exponential(key) * mean


def gamma_shape_rng(key, alpha, size, dtype=None):
    """M-sized Gamma(alpha, 1) draws with exact rejection-free fast paths
    for STATIC integer and half-integer shapes.

    - alpha == 1: Gamma(1, 1) == Exponential(1), inverse CDF (the
      horseshoe's local-scale refresh draws 2M of these per iteration at
      the default vL = 1, src/HorseshoeR.cpp:218,242 -- this avoids
      XLA's rejection sampler there).
    - alpha in {0.5, 1.5, 2, 2.5, ...}: the exact decomposition
      Gamma(n + r) == sum of n Exponentials + [r == 1/2] * Z^2/2
      (Gamma(1/2, 1) == chi^2_1 / 2).  The horseshoe's shape is
      (1 + vL)/2, so EVERY integer dof vL is rejection-free -- the
      reference exposes vL as a free argument (src/HorseshoeR.cpp:109).
    - anything else: XLA's batched rejection sampler.
    """
    import jax

    dtype = jnp.float32 if dtype is None else dtype
    a = float(alpha)
    if a == 1.0:
        return jax.random.exponential(key, (size,), dtype)
    if a > 0 and (2.0 * a) == int(2.0 * a):
        n = int(a)
        half = (a - n) == 0.5
        ke, kz = jax.random.split(key)
        tot = jnp.zeros((size,), dtype)
        if n > 0:
            tot = jnp.sum(jax.random.exponential(ke, (n, size), dtype),
                          axis=0)
        if half:
            z = jax.random.normal(kz, (size,), dtype)
            tot = tot + 0.5 * z * z
        return tot
    return jax.random.gamma(key, jnp.full((size,), alpha, dtype), dtype=dtype)
