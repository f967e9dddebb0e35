"""BayesR spike-and-slab Gibbs samplers (the engine for C1/C2/C3).

One engine covers the reference's three mixture samplers:

- ``variant="bayesr"``  -- BayesRSamplerV2 (reference: src/BayesRv2.cpp:60):
  single group, sigmaG scale uses the FULL ``|beta|^2`` (src/BayesRv2.cpp:248),
  priorPi derived from cva (the intent of the uninitialised-read at
  src/BayesRv2.cpp:150; see SURVEY.md section 2.3).
- ``variant="groups"`` -- BayesRSamplerV2Groups (src/BayesRv2Groups.cpp:75):
  per-group cva/pi/sigmaG rows gathered by gAssign, Gaussian fixed-effect
  sweep (src/BayesRv2Groups.cpp:216-225), per-group hyper updates
  (src/BayesRv2Groups.cpp:307-312).
- warm restart -- BRV2Grstart (src/BRv2Grstart.cpp:77): :meth:`init_from`
  rebuilds pi from the supplied component labels (src/BRv2Grstart.cpp:157-165)
  and the chain continues from the given state.  Unlike the reference, resume
  from a framework checkpoint is bitwise exact because the PRNG key is part of
  the state pytree.

Per-iteration skeleton (reference: src/BayesRv2.cpp:171-272):
intercept update -> [fixed-effect sweep] -> shuffled marker sweep ->
sigmaF/sigmaE/sigmaG(G)/pi hyper draws -> optional thinned emission.
"""
from __future__ import annotations


from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import distributions as dist
from ..config import BayesRConfig, ChainConfig, GroupsConfig
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops import strided
from ..ops.sweep import bayesr_sweep_scan
from ..ops.xpass import xpass_impl
from .state import SpikeSlabState


class MarkerData(NamedTuple):
    """Static per-chain device data (closed over by nothing; always an argument
    so jit never constant-folds a multi-GB genotype matrix into the program)."""

    XT: jax.Array        # (Mpad, N) standardized genotypes, marker-major
                         # (f32 dense, int8 dosage codes, or (Mpad, Npad/16)
                         # int32 2-bit words)
    xsq: jax.Array       # (Mpad,) per-marker squared norms (src/BayesRv2.cpp:170)
    gram: jax.Array      # (nb, B, B) block Gram matrices ((0,0,0) if scan-only)
    g_assign: jax.Array  # (Mpad,) int32 marker -> group map
    valid: jax.Array     # (Mpad,) bool, False on padding markers
    cva: jax.Array       # (G, K-1) slab variances
    prior_pi: jax.Array  # (G, K) initial mixture probabilities
    fixedT: jax.Array    # (F, N) fixed-effect covariates, column-major
    fsq: jax.Array       # (F,) squared norms of fixed columns
    x_mean: jax.Array    # (Mpad,) dosage means ((0,) when dense)
    x_scale: jax.Array   # (Mpad,) 1/sd standardization scales ((0,) when dense)
    row_valid: jax.Array # (Npad,) bool row mask ((0,) unless 2-bit packed)
    n_perm: jax.Array    # (Npad,) packed-layout individual permutation ((0,))


def _warn_if_padded_rows(x_stats):
    """Pre-packed words loaded with read_bed_packed(mpad=...) carry
    trailing all-missing pad rows (sd == 0); without ``n_markers`` those
    rows count as real markers and flip has_missing, which turns on the
    missing-code select for every marker."""
    sds = np.asarray(x_stats[1]).reshape(-1)
    ntrail = 0
    while ntrail < sds.size and sds[sds.size - 1 - ntrail] == 0:
        ntrail += 1
    if ntrail > 0:
        import warnings

        warnings.warn(
            f"pre-packed input has {ntrail} trailing zero-sd marker rows "
            f"that look like host-side mpad padding "
            f"(io.bed.read_bed_packed(mpad=...)); pass "
            f"n_markers={sds.size - ntrail} so pad rows are masked "
            f"instead of treated as (all-missing) data.", stacklevel=4)


def _plan(M: int, block_size: int, jacobi_blocks: Optional[int]):
    """(J, B) for a single-device sampler: the default plan, or J as
    given with the configured block size."""
    B = strided.base_block_size(M, block_size)
    if jacobi_blocks is None:
        return strided.jacobi_plan(M, B)
    if int(jacobi_blocks) < 1:
        raise ValueError("jacobi_blocks must be >= 1")
    return int(jacobi_blocks), B


def _as_2d_cva(cva) -> np.ndarray:
    cva = np.asarray(cva, np.float64)
    if cva.ndim == 0:
        cva = cva[None]
    if cva.ndim == 1:
        cva = cva[None, :]
    return cva


class SpikeSlabSampler:
    """BayesR sampler over a fixed dataset (X, Y[, groups, fixed]).

    Parameters
    ----------
    X : (N, M) array -- standardized genotype/covariate matrix (the reference
        expects centered+scaled columns, vignettes/BayesRR.Rmd:81,92).
    Y : (N,) response.
    cva : (K-1,) or (G, K-1) slab variances (spike prepended internally,
        reference: src/BayesRv2.cpp:152-153).
    config : BayesRConfig or GroupsConfig.
    g_assign : (M,) int group assignment (groups variant).
    fixed : (N, F) fixed-effect covariates (groups variant).
    backend : "blocked" (the strided-rounds sweep of ops/strided.py, any
        genotype storage; the default) or "scan" (the sequential
        reference, dense X only).
    permutation : "blocked" or "full"; defaults to match the backend.  The
        blocked backend requires block-restricted permutations.
    jacobi_blocks : blocks per Jacobi round J; default from
        ``ops.strided.jacobi_plan`` (J=1 is the exact sequential sweep).
    """

    def __init__(self, X, Y, cva, config, *, g_assign=None, fixed=None,
                 dtype=jnp.float32, backend: Optional[str] = None,
                 permutation: Optional[str] = None,
                 variant: Optional[str] = None, transposed: bool = False,
                 x_dtype: str = "dense", x_stats=None,
                 n_individuals: Optional[int] = None,
                 n_markers: Optional[int] = None,
                 jacobi_blocks: Optional[int] = None):
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r}")
        backend = "blocked" if backend is None else backend
        if backend not in ("blocked", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        if x_dtype in ("int8", "2bit") and backend != "blocked":
            raise ValueError(f"x_dtype={x_dtype!r} requires the blocked "
                             f"backend")
        if permutation is None:
            permutation = "full" if backend == "scan" else "blocked"
        if backend == "blocked" and permutation != "blocked":
            raise ValueError("blocked backend requires blocked permutation")
        if variant is None:
            variant = "groups" if isinstance(config, GroupsConfig) else "bayesr"

        # Device arrays are used as-is (no host round-trip -- at biobank scale
        # X never fits in host memory as f64); ``transposed=True`` means X is
        # already marker-major (M, N).
        x_on_device = isinstance(X, jax.Array)
        if not x_on_device:
            X = np.asarray(X)
        self._prepacked = (x_dtype == "2bit" and x_on_device
                           and X.dtype == jnp.int32)
        if self._prepacked:
            # X is already packed int32 words (M, Npad/16), marker-major
            # (e.g. from io.bed.read_bed_packed); n_individuals gives the
            # true N when the word lanes are padded to a 2048 multiple
            if not transposed or x_stats is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "transposed=True and x_stats=(means, sds)")
            # n_markers: the words may arrive HOST-PRE-PADDED to the
            # planned Mpad (io.bed.read_bed_packed(mpad="auto") -- a
            # device-resident packed array cannot be padded later without
            # a second near-HBM-sized buffer)
            M = X.shape[0] if n_markers is None else int(n_markers)
            if not (0 < M <= X.shape[0]):
                raise ValueError(f"n_markers={M} inconsistent with "
                                 f"{X.shape[0]} packed word rows")
            if n_markers is None:
                _warn_if_padded_rows(x_stats)
            N = X.shape[1] * 16 if n_individuals is None else int(n_individuals)
            if not (X.shape[1] * 16 - 2048 < N <= X.shape[1] * 16):
                raise ValueError(
                    f"n_individuals={N} inconsistent with "
                    f"{X.shape[1]} words/marker (lanes pad to 2048)")
        elif transposed:
            M, N = X.shape
        else:
            N, M = X.shape
        if Y.shape != (N,):
            raise ValueError("Y must have the same number of rows as X")
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        K = Km1 + 1
        if np.any(cva2 <= 0):
            # the reference only warns here (src/BayesRv2.cpp:86-95); we fail.
            raise ValueError("slab variances must be strictly positive")

        if g_assign is None:
            g_assign = np.zeros((M,), np.int32)
        else:
            g_assign = np.asarray(g_assign, np.int32)
            if g_assign.shape != (M,) or g_assign.min() < 0 or g_assign.max() >= G:
                raise ValueError("gAssign must be (M,) ints in [0, groups)")
        if fixed is None:
            fixed = np.zeros((N, 0))
        fixed = np.asarray(fixed)
        F = fixed.shape[1]

        self.jacobi, B = _plan(M, config.block_size, jacobi_blocks)
        Mpad = strided.plan_mpad(M, B, self.jacobi)
        self.N, self.M, self.Mpad, self.K, self.G, self.F, self.B = N, M, Mpad, K, G, F, B
        self.nb = Mpad // B
        if self._prepacked and X.shape[0] not in (M, Mpad):
            raise ValueError(
                f"pre-packed words have {X.shape[0]} rows; expected the "
                f"true marker count ({M}) or the planned padded count "
                f"({Mpad}, = ops.strided.planned_mpad)")
        self.config = config
        self.variant = variant
        self.backend = backend
        self.permutation = permutation
        self.dtype = jnp.dtype(dtype)

        self.x_quantized = x_dtype in ("int8", "2bit")
        self.x_packed = x_dtype == "2bit"
        x_mean = x_scale = jnp.zeros((0,), jnp.float32)
        row_valid = jnp.zeros((0,), bool)
        n_perm = jnp.zeros((0,), jnp.int32)
        has_missing = False
        self.Npad = N
        if self.x_quantized:
            if self.x_packed:
                q = genotypes.quantize_packed(X, transposed, x_stats, B,
                                              Mpad, N,
                                              prepacked=self._prepacked,
                                              m_true=M)
            else:
                q = genotypes.quantize_int8(X, transposed, x_stats, B, Mpad)
            XT, xsq, gram = q.XT, q.xsq, q.gram
            x_mean, x_scale = q.x_mean, q.x_scale
            row_valid, n_perm = q.row_valid, q.n_perm
            self.Npad, has_missing = q.Npad, q.has_missing
        else:
            if x_on_device:
                XT = (X if transposed else X.T).astype(self.dtype)
            else:
                XT = jnp.asarray(
                    np.ascontiguousarray(X if transposed else X.T), self.dtype)
            xsq = jnp.sum(XT * XT, axis=1)
            XT, xsq, _ = bs.pad_markers(XT, xsq, B, mpad=Mpad)
            gram = (bs.gram_blocks(XT, B) if backend == "blocked"
                    else jnp.zeros((0, 0, 0), self.dtype))
        # quantized data with no missing call lets the X pass skip the
        # missing-code select (ops/xpass.py)
        self._x_fold = self.x_quantized and not has_missing
        self._x_kind = x_dtype
        self._xpass_impl = xpass_impl(jax.devices()[0].platform)

        prior_pi = self._prior_pi(cva2)
        self.data = MarkerData(
            x_mean=x_mean,
            x_scale=x_scale,
            row_valid=row_valid,
            n_perm=n_perm,
            XT=XT,
            xsq=xsq,
            gram=gram,
            g_assign=jnp.asarray(np.pad(g_assign, (0, Mpad - M))),
            valid=jnp.asarray(np.arange(Mpad) < M),
            cva=jnp.asarray(cva2, self.dtype),
            prior_pi=jnp.asarray(prior_pi, self.dtype),
            fixedT=self._maybe_permute_rows(
                jnp.asarray(np.ascontiguousarray(fixed.T), self.dtype),
                n_perm, axis=1),
            fsq=jnp.asarray(np.sum(fixed * fixed, axis=0), self.dtype),
        )
        # packed mode stores Y (and eps) padded to Npad in the packed-word
        # individual order; all sweep sums are permutation-invariant and
        # emission un-permutes
        self.Y = self._maybe_permute_rows(jnp.asarray(Y, self.dtype), n_perm)

        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._run_steps = jax.jit(self._run_steps_impl, static_argnums=(2,),
                                  donate_argnums=(0,))
        self._emit_chunk = jax.jit(self._emit_chunk_impl, static_argnums=(2, 3),
                                   donate_argnums=(0,))
        # multi-chain: chains are a leading axis of the state pytree and
        # one sweep serves them all (the reference can only run one chain
        # per process, src/BayesRv2.cpp:171)
        self._mc_step = jax.jit(self._mc_step_impl, donate_argnums=(0,))
        self._mc_run_steps = jax.jit(
            lambda s, d, n: lax.fori_loop(
                0, n, lambda i, st: self._mc_step_impl(st, d), s),
            static_argnums=(2,), donate_argnums=(0,))
        self._mc_emit_chunk = jax.jit(self._mc_emit_chunk_impl,
                                      static_argnums=(2, 3),
                                      donate_argnums=(0,))
        # exact-residual recompute (ChainConfig.eps_refresh_every)
        self._refresh = jax.jit(self._refresh_impl)
        self._vrefresh = jax.jit(jax.vmap(self._refresh_impl,
                                          in_axes=(0, None)))

    # ------------------------------------------------------------------ init

    def _maybe_permute_rows(self, arr, n_perm, axis=0):
        """Pad the individual axis to Npad and reorder into the packed-word
        layout (identity when not in 2-bit mode)."""
        if not self.x_packed:
            return arr
        pad = self.Npad - self.N
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = jnp.pad(arr, widths)
        return jnp.take(arr, n_perm, axis=axis)

    def _prior_pi(self, cva2: np.ndarray) -> np.ndarray:
        G, Km1 = cva2.shape
        K = Km1 + 1
        pi = np.empty((G, K))
        pi[:, 0] = 0.5
        if self.variant == "bayesr":
            # intended semantics of src/BayesRv2.cpp:150 (the reference reads
            # uninitialised memory there; see SURVEY.md section 2.3).
            pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        else:
            # src/BayesRv2Groups.cpp:170-175: 0.5/K per slab component (does
            # not sum to 1); optionally normalised.
            pi[:, 1:] = 0.5 / K
            if not getattr(self.config, "reference_prior_pi", True):
                pi /= pi.sum(axis=1, keepdims=True)
        return pi

    def init(self, key) -> SpikeSlabState:
        """Fresh-chain init (reference: src/BayesRv2.cpp:146-170,
        src/BayesRv2Groups.cpp:185-205)."""
        key, kG, kF = jax.random.split(key, 3)
        dt = self.dtype
        sigmaGG = jax.vmap(lambda k: dist.beta_rng(k, 1.0, 1.0, dtype=dt))(
            jax.random.split(kG, self.G))
        sigmaF = (jax.random.uniform(kF, (), dtype=dt) if self.F > 0
                  else jnp.ones((), dt))
        mu = jnp.zeros((), dt)
        eps = self.Y - mu  # packed: Y is permuted+padded, pads are exactly 0
        sigmaE = jnp.sum(eps * eps) / self.N * 0.5
        return SpikeSlabState(
            key=key,
            iteration=jnp.zeros((), jnp.int32),
            mu=mu,
            beta=jnp.zeros((self.Mpad,), dt),
            labels=jnp.zeros((self.Mpad,), jnp.int32),
            eps=eps,
            sigmaE=sigmaE,
            sigmaGG=sigmaGG,
            # copy: the state is donated by step functions and must not alias
            # the per-chain data
            pi=self.data.prior_pi + jnp.zeros((), dt),
            alpha=jnp.zeros((self.F,), dt),
            sigmaF=sigmaF,
        )

    def init_from(self, key, mu, beta, sigmaE, sigmaGG, epsilon, components,
                  alpha=None, sigmaF=None) -> SpikeSlabState:
        """Warm restart from a previous chain's last sample.

        Reproduces BRV2Grstart's resume contract (src/BRv2Grstart.cpp:77,
        157-165): everything is taken as given except pi, which is re-drawn
        from Dirichlet(v + 1) with v the per-group component-label counts.
        """
        key, kpi = jax.random.split(key)
        dt = self.dtype
        beta = np.asarray(beta, np.float64).reshape(-1)
        components = np.asarray(components).reshape(-1).astype(np.int32)
        if beta.shape[0] != self.M or components.shape[0] != self.M:
            raise ValueError("beta/components must have length M")
        pad = self.Mpad - self.M
        g_assign = np.asarray(self.data.g_assign)[: self.M]
        v = np.zeros((self.G, self.K))
        np.add.at(v, (g_assign, components), 1.0)
        pi = jax.vmap(dist.dirichlet_rng)(
            jax.random.split(kpi, self.G), jnp.asarray(v + 1.0, dt))
        return SpikeSlabState(
            key=key,
            iteration=jnp.zeros((), jnp.int32),
            mu=jnp.asarray(mu, dt),
            beta=jnp.asarray(np.pad(beta, (0, pad)), dt),
            labels=jnp.asarray(np.pad(components, (0, pad))),
            eps=self._maybe_permute_rows(jnp.asarray(epsilon, dt),
                                         self.data.n_perm),
            sigmaE=jnp.asarray(sigmaE, dt),
            sigmaGG=jnp.asarray(sigmaGG, dt).reshape(self.G),
            pi=pi.astype(dt),
            alpha=(jnp.zeros((self.F,), dt) if alpha is None
                   else jnp.asarray(alpha, dt)),
            sigmaF=(jnp.ones((), dt) if sigmaF is None
                    else jnp.asarray(sigmaF, dt)),
        )

    def xbeta(self, beta) -> np.ndarray:
        """``X @ beta`` in ORIGINAL individual order for any storage mode
        (dense / int8 / 2-bit packed) -- used to reconstruct residuals when
        resuming from a CSV written with emit_epsilon=False."""
        beta = np.asarray(beta, np.float64).reshape(-1)
        if beta.shape[0] != self.M:
            raise ValueError("beta must have length M")
        beta_pad = jnp.asarray(np.pad(beta, (0, self.Mpad - self.M)),
                               jnp.float32)
        if not self.x_quantized:
            return np.asarray(beta_pad @ self.data.XT.astype(jnp.float32))
        if self.x_packed:
            return np.asarray(genotypes.xbeta_packed(
                self.data.XT, self.data.x_mean, self.data.x_scale, beta_pad,
                self.B, self.N))
        return np.asarray(genotypes.xbeta_int8(
            self.data.XT, self.data.x_mean, self.data.x_scale, beta_pad,
            self.B))

    def _refresh_impl(self, state: SpikeSlabState,
                      data: MarkerData) -> SpikeSlabState:
        """Recompute eps = Y - mu - X beta (- F alpha) with ONE fresh X
        pass: bounds the f32 drift of long rank-1-updated chains
        (ChainConfig.eps_refresh_every).  The f64 reference accrues no
        drift and needs no analog (src/BayesRv2.cpp:60)."""
        f32 = jnp.float32
        beta = state.beta.astype(f32)
        if not self.x_quantized:
            xb = beta @ data.XT.astype(f32)
        elif self.x_packed:
            xb = self._maybe_permute_rows(
                genotypes.xbeta_packed(data.XT, data.x_mean, data.x_scale,
                                       beta, self.B, self.N),
                data.n_perm)
        else:
            xb = genotypes.xbeta_int8(data.XT, data.x_mean, data.x_scale,
                                      beta, self.B)
        eps = self.Y.astype(f32) - xb - state.mu.astype(f32)
        if self.F > 0:
            eps = eps - state.alpha.astype(f32) @ data.fixedT.astype(f32)
        if self.x_packed:
            eps = jnp.where(data.row_valid, eps, 0.0)
        return state._replace(eps=eps.astype(self.dtype))

    def refresh_eps(self, state: SpikeSlabState) -> SpikeSlabState:
        """Exact residual recompute (single state or chain-batched)."""
        if getattr(state.mu, "ndim", 0):
            return self._vrefresh(state, self.data)
        return self._refresh(state, self.data)

    # ------------------------------------------------------------------ step

    def _pre_sweep(self, state: SpikeSlabState, data: MarkerData):
        """Key split + intercept + fixed-effect sweep (everything before the
        marker sweep); shared by the single-chain and fused multi-chain
        steps (the latter vmaps this over the chain axis)."""
        N, F = self.N, self.F
        dt = self.dtype
        keys = jax.random.split(state.key, 11)
        (key, kmu, kforder, kfz, korder, kp, kz, ksE, ksF, ksG, kpi) = keys

        # ---- intercept (src/BayesRv2.cpp:177-179); sigma0 is accepted but
        # unused, exactly like the reference (vignettes/BayesRR.Rmd:93).
        if self.x_packed:
            rv = data.row_valid
            eps = jnp.where(rv, state.eps + state.mu, 0.0)
            mu = dist.norm_rng(kmu, jnp.sum(eps) / N, state.sigmaE / N)
            eps = jnp.where(rv, eps - mu, 0.0)
        else:
            eps = state.eps + state.mu
            mu = dist.norm_rng(kmu, jnp.sum(eps) / N, state.sigmaE / N)
            eps = eps - mu

        # ---- fixed-effect sweep (src/BayesRv2Groups.cpp:216-225)
        alpha, sigmaF = state.alpha, state.sigmaF
        if F > 0:
            forder = jax.random.permutation(kforder, F)
            zf = jax.random.normal(kfz, (F,), dt)

            def fbody(carry, xs):
                eps, alpha = carry
                c, z = xs
                fc = data.fixedT[c]
                denom_f = (N - 1) + state.sigmaE / sigmaF
                num_f = jnp.dot(fc, eps) + alpha[c] * data.fsq[c]
                a_new = num_f / denom_f + jnp.sqrt(state.sigmaE / denom_f) * z
                eps = eps - fc * (a_new - alpha[c])
                alpha = alpha.at[c].set(a_new)
                return (eps, alpha), None

            (eps, alpha), _ = lax.scan(fbody, (eps, alpha), (forder, zf))
        return keys, mu, eps, alpha, sigmaF

    def _hyper_block(self, keys, eps, alpha, sigmaF, beta, v, bacc):
        """Post-sweep hyperparameter draws (src/BayesRv2.cpp:247-255,
        src/BayesRv2Groups.cpp:301-312)."""
        cfg = self.config
        N, F, G = self.N, self.F, self.G
        dt = self.dtype
        ksE, ksF, ksG, kpi = keys[7], keys[8], keys[9], keys[10]
        if F > 0:
            # note the reference reuses the residual prior (v0E, s02E) for
            # sigmaF (src/BayesRv2Groups.cpp:301)
            sigmaF = dist.inv_scaled_chisq_rng(
                ksF, cfg.v0E + F,
                (jnp.sum(alpha * alpha) + cfg.v0E * cfg.s02E) / (cfg.v0E + F)
            ).astype(dt)
        sigmaE = dist.inv_scaled_chisq_rng(
            ksE, cfg.v0E + N,
            (jnp.sum(eps * eps) + cfg.v0E * cfg.s02E) / (cfg.v0E + N)
        ).astype(dt)

        m0 = jnp.sum(v, axis=1) - v[:, 0]                       # (G,)
        if self.variant == "bayesr":
            # C1 uses the full |beta|^2, not the per-sweep accumulator
            # (src/BayesRv2.cpp:248); padding betas are identically 0.
            ss = jnp.broadcast_to(jnp.sum(beta * beta), (G,))
        else:
            ss = bacc                                            # (G,)
        if cfg.reference_sigma_g_scaling:
            scale_g = (ss * m0 + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        else:
            scale_g = (ss + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        sigmaGG = jax.vmap(dist.inv_scaled_chisq_rng)(
            jax.random.split(ksG, G), cfg.v0G + m0, scale_g)
        pi = jax.vmap(dist.dirichlet_rng)(
            jax.random.split(kpi, G), v + 1.0)
        return sigmaE, sigmaF, sigmaGG.astype(dt), pi.astype(dt)

    def _step_impl(self, state: SpikeSlabState, data: MarkerData) -> SpikeSlabState:
        dt = self.dtype
        keys, mu, eps, alpha, sigmaF = self._pre_sweep(state, data)
        (key, kmu, kforder, kfz, korder, kp, kz,
         ksE, ksF, ksG, kpi) = keys

        # ---- marker sweep (the hot loop, src/BayesRv2.cpp:186-245)
        Mpad, B, nb = self.Mpad, self.B, self.nb
        p_arr = jax.random.uniform(kp, (Mpad,), dtype=dt)
        z_arr = jax.random.normal(kz, (Mpad,), dtype=dt)
        if self.permutation == "blocked":
            rho, inner = bs.strided_orders(korder, nb, B, self.jacobi)
            if self.backend == "blocked":
                res = self._sweep(
                    data, eps[None], state.beta[None], state.labels[None],
                    rho, inner, p_arr[None], z_arr[None], state.pi[None],
                    state.sigmaE[None], state.sigmaGG[None])
                res = jax.tree.map(lambda a: a[0], res)
            else:
                order = bs.flat_order(bs.strided_border(rho, self.jacobi),
                                      inner, B)
                res = bayesr_sweep_scan(
                    data.XT, data.xsq, eps, state.beta, state.labels, order,
                    p_arr, z_arr, state.pi, data.cva, state.sigmaE,
                    state.sigmaGG, data.g_assign, data.valid)
        else:
            order = jax.random.permutation(korder, Mpad)
            res = bayesr_sweep_scan(
                data.XT, data.xsq, eps, state.beta, state.labels, order,
                p_arr, z_arr, state.pi, data.cva, state.sigmaE,
                state.sigmaGG, data.g_assign, data.valid)
        eps, beta, labels, v, bacc = res

        sigmaE, sigmaF, sigmaGG, pi = self._hyper_block(
            keys, eps, alpha, sigmaF, beta, v, bacc)
        return SpikeSlabState(
            key=key, iteration=state.iteration + 1, mu=mu, beta=beta,
            labels=labels, eps=eps, sigmaE=sigmaE,
            sigmaGG=sigmaGG, pi=pi, alpha=alpha, sigmaF=sigmaF)

    def _sweep(self, data: MarkerData, eps, beta, labels, rho, inner, p, z,
               pi, sigmaE, sigmaGG):
        """The strided sweep over a leading chain axis (ops/strided.py)."""
        return strided.bayesr_strided_sweep(
            (data.XT, data.x_mean, data.x_scale, data.row_valid), data.gram,
            data.xsq, eps, beta, labels, rho, inner, p, z, pi, data.cva,
            sigmaE, sigmaGG, data.g_assign, data.valid, J=self.jacobi,
            kind=self._x_kind, fold=self._x_fold, impl=self._xpass_impl)

    def _mc_step_impl(self, state: SpikeSlabState,
                      data: MarkerData) -> SpikeSlabState:
        """Fused multi-chain Gibbs iteration: state leaves carry a leading
        chain axis C and one strided sweep serves all chains, so each
        round reads X once for every chain.

        The marker visit order is shared across chains (drawn from chain
        0's order key); p/z streams are independent per chain.
        """
        dt = self.dtype
        Mpad, B, nb = self.Mpad, self.B, self.nb
        keys, mu, eps, alpha, sigmaF = jax.vmap(
            self._pre_sweep, in_axes=(0, None))(state, data)
        # keys is (C, 11, 2): per-chain key rows in _pre_sweep's order
        key, korder = keys[:, 0], keys[:, 4]
        kp, kz = keys[:, 5], keys[:, 6]

        p_arr = jax.vmap(
            lambda k: jax.random.uniform(k, (Mpad,), dtype=dt))(kp)
        z_arr = jax.vmap(
            lambda k: jax.random.normal(k, (Mpad,), dtype=dt))(kz)
        rho, inner = bs.strided_orders(korder[0], nb, B, self.jacobi)
        eps, beta, labels, v, bacc = self._sweep(
            data, eps, state.beta, state.labels, rho, inner, p_arr, z_arr,
            state.pi, state.sigmaE, state.sigmaGG)

        sigmaE, sigmaF, sigmaGG, pi = jax.vmap(self._hyper_block)(
            keys, eps, alpha, sigmaF, beta, v, bacc)
        return SpikeSlabState(
            key=key, iteration=state.iteration + 1, mu=mu,
            beta=beta.astype(dt), labels=labels, eps=eps.astype(dt),
            sigmaE=sigmaE, sigmaGG=sigmaGG, pi=pi,
            alpha=alpha, sigmaF=sigmaF)

    @property
    def supports_fused_chains(self) -> bool:
        """Fused multi-chain steps run on the blocked backend (any
        storage); the scan reference has no chain axis."""
        return self.backend == "blocked"

    def step_chains(self, state: SpikeSlabState) -> SpikeSlabState:
        """One fused multi-chain iteration (state leaves batched over C)."""
        return self._mc_step(state, self.data)

    def step(self, state: SpikeSlabState) -> SpikeSlabState:
        return self._step(state, self.data)

    # ------------------------------------------------------------------ run

    def _run_steps_impl(self, state, data, n):
        return lax.fori_loop(0, n, lambda i, s: self._step_impl(s, data), state)

    def _emit_one(self, state: SpikeSlabState, data: MarkerData):
        M = self.M
        if self.config.emit_epsilon:
            if self.x_packed:
                # un-permute back to original individual order
                eps = jnp.zeros((self.Npad,), state.eps.dtype).at[
                    data.n_perm].set(state.eps)[: self.N]
            else:
                eps = state.eps
        else:
            eps = jnp.zeros((0,), self.dtype)
        return {
            "iteration": state.iteration - 1,
            "mu": state.mu,
            "beta": state.beta[:M],
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            # int8: component labels are < K <= 127; a 4x smaller
            # emission payload matters on slow device->host links
            "comp": state.labels[:M].astype(jnp.int8),
            "epsilon": eps,
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }

    def _emit_chunk_impl(self, state, data, n_emits, thinning):
        def body(state, _):
            state = lax.fori_loop(
                0, thinning, lambda i, s: self._step_impl(s, data), state)
            return state, self._emit_one(state, data)

        return lax.scan(body, state, None, length=n_emits)

    def _mc_emit_chunk_impl(self, state, data, n_emits, thinning):
        def body(state, _):
            state = lax.fori_loop(
                0, thinning, lambda i, st: self._mc_step_impl(st, data), state)
            return state, jax.vmap(lambda st: self._emit_one(st, data))(state)

        return lax.scan(body, state, None, length=n_emits)

    def run(self, key_or_state, chain: ChainConfig, *, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        """Run a full chain, emitting thinned post-burn-in samples.

        Replaces the reference's producer/consumer OpenMP split
        (src/BayesRv2.cpp:102-108, 281-290) with async device dispatch + a
        host sink; no tail-sample drop (src/BayesRv2.cpp:279-289).
        """
        from .driver import run_chain

        state = (key_or_state if isinstance(key_or_state, SpikeSlabState)
                 else self.init(key_or_state))
        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._run_steps(st, self.data, n),
            emit_fn=lambda st, n, t: self._emit_chunk(st, self.data, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk,
            start_iteration=int(state.iteration), progress=progress,
            on_chunk=on_chunk, refresh_fn=self.refresh_eps)

    def run_chains(self, key, n_chains: int, chain: ChainConfig, *,
                   collect: bool = True, emit_chunk: int = 32, sink=None,
                   progress=None, on_chunk=None):
        """Run ``n_chains`` independent chains batched on one device.

        One strided sweep serves all chains per iteration, so X is read
        once per round for every chain.  Collected arrays gain a chain axis
        after the emission axis, e.g. beta is (n_emits, n_chains, M).
        """
        from .driver import run_chain

        if not self.supports_fused_chains:
            raise ValueError("run_chains needs the blocked backend")
        keys = jax.random.split(key, n_chains)
        state = jax.vmap(self.init)(keys)
        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._mc_run_steps(st, self.data, n),
            emit_fn=lambda st, n, t: self._mc_emit_chunk(st, self.data, n, t),
            sink=sink, collect=collect, emit_chunk=emit_chunk,
            progress=progress, on_chunk=on_chunk,
            refresh_fn=self.refresh_eps)

    @staticmethod
    def _deliver(rows, sink, collected):
        rows = jax.tree.map(np.asarray, rows)  # leading axis = n_emits (scan-stacked)
        if collected is not None:
            collected.append(rows)
        if sink is not None:
            sink.write(rows)
