"""Regularized-horseshoe Gibbs sampler (C4).

Re-design of the reference HorseshoeR sampler (reference:
src/HorseshoeR.cpp:109-264): local-global half-Cauchy shrinkage via
inverse-gamma auxiliary variables with a finite slab c^2.

Per-iteration order, exactly as the reference:
  1. intercept mu (src/HorseshoeR.cpp:210-212)
  2. global auxiliary eta ~ InvGamma(0.5+0.5*vT, 1/(sigmaE*A^2) + vT/tau) (:217)
  3. local auxiliaries v_j ~ InvGamma(0.5+0.5*vL, vL/lambda_j + 1), vectorised
     where the reference uses an Eigen unaryExpr functor (:218, :57-64)
  4. shuffled dense marker sweep with effective prior variance
     s_j = tau*c2*lambda_j/(tau*lambda_j + c2) (:219-240); lambda is held
     fixed during the sweep, which is what makes the Gram-blocked fast path
     exact here too
  5. lambda_j ~ InvGamma(0.5+0.5*vL, vL/v_j + beta_j^2/(2*tau)) (:242)
  6. tau ~ InvGamma(0.5*(M+vT), vT/eta + 0.5*sum(beta^2/lambda)) (:245)
  7. c2 ~ InvGamma(0.5*vC+0.5*M, 0.5*vC*sC + 0.5*|beta|^2) (:248)
  8. sigmaE ~ InvScaledChi2(v0E+N, (|eps|^2+v0E*s02E)/(v0E+N)) (:253)

The reference recomputes |X_j|^2 per marker per iteration (:234); we
precompute it once like the mixture samplers do (src/BayesRv2.cpp:170).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import distributions as dist
from ..config import ChainConfig, HorseshoeConfig
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops import strided
from ..ops.sweep import horseshoe_sweep_scan
from ..ops.xpass import xpass_impl
from .state import HorseshoeState


class HorseshoeData(NamedTuple):
    XT: jax.Array        # (Mpad, N) f32, int8 codes, or int32 packed words
    xsq: jax.Array       # (Mpad,)
    gram: jax.Array      # (nb, B, B)
    valid: jax.Array     # (Mpad,)
    x_mean: jax.Array    # (Mpad,) dosage means ((0,) when dense)
    x_scale: jax.Array   # (Mpad,) 1/sd scales ((0,) when dense)
    row_valid: jax.Array # (Npad,) bool lane mask ((0,) unless packed)
    n_perm: jax.Array    # (Npad,) packed-layout lane permutation ((0,))


class HorseshoeSampler:
    """Regularized-horseshoe sampler over a fixed (X, Y).

    Genotype storage (``x_dtype``: dense f32, int8 dosage codes, or 2-bit
    packed words incl. pre-packed io.bed.read_bed_packed input) matches
    SpikeSlabSampler -- the reference HorseshoeR holds a dense f64 Eigen X
    (src/HorseshoeR.cpp:109), capping it at host RAM.
    """

    def __init__(self, X, Y, config: HorseshoeConfig, *, dtype=jnp.float32,
                 backend: Optional[str] = None,
                 permutation: Optional[str] = None, transposed: bool = False,
                 x_dtype: str = "dense", x_stats=None,
                 n_individuals: Optional[int] = None,
                 n_markers: Optional[int] = None,
                 jacobi_blocks: Optional[int] = None):
        from .bayesr import _plan, _warn_if_padded_rows

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
        x_on_device = isinstance(X, jax.Array)
        if not x_on_device:
            X = np.asarray(X)
        Y = np.asarray(Y)
        self._prepacked = (x_dtype == "2bit" and x_on_device
                           and X.dtype == jnp.int32)
        if self._prepacked:
            if not transposed or x_stats is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "transposed=True and x_stats=(means, sds)")
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
        self.jacobi, B = _plan(M, config.block_size, jacobi_blocks)
        Mpad = strided.plan_mpad(M, B, self.jacobi)
        self.N, self.M, self.Mpad, self.B, self.nb = N, M, Mpad, B, Mpad // B
        if self._prepacked and X.shape[0] not in (M, Mpad):
            raise ValueError(
                f"pre-packed words have {X.shape[0]} rows; expected the "
                f"true marker count ({M}) or the planned padded count "
                f"({Mpad}, = ops.strided.planned_mpad)")
        self.config = config
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
        self._x_fold = self.x_quantized and not has_missing
        self._x_kind = x_dtype
        self._xpass_impl = xpass_impl(jax.devices()[0].platform)
        self.data = HorseshoeData(XT=XT, xsq=xsq, gram=gram,
                                  valid=jnp.asarray(np.arange(Mpad) < M),
                                  x_mean=x_mean, x_scale=x_scale,
                                  row_valid=row_valid, n_perm=n_perm)
        # packed mode stores Y (and eps) padded to Npad in the packed-word
        # individual order (sweep sums are permutation-invariant; emission
        # un-permutes)
        self.Y = self._maybe_permute_rows(jnp.asarray(Y, self.dtype), n_perm)

        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._run_steps = jax.jit(self._run_steps_impl, static_argnums=(2,),
                                  donate_argnums=(0,))
        self._emit_chunk = jax.jit(self._emit_chunk_impl, static_argnums=(2, 3),
                                   donate_argnums=(0,))
        # multi-chain: one sweep serves every chain per iteration
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

    def _refresh_impl(self, state, data):
        """Recompute eps = Y - mu - X beta with ONE fresh X pass (see
        SpikeSlabSampler._refresh_impl / ChainConfig.eps_refresh_every)."""
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
        if self.x_packed:
            eps = jnp.where(data.row_valid, eps, 0.0)
        return state._replace(eps=eps.astype(self.dtype))

    def refresh_eps(self, state):
        """Exact residual recompute (single state or chain-batched)."""
        if getattr(state.mu, "ndim", 0):
            return self._vrefresh(state, self.data)
        return self._refresh(state, self.data)

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

    # ------------------------------------------------------------------ init

    def init(self, key) -> HorseshoeState:
        """Fresh-chain init (src/HorseshoeR.cpp:168-195): beta=0, mu=0,
        lambda=v=1, sigmaE=|Y-mu|^2/(2N), eta/tau from their priors."""
        cfg = self.config
        key, keta, ktau = jax.random.split(key, 3)
        dt = self.dtype
        mu = jnp.zeros((), dt)
        eps = self.Y - mu
        sigmaE = jnp.sum(eps * eps) / self.N * 0.5
        eta = dist.inv_gamma_rate_rng(keta, 0.5, 1.0 / (sigmaE * cfg.A ** 2))
        tau = (1.0 / eta) * dist.inv_gamma_rate_rng(ktau, 0.5 * cfg.vT, cfg.vT)
        return HorseshoeState(
            key=key,
            iteration=jnp.zeros((), jnp.int32),
            mu=mu,
            beta=jnp.zeros((self.Mpad,), dt),
            eps=eps,
            sigmaE=sigmaE,
            lam=jnp.ones((self.Mpad,), dt),
            v=jnp.ones((self.Mpad,), dt),
            tau=tau.astype(dt),
            eta=eta.astype(dt),
            c2=jnp.asarray(cfg.c2, dt),
        )

    def init_from(self, key, mu, beta, sigmaE, tau, lam,
                  epsilon) -> HorseshoeState:
        """Warm restart from a previous chain's last emitted sample.

        The C4 CSV schema (src/HorseshoeR.cpp:258) carries mu/beta/sigmaE/
        tau/lambda/epsilon but not the inverse-gamma auxiliaries (eta, v)
        nor the slab width c2; those are re-drawn here from their full
        conditionals given the supplied state -- the same spirit as
        BRV2Grstart re-drawing pi from the supplied component counts
        (src/BRv2Grstart.cpp:157-165).  The reference has no horseshoe
        restart mechanism at all.
        """
        cfg = self.config
        key, keta, kv, kc2 = jax.random.split(key, 4)
        dt = self.dtype
        beta = np.asarray(beta, np.float64).reshape(-1)
        lam_in = np.asarray(lam, np.float64).reshape(-1)
        if beta.shape[0] != self.M or lam_in.shape[0] != self.M:
            raise ValueError("beta/lambda must have length M")
        pad = self.Mpad - self.M
        beta_pad = jnp.asarray(np.pad(beta, (0, pad)), dt)
        # pad lambdas to 1 (exact 0 would divide by zero in the v draw)
        lam_pad = jnp.asarray(np.pad(lam_in, (0, pad), constant_values=1.0),
                              dt)
        tau = jnp.asarray(tau, dt)
        sigmaE = jnp.asarray(sigmaE, dt)
        # eta | tau, sigmaE  (src/HorseshoeR.cpp:217)
        eta = dist.inv_gamma_rate_rng(
            keta, 0.5 + 0.5 * cfg.vT,
            1.0 / (sigmaE * cfg.A * cfg.A) + cfg.vT / tau)
        # v_j | lambda_j  (src/HorseshoeR.cpp:218)
        gv = dist.gamma_shape_rng(kv, 0.5 + 0.5 * cfg.vL, self.Mpad,
                                  dtype=dt)
        v = (cfg.vL / lam_pad + 1.0) / gv
        # c2 | beta  (src/HorseshoeR.cpp:248)
        bsq = jnp.sum(beta_pad * beta_pad)
        c2 = dist.inv_gamma_rate_rng(
            kc2, 0.5 * cfg.vC + 0.5 * self.M, 0.5 * cfg.vC * cfg.sC
            + 0.5 * bsq)
        return HorseshoeState(
            key=key,
            iteration=jnp.zeros((), jnp.int32),
            mu=jnp.asarray(mu, dt),
            beta=beta_pad,
            eps=self._maybe_permute_rows(
                jnp.asarray(np.asarray(epsilon, np.float64), dt),
                self.data.n_perm),
            sigmaE=sigmaE,
            lam=lam_pad,
            v=v.astype(dt),
            tau=tau,
            eta=eta.astype(dt),
            c2=c2.astype(dt),
        )

    def xbeta(self, beta) -> np.ndarray:
        """``X @ beta`` in ORIGINAL individual order for any storage mode
        (see SpikeSlabSampler.xbeta)."""
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

    # ------------------------------------------------------------------ step

    def _pre_sweep(self, state: HorseshoeState, data: HorseshoeData):
        """Key split + intercept + eta/v auxiliary draws (everything before
        the marker sweep); shared by single-chain and fused multi-chain."""
        cfg = self.config
        N, Mpad = self.N, self.Mpad
        dt = self.dtype
        keys = jax.random.split(state.key, 10)
        (key, kmu, keta, kv, korder, kz, klam, ktau, kc2, ksE) = keys

        # ---- intercept (pad lanes of the packed layout carry 0 and stay 0)
        if self.x_packed:
            rv = data.row_valid
            eps = jnp.where(rv, state.eps + state.mu, 0.0)
            mu = dist.norm_rng(kmu, jnp.sum(eps) / N, state.sigmaE / N)
            eps = jnp.where(rv, eps - mu, 0.0)
        else:
            eps = state.eps + state.mu
            mu = dist.norm_rng(kmu, jnp.sum(eps) / N, state.sigmaE / N)
            eps = eps - mu

        # ---- global auxiliary eta, local auxiliaries v (pre-sweep)
        eta = dist.inv_gamma_rate_rng(
            keta, 0.5 + 0.5 * cfg.vT,
            1.0 / (state.sigmaE * cfg.A * cfg.A) + cfg.vT / state.tau)
        gv = dist.gamma_shape_rng(kv, 0.5 + 0.5 * cfg.vL, Mpad, dtype=dt)
        v = (cfg.vL / state.lam + 1.0) / gv
        return keys, mu, eps, eta, v

    def _hyper_block(self, keys, eta, v, beta, eps, tau_old, valid):
        """Post-sweep lambda/tau/c2/sigmaE draws (src/HorseshoeR.cpp:242-253);
        shared by single-chain and fused multi-chain (vmapped)."""
        cfg = self.config
        N, M, Mpad = self.N, self.M, self.Mpad
        dt = self.dtype
        klam, ktau, kc2, ksE = keys[6], keys[7], keys[8], keys[9]
        glam = dist.gamma_shape_rng(klam, 0.5 + 0.5 * cfg.vL, Mpad,
                                    dtype=dt)
        lam = (cfg.vL / v + 0.5 * beta * beta / tau_old) / glam
        bl = jnp.where(valid, beta * beta / lam, 0.0)
        tau = dist.inv_gamma_rate_rng(
            ktau, 0.5 * (M + cfg.vT), cfg.vT / eta + 0.5 * jnp.sum(bl))
        bsq = jnp.sum(beta * beta)
        c2 = dist.inv_gamma_rate_rng(
            kc2, 0.5 * cfg.vC + 0.5 * M, 0.5 * cfg.vC * cfg.sC + 0.5 * bsq)
        sigmaE = dist.inv_scaled_chisq_rng(
            ksE, cfg.v0E + N,
            (jnp.sum(eps * eps) + cfg.v0E * cfg.s02E) / (cfg.v0E + N)
        ).astype(dt)
        return lam, tau.astype(dt), c2.astype(dt), sigmaE

    def _step_impl(self, state: HorseshoeState, data: HorseshoeData) -> HorseshoeState:
        cfg = self.config
        N, M, Mpad, B, nb = self.N, self.M, self.Mpad, self.B, self.nb
        dt = self.dtype
        keys, mu, eps, eta, v = self._pre_sweep(state, data)
        (key, kmu, keta, kv, korder, kz, klam, ktau, kc2, ksE) = keys

        # ---- dense marker sweep
        z_arr = jax.random.normal(kz, (Mpad,), dt)
        if self.permutation == "blocked":
            rho, inner = bs.strided_orders(korder, nb, B, self.jacobi)
            if self.backend == "blocked":
                eps, beta = self._sweep(
                    data, eps[None], state.beta[None], rho, inner,
                    z_arr[None], state.lam[None], state.tau[None],
                    state.c2[None], state.sigmaE[None])
                eps, beta = eps[0], beta[0]
            else:
                order = bs.flat_order(bs.strided_border(rho, self.jacobi),
                                      inner, B)
                eps, beta = horseshoe_sweep_scan(
                    data.XT, data.xsq, eps, state.beta, order, z_arr,
                    state.lam, state.tau, state.c2, state.sigmaE, data.valid)
        else:
            order = jax.random.permutation(korder, Mpad)
            eps, beta = horseshoe_sweep_scan(
                data.XT, data.xsq, eps, state.beta, order, z_arr,
                state.lam, state.tau, state.c2, state.sigmaE, data.valid)

        # ---- local/global scale updates (post-sweep)
        lam, tau, c2, sigmaE = self._hyper_block(
            keys, eta, v, beta, eps, state.tau, data.valid)

        return HorseshoeState(
            key=key, iteration=state.iteration + 1, mu=mu, beta=beta, eps=eps,
            sigmaE=sigmaE, lam=lam, v=v, tau=tau,
            eta=eta.astype(dt), c2=c2)

    def _sweep(self, data: HorseshoeData, eps, beta, rho, inner, z, lam,
               tau, c2, sigmaE):
        """The strided sweep over a leading chain axis (ops/strided.py)."""
        return strided.horseshoe_strided_sweep(
            (data.XT, data.x_mean, data.x_scale, data.row_valid), data.gram,
            data.xsq, eps, beta, rho, inner, z, lam, tau, c2, sigmaE,
            data.valid, J=self.jacobi, kind=self._x_kind, fold=self._x_fold,
            impl=self._xpass_impl)

    def _mc_step_impl(self, state: HorseshoeState,
                      data: HorseshoeData) -> HorseshoeState:
        """Fused multi-chain iteration: one strided sweep serves all
        chains; marker order shared across chains, z streams independent."""
        dt = self.dtype
        Mpad, B, nb = self.Mpad, self.B, self.nb
        keys, mu, eps, eta, v = jax.vmap(
            self._pre_sweep, in_axes=(0, None))(state, data)
        key, korder, kz = keys[:, 0], keys[:, 4], keys[:, 5]

        z_arr = jax.vmap(
            lambda k: jax.random.normal(k, (Mpad,), dtype=dt))(kz)
        rho, inner = bs.strided_orders(korder[0], nb, B, self.jacobi)
        eps, beta = self._sweep(data, eps, state.beta, rho, inner, z_arr,
                                state.lam, state.tau, state.c2, state.sigmaE)
        eps = eps.astype(dt)
        beta = beta.astype(dt)

        lam, tau, c2, sigmaE = jax.vmap(
            self._hyper_block, in_axes=(0, 0, 0, 0, 0, 0, None))(
            keys, eta, v, beta, eps, state.tau, data.valid)
        return HorseshoeState(
            key=key, iteration=state.iteration + 1, mu=mu, beta=beta, eps=eps,
            sigmaE=sigmaE, lam=lam, v=v, tau=tau,
            eta=eta.astype(dt), c2=c2)

    @property
    def supports_fused_chains(self) -> bool:
        """Fused multi-chain steps run on the blocked backend (any
        storage); the scan reference has no chain axis."""
        return self.backend == "blocked"

    def step_chains(self, state: HorseshoeState) -> HorseshoeState:
        return self._mc_step(state, self.data)

    def step(self, state: HorseshoeState) -> HorseshoeState:
        return self._step(state, self.data)

    # ------------------------------------------------------------------ run

    def _run_steps_impl(self, state, data, n):
        return lax.fori_loop(0, n, lambda i, s: self._step_impl(s, data), state)

    def _emit_one(self, state: HorseshoeState):
        M = self.M
        if self.config.emit_epsilon:
            if self.x_packed:
                # un-permute back to original individual order
                eps = jnp.zeros((self.Npad,), state.eps.dtype).at[
                    self.data.n_perm].set(state.eps)[: self.N]
            else:
                eps = state.eps
        else:
            eps = jnp.zeros((0,), self.dtype)
        return {
            "iteration": state.iteration - 1,
            "mu": state.mu,
            "beta": state.beta[:M],
            "sigmaE": state.sigmaE,
            "tau": state.tau,
            "lambda": state.lam[:M],
            "epsilon": eps,
        }

    def _emit_chunk_impl(self, state, data, n_emits, thinning):
        def body(state, _):
            state = lax.fori_loop(
                0, thinning, lambda i, s: self._step_impl(s, data), state)
            return state, self._emit_one(state)

        return lax.scan(body, state, None, length=n_emits)

    def _mc_emit_chunk_impl(self, state, data, n_emits, thinning):
        def body(state, _):
            state = lax.fori_loop(
                0, thinning, lambda i, st: self._mc_step_impl(st, data), state)
            return state, jax.vmap(self._emit_one)(state)

        return lax.scan(body, state, None, length=n_emits)

    def run(self, key_or_state, chain: ChainConfig, *, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        """Run a full chain; see SpikeSlabSampler.run for the emission model."""
        from .driver import run_chain

        state = (key_or_state if isinstance(key_or_state, HorseshoeState)
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
        """Run ``n_chains`` independent horseshoe chains batched on one
        device; one strided sweep serves all chains per iteration."""
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
        import numpy as np

        rows = jax.tree.map(np.asarray, rows)
        if collected is not None:
            collected.append(rows)
        if sink is not None:
            sink.write(rows)
