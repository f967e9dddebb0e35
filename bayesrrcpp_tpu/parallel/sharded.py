"""Mesh-sharded samplers (multi-device scaling via shard_map + psum).

Scaling design (SURVEY.md sections 2.4, 7; no reference analog exists -- the
reference holds X as one in-RAM Eigen matrix, src/BayesRv2.cpp:60, and cannot
reach biobank scale):

- **markers ("m" axis, model parallel)**: X is column-sharded in contiguous
  groups of Gram blocks.  Each m-slice runs the strided-rounds sweep of
  ops/strided.py over its own blocks, J per round; the combined residual
  update ``eps -= sum_d X_slab_d' delta_d`` is a single ``psum`` over "m"
  per round.  Within a block the updates are exact sequential Gibbs; across
  the Dm*J simultaneously-processed blocks they are block-Jacobi (each
  block sees the residual as of the round start).  This is the standard
  synchronous relaxation used by distributed BayesR implementations;
  posterior equivalence is validated statistically in
  tests/test_sharded.py.  With Dm=1 the sweep is exactly the single-device
  one.
- **individuals ("n" axis, data parallel)**: rows of X / eps are sharded;
  every per-block correlation ``r = X_b' eps`` is a partial matmul plus a
  ``psum`` over "n".  This axis is *mathematically exact* (only float
  reassociation differs) -- tested to tight tolerance against Dn=1.
- scalars/hyperparameters are replicated and updated with identical PRNG
  keys on every device, so no broadcast step is ever needed.
- per-marker RNG streams fold the m-coordinate into the key, so chains are
  reproducible for a fixed mesh shape.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import distributions as dist
from ..config import ChainConfig, GroupsConfig
from ..models.bayesr import _as_2d_cva
from ..models.state import SpikeSlabState
from ..ops import block_sweep as bs
from ..ops import genotypes
from ..ops import strided
from ..ops.xpass import xpass_impl
from .distributed import process_marker_range, put_global, put_process_shard
from .mesh import AXIS_M, AXIS_N


def _slice_plan(M: int, Dm: int, block_size: int):
    """(J, B, Mpad) for Dm m-slices: each slice is planned like a
    single-device sampler of ceil(M/Dm) markers (ops/strided.py)."""
    m_slice = -(-M // Dm)
    J, B = strided.jacobi_plan(m_slice, strided.base_block_size(M, block_size))
    return J, B, strided.plan_mpad(m_slice, B, J) * Dm


class ShardedMarkerData(NamedTuple):
    XT: jax.Array        # (Mpad, Npad) f32 -- or (Mpad, Npad/16) int32
                         # packed words -- P(m, n)
    xsq: jax.Array       # (Mpad,)       P(m)
    gram: jax.Array      # (nb, B, B)    P(m, None, None)
    g_assign: jax.Array  # (Mpad,)       P(m)
    valid: jax.Array     # (Mpad,)       P(m)
    row_valid: jax.Array # (Npad,)       P(n)
    cva: jax.Array       # (G, K-1)      replicated
    prior_pi: jax.Array  # (G, K)        replicated
    fixedT: jax.Array    # (F, Npad)     P(None, n)
    fsq: jax.Array       # (F,)          replicated
    x_mean: jax.Array    # (Mpad,)       P(m)  ((0,) when dense)
    x_scale: jax.Array   # (Mpad,)       P(m)  ((0,) when dense)
    n_perm: jax.Array    # (Npad,)       P(n)  ((0,) unless packed)


def _packed_shard_setup(mesh, X, x_on_device, prepacked, transposed, x_stats,
                        has_missing, M, N, Mpad, Npad, B,
                        x_process_shard=False):
    """Shared packed-genotype device setup for the sharded samplers:
    words sharded P(m), per-slice xsq/Gram built inside shard_map,
    lane permutation + row mask.  Returns (XT, x_mean, x_scale, xsq, gram,
    row_valid, n_perm, n_perm_np, has_missing).

    ``x_process_shard=True`` (multi-host): X/x_stats hold only THIS host's
    marker slice ``process_marker_range(mesh, Mpad)`` clipped to M -- each
    host reads its own slice of the .bed and no host ever materializes the
    full word matrix (see parallel/distributed.py)."""
    from ..ops import genotypes

    if prepacked:
        if not transposed or x_stats is None:
            raise ValueError("pre-packed 2-bit input requires "
                             "transposed=True and x_stats=(means, sds)")
        if has_missing is None:
            raise ValueError("pre-packed 2-bit input requires "
                             "has_missing= (read_bed_packed reports it)")
        words = X
        lo, hi = ((0, Mpad) if not x_process_shard
                  else process_marker_range(mesh, Mpad))
        m_real = min(hi, M) - lo      # real (non-pad) markers in this slab
        if m_real < 0:
            m_real = 0
        mean_np = np.pad(np.asarray(x_stats[0], np.float64)[:m_real],
                         (0, hi - lo - m_real)).astype(np.float32)
        scl = np.asarray(x_stats[1], np.float64)[:m_real]
        scl = np.where(scl > 0, 1.0 / np.where(scl > 0, scl, 1.0), 0.0)
        scale_np = np.pad(scl, (0, hi - lo - m_real)).astype(np.float32)
        if x_process_shard and (words.shape[0] != m_real
                                or len(np.asarray(x_stats[0])) != m_real):
            raise ValueError(
                f"x_process_shard: this host must pass exactly its marker "
                f"slice [{lo}, {lo + m_real}) = {m_real} rows, "
                f"got {words.shape[0]}")
        if words.shape[1] * 16 != Npad:
            raise ValueError(
                f"pre-packed words must pad lanes to 2048: got "
                f"{words.shape[1]} words/marker, want {Npad // 16}")
        pad_rows_n = (hi - lo if x_process_shard else Mpad) - words.shape[0]
        if pad_rows_n:
            pad_rows = ((0, pad_rows_n), (0, 0))
            if x_on_device:
                words = jnp.pad(words, pad_rows, constant_values=-1)
            else:
                words = np.pad(words, pad_rows, constant_values=-1)
        has_missing = bool(has_missing)
    else:
        if x_process_shard:
            raise ValueError("x_process_shard packed input must be "
                             "pre-packed int32 words (read_bed_packed)")
        _, words, mean_np, scale_np, _, has_missing = \
            genotypes.pack_codes_host(X, transposed, x_stats, Mpad, N)
    if x_process_shard:
        wshape = (Mpad, Npad // 16)
        XT = put_process_shard(mesh, P(AXIS_M), words, wshape)
        x_mean = put_process_shard(mesh, P(AXIS_M), mean_np, (Mpad,))
        x_scale = put_process_shard(mesh, P(AXIS_M), scale_np, (Mpad,))
    else:
        XT = put_global(mesh, P(AXIS_M), words)
        x_mean = put_global(mesh, P(AXIS_M), mean_np)
        x_scale = put_global(mesh, P(AXIS_M), scale_np)

    def shard_fn(w_loc, m_loc, s_loc):
        return genotypes.packed_stats_local(w_loc, m_loc, s_loc, N=N, B=B,
                                            varying=(AXIS_M,))

    f = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS_M), P(AXIS_M), P(AXIS_M)),
        out_specs=(P(AXIS_M), P(AXIS_M, None, None))))
    xsq, gram = f(XT, x_mean, x_scale)
    perm = genotypes._lane_perm(Npad)
    row_valid = put_global(mesh, P(AXIS_N), perm < N)
    n_perm = put_global(mesh, P(AXIS_N), perm.astype(np.int32))
    return (XT, x_mean, x_scale, xsq, gram, row_valid, n_perm, perm,
            has_missing)


def _int8_shard_setup(mesh, X, transposed, x_stats, M, Mpad, B):
    """int8-code device setup for the sharded samplers: codes sharded
    P(m) (full rows, (m, 1) mesh), per-slice xsq/Gram built inside
    shard_map (genotypes.int8_stats_local).  Returns
    (XT, x_mean, x_scale, xsq, gram, has_missing)."""
    from ..ops import genotypes

    if x_stats is not None:
        means = np.asarray(x_stats[0], np.float64)
        sds = np.asarray(x_stats[1], np.float64)
        codes = np.asarray(X if transposed else X.T, np.int8)
    else:
        Xh = np.asarray(X, np.float64)
        XTh = np.ascontiguousarray(Xh if transposed else Xh.T)
        means = np.nanmean(XTh, axis=1)
        sds = np.nanstd(XTh, axis=1, ddof=1)
        ch = np.where(np.isnan(XTh), float(genotypes.MISSING_CODE), XTh)
        if not np.isin(np.unique(ch), [0.0, 1.0, 2.0, 3.0]).all():
            raise ValueError(
                "x_dtype='int8' expects raw dosages in {0,1,2} (+NaN)")
        codes = ch.astype(np.int8)
    has_missing = bool(np.any(codes == genotypes.MISSING_CODE))
    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    codes = np.pad(codes, ((0, Mpad - M), (0, 0)),
                   constant_values=genotypes.MISSING_CODE)
    XT = put_global(mesh, P(AXIS_M), codes)
    x_mean = put_global(mesh, P(AXIS_M),
                        np.pad(means, (0, Mpad - M)).astype(np.float32))
    x_scale = put_global(mesh, P(AXIS_M),
                         np.pad(scales, (0, Mpad - M)).astype(np.float32))

    def shard_fn(c_loc, m_loc, s_loc):
        return genotypes.int8_stats_local(c_loc, m_loc, s_loc, B=B,
                                          varying=(AXIS_M,))

    f = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS_M), P(AXIS_M), P(AXIS_M)),
        out_specs=(P(AXIS_M), P(AXIS_M, None, None))))
    xsq, gram = f(XT, x_mean, x_scale)
    return XT, x_mean, x_scale, xsq, gram, has_missing


class ShardedSpikeSlabSampler:
    """BayesR sampler sharded over a ("m", "n") device mesh."""

    def __init__(self, X, Y, cva, config, mesh: Mesh, *, g_assign=None,
                 fixed=None, dtype=jnp.float32, variant: Optional[str] = None,
                 x_dtype: str = "dense", x_stats=None, transposed=False,
                 n_individuals: Optional[int] = None,
                 has_missing: Optional[bool] = None,
                 x_process_shard: bool = False,
                 n_markers: Optional[int] = None):
        if tuple(mesh.axis_names) != (AXIS_M, AXIS_N):
            raise ValueError("mesh must have axis names ('m', 'n')")
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r} (sharded supports "
                             "dense f32, int8 codes, and 2-bit packed)")
        self.mesh = mesh
        self.Dm = mesh.shape[AXIS_M]
        self.Dn = mesh.shape[AXIS_N]
        if self.Dn != 1 and x_dtype != "dense":
            raise ValueError("Dn > 1 supports dense X only (quantized code "
                             "rows cannot row-shard: use an (m, 1) mesh)")
        self._xpass_impl = xpass_impl(mesh.devices.flat[0].platform)
        if variant is None:
            variant = "groups" if isinstance(config, GroupsConfig) else "bayesr"
        self.variant = variant
        self.config = config
        self.dtype = jnp.dtype(dtype)
        self.x_packed = x_dtype == "2bit"
        self.x_quantized = x_dtype in ("int8", "2bit")
        self._x_kind = x_dtype

        x_on_device = isinstance(X, jax.Array)
        if not x_on_device:
            X = np.asarray(X)
        prepacked = self.x_packed and X.dtype == jnp.int32
        Y = np.asarray(Y)
        self.x_process_shard = bool(x_process_shard)
        if self.x_process_shard and x_dtype == "int8":
            raise ValueError("x_process_shard supports dense and pre-packed "
                             "2-bit input (int8: pass the full code matrix)")
        if self.x_process_shard:
            # multi-host: X holds only THIS process's marker slice
            # (parallel/distributed.py::process_marker_range); the global
            # marker count must be given explicitly
            if n_markers is None:
                raise ValueError("x_process_shard requires n_markers= "
                                 "(the GLOBAL marker count)")
            if not transposed:
                raise ValueError("x_process_shard input must be marker-major "
                                 "(transposed=True)")
            M = int(n_markers)
            if prepacked:
                if has_missing is None:
                    raise ValueError("pre-packed 2-bit input requires "
                                     "has_missing=")
                N = (X.shape[1] * 16 if n_individuals is None
                     else int(n_individuals))
            else:
                N = X.shape[1]
        elif prepacked:
            # packed int32 words (M, ceil(N/2048)*128), marker-major, e.g.
            # from io.bed.read_bed_packed; n_markers < rows means the words
            # arrive already padded to the planned marker count
            if not transposed or x_stats is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "transposed=True and x_stats=(means, sds)")
            if has_missing is None:
                raise ValueError("pre-packed 2-bit input requires "
                                 "has_missing= (read_bed_packed reports it)")
            M = X.shape[0] if n_markers is None else int(n_markers)
            N = (X.shape[1] * 16 if n_individuals is None
                 else int(n_individuals))
        elif transposed:
            M, N = X.shape
        else:
            N, M = X.shape
        cva2 = _as_2d_cva(cva)
        G, Km1 = cva2.shape
        if np.any(cva2 <= 0):
            raise ValueError("slab variances must be strictly positive")
        K = Km1 + 1
        if g_assign is None:
            g_assign = np.zeros((M,), np.int32)
        g_assign = np.asarray(g_assign, np.int32)
        if fixed is None:
            fixed = np.zeros((N, 0))
        fixed = np.asarray(fixed)
        F = fixed.shape[1]

        self.jacobi, B, Mpad = _slice_plan(M, self.Dm, config.block_size)
        if prepacked and X.shape[0] not in (M, Mpad) \
                and not self.x_process_shard:
            raise ValueError(f"pre-packed words have {X.shape[0]} rows; "
                             f"expected {M} or the planned {Mpad}")
        if self.x_packed:
            # lanes pad to the packed tile (2048); individuals stay
            # unsharded (Dn == 1 enforced above)
            Npad = -(-N // 2048) * 2048
        else:
            Npad = -(-N // self.Dn) * self.Dn
        self.N, self.M, self.Mpad, self.Npad = N, M, Mpad, Npad
        self.K, self.G, self.F, self.B = K, G, F, B
        self.Mloc = Mpad // self.Dm
        self.nb_loc = self.Mloc // B
        self.Nloc = Npad // self.Dn

        empty_f = put_global(mesh, P(), np.zeros((0,), np.float32))
        empty_i = put_global(mesh, P(), np.zeros((0,), np.int32))
        n_perm_np = None
        if self.x_packed:
            (XT, x_mean, x_scale, xsq, gram, row_valid, n_perm,
             n_perm_np, self._has_missing) = _packed_shard_setup(
                mesh, X, x_on_device, prepacked, transposed, x_stats,
                has_missing, M, N, Mpad, Npad, B,
                x_process_shard=self.x_process_shard)
        elif self.x_quantized:   # int8 codes, full rows on an (m, 1) mesh
            (XT, x_mean, x_scale, xsq, gram,
             self._has_missing) = _int8_shard_setup(
                mesh, X, transposed, x_stats, M, Mpad, B)
            row_valid = put_global(mesh, P(AXIS_N), np.arange(Npad) < N)
            n_perm = empty_i
        else:
            self._has_missing = False
            if self.x_process_shard:
                lo, hi = process_marker_range(mesh, Mpad)
                m_real = max(0, min(hi, M) - lo)
                if X.shape[0] != m_real:
                    raise ValueError(
                        f"x_process_shard: this host must pass exactly its "
                        f"marker slice [{lo}, {lo + m_real}) = {m_real} "
                        f"rows, got {X.shape[0]}")
                XTh = np.zeros((hi - lo, Npad), self.dtype)
                XTh[:m_real, :N] = X
                XT = put_process_shard(mesh, P(AXIS_M, AXIS_N), XTh,
                                       (Mpad, Npad))
                xsq = self._xsq_shard(XT)
            else:
                XTh = np.zeros((Mpad, Npad), self.dtype)
                XTh[:M, :N] = (X if transposed else X.T)
                xsq_h = (XTh.astype(np.float64) ** 2).sum(axis=1).astype(self.dtype)
                XT = put_global(mesh, P(AXIS_M, AXIS_N), XTh)
                xsq = put_global(mesh, P(AXIS_M), xsq_h)
            gram = self._gram(XT)
            x_mean = x_scale = empty_f
            row_valid = put_global(mesh, P(AXIS_N), np.arange(Npad) < N)
            n_perm = empty_i
        self._x_fold = self.x_quantized and not self._has_missing

        fixedTh = np.zeros((F, Npad), self.dtype)
        fixedTh[:, :N] = fixed.T
        Yh = np.pad(Y.astype(self.dtype), (0, Npad - N))
        if self.x_packed:
            # eps/Y/fixed live in the packed-word lane permutation (all sweep
            # sums are permutation-invariant; emission un-permutes)
            fixedTh = fixedTh[:, n_perm_np]
            Yh = Yh[n_perm_np]
        prior_pi = self._prior_pi(cva2)
        self.data = ShardedMarkerData(
            XT=XT,
            xsq=xsq,
            gram=gram,
            g_assign=put_global(mesh, P(AXIS_M),
                                np.pad(g_assign, (0, Mpad - M))),
            valid=put_global(mesh, P(AXIS_M), np.arange(Mpad) < M),
            row_valid=row_valid,
            cva=put_global(mesh, P(), np.asarray(cva2, self.dtype)),
            prior_pi=put_global(mesh, P(), np.asarray(prior_pi, self.dtype)),
            fixedT=put_global(mesh, P(None, AXIS_N), fixedTh),
            fsq=put_global(mesh, P(), (fixedTh.astype(np.float64) ** 2)
                           .sum(axis=1).astype(self.dtype)),
            x_mean=x_mean, x_scale=x_scale, n_perm=n_perm,
        )
        self.Y = put_global(mesh, P(AXIS_N), Yh)

        self.state_specs = SpikeSlabState(
            key=P(), iteration=P(), mu=P(), beta=P(AXIS_M), labels=P(AXIS_M),
            eps=P(AXIS_N), sigmaE=P(), sigmaGG=P(), pi=P(), alpha=P(),
            sigmaF=P())
        mspec = P(AXIS_M) if self.x_quantized else P()
        self.data_specs = ShardedMarkerData(
            XT=P(AXIS_M) if self.x_quantized else P(AXIS_M, AXIS_N),
            xsq=P(AXIS_M), gram=P(AXIS_M, None, None),
            g_assign=P(AXIS_M), valid=P(AXIS_M), row_valid=P(AXIS_N),
            cva=P(), prior_pi=P(), fixedT=P(None, AXIS_N), fsq=P(),
            x_mean=mspec, x_scale=mspec,
            n_perm=P(AXIS_N) if self.x_packed else P())

        self._run_steps_cache = {}
        self._emit_cache = {}

    def _gram(self, XT):
        B, nb_loc, Nloc = self.B, self.nb_loc, self.Nloc

        def gram_shard(xt_loc):
            blocks = xt_loc.reshape(nb_loc, B, Nloc)
            g_part = lax.map(lambda xb: xb @ xb.T, blocks)
            return lax.psum(g_part, AXIS_N)

        f = jax.jit(jax.shard_map(gram_shard, mesh=self.mesh,
                              in_specs=P(AXIS_M, AXIS_N),
                              out_specs=P(AXIS_M, None, None)))
        return f(XT)

    def _xsq_shard(self, XT):
        f = jax.jit(jax.shard_map(
            lambda xt_loc: lax.psum(jnp.sum(xt_loc * xt_loc, axis=1), AXIS_N),
            mesh=self.mesh, in_specs=P(AXIS_M, AXIS_N), out_specs=P(AXIS_M)))
        return f(XT)

    def _prior_pi(self, cva2: np.ndarray) -> np.ndarray:
        G, Km1 = cva2.shape
        K = Km1 + 1
        pi = np.empty((G, K))
        pi[:, 0] = 0.5
        if self.variant == "bayesr":
            pi[:, 1:] = 0.5 * cva2 / cva2.sum(axis=1, keepdims=True)
        else:
            pi[:, 1:] = 0.5 / K
            if not getattr(self.config, "reference_prior_pi", True):
                pi /= pi.sum(axis=1, keepdims=True)
        return pi

    # ---------------------------------------------------------------- init

    def init(self, key) -> SpikeSlabState:
        # jitted with explicit out_shardings so it also runs multi-host
        # (eager ops on non-addressable global arrays are not allowed)
        sh = lambda spec: NamedSharding(self.mesh, spec)
        fn = jax.jit(self._init_impl,
                     out_shardings=jax.tree.map(sh, self.state_specs))
        return fn(key, self.Y, self.data.prior_pi)

    def _init_impl(self, key, Y, prior_pi) -> SpikeSlabState:
        key, kG, kF = jax.random.split(key, 3)
        dt = self.dtype
        sigmaGG = jax.vmap(lambda k: dist.beta_rng(k, 1.0, 1.0, dtype=dt))(
            jax.random.split(kG, self.G))
        sigmaF = (jax.random.uniform(kF, (), dtype=dt) if self.F > 0
                  else jnp.ones((), dt))
        # mu=0, beta=0; padded rows are already exactly 0.  Copy: the state
        # is donated by the step functions and must not alias self.Y.
        eps = Y + jnp.zeros((), self.dtype)
        sigmaE = jnp.sum(eps * eps) / self.N * 0.5
        return SpikeSlabState(
            key=key, iteration=jnp.zeros((), jnp.int32), mu=jnp.zeros((), dt),
            beta=jnp.zeros((self.Mpad,), dt),
            labels=jnp.zeros((self.Mpad,), jnp.int32),
            eps=eps, sigmaE=sigmaE,
            sigmaGG=sigmaGG, pi=prior_pi + jnp.zeros((), self.dtype),
            alpha=jnp.zeros((self.F,), dt), sigmaF=sigmaF)

    # ---------------------------------------------------------------- step

    def _pre_marker(self, state: SpikeSlabState, data: ShardedMarkerData):
        """Intercept + fixed-effect sweep (everything before the marker
        sweep), on per-device shards; shared by the single-chain and fused
        multi-chain step bodies (the latter vmaps this over chains)."""
        N, F = self.N, self.F
        dt = self.dtype
        keys = jax.random.split(state.key, 9)
        (key, kmu, kforder, kfz, ksweep, ksE, ksF, ksG, kpi) = keys

        rv = data.row_valid
        # ---- intercept (masked so padded rows stay identically zero)
        eps = jnp.where(rv, state.eps + state.mu, 0.0)
        s_eps = lax.psum(jnp.sum(eps), AXIS_N)
        mu = dist.norm_rng(kmu, s_eps / N, state.sigmaE / N)
        eps = jnp.where(rv, eps - mu, 0.0)

        # ---- fixed-effect sweep (replicated draws; padded fixed rows are 0)
        alpha, sigmaF = state.alpha, state.sigmaF
        if F > 0:
            forder = jax.random.permutation(kforder, F)
            zf = jax.random.normal(kfz, (F,), dt)

            def fbody(carry, xs):
                eps, alpha = carry
                c, z = xs
                fc = data.fixedT[c]
                denom_f = (N - 1) + state.sigmaE / sigmaF
                num_f = lax.psum(jnp.dot(fc, eps), AXIS_N) + alpha[c] * data.fsq[c]
                a_new = num_f / denom_f + jnp.sqrt(state.sigmaE / denom_f) * z
                eps = eps - fc * (a_new - alpha[c])
                alpha = alpha.at[c].set(a_new)
                return (eps, alpha), None

            (eps, alpha), _ = lax.scan(fbody, (eps, alpha), (forder, zf))
        return keys, mu, eps, alpha, sigmaF

    def _sweep(self, data: ShardedMarkerData, eps, beta, labels, rho, inner,
               p, z, pi, sigmaE, sigmaGG):
        """This slice's strided sweep over a leading chain axis, with r
        psum'd over "n" and the eps update psum'd over "m" each round."""
        return strided.bayesr_strided_sweep(
            (data.XT, data.x_mean, data.x_scale, data.row_valid), data.gram,
            data.xsq, eps, beta, labels, rho, inner, p, z, pi, data.cva,
            sigmaE, sigmaGG, data.g_assign, data.valid, J=self.jacobi,
            kind=self._x_kind, fold=self._x_fold, impl=self._xpass_impl,
            reduce_r=lambda r: lax.psum(r, AXIS_N),
            reduce_eps=lambda u: lax.psum(u, AXIS_M))

    def _step_local(self, state: SpikeSlabState, data: ShardedMarkerData):
        """One Gibbs iteration on per-device shards (runs inside shard_map)."""
        B, nb_loc, Mloc = self.B, self.nb_loc, self.Mloc
        dt = self.dtype
        im = lax.axis_index(AXIS_M)
        keys, mu, eps, alpha, sigmaF = self._pre_marker(state, data)
        (key, kmu, kforder, kfz, ksweep, ksE, ksF, ksG, kpi) = keys

        # ---- marker sweep: per-slice visit order and randoms
        korder, kp, kz = jax.random.split(jax.random.fold_in(ksweep, im), 3)
        rho, inner = bs.strided_orders(korder, nb_loc, B, self.jacobi)
        p_arr = jax.random.uniform(kp, (Mloc,), dtype=dt)
        z_arr = jax.random.normal(kz, (Mloc,), dt)
        res = self._sweep(data, eps[None], state.beta[None],
                          state.labels[None], rho, inner, p_arr[None],
                          z_arr[None], state.pi[None], state.sigmaE[None],
                          state.sigmaGG[None])
        eps, beta, labels, v, bacc = (a[0] for a in res)
        return self._hypers(state, data, key, eps, mu, alpha, sigmaF,
                            beta, labels, v, bacc, ksE, ksF, ksG, kpi)

    def _hypers(self, state, data, key, eps, mu, alpha, sigmaF,
                beta, labels, v, bacc, ksE, ksF, ksG, kpi):
        cfg = self.config
        N, F, G = self.N, self.F, self.G
        dt = self.dtype
        v = lax.psum(v, AXIS_M)
        bacc = lax.psum(bacc, AXIS_M)

        # ---- hyperparameters (replicated draws, identical on all devices)
        if F > 0:
            sigmaF = dist.inv_scaled_chisq_rng(
                ksF, cfg.v0E + F,
                (jnp.sum(alpha * alpha) + cfg.v0E * cfg.s02E) / (cfg.v0E + F)
            ).astype(dt)
        ss_eps = lax.psum(jnp.sum(eps * eps), AXIS_N)
        sigmaE = dist.inv_scaled_chisq_rng(
            ksE, cfg.v0E + N,
            (ss_eps + cfg.v0E * cfg.s02E) / (cfg.v0E + N)).astype(dt)

        m0 = jnp.sum(v, axis=1) - v[:, 0]
        if self.variant == "bayesr":
            ss = jnp.broadcast_to(lax.psum(jnp.sum(beta * beta), AXIS_M), (G,))
        else:
            ss = bacc
        if cfg.reference_sigma_g_scaling:
            scale_g = (ss * m0 + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        else:
            scale_g = (ss + cfg.v0G * cfg.s02G) / (cfg.v0G + m0)
        sigmaGG = jax.vmap(dist.inv_scaled_chisq_rng)(
            jax.random.split(ksG, G), cfg.v0G + m0, scale_g).astype(dt)
        pi = jax.vmap(dist.dirichlet_rng)(
            jax.random.split(kpi, G), v + 1.0).astype(dt)

        return SpikeSlabState(
            key=key, iteration=state.iteration + 1, mu=mu, beta=beta,
            labels=labels, eps=eps, sigmaE=sigmaE, sigmaGG=sigmaGG, pi=pi,
            alpha=alpha, sigmaF=sigmaF)

    def _mc_step_local(self, state: SpikeSlabState, data: ShardedMarkerData):
        """Fused multi-chain Gibbs iteration on per-device shards: state
        leaves carry a leading chain axis C (sharded like the single-chain
        state plus a replicated chain axis); one strided sweep per slice
        serves all chains, with one cross-slice (C, Npad) eps psum per
        round."""
        B, nb_loc = self.B, self.nb_loc
        dt = self.dtype
        im = lax.axis_index(AXIS_M)
        keys, mu, eps, alpha, sigmaF = jax.vmap(
            self._pre_marker, in_axes=(0, None))(state, data)
        key, ksweep = keys[:, 0], keys[:, 4]
        ksE, ksF, ksG, kpi = keys[:, 5], keys[:, 6], keys[:, 7], keys[:, 8]

        # shared visit order from chain 0; independent per-chain p/z, each
        # drawn as _step_local draws them (chain 0 steps as it would alone)
        kopz = jax.vmap(lambda k: jax.random.split(
            jax.random.fold_in(k, im), 3))(ksweep)          # (C, 3, 2)
        korder = kopz[0, 0]
        p_arr = jax.vmap(lambda k: jax.random.uniform(
            k, (self.Mloc,), dtype=dt))(kopz[:, 1])
        z_arr = jax.vmap(lambda k: jax.random.normal(
            k, (self.Mloc,), dt))(kopz[:, 2])
        rho, inner = bs.strided_orders(korder, nb_loc, B, self.jacobi)
        eps, beta, labels, v, bacc = self._sweep(
            data, eps, state.beta, state.labels, rho, inner, p_arr, z_arr,
            state.pi, state.sigmaE, state.sigmaGG)

        def hyp(state_c, key_c, eps_c, mu_c, alpha_c, sigmaF_c, beta_c,
                labels_c, v_c, bacc_c, ksE_c, ksF_c, ksG_c, kpi_c):
            return self._hypers(state_c, data, key_c, eps_c, mu_c, alpha_c,
                                sigmaF_c, beta_c, labels_c, v_c, bacc_c,
                                ksE_c, ksF_c, ksG_c, kpi_c)

        return jax.vmap(hyp)(state, key, eps, mu, alpha, sigmaF, beta,
                             labels, v, bacc, ksE, ksF, ksG, kpi)

    def _refresh_local(self, state, data, y_loc):
        """Exact residual recompute with one sharded X pass (runs inside
        shard_map; see ChainConfig.eps_refresh_every)."""
        f32 = jnp.float32
        beta = state.beta.astype(f32)                       # (Mloc,)
        if not self.x_quantized:
            xb = lax.psum(beta @ data.XT.astype(f32), AXIS_M)
        elif self.x_packed:
            xb = lax.psum(genotypes.xbeta_packed(
                data.XT, data.x_mean, data.x_scale, beta, self.B,
                self.Npad), AXIS_M)
            # back to the stored lane permutation
            xb = jnp.take(xb, data.n_perm)
        else:
            xb = lax.psum(genotypes.xbeta_int8(
                data.XT, data.x_mean, data.x_scale, beta, self.B), AXIS_M)
        eps = y_loc.astype(f32) - xb - state.mu.astype(f32)
        if self.F > 0:
            eps = eps - state.alpha.astype(f32) @ data.fixedT.astype(f32)
        eps = jnp.where(data.row_valid, eps, 0.0)
        return state._replace(eps=eps.astype(self.dtype))

    def refresh_eps(self, state):
        """Exact residual recompute (single or chain-batched state)."""
        batched = bool(getattr(state.mu, "ndim", 0))
        kk = ("refresh", batched)
        fn = self._run_steps_cache.get(kk)
        if fn is None:
            specs = self.state_specs
            if batched:
                specs = jax.tree.map(lambda s: P(*((None,) + tuple(s))),
                                     specs)

                def body(st, d, y):
                    return jax.vmap(self._refresh_local,
                                    in_axes=(0, None, None))(st, d, y)
            else:
                body = self._refresh_local
            fn = jax.jit(jax.shard_map(
                body, mesh=self.mesh,
                in_specs=(specs, self.data_specs, P(AXIS_N)),
                out_specs=specs, check_vma=False))
            self._run_steps_cache[kk] = fn
        return fn(state, self.data, self.Y)

    def init_chains(self, key, n_chains: int) -> SpikeSlabState:
        """Batched fresh-chain init: state leaves gain a leading chain axis
        (replicated over the mesh; everything else sharded as in init)."""
        sh = lambda spec: NamedSharding(self.mesh, spec)
        specs = jax.tree.map(lambda s: P(*((None,) + tuple(s))),
                             self.state_specs)
        fn = jax.jit(jax.vmap(self._init_impl, in_axes=(0, None, None)),
                     out_shardings=jax.tree.map(sh, specs))
        return fn(jax.random.split(key, n_chains), self.Y,
                  self.data.prior_pi)

    def _get_mc_run_steps(self, n: int, C: int):
        kk = ("mc", n, C)
        fn = self._run_steps_cache.get(kk)
        if fn is None:
            specs = jax.tree.map(lambda s: P(*((None,) + tuple(s))),
                                 self.state_specs)

            def body(state, data):
                return lax.fori_loop(
                    0, n, lambda i, s: self._mc_step_local(s, data), state)

            fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(specs, self.data_specs),
                                   out_specs=specs, check_vma=False),
                         donate_argnums=(0,))
            self._run_steps_cache[kk] = fn
        return fn

    def step_chains(self, state: SpikeSlabState) -> SpikeSlabState:
        """One fused multi-chain iteration (state leaves batched over C)."""
        C = state.mu.shape[0]
        return self._get_mc_run_steps(1, C)(state, self.data)

    def run_chains(self, key, n_chains: int, chain: ChainConfig, *,
                   collect: bool = True, emit_chunk: int = 32,
                   progress=None):
        """Run n_chains fused chains, all column-sharded over the mesh --
        the aggregate-throughput R-hat workflow at pod scale (the reference
        runs one chain per R process, src/BayesRv2.cpp:171).  Collected
        arrays gain a chain axis after the emission axis."""
        from ..models.driver import run_chain

        state = self.init_chains(key, n_chains)
        C = n_chains

        if self.x_packed:
            from .distributed import replicate
            n_perm_np = np.asarray(replicate(self.data.n_perm, self.mesh))

        def postprocess(rows):
            rows["beta"] = rows["beta"][:, :, : self.M]
            rows["comp"] = rows["comp"][:, :, : self.M]
            if self.x_packed and self.config.emit_epsilon:
                eps_orig = np.zeros_like(rows["epsilon"])
                eps_orig[:, :, n_perm_np] = rows["epsilon"]
                rows["epsilon"] = eps_orig[:, :, : self.N]
            else:
                rows["epsilon"] = rows["epsilon"][:, :, : self.N]
            if not self.config.emit_epsilon:
                rows["epsilon"] = rows["epsilon"][:, :, :0]
            return rows

        def emit_fn(st, n_emits, thinning):
            kk = ("mc_emit", n_emits, thinning, C)
            fn = self._emit_cache.get(kk)
            if fn is None:
                specs = jax.tree.map(lambda s: P(*((None,) + tuple(s))),
                                     self.state_specs)
                row_specs = {
                    "iteration": P(None), "mu": P(None),
                    "beta": P(None, None, AXIS_M),
                    "sigmaE": P(None), "sigmaG": P(None),
                    "comp": P(None, None, AXIS_M),
                    "epsilon": P(None, None, AXIS_N),
                    "alpha": P(None), "sigmaF": P(None),
                }
                if jax.process_count() > 1:
                    row_specs = jax.tree.map(lambda _: P(), row_specs)

                def body(state, data):
                    def one(state, _):
                        state = lax.fori_loop(
                            0, thinning,
                            lambda i, s: self._mc_step_local(s, data), state)
                        return state, jax.vmap(self._emit_one)(state)

                    return lax.scan(one, state, None, length=n_emits)

                fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                       in_specs=(specs, self.data_specs),
                                       out_specs=(specs, row_specs),
                                       check_vma=False),
                             donate_argnums=(0,))
                self._emit_cache[kk] = fn
            return fn(st, self.data)

        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._get_mc_run_steps(n, C)(st, self.data),
            emit_fn=emit_fn, postprocess=postprocess, collect=collect,
            emit_chunk=emit_chunk, progress=progress,
            refresh_fn=self.refresh_eps)

    # ------------------------------------------------------------- drivers

    def _emit_one(self, state: SpikeSlabState):
        return {
            "iteration": state.iteration - 1,
            "mu": state.mu,
            "beta": state.beta,
            "sigmaE": state.sigmaE,
            "sigmaG": state.sigmaGG,
            "comp": state.labels.astype(jnp.int8),  # 4x smaller payload
            "epsilon": state.eps,
            "alpha": state.alpha,
            "sigmaF": state.sigmaF,
        }

    def _get_run_steps(self, n: int):
        fn = self._run_steps_cache.get(n)
        if fn is None:
            def body(state, data):
                return lax.fori_loop(
                    0, n, lambda i, s: self._step_local(s, data), state)

            fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(self.state_specs, self.data_specs),
                                   out_specs=self.state_specs,
                                   check_vma=False),
                         donate_argnums=(0,))
            self._run_steps_cache[n] = fn
        return fn

    def _get_emit_chunk(self, n_emits: int, thinning: int):
        kk = (n_emits, thinning)
        fn = self._emit_cache.get(kk)
        if fn is None:
            row_specs = {
                "iteration": P(), "mu": P(), "beta": P(None, AXIS_M),
                "sigmaE": P(), "sigmaG": P(), "comp": P(None, AXIS_M),
                "epsilon": P(None, AXIS_N), "alpha": P(), "sigmaF": P(),
            }
            if jax.process_count() > 1:
                # multi-host emission: replicate rows (an in-jit all-gather)
                # so every host's sink sees the full sample
                row_specs = jax.tree.map(lambda _: P(), row_specs)

            def body(state, data):
                def one(state, _):
                    state = lax.fori_loop(
                        0, thinning, lambda i, s: self._step_local(s, data),
                        state)
                    return state, self._emit_one(state)

                return lax.scan(one, state, None, length=n_emits)

            fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(self.state_specs, self.data_specs),
                                   out_specs=(self.state_specs, row_specs),
                                   check_vma=False),
                         donate_argnums=(0,))
            self._emit_cache[kk] = fn
        return fn

    def step(self, state: SpikeSlabState) -> SpikeSlabState:
        return self._get_run_steps(1)(state, self.data)

    def run(self, key_or_state, chain: ChainConfig, *, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        from ..models.driver import run_chain

        state = (key_or_state if isinstance(key_or_state, SpikeSlabState)
                 else self.init(key_or_state))

        if self.x_packed:
            from .distributed import replicate
            n_perm_np = np.asarray(replicate(self.data.n_perm, self.mesh))

        def postprocess(rows):
            rows["beta"] = rows["beta"][:, : self.M]
            rows["comp"] = rows["comp"][:, : self.M]
            if self.x_packed and self.config.emit_epsilon:
                # un-permute eps back to original individual order
                eps_orig = np.zeros_like(rows["epsilon"])
                eps_orig[:, n_perm_np] = rows["epsilon"]
                rows["epsilon"] = eps_orig[:, : self.N]
            else:
                rows["epsilon"] = rows["epsilon"][:, : self.N]
            if not self.config.emit_epsilon:
                rows["epsilon"] = rows["epsilon"][:, :0]
            return rows

        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._get_run_steps(n)(st, self.data),
            emit_fn=lambda st, n, t: self._get_emit_chunk(n, t)(st, self.data),
            postprocess=postprocess, sink=sink, collect=collect,
            emit_chunk=emit_chunk, start_iteration=int(state.iteration),
            progress=progress, on_chunk=on_chunk,
            refresh_fn=self.refresh_eps)


class ShardedHorseshoeSampler:
    """Regularized-horseshoe sampler sharded over a ("m", "n") device mesh.

    Same layout as ShardedSpikeSlabSampler: markers (and the per-marker
    lambda/v scales) column-sharded over "m", individuals over "n"; each
    slice runs the strided sweep, block-Jacobi across m-slices with one
    residual psum per round.
    """

    def __init__(self, X, Y, config, mesh: Mesh, *, dtype=jnp.float32,
                 x_dtype: str = "dense", x_stats=None, transposed=False,
                 n_individuals: Optional[int] = None,
                 has_missing: Optional[bool] = None,
                 x_process_shard: bool = False,
                 n_markers: Optional[int] = None):
        from ..models.state import HorseshoeState

        if tuple(mesh.axis_names) != (AXIS_M, AXIS_N):
            raise ValueError("mesh must have axis names ('m', 'n')")
        if x_dtype not in ("dense", "int8", "2bit"):
            raise ValueError(f"unknown x_dtype {x_dtype!r} (sharded supports "
                             "dense f32, int8 codes, and 2-bit packed)")
        self.mesh = mesh
        self.Dm = mesh.shape[AXIS_M]
        self.Dn = mesh.shape[AXIS_N]
        if self.Dn != 1 and x_dtype != "dense":
            raise ValueError("Dn > 1 supports dense X only (quantized code "
                             "rows cannot row-shard: use an (m, 1) mesh)")
        self._xpass_impl = xpass_impl(mesh.devices.flat[0].platform)
        self.config = config
        self.dtype = jnp.dtype(dtype)
        self.x_packed = x_dtype == "2bit"
        self.x_quantized = x_dtype in ("int8", "2bit")
        self._x_kind = x_dtype

        x_on_device = isinstance(X, jax.Array)
        if not x_on_device:
            X = np.asarray(X)
        prepacked = self.x_packed and X.dtype == jnp.int32
        Y = np.asarray(Y)
        self.x_process_shard = bool(x_process_shard)
        if self.x_process_shard:
            if n_markers is None or not transposed:
                raise ValueError("x_process_shard requires n_markers= and "
                                 "transposed=True (see ShardedSpikeSlab)")
            M = int(n_markers)
            if prepacked:
                if has_missing is None:
                    raise ValueError("pre-packed 2-bit input requires "
                                     "has_missing=")
                N = (X.shape[1] * 16 if n_individuals is None
                     else int(n_individuals))
            else:
                N = X.shape[1]
        elif prepacked:
            M = X.shape[0] if n_markers is None else int(n_markers)
            N = (X.shape[1] * 16 if n_individuals is None
                 else int(n_individuals))
        elif transposed:
            M, N = X.shape
        else:
            N, M = X.shape
        self.jacobi, B, Mpad = _slice_plan(M, self.Dm, config.block_size)
        if self.x_packed:
            Npad = -(-N // 2048) * 2048
        else:
            Npad = -(-N // self.Dn) * self.Dn
        self.N, self.M, self.Mpad, self.Npad = N, M, Mpad, Npad
        self.B = B
        self.Mloc = Mpad // self.Dm
        self.nb_loc = self.Mloc // B
        self.Nloc = Npad // self.Dn

        empty_f = put_global(mesh, P(), np.zeros((0,), np.float32))
        empty_i = put_global(mesh, P(), np.zeros((0,), np.int32))
        n_perm_np = None
        if self.x_packed:
            (XT, x_mean, x_scale, xsq, gram, row_valid, n_perm,
             n_perm_np, self._has_missing) = _packed_shard_setup(
                mesh, X, x_on_device, prepacked, transposed, x_stats,
                has_missing, M, N, Mpad, Npad, B,
                x_process_shard=self.x_process_shard)
        elif self.x_quantized:   # int8 codes, full rows on an (m, 1) mesh
            (XT, x_mean, x_scale, xsq, gram,
             self._has_missing) = _int8_shard_setup(
                mesh, X, transposed, x_stats, M, Mpad, B)
            row_valid = put_global(mesh, P(AXIS_N), np.arange(Npad) < N)
            n_perm = empty_i
        else:
            self._has_missing = False
            if self.x_process_shard:
                lo, hi = process_marker_range(mesh, Mpad)
                m_real = max(0, min(hi, M) - lo)
                if X.shape[0] != m_real:
                    raise ValueError(
                        f"x_process_shard: this host must pass exactly its "
                        f"marker slice [{lo}, {lo + m_real}) = {m_real} "
                        f"rows, got {X.shape[0]}")
                XTh = np.zeros((hi - lo, Npad), self.dtype)
                XTh[:m_real, :N] = X
                XT = put_process_shard(mesh, P(AXIS_M, AXIS_N), XTh,
                                       (Mpad, Npad))
                xsq = self._xsq_shard(XT)
            else:
                XTh = np.zeros((Mpad, Npad), self.dtype)
                XTh[:M, :N] = (X if transposed else X.T)
                xsq_h = (XTh.astype(np.float64) ** 2).sum(axis=1).astype(self.dtype)
                XT = put_global(mesh, P(AXIS_M, AXIS_N), XTh)
                xsq = put_global(mesh, P(AXIS_M), xsq_h)
            gram = self._gram(XT)
            x_mean = x_scale = empty_f
            row_valid = put_global(mesh, P(AXIS_N), np.arange(Npad) < N)
            n_perm = empty_i
        self._x_fold = self.x_quantized and not self._has_missing

        Yh = np.pad(Y.astype(self.dtype), (0, Npad - N))
        if self.x_packed:
            Yh = Yh[n_perm_np]
        self.data = {
            "XT": XT,
            "xsq": xsq,
            "gram": gram,
            "valid": put_global(mesh, P(AXIS_M), np.arange(Mpad) < M),
            "row_valid": row_valid,
            "x_mean": x_mean, "x_scale": x_scale,
            "n_perm": n_perm,
        }
        self.Y = put_global(mesh, P(AXIS_N), Yh)

        self.state_specs = HorseshoeState(
            key=P(), iteration=P(), mu=P(), beta=P(AXIS_M), eps=P(AXIS_N),
            sigmaE=P(), lam=P(AXIS_M), v=P(AXIS_M), tau=P(), eta=P(), c2=P())
        mspec = P(AXIS_M) if self.x_quantized else P()
        self.data_specs = {
            "XT": P(AXIS_M) if self.x_quantized else P(AXIS_M, AXIS_N),
            "xsq": P(AXIS_M),
            "gram": P(AXIS_M, None, None), "valid": P(AXIS_M),
            "row_valid": P(AXIS_N),
            "x_mean": mspec, "x_scale": mspec,
            "n_perm": P(AXIS_N) if self.x_packed else P(),
        }
        self._run_steps_cache = {}
        self._emit_cache = {}

    def _gram(self, XT):
        B, nb_loc, Nloc = self.B, self.nb_loc, self.Nloc

        def gram_shard(xt_loc):
            blocks = xt_loc.reshape(nb_loc, B, Nloc)
            g_part = lax.map(lambda xb: xb @ xb.T, blocks)
            return lax.psum(g_part, AXIS_N)

        return jax.jit(jax.shard_map(gram_shard, mesh=self.mesh,
                                 in_specs=P(AXIS_M, AXIS_N),
                                 out_specs=P(AXIS_M, None, None)))(XT)

    def _xsq_shard(self, XT):
        f = jax.jit(jax.shard_map(
            lambda xt_loc: lax.psum(jnp.sum(xt_loc * xt_loc, axis=1), AXIS_N),
            mesh=self.mesh, in_specs=P(AXIS_M, AXIS_N), out_specs=P(AXIS_M)))
        return f(XT)

    def init(self, key):
        # jitted with explicit out_shardings so it also runs multi-host
        sh = lambda spec: NamedSharding(self.mesh, spec)
        fn = jax.jit(self._init_impl,
                     out_shardings=jax.tree.map(sh, self.state_specs))
        return fn(key, self.Y)

    def _init_impl(self, key, Y):
        from ..models.state import HorseshoeState

        cfg = self.config
        key, keta, ktau = jax.random.split(key, 3)
        dt = self.dtype
        mu = jnp.zeros((), dt)
        eps = Y - mu
        sigmaE = jnp.sum(eps * eps) / self.N * 0.5
        eta = dist.inv_gamma_rate_rng(keta, 0.5, 1.0 / (sigmaE * cfg.A ** 2))
        tau = (1.0 / eta) * dist.inv_gamma_rate_rng(ktau, 0.5 * cfg.vT, cfg.vT)
        ones_m = jnp.ones((self.Mpad,), dt)
        return HorseshoeState(
            key=key, iteration=jnp.zeros((), jnp.int32), mu=mu,
            beta=jnp.zeros((self.Mpad,), dt),
            eps=eps, sigmaE=sigmaE.astype(dt), lam=ones_m,
            v=ones_m + jnp.zeros((), dt), tau=tau.astype(dt),
            eta=eta.astype(dt), c2=jnp.asarray(cfg.c2, dt))

    # ---------------------------------------------------------------- step

    def _step_local(self, state, data):
        from ..models.state import HorseshoeState

        cfg = self.config
        N, M = self.N, self.M
        B, nb_loc = self.B, self.nb_loc
        dt = self.dtype
        im = lax.axis_index(AXIS_M)
        (key, kmu, keta, kv, ksweep, klam, ktau, kc2, ksE) = \
            jax.random.split(state.key, 9)

        rv = data["row_valid"]
        eps = jnp.where(rv, state.eps + state.mu, 0.0)
        s_eps = lax.psum(jnp.sum(eps), AXIS_N)
        mu = dist.norm_rng(kmu, s_eps / N, state.sigmaE / N)
        eps = jnp.where(rv, eps - mu, 0.0)

        eta = dist.inv_gamma_rate_rng(
            keta, 0.5 + 0.5 * cfg.vT,
            1.0 / (state.sigmaE * cfg.A * cfg.A) + cfg.vT / state.tau)
        # local auxiliaries: per-m-slice keys, identical across n
        key_m = jax.random.fold_in(kv, im)
        Mloc = self.Mloc
        gv = dist.gamma_shape_rng(key_m, 0.5 + 0.5 * cfg.vL, Mloc, dtype=dt)
        v = (cfg.vL / state.lam + 1.0) / gv

        # ---- strided sweep, block-Jacobi across m-slices
        korder, kz = jax.random.split(jax.random.fold_in(ksweep, im), 2)
        rho, inner = bs.strided_orders(korder, nb_loc, B, self.jacobi)
        z_arr = jax.random.normal(kz, (Mloc,), dt)
        eps, beta = strided.horseshoe_strided_sweep(
            (data["XT"], data["x_mean"], data["x_scale"], data["row_valid"]),
            data["gram"], data["xsq"], eps[None], state.beta[None], rho,
            inner, z_arr[None], state.lam[None], state.tau[None],
            state.c2[None], state.sigmaE[None], data["valid"], J=self.jacobi,
            kind=self._x_kind, fold=self._x_fold, impl=self._xpass_impl,
            reduce_r=lambda r: lax.psum(r, AXIS_N),
            reduce_eps=lambda u: lax.psum(u, AXIS_M))
        eps, beta = eps[0], beta[0]

        # ---- local/global scale updates
        key_l = jax.random.fold_in(klam, im)
        glam = dist.gamma_shape_rng(key_l, 0.5 + 0.5 * cfg.vL, Mloc,
                                    dtype=dt)
        lam = (cfg.vL / v + 0.5 * beta * beta / state.tau) / glam
        bl = jnp.where(data["valid"], beta * beta / lam, 0.0)
        sum_bl = lax.psum(jnp.sum(bl), AXIS_M)
        tau = dist.inv_gamma_rate_rng(
            ktau, 0.5 * (M + cfg.vT), cfg.vT / eta + 0.5 * sum_bl)
        bsq = lax.psum(jnp.sum(beta * beta), AXIS_M)
        c2 = dist.inv_gamma_rate_rng(
            kc2, 0.5 * cfg.vC + 0.5 * M, 0.5 * cfg.vC * cfg.sC + 0.5 * bsq)
        ss_eps = lax.psum(jnp.sum(eps * eps), AXIS_N)
        sigmaE = dist.inv_scaled_chisq_rng(
            ksE, cfg.v0E + N,
            (ss_eps + cfg.v0E * cfg.s02E) / (cfg.v0E + N)).astype(dt)

        return HorseshoeState(
            key=key, iteration=state.iteration + 1, mu=mu, beta=beta, eps=eps,
            sigmaE=sigmaE, lam=lam, v=v, tau=tau.astype(dt),
            eta=eta.astype(dt), c2=c2.astype(dt))

    # ------------------------------------------------------------- drivers

    def _emit_one(self, state):
        return {
            "iteration": state.iteration - 1,
            "mu": state.mu,
            "beta": state.beta,
            "sigmaE": state.sigmaE,
            "tau": state.tau,
            "lambda": state.lam,
            "epsilon": state.eps,
        }

    def _get_run_steps(self, n: int):
        fn = self._run_steps_cache.get(n)
        if fn is None:
            def body(state, data):
                return lax.fori_loop(
                    0, n, lambda i, s: self._step_local(s, data), state)

            fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(self.state_specs, self.data_specs),
                                   out_specs=self.state_specs,
                                   check_vma=False),
                         donate_argnums=(0,))
            self._run_steps_cache[n] = fn
        return fn

    def _get_emit_chunk(self, n_emits: int, thinning: int):
        kk = (n_emits, thinning)
        fn = self._emit_cache.get(kk)
        if fn is None:
            row_specs = {
                "iteration": P(), "mu": P(), "beta": P(None, AXIS_M),
                "sigmaE": P(), "tau": P(), "lambda": P(None, AXIS_M),
                "epsilon": P(None, AXIS_N),
            }
            if jax.process_count() > 1:
                # multi-host emission: replicate rows for host-side sinks
                row_specs = jax.tree.map(lambda _: P(), row_specs)

            def body(state, data):
                def one(state, _):
                    state = lax.fori_loop(
                        0, thinning, lambda i, s: self._step_local(s, data),
                        state)
                    return state, self._emit_one(state)

                return lax.scan(one, state, None, length=n_emits)

            fn = jax.jit(jax.shard_map(body, mesh=self.mesh,
                                   in_specs=(self.state_specs, self.data_specs),
                                   out_specs=(self.state_specs, row_specs),
                                   check_vma=False),
                         donate_argnums=(0,))
            self._emit_cache[kk] = fn
        return fn

    def _refresh_local(self, state, data, y_loc):
        """Exact residual recompute with one sharded X pass (runs inside
        shard_map; see ChainConfig.eps_refresh_every)."""
        f32 = jnp.float32
        beta = state.beta.astype(f32)
        if not self.x_quantized:
            xb = lax.psum(beta @ data["XT"].astype(f32), AXIS_M)
        elif self.x_packed:
            xb = lax.psum(genotypes.xbeta_packed(
                data["XT"], data["x_mean"], data["x_scale"], beta, self.B,
                self.Npad), AXIS_M)
            xb = jnp.take(xb, data["n_perm"])
        else:
            xb = lax.psum(genotypes.xbeta_int8(
                data["XT"], data["x_mean"], data["x_scale"], beta,
                self.B), AXIS_M)
        eps = y_loc.astype(f32) - xb - state.mu.astype(f32)
        eps = jnp.where(data["row_valid"], eps, 0.0)
        return state._replace(eps=eps.astype(self.dtype))

    def refresh_eps(self, state):
        """Exact residual recompute (see ChainConfig.eps_refresh_every)."""
        fn = self._run_steps_cache.get("refresh")
        if fn is None:
            fn = jax.jit(jax.shard_map(
                self._refresh_local, mesh=self.mesh,
                in_specs=(self.state_specs, self.data_specs, P(AXIS_N)),
                out_specs=self.state_specs, check_vma=False))
            self._run_steps_cache["refresh"] = fn
        return fn(state, self.data, self.Y)

    def step(self, state):
        return self._get_run_steps(1)(state, self.data)

    def run(self, key_or_state, chain: ChainConfig, *, sink=None,
            collect: bool = True, emit_chunk: int = 32, progress=None,
            on_chunk=None):
        """Drive a sharded horseshoe chain.  Same surface as
        ShardedSpikeSlabSampler.run: ``sink`` streams rows (CSV/NPZ/...),
        ``on_chunk`` fires per emitted chunk (periodic checkpointing), and
        ``config.emit_epsilon=False`` suppresses the full-N residual
        emission -- at pod scale the N-vector per thinned iteration is
        exactly the observability cost SURVEY section 5 makes optional
        (the reference always writes it, src/HorseshoeR.cpp:289-296)."""
        from ..models.driver import run_chain
        from ..models.state import HorseshoeState

        state = (key_or_state if isinstance(key_or_state, HorseshoeState)
                 else self.init(key_or_state))

        if self.x_packed and self.config.emit_epsilon:
            from .distributed import replicate
            n_perm_np = np.asarray(replicate(self.data["n_perm"], self.mesh))

        def postprocess(rows):
            rows["beta"] = rows["beta"][:, : self.M]
            rows["lambda"] = rows["lambda"][:, : self.M]
            if self.x_packed and self.config.emit_epsilon:
                eps_orig = np.zeros_like(rows["epsilon"])
                eps_orig[:, n_perm_np] = rows["epsilon"]
                rows["epsilon"] = eps_orig[:, : self.N]
            else:
                rows["epsilon"] = rows["epsilon"][:, : self.N]
            if not self.config.emit_epsilon:
                rows["epsilon"] = rows["epsilon"][:, :0]
            return rows

        return run_chain(
            state, chain,
            steps_fn=lambda st, n: self._get_run_steps(n)(st, self.data),
            emit_fn=lambda st, n, t: self._get_emit_chunk(n, t)(st, self.data),
            postprocess=postprocess, sink=sink, collect=collect,
            emit_chunk=emit_chunk, start_iteration=int(state.iteration),
            progress=progress, on_chunk=on_chunk,
            refresh_fn=self.refresh_eps)
