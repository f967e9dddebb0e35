"""Gram-blocked marker sweeps: the plain references of the fast path.

The reference's marker loop is sequential because every update mutates the
N-vector of residuals (reference: src/BayesRv2.cpp:186-245): per marker it
pays one O(N) dot and one O(N) axpy.  The blocked form restructures the
sweep *exactly* (same math, same Markov kernel, only float reassociation
differs) using per-block Gram matrices:

For a block b of B markers with X_b (N x B):
  1. r = X_b' eps                      -- one (B,N)x(N,) product
  2. B sequential updates: num_j = r_j + beta_j * xsq_j; after a marker
     changes by delta, r <- r - G_b[:, j] * delta where G_b = X_b' X_b is
     the (precomputed, static) block Gram matrix.  Each step is O(B + K)
     work instead of O(N).
  3. eps <- eps - X_b' delta           -- one more product

Per iteration X is read twice, as two streaming products, instead of in
3M strided vector operations.  The Gram blocks are computed once per chain
(X is static) at O(M*B*N) flops and O(M*B) memory.

The marker permutation is *block-restricted*: the block processing order and
the order within each block are both shuffled per iteration, but markers do
not cross blocks.  Any deterministic-or-random scan order is a valid
systematic-scan Gibbs sampler with the same stationary distribution as the
reference's full shuffle (src/BayesRv2.cpp:182); equality with the scan path
under the *same* order is enforced by
tests/test_bayesr.py::test_blocked_equals_scan_single_iteration.

The samplers run the strided-rounds sweep of ops/strided.py; the functions
here (``bayesr_block_sweep``, ``bayesr_jacobi_sweep`` and their horseshoe
twins) are its plain references, plus the inner solves it shares.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .selection import select_component
from .sweep import SweepResult


def pad_markers(XT, xsq, block_size, mpad=None):
    """Pad the marker axis of XT/xsq with zero rows to a block multiple
    (or to an explicit ``mpad`` >= that, e.g. the 8-aligned block count the
    samplers use at scale)."""
    M = XT.shape[0]
    Mpad = mpad if mpad is not None else -(-M // block_size) * block_size
    if Mpad != M:
        XT = jnp.pad(XT, ((0, Mpad - M), (0, 0)))
        xsq = jnp.pad(xsq, (0, Mpad - M))
    return XT, xsq, Mpad


def gram_blocks(XT_pad, block_size):
    """(nb, B, B) stack of per-block Gram matrices G_b = X_b' X_b.

    Computed blockwise with ``lax.map`` so peak memory stays O(B*N + M*B).
    """
    Mpad, N = XT_pad.shape
    nb = Mpad // block_size
    blocks = XT_pad.reshape(nb, block_size, N)

    def one(xb):
        return jax.lax.dot_general(
            xb, xb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32 if xb.dtype == jnp.bfloat16 else None,
        ).astype(XT_pad.dtype)

    return lax.map(one, blocks)


def block_orders(key, nb, block_size, dtype=jnp.int32):
    """Sample the block-restricted permutation for one iteration.

    Returns (block_order (nb,), inner_perm (nb, B)); the equivalent flat order
    for the scan path is ``(block_order[:,None]*B + inner_perm[block_order]).ravel()``.
    """
    kb, ki = jax.random.split(key)
    block_order = jax.random.permutation(kb, nb).astype(dtype)
    inner = jax.vmap(lambda k: jax.random.permutation(k, block_size))(
        jax.random.split(ki, nb)).astype(dtype)
    return block_order, inner


def strided_orders(key, nb, block_size, J, dtype=jnp.int32):
    """Permutations for the strided-rounds sweep (ops/strided.py): the
    round visit order rho (nr,) plus the within-block permutations (nb, B)
    by block id, drawn as argsort of iid uniforms (one fused draw instead
    of nb vmapped ``permutation()`` calls).  Round t sweeps blocks
    {j*nr + rho[t] : j < J} (a fixed strided partition; the equivalent
    flat block_order is ``strided_border(rho, J)``)."""
    nr = nb // J
    kb, ki = jax.random.split(key)
    rho = jax.random.permutation(kb, nr).astype(dtype)
    inner = jnp.argsort(jax.random.uniform(ki, (nb, block_size)),
                        axis=1).astype(dtype)
    return rho, inner


def strided_border(rho, J):
    """The flat block_order equivalent to a strided-rounds rho (for
    oracles and tests)."""
    nr = rho.shape[0]
    return (jnp.arange(J, dtype=rho.dtype)[None, :] * nr
            + rho[:, None]).reshape(-1)


def flat_order(block_order, inner_perm, block_size):
    """Flatten a block-restricted permutation into a global marker order."""
    return (block_order[:, None] * block_size + inner_perm[block_order]).reshape(-1)


def spike_slab_inner_solve(r, Gb, beta_b, labels_b, xsq_b, gas_b, valid_b,
                           inner, p_b, z_b, pi, cva, sigmaE, sigmaGG,
                           v, bacc):
    """Sequential within-block solve: B exact Gibbs updates against an
    in-register r = X_b' eps maintained by rank-1 Gram updates.

    O(B + K) work per marker; shared by the single-device blocked sweep and
    the sharded (shard_map) sweep.  Returns (r, beta_b, labels_b, delta, v,
    bacc) with delta the per-marker effect changes to apply to eps.
    """
    B = beta_b.shape[0]

    def inner_body(t, c):
        r, beta_b, labels_b, delta, v, bacc = c
        jl = inner[t]
        g = gas_b[jl]
        ok = valid_b[jl]
        num = r[jl] + beta_b[jl] * xsq_b[jl]
        res = select_component(p_b[t], z_b[t], num, xsq_b[jl], pi[g],
                               cva[g], sigmaE, sigmaGG[g],
                               beta_b[jl], labels_b[jl])
        d = jnp.where(ok, res.delta, jnp.zeros_like(res.delta))
        r = r - Gb[jl] * d
        beta_b = beta_b.at[jl].set(jnp.where(ok, res.beta_new, beta_b[jl]))
        labels_b = labels_b.at[jl].set(
            jnp.where(ok, res.label_new, labels_b[jl]))
        delta = delta.at[jl].set(d)
        v = v.at[g].add(jnp.where(ok, res.count_onehot,
                                  jnp.zeros_like(res.count_onehot)))
        slab = jnp.sum(res.count_onehot[1:])
        bacc = bacc.at[g].add(
            jnp.where(ok, slab * res.beta_new * res.beta_new, 0.0))
        return r, beta_b, labels_b, delta, v, bacc

    # derive the zero init from r so shard_map's varying-axis (VMA) tracking
    # sees it as device-varying inside sharded sweeps
    delta0 = r * jnp.zeros((), r.dtype)
    return lax.fori_loop(0, B, inner_body,
                         (r, beta_b, labels_b, delta0, v, bacc))


def horseshoe_inner_solve(r, Gb, beta_b, xsq_b, lam_b, valid_b, inner, z_b,
                          tau, c2, sigmaE):
    """Sequential within-block dense horseshoe solve (see spike_slab_inner_solve)."""
    B = beta_b.shape[0]

    def inner_body(t, c):
        r, beta_b, delta = c
        jl = inner[t]
        ok = valid_b[jl]
        num = r[jl] + beta_b[jl] * xsq_b[jl]
        s_j = tau * c2 * lam_b[jl] / (tau * lam_b[jl] + c2)
        denom = xsq_b[jl] + sigmaE / s_j
        beta_new = num / denom + jnp.sqrt(sigmaE / denom) * z_b[t]
        d = jnp.where(ok, beta_new - beta_b[jl], jnp.zeros_like(beta_new))
        r = r - Gb[jl] * d
        beta_b = beta_b.at[jl].set(jnp.where(ok, beta_new, beta_b[jl]))
        delta = delta.at[jl].set(d)
        return r, beta_b, delta

    delta0 = r * jnp.zeros((), r.dtype)  # VMA-propagating zero init (see above)
    return lax.fori_loop(0, B, inner_body, (r, beta_b, delta0))


def bayesr_block_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                       block_order, inner_perm, p_arr, z_arr,
                       pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad):
    """Blocked spike-and-slab sweep; exact equivalent of bayesr_sweep_scan.

    Shapes: XT_pad (Mpad, N), gram (nb, B, B), beta_pad/labels_pad/xsq_pad/
    g_assign_pad/valid_pad (Mpad,), p_arr/z_arr (Mpad,) indexed by sweep
    position, pi (G, K), cva (G, K-1), sigmaGG (G,).

    Padding markers carry valid=False: their delta/counts are forced to zero
    so they never contaminate the state.
    """
    Mpad, N = XT_pad.shape
    nb, B, _ = gram.shape
    G, K = pi.shape
    v0 = jnp.zeros((G, K), eps.dtype)
    bacc0 = jnp.zeros((G,), eps.dtype)
    p_blk = p_arr.reshape(nb, B)
    z_blk = z_arr.reshape(nb, B)
    inner_by_pos = inner_perm[block_order]

    def block_body(carry, xs):
        eps, beta, labels, v, bacc = carry
        b, inner, p_b, z_b = xs
        start = b * B
        Xb = lax.dynamic_slice_in_dim(XT_pad, start, B, axis=0)
        Gb = gram[b]
        beta_b = lax.dynamic_slice_in_dim(beta, start, B)
        labels_b = lax.dynamic_slice_in_dim(labels, start, B)
        xsq_b = lax.dynamic_slice_in_dim(xsq_pad, start, B)
        gas_b = lax.dynamic_slice_in_dim(g_assign_pad, start, B)
        valid_b = lax.dynamic_slice_in_dim(valid_pad, start, B)
        r = Xb @ eps

        r, beta_b, labels_b, delta, v, bacc = spike_slab_inner_solve(
            r, Gb, beta_b, labels_b, xsq_b, gas_b, valid_b, inner, p_b, z_b,
            pi, cva, sigmaE, sigmaGG, v, bacc)

        eps = eps - delta @ Xb
        beta = lax.dynamic_update_slice_in_dim(beta, beta_b, start, axis=0)
        labels = lax.dynamic_update_slice_in_dim(labels, labels_b, start, axis=0)
        return (eps, beta, labels, v, bacc), None

    (eps, beta, labels, v, bacc), _ = lax.scan(
        block_body,
        (eps, beta_pad, labels_pad, v0, bacc0),
        (block_order, inner_by_pos, p_blk, z_blk))
    return SweepResult(eps, beta, labels, v, bacc)


def bayesr_jacobi_sweep(XT_pad, gram, xsq_pad, eps, beta_pad, labels_pad,
                        block_order, inner_perm, p_arr, z_arr,
                        pi, cva, sigmaE, sigmaGG, g_assign_pad, valid_pad,
                        *, J: int):
    """Block-Jacobi spike-and-slab sweep: J blocks per round, each swept
    against the ROUND-START residual, all J rank-B updates applied at once.

    Plain reference of ops/strided.bayesr_strided_sweep (with
    ``block_order = strided_border(rho, J)``; same math, float op order
    differs): a loop over the round's blocks, each against the saved
    round-start residual.  J = 1 is exactly bayesr_block_sweep.
    """
    Mpad, N = XT_pad.shape
    nb, B, _ = gram.shape
    nr = nb // J
    G, K = pi.shape
    v0 = jnp.zeros((G, K), eps.dtype)
    bacc0 = jnp.zeros((G,), eps.dtype)
    bsel = block_order.reshape(nr, J)
    inner_by = inner_perm[block_order].reshape(nr, J, B)
    p_blk = p_arr.reshape(nr, J, B)
    z_blk = z_arr.reshape(nr, J, B)

    def round_body(carry, xs):
        eps0, beta, labels, v, bacc = carry   # all J blocks see eps0
        bs, inners, p_r, z_r = xs

        def block(j, c):
            upd, beta, labels, v, bacc = c
            start = bs[j] * B
            Xb = lax.dynamic_slice_in_dim(XT_pad, start, B, axis=0)
            beta_b = lax.dynamic_slice_in_dim(beta, start, B)
            labels_b = lax.dynamic_slice_in_dim(labels, start, B)
            xsq_b = lax.dynamic_slice_in_dim(xsq_pad, start, B)
            gas_b = lax.dynamic_slice_in_dim(g_assign_pad, start, B)
            valid_b = lax.dynamic_slice_in_dim(valid_pad, start, B)
            r = Xb @ eps0
            r, beta_b, labels_b, delta, v, bacc = spike_slab_inner_solve(
                r, gram[bs[j]], beta_b, labels_b, xsq_b, gas_b, valid_b,
                inners[j], p_r[j], z_r[j], pi, cva, sigmaE, sigmaGG, v,
                bacc)
            return (upd + delta @ Xb,
                    lax.dynamic_update_slice_in_dim(beta, beta_b, start, 0),
                    lax.dynamic_update_slice_in_dim(labels, labels_b, start,
                                                    0), v, bacc)

        upd, beta, labels, v, bacc = lax.fori_loop(
            0, J, block, (jnp.zeros_like(eps0), beta, labels, v, bacc))
        return (eps0 - upd, beta, labels, v, bacc), None

    (eps, beta, labels, v, bacc), _ = lax.scan(
        round_body, (eps, beta_pad, labels_pad, v0, bacc0),
        (bsel, inner_by, p_blk, z_blk))
    return SweepResult(eps, beta, labels, v, bacc)


def horseshoe_jacobi_sweep(XT_pad, gram, xsq_pad, eps, beta_pad,
                           block_order, inner_perm, z_arr,
                           lam_pad, tau, c2, sigmaE, valid_pad, *, J: int):
    """Block-Jacobi dense horseshoe sweep: J blocks per round against the
    round-start residual (plain reference of
    ops/strided.horseshoe_strided_sweep; J=1 is exactly
    horseshoe_block_sweep).  Reference per-marker math:
    src/HorseshoeR.cpp:219-240."""
    Mpad, N = XT_pad.shape
    nb, B, _ = gram.shape
    nr = nb // J
    bsel = block_order.reshape(nr, J)
    inner_by = inner_perm[block_order].reshape(nr, J, B)
    z_blk = z_arr.reshape(nr, J, B)

    def round_body(carry, xs):
        eps0, beta = carry                    # all J blocks see eps0
        bs, inners, z_r = xs

        def block(j, c):
            upd, beta = c
            start = bs[j] * B
            Xb = lax.dynamic_slice_in_dim(XT_pad, start, B, axis=0)
            beta_b = lax.dynamic_slice_in_dim(beta, start, B)
            xsq_b = lax.dynamic_slice_in_dim(xsq_pad, start, B)
            lam_b = lax.dynamic_slice_in_dim(lam_pad, start, B)
            valid_b = lax.dynamic_slice_in_dim(valid_pad, start, B)
            r = Xb @ eps0
            r, beta_b, delta = horseshoe_inner_solve(
                r, gram[bs[j]], beta_b, xsq_b, lam_b, valid_b, inners[j],
                z_r[j], tau, c2, sigmaE)
            return (upd + delta @ Xb,
                    lax.dynamic_update_slice_in_dim(beta, beta_b, start, 0))

        upd, beta = lax.fori_loop(0, J, block, (jnp.zeros_like(eps0), beta))
        return (eps0 - upd, beta), None

    (eps, beta), _ = lax.scan(round_body, (eps, beta_pad),
                              (bsel, inner_by, z_blk))
    return eps, beta


def horseshoe_block_sweep(XT_pad, gram, xsq_pad, eps, beta_pad,
                          block_order, inner_perm, z_arr,
                          lam_pad, tau, c2, sigmaE, valid_pad):
    """Blocked dense horseshoe sweep; exact equivalent of horseshoe_sweep_scan."""
    Mpad, N = XT_pad.shape
    nb, B, _ = gram.shape
    z_blk = z_arr.reshape(nb, B)
    inner_by_pos = inner_perm[block_order]

    def block_body(carry, xs):
        eps, beta = carry
        b, inner, z_b = xs
        start = b * B
        Xb = lax.dynamic_slice_in_dim(XT_pad, start, B, axis=0)
        Gb = gram[b]
        beta_b = lax.dynamic_slice_in_dim(beta, start, B)
        xsq_b = lax.dynamic_slice_in_dim(xsq_pad, start, B)
        lam_b = lax.dynamic_slice_in_dim(lam_pad, start, B)
        valid_b = lax.dynamic_slice_in_dim(valid_pad, start, B)
        r = Xb @ eps

        r, beta_b, delta = horseshoe_inner_solve(
            r, Gb, beta_b, xsq_b, lam_b, valid_b, inner, z_b, tau, c2, sigmaE)
        eps = eps - delta @ Xb
        beta = lax.dynamic_update_slice_in_dim(beta, beta_b, start, axis=0)
        return (eps, beta), None

    (eps, beta), _ = lax.scan(block_body, (eps, beta_pad),
                              (block_order, inner_by_pos, z_blk))
    return eps, beta
