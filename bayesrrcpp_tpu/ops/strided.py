"""Strided-rounds block-Jacobi sweep: the samplers' one fast path.

The blocked sweep (ops/block_sweep.py) visits Gram blocks one at a time,
so an iteration is nb dependent rounds of an X pass and a B-step solve.
Here a round owns J blocks and sweeps them against the SAME round-start
residual:

- round r owns blocks {j*nr + rho[r] : j < J} (nr = nb/J).  The partition
  is fixed and maximally spread in storage, so same-round blocks are ~M/J
  markers apart; per iteration only the round visit order ``rho`` and the
  within-block permutations are random (``block_sweep.strided_orders``).
  Every marker is swept exactly once per iteration, so this is a valid
  random-scan Gibbs kernel;
- per round: (a) r = X_slab . eps over the round's J*B markers, decoded
  from the stored form (ops/xpass.py); (b) the J exact sequential B-step
  solves of ``spike_slab_inner_solve`` / ``horseshoe_inner_solve``,
  vmapped over J; (c) eps -= X_slab' . delta.

Semantics: exact sequential Gibbs within a block, block-Jacobi across the
J blocks of a round -- the same relaxation as the mesh-sharded sampler
across its m-slices.  J = 1 is exactly ``bayesr_block_sweep``; for any J
the plain references are ``block_sweep.bayesr_jacobi_sweep`` /
``horseshoe_jacobi_sweep`` with ``block_order = strided_border(rho, J)``.

State carries a leading chain axis C.  All chains share the visit order,
so each round reads X once for every chain.  p/z are indexed by sweep
position in visit order: round t, block j, step s reads [(t*J + j)*B + s].

Reference per-update math: src/BayesRv2.cpp:186-245 (bayesr),
src/HorseshoeR.cpp:219-240 (horseshoe).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .block_sweep import horseshoe_inner_solve, spike_slab_inner_solve
from .sweep import SweepResult
from .xpass import x_apply, x_dot

# The Jacobi window J*B is capped at 4096 markers (or M/8 for small M)
# and J at 128 blocks: the window the posterior validation covered
# (tools/ld_validation.py).  Small blocks buy a larger J, which cuts the
# number of dependent solve steps per iteration (Mpad/J).
MAX_WINDOW = 4096
MAX_J = 128
MIN_B = 32


def plan_mpad(M: int, B: int, J: int) -> int:
    """Padded marker count for (B, J): a multiple of B*J, and at >= 64
    blocks a block count that is also a multiple of 8 (kept so that
    host loaders that pre-pad with ``planned_mpad`` stay compatible)."""
    unit = B * J
    Mpad = -(-M // unit) * unit
    if Mpad // B >= 64:
        unit8 = B * 8 * J // int(np.gcd(8, J))
        Mpad = -(-M // unit8) * unit8
    return Mpad


def jacobi_plan(M: int, B: int):
    """Default (J, B) for M markers.

    Windows W are powers of two from min(4096, M/8) down to 256; each has
    J = min(128, W/32) and B = W/J.  A window that needs no marker padding
    wins first, then the larger J.  Where no window exists (M < 2048) the
    sweep is sequential: J = 1 with the caller's B.
    """
    wmax = 1
    while wmax * 2 <= max(1, M // 8) and wmax * 2 <= MAX_WINDOW:
        wmax *= 2
    best = None
    w = wmax
    while w >= 256:
        J = min(MAX_J, w // MIN_B)
        Bc = w // J
        cand = (plan_mpad(M, Bc, J) == M, J, Bc)
        if best is None or cand > best:
            best = cand
        w //= 2
    if best is None:
        return 1, B
    if not best[0]:
        # padding is unavoidable: take the largest window
        J = min(MAX_J, wmax // MIN_B)
        return J, wmax // J
    return best[1], best[2]


def base_block_size(M: int, block_size: int) -> int:
    """The samplers' block size before planning: the configured size,
    cut to the next power of two >= M, at least 8."""
    B = min(block_size, 1 << max(1, (M - 1).bit_length()))
    return max(8, min(B, block_size))


def planned_mpad(M: int, block_size: int = 512) -> int:
    """The padded marker count a default sampler uses for M markers, so
    host loaders can pre-pad packed words (io.bed.read_bed_packed): a
    device array near the size of device memory cannot be padded in
    place."""
    J, B = jacobi_plan(M, base_block_size(M, block_size))
    return plan_mpad(M, B, J)


def _strided_rounds(xs, gram, eps, rho, state, stream, round_solve, acc0, *,
                    J, kind, fold, impl, reduce_r, reduce_eps):
    """Scan the nr rounds.  ``state``: (C, Mpad) per-marker arrays the
    solve updates; ``stream``: (C, Mpad) position-indexed randoms;
    ``round_solve(slab, r, Gr, state_r, stream_r) -> (state_r, delta,
    acc_r)`` with every round slice shaped (C, J, B)."""
    XT, mean, scale, row_valid = xs
    C = eps.shape[0]
    nb, B, _ = gram.shape
    nr = nb // J
    kw = dict(J=J, nr=nr, kind=kind, fold=fold, impl=impl)
    gram4 = gram.reshape(J, nr, B, B)
    state4 = tuple(a.reshape(C, J, nr, B) for a in state)
    stream_r = tuple(a.reshape(C, nr, J, B).swapaxes(0, 1) for a in stream)

    def body(carry, xs_t):
        eps, st4, acc = carry
        slab, strm = xs_t[0], xs_t[1:]
        r = reduce_r(x_dot(XT, mean, scale, slab, eps, **kw))
        Gr = lax.dynamic_index_in_dim(gram4, slab, 1, keepdims=False)
        st_r = tuple(lax.dynamic_index_in_dim(a, slab, 2, keepdims=False)
                     for a in st4)
        st_r, delta, acc_r = round_solve(slab, r, Gr, st_r, strm)
        eps = eps - reduce_eps(x_apply(XT, mean, scale, row_valid, slab,
                                       delta.astype(eps.dtype), **kw))
        st4 = tuple(lax.dynamic_update_index_in_dim(a, u, slab, 2)
                    for a, u in zip(st4, st_r))
        acc = jax.tree.map(jnp.add, acc, acc_r)
        return (eps, st4, acc), None

    (eps, st4, acc), _ = lax.scan(body, (eps, state4, acc0),
                                  (rho,) + stream_r)
    return eps, tuple(a.reshape(C, -1) for a in st4), acc


def _identity(x):
    return x


def bayesr_strided_sweep(xs, gram, xsq, eps, beta, labels, rho, inner, p, z,
                         pi, cva, sigmaE, sigmaGG, g_assign, valid, *, J,
                         kind="dense", fold=False, impl="xla",
                         reduce_r=_identity, reduce_eps=_identity):
    """Spike-and-slab strided sweep over C chains.

    ``xs`` = (XT, x_mean, x_scale, row_valid) in the layout of ``kind``
    (ops/xpass.py); eps (C, Npad); beta/labels/p/z (C, Mpad); pi (C, G, K);
    sigmaE (C,); sigmaGG (C, G); rho (nb/J,); inner (nb, B) by block id.
    ``reduce_r`` / ``reduce_eps`` combine partial passes across devices
    (psum over individuals / markers inside shard_map).  Returns a
    SweepResult whose v is (C, G, K) and beta_acum (C, G).
    """
    C = eps.shape[0]
    nb, B, _ = gram.shape
    nr = nb // J
    G, K = cva.shape[0], cva.shape[1] + 1
    dt = eps.dtype
    per4 = [a.reshape(J, nr, B) for a in (xsq, g_assign, valid, inner)]
    solve = jax.vmap(
        jax.vmap(spike_slab_inner_solve,
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, None, None,
                          None, 0, 0)),
        in_axes=(0, None, 0, 0, None, None, None, None, 0, 0, 0, None, 0, 0,
                 0, 0))

    def round_solve(slab, r, Gr, st_r, strm):
        xsq_r, gas_r, valid_r, inner_r = (
            lax.dynamic_index_in_dim(a, slab, 1, keepdims=False)
            for a in per4)
        r, beta_r, labels_r, delta, v, bacc = solve(
            r, Gr.astype(dt), st_r[0], st_r[1], xsq_r, gas_r, valid_r,
            inner_r, strm[0], strm[1], pi, cva, sigmaE, sigmaGG,
            jnp.zeros((C, J, G, K), dt), jnp.zeros((C, J, G), dt))
        return (beta_r, labels_r), delta, (v.sum(1), bacc.sum(1))

    eps, (beta, labels), (v, bacc) = _strided_rounds(
        xs, gram, eps, rho, (beta, labels), (p, z), round_solve,
        (jnp.zeros((C, G, K), dt), jnp.zeros((C, G), dt)), J=J, kind=kind,
        fold=fold, impl=impl, reduce_r=reduce_r, reduce_eps=reduce_eps)
    return SweepResult(eps, beta, labels, v, bacc)


def horseshoe_strided_sweep(xs, gram, xsq, eps, beta, rho, inner, z, lam,
                            tau, c2, sigmaE, valid, *, J, kind="dense",
                            fold=False, impl="xla", reduce_r=_identity,
                            reduce_eps=_identity):
    """Regularized-horseshoe strided sweep over C chains (see
    bayesr_strided_sweep); lam (C, Mpad), tau/c2/sigmaE (C,).  Returns
    (eps, beta)."""
    C = eps.shape[0]
    nb, B, _ = gram.shape
    nr = nb // J
    dt = eps.dtype
    per4 = [a.reshape(J, nr, B) for a in (xsq, valid, inner)]
    lam4 = lam.reshape(C, J, nr, B)
    solve = jax.vmap(
        jax.vmap(horseshoe_inner_solve,
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None, None)),
        in_axes=(0, None, 0, None, 0, None, None, 0, 0, 0, 0))

    def round_solve(slab, r, Gr, st_r, strm):
        xsq_r, valid_r, inner_r = (
            lax.dynamic_index_in_dim(a, slab, 1, keepdims=False)
            for a in per4)
        lam_r = lax.dynamic_index_in_dim(lam4, slab, 2, keepdims=False)
        r, beta_r, delta = solve(r, Gr.astype(dt), st_r[0], xsq_r, lam_r,
                                 valid_r, inner_r, strm[0], tau, c2, sigmaE)
        return (beta_r,), delta, ()

    eps, (beta,), _ = _strided_rounds(
        xs, gram, eps, rho, (beta,), (z,), round_solve, (), J=J, kind=kind,
        fold=fold, impl=impl, reduce_r=reduce_r, reduce_eps=reduce_eps)
    return eps, beta
