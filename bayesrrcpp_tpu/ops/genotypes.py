"""Quantized genotype storage shared by the samplers.

The reference holds X as a dense in-RAM f64 Eigen matrix
(src/BayesRv2.cpp:60, src/HorseshoeR.cpp:109) -- 8 bytes/genotype, which
caps it far below biobank scale.  Here genotypes are stored as int8 dosage
codes (1 B) or 2-bit packed words (0.25 B, 16 codes per int32) and decoded
to standardized f32 inside the sweep's X pass (ops/xpass.py); this module
builds the
device-side containers and the sweep's precomputed statistics (xsq, Gram
blocks) from either a host dosage matrix or pre-packed
words (e.g. io.bed.read_bed_packed output).

Moved out of models/bayesr.py so the horseshoe sampler shares the exact
same storage path.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# the 2-bit / int8 code of a missing call (PLINK .bed's 0b01 is remapped
# to it on read); it decodes to 0, i.e. mean imputation
MISSING_CODE = 3


class QuantizedGenotypes(NamedTuple):
    XT: jax.Array         # (Mpad, N) int8 codes or (Mpad, Npad/16) int32 words
    xsq: jax.Array        # (Mpad,) standardized column sum-of-squares
    gram: jax.Array       # (nb, B, B) standardized Gram blocks
    x_mean: jax.Array     # (Mpad,) per-marker dosage means
    x_scale: jax.Array    # (Mpad,) per-marker 1/sd (0 where sd == 0)
    row_valid: jax.Array  # (Npad,) bool lane mask ((0,) unless packed)
    n_perm: jax.Array     # (Npad,) int32 stored->original lane permutation
    Npad: int             # padded individual count (N unless packed)
    has_missing: bool


def _lane_perm(Npad: int):
    """Stored-position -> original-individual permutation of the packed
    eps/Y layout: GLOBAL plane-major -- position k*Nw + w (Nw = Npad/16
    words) holds original individual 16*w + k (bit-plane k of word w).

    Plane-major keeps every bit-plane's eps segment contiguous: viewed as
    (16, Nw), eps[k, w] pairs with bit-plane k of word w, which is how the
    X pass reads it (ops/xpass.py).  Any other pairing of eps rows with
    genotype words scrambles the X<->Y association."""
    nw = Npad // 16
    p = np.arange(Npad)
    return 16 * (p % nw) + p // nw


def pack_codes_host(X, transposed, x_stats, Mpad, N):
    """Host-side dosage -> packed-word conversion shared by the single-device
    and sharded constructors.

    Returns (codes (Mpad, Npad) int8, words (Mpad, Npad/16) np.int32, mean
    (Mpad,) f32, scale (Mpad,) f32, Npad, has_missing); pad markers and pad
    lanes carry MISSING_CODE when the data has missing calls, else 0 (the
    X pass masks pad lanes either way).
    """
    TN, WORDS = 2048, 16
    Npad = -(-N // TN) * TN
    Xh = np.asarray(X)
    XTh = Xh if transposed else Xh.T
    if x_stats is not None:
        means = np.asarray(x_stats[0], np.float64)
        sds = np.asarray(x_stats[1], np.float64)
        codes = np.asarray(XTh, np.int8)
    else:
        XTh = np.asarray(XTh, np.float64)
        means = np.nanmean(XTh, axis=1)
        sds = np.nanstd(XTh, axis=1, ddof=1)
        ch = np.where(np.isnan(XTh), float(MISSING_CODE), XTh)
        if not np.isin(np.unique(ch), [0.0, 1.0, 2.0, 3.0]).all():
            raise ValueError(
                "x_dtype='2bit' expects raw dosages in {0,1,2} (+NaN)")
        codes = ch.astype(np.int8)

    M = codes.shape[0]
    has_missing = bool(np.any(codes == MISSING_CODE))
    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    # pad lanes carry code 0 when no call is missing (so they do not turn
    # has_missing on), otherwise the missing code
    pad_code = MISSING_CODE if has_missing else 0
    codes = np.pad(codes, ((0, Mpad - M), (0, Npad - N)),
                   constant_values=pad_code)
    mean = np.pad(means, (0, Mpad - M)).astype(np.float32)
    scale = np.pad(scales, (0, Mpad - M)).astype(np.float32)

    # pack 16 consecutive codes per int32 word, code j at bits 2j
    cw = codes.reshape(Mpad, Npad // WORDS, WORDS).astype(np.uint64)
    shifts = (2 * np.arange(WORDS, dtype=np.uint64))[None, None, :]
    words = (cw << shifts).sum(axis=2).astype(np.uint32).view(np.int32)
    return codes, words, mean, scale, Npad, has_missing


def quantize_packed(X, transposed, x_stats, B, Mpad, N,
                    *, prepacked: bool,
                    m_true=None) -> QuantizedGenotypes:
    """2-bit packed genotypes: 16 codes per int32 word along the individual
    axis -- 0.25 bytes/genotype, the layout that fits biobank-scale M in one
    card's memory.

    eps/Y/fixed must be stored in the ``n_perm`` permutation, which is
    statistically and algebraically neutral (every sweep quantity is a sum
    over individuals).
    """
    Npad = -(-N // 2048) * 2048

    if prepacked:
        return _prepacked_setup(X, x_stats, B, Mpad, N, Npad, m_true=m_true)

    codes, words, mean_np, scale_np, Npad, has_missing = pack_codes_host(
        X, transposed, x_stats, Mpad, N)
    words_dev = jnp.asarray(words)
    mean = jnp.asarray(mean_np)
    scale = jnp.asarray(scale_np)

    perm = _lane_perm(Npad)
    row_valid = jnp.asarray(perm < N)
    n_perm = jnp.asarray(perm.astype(np.int32))

    # xsq / Gram from decoded blocks (order-agnostic sums over n); pad
    # columns masked explicitly (their code is 0 when no call
    # is missing, which would otherwise decode to -m*s != 0)
    nb = Mpad // B
    codes_dev = jnp.asarray(codes)
    cmask = jnp.asarray(np.arange(Npad) < N, jnp.float32)

    def per_block(args):
        blk, m, sc = args
        g = blk.astype(jnp.float32)
        x = (g - m[:, None]) * sc[:, None]
        x = jnp.where(g == float(MISSING_CODE), 0.0, x) * cmask[None, :]
        return jnp.sum(x * x, axis=1), x @ x.T

    xsq_b, gram = jax.lax.map(
        per_block, (codes_dev.reshape(nb, B, Npad),
                    mean.reshape(nb, B), scale.reshape(nb, B)))
    return QuantizedGenotypes(
        words_dev, xsq_b.reshape(Mpad), gram, mean, scale,
        row_valid, n_perm, Npad, has_missing)


def _prepacked_setup(words, x_stats, B, Mpad, N, Npad,
                     m_true=None) -> QuantizedGenotypes:
    """Device-resident pre-packed words (io.bed.read_bed_packed / bench /
    streaming ingestion): no host densification, xsq/Gram from in-flight
    word decodes.  Lanes >= N (padding up to the 2048 multiple) must carry
    code 0 when the data has no missing calls, else code 3."""
    if words.shape[1] * 16 != Npad:
        raise ValueError(
            f"pre-packed 2-bit input needs lanes padded to a 2048 "
            f"multiple: got {words.shape[1]} words/marker for N={N} "
            f"(want {Npad // 16})")
    M = words.shape[0]
    means = np.asarray(x_stats[0], np.float64)
    scales_np = np.asarray(x_stats[1], np.float64)
    scales_np = np.where(scales_np > 0,
                         1.0 / np.where(scales_np > 0, scales_np, 1.0), 0.0)
    # pad markers with all-missing words (0b11... = -1); skip the no-op
    # pad -- padding materializes a second copy (input + output both live
    # during the op), which an array near the size of device memory
    # cannot afford
    if Mpad != M:
        if isinstance(words, np.ndarray):
            # host array: pad on the host BEFORE the device transfer
            # (jnp.pad would device-put the unpadded array and then
            # materialize the padded copy -- the same transient second
            # copy the device-side guard below exists to prevent)
            words = np.concatenate(
                [words, np.full((Mpad - M, words.shape[1]), -1, np.int32)],
                axis=0)
        elif isinstance(words, jax.Array) and words.nbytes > (2 << 30):
            raise ValueError(
                f"pre-packed words need a marker pad {M} -> {Mpad}, but "
                f"the array is device-resident and {words.nbytes >> 20} "
                f"MiB -- padding would transiently double it and run the "
                f"device out of memory.  Load with "
                f"io.bed.read_bed_packed(..., mpad='auto') (host-side pad) "
                f"and pass n_markers={M}.")
        else:
            words = jnp.pad(words, ((0, Mpad - M), (0, 0)),
                            constant_values=-1)
    words = jnp.asarray(words)
    mean = jnp.asarray(np.pad(means, (0, Mpad - M)), jnp.float32)
    scale = jnp.asarray(np.pad(scales_np, (0, Mpad - M)), jnp.float32)

    perm = _lane_perm(Npad)
    row_valid = jnp.asarray(perm < N)
    n_perm = jnp.asarray(perm.astype(np.int32))

    nb = Mpad // B
    Nw = Npad // 16
    # lane k of word i is individual 16*i + k; pad lanes (>= N) must not
    # contribute to the stats nor trip missing detection (read_bed_packed
    # codes them 0 or 3 depending on whether calls are missing)
    word_base = jnp.arange(Nw) * 16

    def per_block(args):
        w, m, sc = args          # (B, Npad/16) int32, (B,), (B,)

        # bit planes decoded under fori_loop (an unrolled loop lets XLA
        # keep many (B, Npad/16) f32 decode temps alive at once)
        def plane(k, carry):
            xsq, g_acc, miss = carry
            lane_ok = word_base + k < N                     # (Nw,)
            c = ((w >> (2 * k)) & 3).astype(jnp.float32)
            miss |= jnp.any((c == float(MISSING_CODE)) & lane_ok[None, :],
                            axis=1)
            x = (c - m[:, None]) * sc[:, None]
            x = jnp.where(c == float(MISSING_CODE), 0.0, x)
            x = x * lane_ok[None, :]
            return xsq + jnp.sum(x * x, axis=1), g_acc + x @ x.T, miss

        return lax.fori_loop(0, 16, plane, (
            jnp.zeros((B,), jnp.float32), jnp.zeros((B, B), jnp.float32),
            jnp.zeros((B,), bool)))

    # chunked build with DONATED accumulators: a single lax.map over all
    # nb blocks would materialize a second stacked copy of the whole word
    # array inside the scan, which a near-device-memory-sized input
    # cannot afford.  Chunks of up to 32 blocks keep the scan copy small
    # and dynamic-update-slice writes in place.
    CH = min(32, nb)
    while nb % CH:
        CH -= 1

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def chunk_update(gram_a, xsq_a, miss_a, wc, mc, sc, i0):
        xs_b, g_b, ms_b = jax.lax.map(
            per_block, (wc.reshape(CH, B, Nw), mc.reshape(CH, B),
                        sc.reshape(CH, B)))
        z0 = jnp.zeros((), jnp.int32)
        return (lax.dynamic_update_slice(gram_a, g_b, (i0, z0, z0)),
                lax.dynamic_update_slice(xsq_a, xs_b, (i0, z0)),
                lax.dynamic_update_slice(miss_a, ms_b, (i0, z0)))

    f32 = jnp.float32
    accs = (jnp.zeros((nb, B, B), f32), jnp.zeros((nb, B), f32),
            jnp.zeros((nb, B), bool))
    for i in range(0, nb, CH):
        a = i * B
        accs = chunk_update(*accs, words[a:a + CH * B],
                            mean[a:a + CH * B], scale[a:a + CH * B],
                            jnp.int32(i))
    gram, xsq_b, miss_b = accs
    # host-pre-padded words (io.bed.read_bed_packed(mpad=...)) carry
    # all-missing PAD marker rows; they must not trip missing detection
    # (which would turn on the missing-code select for every marker)
    m_real = M if m_true is None else min(int(m_true), M)
    has_missing = bool(np.asarray(miss_b).reshape(Mpad)[:m_real].any())
    return QuantizedGenotypes(
        words, xsq_b.reshape(Mpad), gram, mean, scale,
        row_valid, n_perm, Npad, has_missing)


def packed_stats_local(words_loc, mean_loc, scale_loc, *, N, B,
                       varying=()):
    """xsq / Gram blocks for a LOCAL shard of packed words ((Mloc, Npad/16)
    int32) -- runs inside shard_map, one m-slice per device.  fori_loop +
    dynamic_slice keeps memory at one block's decode (a lax.map here would
    stack a second copy of the whole word shard).

    Returns (xsq (Mloc,), gram (nb_loc, B, B))."""
    f32 = jnp.float32
    Mloc, Nw = words_loc.shape
    nb_loc = Mloc // B
    word_base = jnp.arange(Nw) * 16

    def block_stats(i, carry):
        xsq_a, gram_a = carry
        wb = lax.dynamic_slice_in_dim(words_loc, i * B, B)
        mb = lax.dynamic_slice_in_dim(mean_loc, i * B, B)
        sb = lax.dynamic_slice_in_dim(scale_loc, i * B, B)

        def plane(k, c2):
            xsq, g = c2
            lane_ok = word_base + k < N
            c = ((wb >> (2 * k)) & 3).astype(f32)
            x = (c - mb[:, None]) * sb[:, None]
            x = jnp.where(c == float(MISSING_CODE), 0.0, x)
            x = x * lane_ok[None, :]
            return xsq + jnp.sum(x * x, axis=1), g + x @ x.T

        xsq_b, g_b = lax.fori_loop(0, 16, plane, _mark(
            (jnp.zeros((B,), f32), jnp.zeros((B, B), f32)), varying))
        z0 = jnp.zeros((), jnp.asarray(i).dtype)
        return (lax.dynamic_update_slice_in_dim(xsq_a, xsq_b, i * B, 0),
                lax.dynamic_update_slice(gram_a, g_b[None], (i, z0, z0)))

    return lax.fori_loop(0, nb_loc, block_stats, _mark(
        (jnp.zeros((Mloc,), f32), jnp.zeros((nb_loc, B, B), f32)), varying))


def int8_stats_local(codes_loc, mean_loc, scale_loc, *, B, varying=()):
    """xsq / Gram blocks for a LOCAL shard of int8 genotype codes
    ((Mloc, N) int8) -- runs inside shard_map, one m-slice per device (the
    int8 analog of packed_stats_local; no lane permutation in this storage
    mode).

    Returns (xsq (Mloc,), gram (nb_loc, B, B))."""
    f32 = jnp.float32
    Mloc, N = codes_loc.shape
    nb_loc = Mloc // B

    def block_stats(i, carry):
        xsq_a, gram_a = carry
        blk = lax.dynamic_slice_in_dim(codes_loc, i * B, B)
        mb = lax.dynamic_slice_in_dim(mean_loc, i * B, B)
        sb = lax.dynamic_slice_in_dim(scale_loc, i * B, B)
        g = blk.astype(f32)
        x = (g - mb[:, None]) * sb[:, None]
        x = jnp.where(blk == MISSING_CODE, 0.0, x)
        z0 = jnp.zeros((), jnp.asarray(i).dtype)
        return (lax.dynamic_update_slice_in_dim(
                    xsq_a, jnp.sum(x * x, axis=1), i * B, 0),
                lax.dynamic_update_slice(gram_a, (x @ x.T)[None],
                                         (i, z0, z0)))

    return lax.fori_loop(0, nb_loc, block_stats, _mark(
        (jnp.zeros((Mloc,), f32), jnp.zeros((nb_loc, B, B), f32)), varying))


def _mark(tree, varying):
    """Mark zero-init loop carries as varying over the given shard_map axes
    (required by shard_map's varying-manual-axis tracking)."""
    if not varying:
        return tree
    return jax.tree.map(lambda x: lax.pcast(x, tuple(varying), to="varying"),
                        tree)


@functools.partial(jax.jit, static_argnums=(4,))
def xbeta_int8(codes, mean, scale, beta_pad, B):
    """X @ beta for int8-code storage, decoded blockwise (O(B*N) memory)."""
    f32 = jnp.float32
    Mpad, N = codes.shape
    nb = Mpad // B

    def one(args):
        blk, m, s, bb = args
        g = blk.astype(f32)
        x = (g - m[:, None]) * s[:, None]
        x = jnp.where(g == float(MISSING_CODE), 0.0, x)
        return bb @ x

    parts = lax.map(one, (codes.reshape(nb, B, N), mean.reshape(nb, B),
                          scale.reshape(nb, B), beta_pad.reshape(nb, B)))
    return jnp.sum(parts, axis=0)                                # (N,)


@functools.partial(jax.jit, static_argnums=(4, 5))
def xbeta_packed(words, mean, scale, beta_pad, B, N):
    """X @ beta for 2-bit packed storage, in ORIGINAL individual order
    (individual 16*i + k lives in bit-plane k of word i)."""
    f32 = jnp.float32
    Mpad, Nw = words.shape
    nb = Mpad // B
    word_base = jnp.arange(Nw) * 16

    def block(i, acc):
        wb = lax.dynamic_slice_in_dim(words, i * B, B)
        mb = lax.dynamic_slice_in_dim(mean, i * B, B)
        sb = lax.dynamic_slice_in_dim(scale, i * B, B)
        bb = lax.dynamic_slice_in_dim(beta_pad, i * B, B)

        def plane(k, a):
            c = ((wb >> (2 * k)) & 3).astype(f32)
            x = (c - mb[:, None]) * sb[:, None]
            x = jnp.where(c == float(MISSING_CODE), 0.0, x)
            x = x * (word_base + k < N)[None, :]
            return lax.dynamic_update_slice(a, (bb @ x)[:, None], (0, k))

        return acc + lax.fori_loop(0, 16, plane,
                                   jnp.zeros((Nw, 16), f32))

    acc = lax.fori_loop(0, nb, block, jnp.zeros((Nw, 16), f32))
    return acc.reshape(Nw * 16)[:N]                              # (N,)


def quantize_int8(X, transposed, x_stats, B, Mpad) -> QuantizedGenotypes:
    """Quantize dosages to int8 codes {0,1,2, 3=missing} with per-marker
    standardization stats, and build xsq/Gram from in-flight decodes.

    The decoded value is exactly (g - mean) * (1/sd), with missing calls
    decoding to 0 (mean imputation); memory per genotype drops 4x vs f32,
    which is what lets biobank-scale M fit in device memory.
    """
    if x_stats is not None:
        means, sds = (np.asarray(x_stats[0], np.float64),
                      np.asarray(x_stats[1], np.float64))
        if isinstance(X, jax.Array) and X.dtype == jnp.int8:
            codes = X if transposed else X.T
        else:
            Xh = np.asarray(X)
            codes = jnp.asarray(
                np.ascontiguousarray(Xh if transposed else Xh.T), jnp.int8)
    else:
        Xh = np.asarray(X, np.float64)
        XTh = np.ascontiguousarray(Xh if transposed else Xh.T)
        means = np.nanmean(XTh, axis=1)
        sds = np.nanstd(XTh, axis=1, ddof=1)
        ch = np.where(np.isnan(XTh), float(MISSING_CODE), XTh)
        if not np.isin(np.unique(ch), [0.0, 1.0, 2.0, 3.0]).all():
            raise ValueError(
                "x_dtype='int8' expects raw dosages in {0,1,2} (+NaN)")
        codes = jnp.asarray(ch.astype(np.int8))

    scales = np.where(sds > 0, 1.0 / np.where(sds > 0, sds, 1.0), 0.0)
    has_missing = bool(jax.device_get(jnp.any(
        jnp.asarray(codes) == MISSING_CODE)))
    pad = Mpad - codes.shape[0]
    codes = jnp.pad(codes, ((0, pad), (0, 0)),
                    constant_values=MISSING_CODE)
    mean = jnp.asarray(np.pad(means, (0, pad)), jnp.float32)
    scale = jnp.asarray(np.pad(scales, (0, pad)), jnp.float32)

    nb = Mpad // B
    N = codes.shape[1]

    def decode_block(args):
        blk, m, s = args
        g = blk.astype(jnp.float32)
        x = (g - m[:, None]) * s[:, None]
        return jnp.where(blk == MISSING_CODE, 0.0, x)

    def per_block(args):
        x = decode_block(args)
        return jnp.sum(x * x, axis=1), x @ x.T

    xsq_b, gram = jax.lax.map(
        per_block, (codes.reshape(nb, B, N), mean.reshape(nb, B),
                    scale.reshape(nb, B)))
    empty_b = jnp.zeros((0,), bool)
    empty_i = jnp.zeros((0,), jnp.int32)
    return QuantizedGenotypes(
        codes, xsq_b.reshape(Mpad), gram, mean, scale,
        empty_b, empty_i, N, has_missing)
