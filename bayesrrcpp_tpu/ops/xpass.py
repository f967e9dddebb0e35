"""The X pass of one strided round: ``r = X_slab . eps`` and ``X_slab' . d``.

A round of the strided sweep (ops/strided.py) owns the J blocks
``{j*nr + slab}``; its slab is the (J, B) stack of those blocks' marker
rows, read in place from the stored genotypes (a strided view, never a
gathered copy).  Every pass carries a leading chain axis C: all chains
share the round's visit order, so X is read once per round for all of
them.

Storage (``kind``):

- ``"dense"``: f32/f64 rows, XLA's dot;
- ``"int8"``: dosage codes {0, 1, 2, 3=missing};
- ``"2bit"``: 16 codes per int32 word; stored eps is plane-major
  (genotypes._lane_perm), so eps viewed as (16, Nw) pairs element [k, w]
  with bit-plane k of word w.

Quantized rows decode to (code - mean) * scale: the passes sum centered
codes (code - mean, well conditioned) and apply the per-marker scale to
the (C, J, B) / (C, Npad) results.  Where calls are missing, code 3
decodes to 0 (mean imputation); ``fold`` says no call is missing, and the
select is skipped.  Pad lanes of 2-bit rows decode to -mean, so the apply
result is masked to real lanes.

The 2-bit passes have two implementations with one signature: plain XLA
(a reduction over (bit-plane, word) of decoded codes) and a Pallas kernel
through Triton (``_packed_dot_kernel`` /
``_packed_apply_kernel``).  ``xpass_impl`` is the one place that chooses.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .genotypes import MISSING_CODE

_SHIFTS = 2 * np.arange(16, dtype=np.int32)      # bit offset of each plane


def xpass_impl(platform: str) -> str:
    """The 2-bit X-pass implementation for a device platform: the Triton
    kernel on the GPU (it beat plain XLA on the iteration there), plain
    XLA on the CPU."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no X-pass implementation for platform {platform!r}")


def slab_rows(a, slab, J: int, nr: int):
    """Rows of the round's J blocks {j*nr + slab}: (Mpad, ...) -> (J, B, ...)."""
    B = a.shape[0] // (J * nr)
    a4 = a.reshape((J, nr, B) + a.shape[1:])
    return lax.dynamic_index_in_dim(a4, slab, axis=1, keepdims=False)


# ------------------------------------------------------------------ plain XLA

def _decode(codes, mean, fold, dtype):
    """codes (..., W) int -> centered values code - mean (0 where missing
    unless ``fold``); ``mean`` broadcasts against codes."""
    x = codes.astype(dtype) - mean
    if fold:
        return x
    return jnp.where(codes == MISSING_CODE, jnp.zeros((), dtype), x)


def _planes(words):
    """(..., Nw) int32 words -> (..., 16, Nw) 2-bit codes."""
    return (words[..., None, :] >> _SHIFTS[:, None]) & 3


def packed_dot_xla(words, slab, eps3, mean, *, J, nr, fold):
    """S (C, J, B) = sum over (k, w) of centered code * eps3[c, k, w]."""
    W = slab_rows(words, slab, J, nr)                          # (J, B, Nw)
    x = _decode(_planes(W), slab_rows(mean, slab, J, nr)[..., None, None],
                fold, eps3.dtype)                              # (J,B,16,Nw)
    return jnp.sum(x[None] * eps3[:, None, None], axis=(-2, -1))


def packed_apply_xla(words, slab, ds, mean, *, J, nr, fold):
    """U (C, 16, Nw) = sum over the slab's markers of ds * centered code."""
    W = slab_rows(words, slab, J, nr)
    x = _decode(_planes(W), slab_rows(mean, slab, J, nr)[..., None, None],
                fold, ds.dtype)
    return jnp.sum(ds[:, :, :, None, None] * x[None], axis=(1, 2))


# ------------------------------------------------------------ Triton kernels
#
# Decode without an int->float conversion (a quarter-rate instruction that
# bounds a plain decode): bit-plane k's two bits are moved to the top of a
# float's mantissa, so OR-ing in the bits of 1.0 gives the float 1 + c/4,
# and one FMA, 4 * (1 + c/4) - (4 + mean), gives the centered code exactly
# up to the rounding of 4 + mean.  Missing calls add a select.

_ONE = 0x3F800000                # bits of 1.0f
_FIELD = 3 << 21                 # the two top mantissa bits


def _field(w, k):
    """Bits 2k, 2k+1 of each word moved to mantissa bits 21-22."""
    s = 21 - 2 * k
    t = w << s if s >= 0 else lax.shift_right_logical(w, np.int32(-s))
    return t & _FIELD


def _value(field, m4, fold):
    """Centered code c - mean (0 where missing unless ``fold``), with
    m4 = 4 + mean."""
    x = 4.0 * lax.bitcast_convert_type(field | _ONE, jnp.float32) - m4
    return x if fold else jnp.where(field == _FIELD, 0.0, x)


def _dot_tiles(C):
    """(TM markers, TW words, warps) for the r pass: C (TM, TW) f32
    accumulators stay in registers."""
    return (8, 256, 4) if C <= 2 else (16, 64, 4)


def _apply_tiles(C):
    """(TW words, marker splits, warps) for the apply pass: 16*C (TW,)
    accumulators stay in registers."""
    return (256, 32, 4) if C <= 2 else (64, 8, 2)


def _i32(i):
    """A static index as int32, like the kernels' traced indices (keeps
    index types uniform when x64 is enabled)."""
    return np.int32(i)


def _packed_dot_kernel(slab_ref, words_ref, eps_ref, mean_ref, out_ref, *,
                       nr, B, TM, TW, Nw, C, fold):
    """One program: TM consecutive markers of one block of the slab, all
    words, all chains.  Walks the words in TW tiles (masked tail), decodes
    16 bit-planes in registers and accumulates in f32."""
    pid = pl.program_id(0)
    per_block = B // TM
    j = pid // per_block
    row0 = (j * nr + slab_ref[0]) * B + (pid % per_block) * TM
    m4 = 4.0 + plgpu.load(mean_ref.at[pl.ds(row0, TM)])[:, None]

    def body(i, accs):
        w0 = i.astype(jnp.int32) * TW
        cmask = w0 + jnp.arange(TW) < Nw
        w = plgpu.load(words_ref.at[pl.ds(row0, TM), pl.ds(w0, TW)],
                       mask=cmask[None, :], other=0)
        accs = list(accs)
        for k in range(16):
            x = _value(_field(w, k), m4, fold)
            for c in range(C):
                e = plgpu.load(eps_ref.at[_i32(c), _i32(k), pl.ds(w0, TW)],
                               mask=cmask, other=0.0)
                accs[c] = accs[c] + x * e[None, :]
        return tuple(accs)

    accs = lax.fori_loop(0, pl.cdiv(Nw, TW), body, tuple(
        jnp.zeros((TM, TW), jnp.float32) for _ in range(C)))
    for c in range(C):
        plgpu.store(out_ref.at[_i32(c), pl.ds(pid * TM, TM)],
                    jnp.sum(accs[c], axis=1))


def _packed_apply_kernel(slab_ref, words_ref, ds_ref, mean_ref, out_ref, *,
                         nr, B, TW, Nw, C, n_per, fold):
    """One program: TW words of every bit-plane, for n_per of the slab's
    markers (one split), all chains.  Walks the markers one word row at a
    time, so the 16*C accumulators need no cross-thread reduction."""
    pw, ps = pl.program_id(0), pl.program_id(1)
    w0 = pw * TW
    cmask = w0 + jnp.arange(TW) < Nw
    slab = slab_ref[0]

    def body(i, accs):
        pos = ps * n_per + i.astype(jnp.int32)     # position in the slab
        row = ((pos // B) * nr + slab) * B + pos % B
        w = plgpu.load(words_ref.at[row, pl.ds(w0, TW)], mask=cmask,
                       other=0)
        m4 = 4.0 + mean_ref[row]
        d = [ds_ref[_i32(c), pos] for c in range(C)]
        accs = list(accs)
        for k in range(16):
            x = _value(_field(w, k), m4, fold)
            for c in range(C):
                accs[c * 16 + k] = accs[c * 16 + k] + d[c] * x
        return tuple(accs)

    accs = lax.fori_loop(0, n_per, body, tuple(
        jnp.zeros((TW,), jnp.float32) for _ in range(16 * C)))
    for c in range(C):
        for k in range(16):
            plgpu.store(out_ref.at[ps, _i32(c), _i32(k), pl.ds(w0, TW)],
                        accs[c * 16 + k], mask=cmask)


@functools.partial(jax.jit, static_argnames=("J", "nr", "fold"))
def packed_dot_triton(words, slab, eps3, mean, *, J, nr, fold):
    """Triton version of packed_dot_xla (f32 only)."""
    C, _, Nw = eps3.shape
    B = words.shape[0] // (J * nr)
    TM, TW, warps = _dot_tiles(C)
    TM = min(TM, B)
    kernel = functools.partial(_packed_dot_kernel, nr=nr, B=B, TM=TM, TW=TW,
                               Nw=Nw, C=C, fold=fold)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((C, J * B), jnp.float32),
        grid=(J * B // TM,),
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=2),
        backend="triton", name="packed_xdot",
    )(jnp.reshape(slab, (1,)).astype(jnp.int32), words,
      eps3.astype(jnp.float32), mean.astype(jnp.float32))
    return out.reshape(C, J, B)


@functools.partial(jax.jit, static_argnames=("J", "nr", "fold"))
def packed_apply_triton(words, slab, ds, mean, *, J, nr, fold):
    """Triton version of packed_apply_xla (f32 only)."""
    C = ds.shape[0]
    B = ds.shape[2]
    Nw = words.shape[1]
    TW, splits, warps = _apply_tiles(C)
    JB = J * B
    while JB % splits:
        splits //= 2
    kernel = functools.partial(_packed_apply_kernel, nr=nr, B=B, TW=TW,
                               Nw=Nw, C=C, n_per=JB // splits, fold=fold)
    part = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((splits, C, 16, Nw), jnp.float32),
        grid=(pl.cdiv(Nw, TW), splits),
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=2),
        backend="triton", name="packed_xapply",
    )(jnp.reshape(slab, (1,)).astype(jnp.int32), words,
      ds.reshape(C, JB).astype(jnp.float32), mean.astype(jnp.float32))
    return jnp.sum(part, axis=0)


_PACKED = {"xla": (packed_dot_xla, packed_apply_xla),
           "triton": (packed_dot_triton, packed_apply_triton)}


# ------------------------------------------------------------ round passes

def x_dot(XT, mean, scale, slab, eps, *, J, nr, kind, fold, impl="xla"):
    """r (C, J, B) = X_slab . eps for eps (C, Npad)."""
    dt = eps.dtype
    if kind == "dense":
        Xs = slab_rows(XT, slab, J, nr).astype(dt)             # (J, B, N)
        return jnp.einsum("cn,jbn->cjb", eps, Xs)
    m = slab_rows(mean, slab, J, nr).astype(dt)                # (J, B)
    s = slab_rows(scale, slab, J, nr).astype(dt)
    if kind == "2bit":
        dot = _PACKED["xla" if dt != jnp.float32 else impl][0]
        S = dot(XT, slab, eps.reshape(eps.shape[0], 16, -1), mean,
                J=J, nr=nr, fold=fold).astype(dt)
    else:
        x = _decode(slab_rows(XT, slab, J, nr), m[..., None], fold, dt)
        S = jnp.sum(x[None] * eps[:, None, None, :], axis=-1)
    return S * s[None]


def x_apply(XT, mean, scale, row_valid, slab, d, *, J, nr, kind, fold,
            impl="xla"):
    """X_slab' . d (C, Npad) for per-marker changes d (C, J, B)."""
    dt = d.dtype
    C = d.shape[0]
    if kind == "dense":
        Xs = slab_rows(XT, slab, J, nr).astype(dt)
        return jnp.einsum("cjb,jbn->cn", d, Xs)
    m = slab_rows(mean, slab, J, nr).astype(dt)
    ds = d * slab_rows(scale, slab, J, nr).astype(dt)[None]
    if kind == "2bit":
        apply = _PACKED["xla" if dt != jnp.float32 else impl][1]
        U = apply(XT, slab, ds, mean, J=J, nr=nr,
                  fold=fold).astype(dt).reshape(C, -1)
    else:
        x = _decode(slab_rows(XT, slab, J, nr), m[..., None], fold, dt)
        U = jnp.sum(ds[..., None] * x[None], axis=(1, 2))
    if kind == "2bit":
        U = jnp.where(row_valid[None], U, jnp.zeros((), dt))
    return U
