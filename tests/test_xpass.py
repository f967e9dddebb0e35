"""The X pass of a strided round (ops/xpass.py).

- The Triton kernels, in interpret mode, against the plain XLA pass: masked
  word tails (Nw = 200 is no multiple of any tile), missing codes, several
  chains, both directions.
- The plain pass of every storage against float64 NumPy on the decoded
  matrix.
- ``gpu``-marked tests run the compiled kernels on a card; they skip
  where there is none.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from bayesrrcpp_tpu.ops import xpass
from bayesrrcpp_tpu.ops.genotypes import _lane_perm, pack_codes_host

J, NR, B = 4, 3, 32           # slab of 4 blocks of 32 markers, 3 rounds
M = J * NR * B


def _words(seed, n_words, missing):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, (M, n_words, 16))
    if missing:
        codes[rng.random(codes.shape) < 0.1] = 3
    shifts = 2 * np.arange(16, dtype=np.uint64)
    w = (codes.astype(np.uint64) << shifts).sum(axis=2)
    mean = rng.uniform(0.5, 1.5, M).astype(np.float32)
    return (jnp.asarray(w.astype(np.uint32).view(np.int32)),
            jnp.asarray(mean), rng)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Triton kernels in Pallas' interpret mode (no card here)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("fold", [True, False])
def test_triton_dot_matches_xla(interpret, C, fold):
    words, mean, rng = _words(C + 10 * fold, 200, missing=not fold)
    eps3 = jnp.asarray(rng.standard_normal((C, 16, 200)).astype(np.float32))
    for slab in (0, 2):
        want = xpass.packed_dot_xla(words, slab, eps3, mean, J=J, nr=NR,
                                    fold=fold)
        got = xpass.packed_dot_triton(words, slab, eps3, mean, J=J, nr=NR,
                                      fold=fold)
        assert got.shape == (C, J, B)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("fold", [True, False])
def test_triton_apply_matches_xla(interpret, C, fold):
    words, mean, rng = _words(20 + C + 10 * fold, 200, missing=not fold)
    ds = jnp.asarray(rng.standard_normal((C, J, B)).astype(np.float32))
    for slab in (1, 2):
        want = xpass.packed_apply_xla(words, slab, ds, mean, J=J, nr=NR,
                                      fold=fold)
        got = xpass.packed_apply_triton(words, slab, ds, mean, J=J, nr=NR,
                                        fold=fold)
        assert got.shape == (C, 16, 200)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)


def _decoded(kind, missing, N=300):
    """Stored slab inputs plus the float64 decoded matrix (original order)
    and a stored-order <-> original-order lane map."""
    rng = np.random.default_rng(7 + missing)
    dos = rng.integers(0, 3, (M, N)).astype(float)
    if missing:
        dos[rng.random(dos.shape) < 0.05] = np.nan
    codes, words, mean, scale, Npad, has_missing = pack_codes_host(
        dos, True, None, M, N)
    assert has_missing == missing
    x = np.where(codes == 3, 0.0, (codes - mean[:, None]) * scale[:, None])
    x[:, N:] = 0.0
    if kind == "2bit":
        perm = _lane_perm(Npad)
        XT, n = jnp.asarray(words), Npad
    elif kind == "int8":
        perm, XT, n = np.arange(N), jnp.asarray(codes[:, :N]), N
    else:
        perm, n = np.arange(N), N
        XT = jnp.asarray(x[:, :N].astype(np.float32))
    return (XT, jnp.asarray(mean), jnp.asarray(scale), jnp.asarray(perm < N),
            x[:, :n], perm, n, rng)


@pytest.mark.parametrize("kind,missing", [("2bit", False), ("2bit", True),
                                          ("int8", False), ("int8", True),
                                          ("dense", False)])
def test_plain_pass_matches_float64(kind, missing):
    XT, mean, scale, rv, x, perm, n, rng = _decoded(kind, missing)
    fold = kind != "dense" and not missing
    C, slab = 2, 1
    rows = ((np.arange(J)[:, None] * NR + slab) * B
            + np.arange(B)[None]).reshape(-1)
    eps_o = rng.standard_normal((C, n))                 # original order
    eps_o[:, 300:] = 0.0
    eps_s = np.zeros_like(eps_o)
    eps_s[:, :] = eps_o[:, perm] if kind == "2bit" else eps_o
    r = xpass.x_dot(XT, mean, scale, slab, jnp.asarray(eps_s, jnp.float32),
                    J=J, nr=NR, kind=kind, fold=fold)
    r64 = eps_o @ x[rows].T
    assert (np.linalg.norm(np.asarray(r).reshape(C, -1) - r64)
            / np.linalg.norm(r64)) < 1e-5
    d = rng.standard_normal((C, J, B))
    u = np.asarray(xpass.x_apply(XT, mean, scale, rv, slab,
                                 jnp.asarray(d, jnp.float32), J=J, nr=NR,
                                 kind=kind, fold=fold))
    u_o = np.zeros_like(u)
    if kind == "2bit":
        u_o[:, perm] = u
    else:
        u_o = u
    u64 = d.reshape(C, -1) @ x[rows]
    assert np.linalg.norm(u_o - u64) / np.linalg.norm(u64) < 1e-5
    if kind == "2bit":                  # pad lanes stay exactly zero
        assert np.all(u[:, ~np.asarray(rv)] == 0.0)


def test_xpass_impl_choice():
    assert xpass.xpass_impl("gpu") == "triton"
    assert xpass.xpass_impl("cpu") == "xla"
    with pytest.raises(ValueError):
        xpass.xpass_impl("other")


# ------------------------------------------------------------- on a card

@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run through `python chip_smoke.py`")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("fold", [True, False])
def test_compiled_kernels_match_xla(gpu, C, fold):
    """The kernels as compiled for the card, at a slab of J=128 blocks of
    32 markers over 6,272 words (the biobank round), against plain XLA."""
    from bayesrrcpp_tpu.simulate import (random_packed_words,
                                         random_packed_words_missing)

    Jg, nr, Nw = 128, 2, 6272
    gen = random_packed_words if fold else random_packed_words_missing
    words = gen(jax.random.PRNGKey(C), Jg * nr * 32, Nw)
    rng = np.random.default_rng(C)
    mean = jnp.asarray(rng.uniform(0.5, 1.5, Jg * nr * 32), jnp.float32)
    eps3 = jnp.asarray(rng.standard_normal((C, 16, Nw)), jnp.float32)
    ds = jnp.asarray(rng.standard_normal((C, Jg, 32)), jnp.float32)
    kw = dict(J=Jg, nr=nr, fold=fold)
    for slab in (0, 1):
        a = xpass.packed_dot_triton(words, slab, eps3, mean, **kw)
        b = xpass.packed_dot_xla(words, slab, eps3, mean, **kw)
        assert float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b)) < 1e-5
        u = xpass.packed_apply_triton(words, slab, ds, mean, **kw)
        v = xpass.packed_apply_xla(words, slab, ds, mean, **kw)
        assert float(jnp.linalg.norm(u - v) / jnp.linalg.norm(v)) < 1e-5
