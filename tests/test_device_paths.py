"""The jitted plain device path (XLA) against the NumPy golden model, at the
shapes and words the fused kernels of earlier versions were tested at:
NTT/INTT (plain and under vmap), FastBConv, the key-switch inner product,
and the 31-bit-word BEHZ multiply and key switch."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from lattisense_tpu.core import ntt as ntt_mod
from lattisense_tpu.core import u64 as _u
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.core.rns import BasisConv
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext
from lattisense_tpu.schemes.types import Ciphertext


def _rows(q, n, batch, dt, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, qi, (*batch, n), dtype=np.uint64).astype(dt)
                     for qi in q], axis=-2)


@pytest.mark.parametrize('word,n,L,batch,vmap', [
    (64, 16384, 2, (1,), False),
    (64, 2048, 2, (3,), True),
    (64, 256, 3, (1,), False),
    (64, 1024, 3, (3,), False),
    (32, 256, 3, (1,), False),
    (32, 256, 3, (3,), False),
    (32, 1024, 3, (2, 2), False),
    (32, 256, 2, (4,), True),
])
def test_xla_ntt_matches_golden(word, n, L, batch, vmap):
    dt = np.uint32 if word == 32 else np.uint64
    q = tuple(gen_ntt_primes(n, 31 if word == 32 else 55, L))
    ring = get_rns_ring(q, n, word)
    x = _rows(q, n, batch, dt, seed=n + L)
    fwd = lambda v: ntt_mod.ntt(jnp, v, ring)
    inv = lambda v: ntt_mod.intt(jnp, v, ring)
    if vmap:
        fwd, inv = jax.vmap(fwd), jax.vmap(inv)
    want = ntt_mod.ntt(np, x, ring)
    got = np.asarray(jax.jit(fwd)(x))
    assert got.dtype == dt
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jax.jit(inv)(want)), x)


@pytest.mark.parametrize('n,L,T,batch', [(2048, 3, 4, (2,)), (4096, 2, 2, ())])
def test_xla_basis_conv(n, L, T, batch):
    src = gen_ntt_primes(n, 55, L)
    dst = gen_ntt_primes(n, 56, T, exclude=tuple(src))
    conv = BasisConv(tuple(src), tuple(dst))
    y = conv.decompose(np, _rows(src, n, batch, np.uint64, seed=n))
    got = np.asarray(jax.jit(lambda v: conv.convert(jnp, v))(y))
    np.testing.assert_array_equal(got, conv.convert(np, y))


@pytest.fixture(scope='module')
def bfv4096():
    ctx = BfvContext.create_random_context(BfvParams.create(4096), seed=4)
    ctx.gen_rotation_keys_for_rotations([1])
    return ctx


@pytest.mark.parametrize('op', ['mult_relin', 'rotate'])
def test_xla_keyswitch_matches_golden(bfv4096, op):
    """Key-switch inner product (relinearize; hoisted Galois switch) on the
    jitted path equals the NumPy engine bit for bit."""
    from lattisense_tpu.schemes.galois import galois_elt_col
    ctx, eng = bfv4096, bfv4096.engine
    m = np.arange(ctx.params.n) % 31
    ct = ctx.encrypt(ctx.encode(m))
    level = ct.level
    if op == 'mult_relin':
        rlk = ctx.rlk
        want = eng.relinearize(np, eng.mult(np, ct, ct), rlk).data

        def dev(d, k):
            c = Ciphertext(data=d, level=level)
            return eng.relinearize(jnp, eng.mult(jnp, c, c), k).data
        got = jax.jit(dev)(ct.data, rlk)
    else:
        elt = galois_elt_col(1, ctx.params.n)
        glk = ctx.glk.keys[elt]
        want = eng.apply_galois(np, ct, elt, glk).data
        got = jax.jit(lambda d, k: eng.apply_galois(
            jnp, Ciphertext(data=d, level=level), elt, k).data)(ct.data, glk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope='module')
def w32_ctx():
    n = 256
    chain = tuple(gen_ntt_primes(n, 31, 8))
    params = BfvParams.create_custom(n, 257, list(chain[:5]), list(chain[5:7]),
                                     word_bits=32)   # alpha=2: ragged last digit
    return BfvContext.create_random_context(params, seed=15)


@pytest.mark.parametrize('stage', ['prep', 'finish', 'mult'])
def test_w32_behz_mult_device(w32_ctx, stage):
    """31-bit-word BEHZ multiply on the jitted path: the extend + NTT +
    Montgomery prologue, the INTT + t/Q + Shenoy epilogue, and the whole
    tensor product."""
    eng = w32_ctx.engine
    level = 2
    bz = eng.behz(level)
    ring, ra = bz.ring_q, bz.ring_aux
    rng = np.random.default_rng(4)

    def rand(moduli, k):
        return np.stack([[rng.integers(0, qi, eng.n, dtype=np.uint64).astype(np.uint32)
                          for qi in moduli] for _ in range(k)])

    if stage == 'prep':
        def f(xp, polys):
            ext = bz.extend(xp, polys)
            return (_u.to_mont(xp, ntt_mod.ntt(xp, polys, ring), ring.q, ring.pinv, ring.r2),
                    _u.to_mont(xp, ntt_mod.ntt(xp, ext, ra), ra.q, ra.pinv, ra.r2))
        args = (rand(ring.moduli, 4),)
    elif stage == 'finish':
        def f(xp, dq, da):
            dq = ntt_mod.intt(xp, _u.from_mont(xp, dq, ring.q, ring.pinv), ring)
            da = ntt_mod.intt(xp, _u.from_mont(xp, da, ra.q, ra.pinv), ra)
            return (bz.scale_and_back(xp, dq, da),)
        args = (rand(ring.moduli, 3), rand(ra.moduli, 3))
    else:
        def f(xp, a, b):
            ca, cb = Ciphertext(data=a, level=level), Ciphertext(data=b, level=level)
            return (eng.mult(xp, ca, cb).data,)
        args = (rand(ring.moduli, 2), rand(ring.moduli, 2))
    want = f(np, *args)
    got = jax.jit(lambda *a: f(jnp, *a))(*args)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize('output_ntt', [False, True])
def test_w32_keyswitch_device(w32_ctx, output_ntt):
    sw = w32_ctx.engine.switcher
    q = w32_ctx.params.q
    rng = np.random.default_rng(8)
    for level in (4, 3, 2):
        x = np.stack([rng.integers(0, qi, w32_ctx.params.n, dtype=np.uint64).astype(np.uint32)
                      for qi in q[:level + 1]])
        want = sw.switch(np, x, w32_ctx.rlk, level, output_ntt=output_ntt)
        got = jax.jit(lambda v, k, lv=level: sw.switch(
            jnp, v, k, lv, output_ntt=output_ntt))(x, w32_ctx.rlk)
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])
