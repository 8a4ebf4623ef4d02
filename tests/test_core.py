"""Unit tests for the exact u64 modular arithmetic and the negacyclic NTT.

Oracles are independent Python-integer computations (exact big-int math),
mirroring the reference's plain-math test oracles
(reference: fhe_ops_lib/utils.h:59-80).
"""

import numpy as np
import pytest

from lattisense_tpu.core import u64 as u
from lattisense_tpu.core import ntt as ntt_mod
from lattisense_tpu.core.modring import get_prime_ring, get_rns_ring, gen_ntt_primes

RNG = np.random.default_rng(12345)

PRIMES = [
    65537,
    0x7FFE0001,                 # 31-bit FPGA-profile prime (custom_task.py:218)
    0x3FFFFFFFEF8001,           # 54-bit custom test prime (test_cpu_bfv.py:44)
    72057594038321153,          # 57-bit default-chain prime (parameter.json BFV 16384)
    0x1FFFFFFFFFE00001,         # 61-bit special prime (bootstrap chain)
]


def rand_u64(shape, bound):
    return RNG.integers(0, bound, size=shape, dtype=np.uint64)


class TestU64:
    def test_mulhi(self):
        a = rand_u64((1000,), 1 << 63)
        b = rand_u64((1000,), 1 << 63)
        hi = u.mulhi(np, a, b)
        for i in range(0, 1000, 97):
            assert int(hi[i]) == (int(a[i]) * int(b[i])) >> 64

    @pytest.mark.parametrize('p', PRIMES)
    def test_mont_roundtrip_and_mulmod(self, p):
        ring = get_prime_ring(p, 16)
        pv = np.uint64(p)
        pinv = np.uint64(ring.pinv)
        r2 = np.uint64(ring.r2)
        a = rand_u64((500,), p)
        b = rand_u64((500,), p)
        c = u.mulmod(np, a, b, pv, pinv, r2)
        for i in range(0, 500, 41):
            assert int(c[i]) == int(a[i]) * int(b[i]) % p
        am = u.to_mont(np, a, pv, pinv, r2)
        back = u.from_mont(np, am, pv, pinv)
        assert np.array_equal(back, a)

    @pytest.mark.parametrize('p', PRIMES)
    def test_addsub(self, p):
        pv = np.uint64(p)
        a = rand_u64((300,), p)
        b = rand_u64((300,), p)
        assert np.array_equal(u.addmod(np, a, b, pv),
                              ((a.astype(object) + b.astype(object)) % p).astype(np.uint64))
        assert np.array_equal(u.submod(np, a, b, pv),
                              ((a.astype(object) - b.astype(object)) % p).astype(np.uint64))
        assert np.array_equal(u.negmod(np, a, pv),
                              ((-a.astype(object)) % p).astype(np.uint64))

    @pytest.mark.parametrize('p', PRIMES[2:])
    def test_shoup(self, p):
        ring = get_prime_ring(p, 16)
        w = int(ring.psi)
        w_shoup = np.uint64((w << 64) // p)
        a = rand_u64((300,), p)
        c = u.shoup_mul(np, a, np.uint64(w), w_shoup, np.uint64(p))
        for i in range(0, 300, 37):
            assert int(c[i]) == int(a[i]) * w % p


def schoolbook_negacyclic(a, b, q):
    """Exact negacyclic polynomial product with Python ints."""
    n = len(a)
    res = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            prod = ai * int(b[j])
            if k < n:
                res[k] = (res[k] + prod) % q
            else:
                res[k - n] = (res[k - n] - prod) % q
    return np.array(res, dtype=np.uint64)


class TestNtt:
    @pytest.mark.parametrize('n', [16, 64, 256])
    @pytest.mark.parametrize('q', [65537, 0x3FFFFFFFEF8001, 0x1FFFFFFFFFE00001])
    def test_roundtrip(self, n, q):
        ring = get_rns_ring((q,), n)
        x = rand_u64((1, n), q)
        y = ntt_mod.intt(np, ntt_mod.ntt(np, x, ring), ring)
        assert np.array_equal(y, x)

    @pytest.mark.parametrize('n', [16, 64])
    def test_negacyclic_convolution(self, n):
        q = 0x3FFFFFFFEF8001
        ring = get_rns_ring((q,), n)
        a = rand_u64((1, n), q)
        b = rand_u64((1, n), q)
        fa = ntt_mod.ntt(np, a, ring)
        fb = ntt_mod.ntt(np, b, ring)
        fc = u.mulmod(np, fa, fb, ring.q, ring.pinv, ring.r2)
        c = ntt_mod.intt(np, fc, ring)
        expected = schoolbook_negacyclic(a[0], b[0], q)
        assert np.array_equal(c[0], expected)

    def test_multi_limb_batch(self):
        n = 64
        moduli = (65537, 0x3FFFFFFFEF8001, 0x1FFFFFFFFFE00001)
        ring = get_rns_ring(moduli, n)
        x = np.stack([rand_u64((3, n), min(moduli))] * 2)  # (2, 3, n) batch
        y = ntt_mod.intt(np, ntt_mod.ntt(np, x, ring), ring)
        assert np.array_equal(y, x)

    def test_jax_matches_numpy(self):
        import jax.numpy as jnp
        import lattisense_tpu  # noqa: F401  (enables x64)
        n = 256
        q = 72057594038321153
        ring = get_rns_ring((q,), n)
        x = rand_u64((1, n), q)
        ref = ntt_mod.ntt(np, x, ring)
        dev = np.asarray(ntt_mod.ntt(jnp, jnp.asarray(x), ring))
        assert np.array_equal(ref, dev)

    def test_gen_ntt_primes(self):
        ps = gen_ntt_primes(16384, 60, 3)
        assert len(set(ps)) == 3
        for p in ps:
            assert (p - 1) % 32768 == 0 and p < (1 << 60) and p > (1 << 59)


def test_xla_conjugated_inverse_bitexact():
    """The env-gated XLA conjugated inverse (core.ntt._intt_conj) is
    bit-identical to the ascending formulation."""
    import jax.numpy as jnp
    n, L = 4096, 3
    q = gen_ntt_primes(n, 55, L)
    ring = get_rns_ring(tuple(q), n)
    rng = np.random.default_rng(17)
    x = np.stack([rng.integers(0, qi, n, dtype=np.uint64) for qi in q])[None]
    ref = ntt_mod.intt(np, x, ring)
    got = np.asarray(ntt_mod._intt_conj(jnp, jnp.asarray(x), ring))
    np.testing.assert_array_equal(got, ref)
