"""Per-prime modular-ring constants and NTT twiddle tables (host precompute).

For each NTT-friendly prime q (q ≡ 1 mod 2n) this builds, with exact Python
integer arithmetic, everything the device kernels need:

- Montgomery constants: ``pinv`` = -q^-1 mod 2^64, ``r2`` = 2^128 mod q,
  ``r1`` = 2^64 mod q.
- A primitive 2n-th root of unity ψ (found without factoring q-1: random
  x^((q-1)/2n) until ψ^n ≡ -1), its inverse, and n^-1 mod q.
- Bit-reverse-ordered twiddle tables for the iterative negacyclic NTT
  (Longa–Naehrig layout): ``psi_rev[i] = ψ^brv(i)`` and
  ``psi_inv_rev[i] = ψ^-brv(i)``, each with a Shoup companion
  (floor(w·2^64/q)) so butterflies run as Shoup multiplications.

The reference delegates all of this to Lattigo's Go ring package
(reference: fhe_ops_lib/fhe_lib_v2.h:41 and SURVEY.md §2.5); here it is a
self-contained host computation cached per (q, n).
"""

import functools

import numpy as np

_U64 = np.uint64
_MOD64 = 1 << 64


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _pow_mod(base: int, exp: int, mod: int) -> int:
    return pow(base, exp, mod)


@functools.lru_cache(maxsize=None)
def find_primitive_2nth_root(q: int, n: int) -> int:
    """Smallest-effort primitive 2n-th root of unity mod q (deterministic)."""
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f'prime {q} is not NTT-friendly for n={n}')
    exp = (q - 1) // (2 * n)
    # Deterministic scan keeps tables reproducible across runs/hosts.
    for x in range(2, 1 << 20):
        psi = _pow_mod(x, exp, q)
        if psi != 1 and _pow_mod(psi, n, q) == q - 1:
            return psi
    raise RuntimeError(f'no primitive 2n-th root found for q={q}, n={n}')


def is_ntt_friendly(q: int, n: int) -> bool:
    return (q - 1) % (2 * n) == 0


# Miller–Rabin with the first thirteen prime bases (2…41) is exact for
# every n < 3.3·10^24 (Sorenson & Webster 2015; bases 2…37 alone stop at
# 3.2·10^23), far above any word-size prime.
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
_MR_LIMIT = 3317044064679887385961981


def is_prime(n: int) -> bool:
    """Deterministic primality test for n < 3.3·10^24."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    if n >= _MR_LIMIT:
        raise ValueError(f'{n} is beyond the deterministic Miller–Rabin range')
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(n: int, bit_size: int, count: int, exclude=()) -> list[int]:
    """Generate ``count`` primes ≡ 1 mod 2n just below 2^bit_size.

    Used for the BFV multiplication auxiliary basis (BEHZ) and for the
    31-bit parameter profiles (the reference pins FPGA primes the same
    way, frontend/custom_task.py:215).
    """
    step = 2 * n
    candidate = (1 << bit_size) - 1
    candidate -= (candidate - 1) % step  # candidate ≡ 1 mod 2n
    found: list[int] = []
    excl = set(exclude)
    while len(found) < count and candidate > (1 << (bit_size - 1)):
        if candidate not in excl and is_prime(candidate):
            found.append(candidate)
        candidate -= step
    if len(found) < count:
        raise RuntimeError(f'not enough {bit_size}-bit NTT primes for n={n}')
    return found


class PrimeRing:
    """Constants and tables for Z_q[x]/(x^n+1) with one prime q.

    ``word_bits`` selects the machine word (R = 2^word): 64 (default) or 32
    for prime chains < 2^31 (core/u64.py).
    """

    def __init__(self, q: int, n: int, word_bits: int = 64):
        from .u64 import word_dtype
        self.q = q
        self.n = n
        self.word_bits = word_bits
        dt = word_dtype(word_bits)
        R = 1 << word_bits
        if word_bits == 32:
            assert q < (1 << 31), f'prime {q} too large for 32-bit word'
        self.logn = n.bit_length() - 1
        assert 1 << self.logn == n
        self.pinv = (-pow(q, -1, R)) % R              # -q^-1 mod R
        self.r1 = R % q                               # R mod q
        self.r2 = (R * R) % q                         # R^2 mod q
        self.n_inv = pow(n, -1, q)

        psi = find_primitive_2nth_root(q, n)
        self.psi = psi
        self.psi_inv = pow(psi, -1, q)

        brv = [bit_reverse(i, self.logn) for i in range(n)]
        psi_pows = [1] * n
        psi_inv_pows = [1] * n
        for i in range(1, n):
            psi_pows[i] = psi_pows[i - 1] * psi % q
            psi_inv_pows[i] = psi_inv_pows[i - 1] * self.psi_inv % q

        def shoup(w):
            return (w << word_bits) // q

        self.psi_rev = np.array([psi_pows[brv[i]] for i in range(n)], dtype=dt)
        self.psi_rev_shoup = np.array([shoup(psi_pows[brv[i]]) for i in range(n)], dtype=dt)
        self.psi_inv_rev = np.array([psi_inv_pows[brv[i]] for i in range(n)], dtype=dt)
        self.psi_inv_rev_shoup = np.array([shoup(psi_inv_pows[brv[i]]) for i in range(n)], dtype=dt)
        self.n_inv_shoup = shoup(self.n_inv)


@functools.lru_cache(maxsize=None)
def get_prime_ring(q: int, n: int, word_bits: int = 64) -> PrimeRing:
    return PrimeRing(q, n, word_bits)


class RnsRing:
    """Stacked per-limb constants for a modulus chain (leading axis = limb).

    Device arrays have shape (L, ...) with L limbs; every constant here is a
    word-dtype array broadcastable against (L, n) coefficient arrays.
    """

    def __init__(self, moduli: tuple[int, ...], n: int, word_bits: int = 64):
        from .u64 import word_dtype
        self.moduli = tuple(int(m) for m in moduli)
        self.n = n
        self.word_bits = word_bits
        dt = word_dtype(word_bits)
        rings = [get_prime_ring(q, n, word_bits) for q in self.moduli]
        self.rings = rings
        L = len(rings)
        col = lambda attr: np.array([getattr(r, attr) for r in rings], dtype=dt).reshape(L, 1)
        self.q = col('q')
        self.pinv = col('pinv')
        self.r1 = col('r1')
        self.r2 = col('r2')
        self.n_inv = col('n_inv')
        self.n_inv_shoup = col('n_inv_shoup')
        self.psi_rev = np.stack([r.psi_rev for r in rings])                    # (L, n)
        self.psi_rev_shoup = np.stack([r.psi_rev_shoup for r in rings])
        self.psi_inv_rev = np.stack([r.psi_inv_rev for r in rings])
        self.psi_inv_rev_shoup = np.stack([r.psi_inv_rev_shoup for r in rings])


@functools.lru_cache(maxsize=None)
def get_rns_ring(moduli: tuple[int, ...], n: int, word_bits: int = 64) -> RnsRing:
    return RnsRing(moduli, n, word_bits)
