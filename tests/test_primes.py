"""Deterministic Miller–Rabin (core/modring.is_prime) and the prime chains
built on it."""

import json
import os

import pytest

from lattisense_tpu.core.modring import gen_ntt_primes, is_prime
from lattisense_tpu.params import BfvParams, bfv_aux_basis

_TABLE = json.load(open(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'lattisense_tpu', 'parameter.json')))


@pytest.mark.parametrize('scheme,n', [(s, n) for s in _TABLE for n in _TABLE[s]])
def test_parameter_table_primes(scheme, n):
    entry = _TABLE[scheme][n]
    for q in entry['q'] + entry['p']:
        assert is_prime(int(q)), q


@pytest.mark.parametrize('c', [
    561, 1105, 1729, 2465, 2821, 6601, 8911,     # Carmichael numbers
    9746347772161,                               # Carmichael, 13 digits
    2047, 3277, 4033, 4681, 8321,                # strong pseudoprimes to base 2
    3215031751,                                  # strong psp to bases 2, 3, 5, 7
    3825123056546413051,                         # strong psp to bases 2 … 23
    318665857834031151167461,                    # strong psp to bases 2 … 37
])
def test_pseudoprimes_rejected(c):
    assert not is_prime(c)


@pytest.mark.parametrize('p', [2, 3, 37, 41, 65537, (1 << 31) - 1, (1 << 61) - 1,
                               0x7FFE0001, 0x1FFFFFFFFFE00001])
def test_known_primes(p):
    assert is_prime(p)


def test_small_range_matches_sieve():
    limit = 20000
    sieve = [True] * limit
    sieve[0] = sieve[1] = False
    for i in range(2, int(limit ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = [False] * len(sieve[i * i::i])
    assert [i for i in range(limit) if is_prime(i)] == \
        [i for i in range(limit) if sieve[i]]


# Auxiliary BEHZ bases of the default n=16384 chains as sympy.isprime chose
# them before the switch to is_prime (recorded on the same tree).
_AUX = {
    64: ((576460752302473217, 576460752302080001, 576460752301785089,
          576460752301391873, 576460752301228033, 576460752301096961,
          576460752300310529), 576460752300113921),
    32: ((2142208001, 2142044161, 2142011393, 2141749249, 2141028353,
          2140766209, 2140569601, 2139783169, 2139455489, 2139062273,
          2138767361, 2137817089), 2137620481),
}


@pytest.mark.parametrize('word', [64, 32])
def test_aux_basis_unchanged(word):
    p = BfvParams.create(16384) if word == 64 else BfvParams.create_tpu_param(16384)
    assert bfv_aux_basis(p.n, tuple(p.q), tuple(p.p), p.word_bits) == _AUX[word]


def test_ntt_primes_are_ntt_friendly():
    for q in gen_ntt_primes(4096, 40, 5):
        assert is_prime(q) and (q - 1) % 8192 == 0
