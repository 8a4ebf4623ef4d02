"""Digit/limb-sharded key switch vs the single-device implementation —
bit-exact over the 8-device CPU mesh."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.parallel.keyswitch_sharded import ShardedKeySwitcher
from lattisense_tpu.parallel.mesh import make_mesh
from lattisense_tpu.schemes import keys as K
from lattisense_tpu.schemes.keyswitch import KeySwitcher

N = 64


@pytest.mark.parametrize('limb_devices', [2, 4])
def test_sharded_keyswitch_bitexact(limb_devices):
    q = gen_ntt_primes(N, 50, 8)
    p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    sw = KeySwitcher(tuple(q), tuple(p), N)
    rng = np.random.default_rng(3)
    sk = K.SecretKey(K.sample_ternary(rng, N))
    ksk = K.gen_keyswitch_key(rng, sk, lambda mods: sk.ntt_form(tuple(mods), N),
                              tuple(q), tuple(p), N)
    level = 7
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64)
                  for qi in q[:level + 1]])

    ref0, ref1 = sw.switch(np, x, ksk, level)

    mesh = make_mesh(op=8 // limb_devices, limb=limb_devices)
    sharded = ShardedKeySwitcher(sw, level, mesh)
    got0, got1 = sharded(x, ksk.key_q, ksk.key_p)
    np.testing.assert_array_equal(got0, ref0)
    np.testing.assert_array_equal(got1, ref1)


@pytest.mark.parametrize('limb_devices', [2, 4])
def test_sharded_keyswitch_w32_bitexact(limb_devices):
    """31-bit-word chains through the limb-sharded switch —
    bit-exact vs the single-device w32 path. limb=4 exercises the widened
    psum_scatter (u32 row sums would wrap for D > 2)."""
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    chain = tuple(gen_ntt_primes(N, 31, 10))
    q, p = list(chain[:8]), list(chain[8:10])
    params = BfvParams.create_custom(N, 257, q, p, word_bits=32)
    ctx = BfvContext.create_random_context(params, seed=19)
    sw = ctx.engine.switcher
    rng = np.random.default_rng(4)
    level = 7
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64).astype(np.uint32)
                  for qi in q[:level + 1]])
    ref0, ref1 = sw.switch(np, x, ctx.rlk, level)

    mesh = make_mesh(op=8 // limb_devices, limb=limb_devices)
    sharded = ShardedKeySwitcher(sw, level, mesh)
    got0, got1 = sharded(x, ctx.rlk.key_q, ctx.rlk.key_p)
    assert got0.dtype == np.uint32 and got1.dtype == np.uint32
    np.testing.assert_array_equal(got0, ref0)
    np.testing.assert_array_equal(got1, ref1)


@pytest.mark.parametrize('word', [64, 32])
def test_sharded_switch_from_digits(word):
    """Hoisted entry: precomputed NTT-domain digits through the sharded
    tail (inner product + psum_scatter + in-mesh epilogue) — bit-exact vs
    KeySwitcher.switch_from_digits on both RNS words."""
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    if word == 64:
        chain = tuple(gen_ntt_primes(N, 50, 8)) + tuple(
            gen_ntt_primes(N, 51, 2, exclude=tuple(gen_ntt_primes(N, 50, 8))))
        q, p = list(chain[:8]), list(chain[8:10])
    else:
        chain = tuple(gen_ntt_primes(N, 31, 10))
        q, p = list(chain[:8]), list(chain[8:10])
    params = BfvParams.create_custom(N, 257, q, p, word_bits=word)
    ctx = BfvContext.create_random_context(params, seed=33)
    sw = ctx.engine.switcher
    rng = np.random.default_rng(5)
    level = 7
    dt = np.uint32 if word == 32 else np.uint64
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64).astype(dt)
                  for qi in q[:level + 1]])
    digits = sw.decompose_modup_ntt(np, x, level)
    want0, want1 = sw.switch_from_digits(np, digits, ctx.rlk, level)

    mesh = make_mesh(op=2, limb=4)
    sharded = ShardedKeySwitcher(sw, level, mesh)
    got0, got1 = sharded.switch_from_digits(digits, ctx.rlk.key_q,
                                            ctx.rlk.key_p)
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got1, want1)
