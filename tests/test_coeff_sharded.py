"""Coefficient-axis sharding conformance: the
distributed four-step NTT and the coeff-sharded key switch / rotation /
relinearization must be BIT-EXACT vs the single-device kernels, on a
virtual CPU mesh (SURVEY §2.8 kernel-level coefficient sharding)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core import ntt as ntt_mod
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.parallel.coeff_sharded import (CoeffShardedKeySwitcher,
                                                   CoeffShardedRelin,
                                                   CoeffShardedRotator,
                                                   DistNtt)

N = 1024


def _mesh(d, name='coeff'):
    devs = jax.devices()
    if len(devs) < d:
        pytest.skip(f'need {d} virtual devices')
    return Mesh(np.array(devs[:d]), (name,))


@pytest.mark.parametrize('wb,bits', [(64, 50), (32, 31)])
@pytest.mark.parametrize('D', [4, 8])
def test_dist_ntt_bit_exact(D, wb, bits):
    mesh = _mesh(D)
    moduli = tuple(gen_ntt_primes(N, bits, 3))
    ring = get_rns_ring(moduli, N, wb)
    dn = DistNtt(moduli, N, mesh, word_bits=wb)
    rng = np.random.default_rng(1)
    dt = np.uint64 if wb == 64 else np.uint32
    x = np.stack([rng.integers(0, q, N, dtype=np.uint64).astype(dt)
                  for q in moduli])
    ref = ntt_mod.ntt(np, x.copy(), ring)
    got = np.asarray(dn.ntt(x))
    np.testing.assert_array_equal(got, ref)
    back = np.asarray(dn.intt(got))
    np.testing.assert_array_equal(back, x)
    # and vs the single-device inverse on the same input
    ref_inv = ntt_mod.intt(np, ref.copy(), ring)
    np.testing.assert_array_equal(np.asarray(dn.intt(ref)), ref_inv)


def test_dist_ntt_batch_dims():
    mesh = _mesh(4)
    moduli = tuple(gen_ntt_primes(N, 50, 2))
    ring = get_rns_ring(moduli, N)
    dn = DistNtt(moduli, N, mesh)
    rng = np.random.default_rng(2)
    x = np.stack([np.stack([rng.integers(0, q, N, dtype=np.uint64)
                            for q in moduli]) for _ in range(3)])  # (3, L, n)
    np.testing.assert_array_equal(np.asarray(dn.ntt(x)),
                                  ntt_mod.ntt(np, x.copy(), ring))


@pytest.mark.parametrize('wb,bits', [(64, 50), (32, 31)])
def test_coeff_sharded_keyswitch_bit_exact(wb, bits):
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    mesh = _mesh(4)
    q = gen_ntt_primes(N, bits, 4)
    p = gen_ntt_primes(N, bits, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, 65537, q, p, word_bits=wb)
    ctx = BfvContext.create_random_context(params, seed=31)
    level = 3
    sw = ctx.engine.switcher
    rng = np.random.default_rng(3)
    dt = np.uint64 if wb == 64 else np.uint32
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64).astype(dt)
                  for qi in q[:level + 1]])
    ref0, ref1 = sw.switch(np, x, ctx.rlk, level)
    ks = CoeffShardedKeySwitcher(sw, level, mesh)
    got0, got1 = ks(x, ctx.rlk.key_q, ctx.rlk.key_p)
    np.testing.assert_array_equal(np.asarray(got0), ref0)
    np.testing.assert_array_equal(np.asarray(got1), ref1)


@pytest.mark.parametrize('wb,bits', [(64, 50), (32, 31)])
def test_limb_coeff_keyswitch_bit_exact(wb, bits):
    """2-D limb×coeff composition: digit axis sharded over 'limb'
    (psum_scatter) and the coefficient axis over 'coeff' (all_to_all
    NTTs) in ONE shard_map program — bit-exact vs the single-device
    switch (TP width = D_limb × D_coeff)."""
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.parallel.coeff_sharded import LimbCoeffKeySwitcher
    from lattisense_tpu.runtime import BfvContext
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip('need 8 virtual devices')
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ('limb', 'coeff'))
    q = gen_ntt_primes(N, bits, 4)
    p = gen_ntt_primes(N, bits, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, 65537, q, p, word_bits=wb)
    ctx = BfvContext.create_random_context(params, seed=33)
    level = 3
    sw = ctx.engine.switcher
    rng = np.random.default_rng(5)
    dt = np.uint64 if wb == 64 else np.uint32
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64).astype(dt)
                  for qi in q[:level + 1]])
    ref0, ref1 = sw.switch(np, x, ctx.rlk, level)
    ks = LimbCoeffKeySwitcher(sw, level, mesh)
    got0, got1 = ks(x, ctx.rlk.key_q, ctx.rlk.key_p)
    np.testing.assert_array_equal(np.asarray(got0), ref0)
    np.testing.assert_array_equal(np.asarray(got1), ref1)


@pytest.mark.parametrize('wb,bits', [(64, 50), (32, 31)])
def test_coeff_sharded_relin_and_rotate_decrypt(wb, bits):
    """End-to-end: coeff-sharded relinearization and rotation on a real
    ciphertext — bit-exact ciphertexts AND exact decryption."""
    from lattisense_tpu.frontend.custom_task import get_glk_col
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    from lattisense_tpu.schemes.galois import galois_elt_col
    from lattisense_tpu.schemes.types import Ciphertext
    from . import oracles

    mesh = _mesh(4)
    t = 65537
    q = gen_ntt_primes(N, bits, 4)
    p = gen_ntt_primes(N, bits, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, t, q, p, word_bits=wb)
    ctx = BfvContext.create_random_context(params, seed=32)
    ctx.gen_rotation_keys_for_rotations([1])
    level = 3
    rng = np.random.default_rng(4)
    m1 = rng.integers(0, t, N, dtype=np.uint64)
    m2 = rng.integers(0, t, N, dtype=np.uint64)
    a = ctx.encrypt(ctx.encode(m1, level))
    b = ctx.encrypt(ctx.encode(m2, level))
    ct3 = ctx.mult(a, b)

    # relinearization
    ref = ctx.engine.relinearize(np, ct3, ctx.rlk)
    relin = CoeffShardedRelin(ctx.engine.switcher, level, mesh)
    got = relin(np.asarray(ct3.data), ctx.rlk)
    np.testing.assert_array_equal(got, np.asarray(ref.data))
    ct = Ciphertext(data=got, level=level)
    np.testing.assert_array_equal(ctx.decrypt_decode(ct),
                                  oracles.vec_mod_mul(m1, m2, t))

    # rotation (direct Galois key, coeff-domain ct)
    elt = galois_elt_col(1, N)
    glk = ctx.glk.keys[elt]
    ref_rot = ctx.engine.apply_galois(np, ct, elt, glk)
    rot = CoeffShardedRotator(ctx.engine.switcher, level, mesh, elt)
    got_rot = rot(got, glk)
    np.testing.assert_array_equal(got_rot, np.asarray(ref_rot.data))
    ct_rot = Ciphertext(data=got_rot, level=level)
    np.testing.assert_array_equal(
        ctx.decrypt_decode(ct_rot),
        oracles.vec_rotate_col(oracles.vec_mod_mul(m1, m2, t), 1))
