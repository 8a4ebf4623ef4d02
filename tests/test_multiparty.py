"""Multiparty threshold-BFV protocols end-to-end in-process, parties
exchanging *serialized* share bytes — the reference's test shape
(unittests/test_mp_lattigo.cpp:174-400)."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import BfvParams
from lattisense_tpu.schemes import multiparty as mp
from lattisense_tpu.schemes.bfv import BfvEngine
from lattisense_tpu.schemes.galois import galois_elt_col
from lattisense_tpu.schemes.keys import SecretKey

N, T, PARTIES = 64, 65537, 3


@pytest.fixture(scope='module', params=[64, 32], ids=['u64', 'w32'])
def setup(request):
    """Both RNS words: the u64 reference chains and the 31-bit
    (word_bits=32) profile — every protocol must hold on both."""
    if request.param == 64:
        q = gen_ntt_primes(N, 50, 3)
        p = gen_ntt_primes(N, 51, 1, exclude=tuple(q))
    else:
        chain = gen_ntt_primes(N, 31, 8)
        q, p = chain[:6], chain[6:8]
    params = BfvParams.create_custom(N, T, q, p, word_bits=request.param)
    eng = BfvEngine(params)
    parties = [mp.DBfvParty(params, seed=100 + i) for i in range(PARTIES)]
    joint = SecretKey(sum(p_.sk.coeffs for p_ in parties))
    # collective public key via serialized share exchange
    ckg = mp.CkgProtocol(params, crp_seed=7)
    blobs = [ckg.gen_share(p_).serialize() for p_ in parties]
    pk = ckg.aggregate([mp.PublicKeyShare.deserialize(b) for b in blobs])
    return params, eng, parties, joint, pk


def test_ckg_joint_encrypt_decrypt(setup):
    params, eng, parties, joint, pk = setup
    rng = np.random.default_rng(0)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ct = eng.encrypt_asymmetric(rng, pk, eng.encode(m, 2))
    np.testing.assert_array_equal(eng.decrypt_decode(joint, ct), m)


def test_rkg_two_round(setup):
    params, eng, parties, joint, pk = setup
    rkg = mp.RkgProtocol(params, crp_seed=11)
    r1 = [rkg.gen_share_round1(p_) for p_ in parties]
    agg1 = rkg.aggregate_round1(
        [mp.RelinKeyShareRound1.deserialize(s.serialize()) for s in r1])
    r2 = [rkg.gen_share_round2(p_, agg1) for p_ in parties]
    rlk = rkg.aggregate_round2(
        [mp.RelinKeyShareRound2.deserialize(s.serialize()) for s in r2], agg1)

    rng = np.random.default_rng(1)
    ma = rng.integers(0, 256, N, dtype=np.uint64)
    mb = rng.integers(0, 256, N, dtype=np.uint64)
    a = eng.encrypt_asymmetric(rng, pk, eng.encode(ma, 2))
    b = eng.encrypt_asymmetric(rng, pk, eng.encode(mb, 2))
    prod = eng.relinearize(np, eng.mult(np, a, b), rlk)
    expected = (ma.astype(object) * mb % T).astype(np.uint64)
    np.testing.assert_array_equal(eng.decrypt_decode(joint, prod), expected)


def test_rtg_collective_rotation(setup):
    params, eng, parties, joint, pk = setup
    elt = galois_elt_col(2, N)
    rtg = mp.RtgProtocol(params, elt, crp_seed=13)
    glk = rtg.aggregate([mp.GaloisKeyShare.deserialize(rtg.gen_share(p_).serialize())
                         for p_ in parties])
    rng = np.random.default_rng(2)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ct = eng.encrypt_asymmetric(rng, pk, eng.encode(m, 1))
    rot = eng.rotate_cols(np, ct, 2, glk)
    expected = np.roll(m.reshape(2, -1), -2, axis=1).reshape(-1)
    np.testing.assert_array_equal(eng.decrypt_decode(joint, rot), expected)


def test_e2s_s2e_roundtrip(setup):
    params, eng, parties, joint, pk = setup
    rng = np.random.default_rng(3)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ct = eng.encrypt_asymmetric(rng, pk, eng.encode(m, 2))

    e2s = mp.E2sProtocol(eng, level=2)
    shares, masks = zip(*[e2s.gen_share(p_, ct) for p_ in parties])
    residual = e2s.aggregate(
        ct, [mp.DecryptionShare.deserialize(s.serialize()) for s in shares])
    # additive reconstruction over Z_t
    total = residual.astype(np.int64)
    for mk in masks:
        total = (total + mk.astype(np.int64)) % T
    np.testing.assert_array_equal(total.astype(np.uint64), m)

    # S2E back under the joint key
    s2e = mp.S2eProtocol(eng, level=2, crp_seed=17)
    enc_shares = [s2e.gen_share(p_, mk) for p_, mk in zip(parties, masks)]
    ct2 = s2e.aggregate([mp.EncryptionShare.deserialize(s.serialize())
                         for s in enc_shares], residual)
    np.testing.assert_array_equal(eng.decrypt_decode(joint, ct2), m)


@pytest.mark.parametrize('permute', [False, True])
def test_collective_refresh(setup, permute):
    params, eng, parties, joint, pk = setup
    rng = np.random.default_rng(4)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ct = eng.encrypt_asymmetric(rng, pk, eng.encode(m, 2))
    # degrade noise: square without relin then treat deg-2 term... keep simple:
    # add the ct to itself several times (noise growth), then refresh
    noisy = ct
    for _ in range(6):
        noisy = eng.add(np, noisy, noisy)
        m = (m.astype(np.int64) * 2 % T).astype(np.uint64)

    perm = np.roll(np.arange(N), 5) if permute else None
    ref = mp.RefreshProtocol(eng, level=2, crp_seed=19, permutation=perm)
    shares = [mp.RefreshShare.deserialize(ref.gen_share(p_, noisy).serialize())
              for p_ in parties]
    fresh = ref.finalize(noisy, shares)
    got = eng.decrypt_decode(joint, fresh)
    expected = m if perm is None else m[perm]
    np.testing.assert_array_equal(got, expected)
