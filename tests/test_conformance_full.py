"""Reference-scale conformance: the op matrix at the REAL default chains
(n=8192 / 16384, every level, both schemes) — the reference's
pytest_generate_tests expansion (unittests/conftest.py:24-69, 34-51 cases
per suite with min_level/at_level hooks). Gated behind LATTISENSE_SLOW_TESTS
(~minutes); the n=65536 25-limb CKKS chain ladder additionally behind
LATTISENSE_HEAVY_TESTS.

BFV cases assert bit-exact equality against the plain-math oracles; CKKS
within precision tolerance (reference test strategy, SURVEY.md §4).
"""

import os

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.params import BfvParams, CkksParams
from lattisense_tpu.runtime import BfvContext, CkksContext

from . import oracles

pytestmark = pytest.mark.skipif(
    os.environ.get('LATTISENSE_SLOW_TESTS', '') in ('', '0'),
    reason='reference-scale tier (set LATTISENSE_SLOW_TESTS=1)')

_BFV_NS = (8192, 16384)
_CKKS_NS = (8192, 16384)


def pytest_generate_tests(metafunc):
    """Expand (n, level) over each default chain's full ladder — the
    reference's per-level hook (min_level markers)."""
    if 'bfv_nl' in metafunc.fixturenames:
        cases = []
        for n in _BFV_NS:
            for lv in range(1, BfvParams.create(n).max_level + 1):
                cases.append((n, lv))
        metafunc.parametrize('bfv_nl', cases,
                             ids=[f'n{n}_L{lv}' for n, lv in cases])
    if 'ckks_nl' in metafunc.fixturenames:
        cases = []
        for n in _CKKS_NS:
            for lv in range(1, CkksParams.create(n).max_level + 1):
                cases.append((n, lv))
        metafunc.parametrize('ckks_nl', cases,
                             ids=[f'n{n}_L{lv}' for n, lv in cases])


@pytest.fixture(scope='module')
def bfv_ctxs():
    out = {}
    for n in _BFV_NS:
        ctx = BfvContext.create_random_context(BfvParams.create(n), seed=71)
        ctx.gen_rotation_keys_for_rotations([1])
        out[n] = ctx
    return out


@pytest.fixture(scope='module')
def ckks_ctxs():
    return {n: CkksContext.create_random_context(CkksParams.create(n), seed=72)
            for n in _CKKS_NS}


def _bfv_msgs(ctx, k=2, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ctx.params.t, ctx.params.n, dtype=np.uint64)
            for _ in range(k)]


def test_bfv_full_chain_matrix(bfv_ctxs, bfv_nl):
    """add/sub/neg/ct×{pt,ringt,mul,ct}+relin/rotate at every level of the
    default chain — exact equality (reference test_cpu_bfv cases)."""
    n, level = bfv_nl
    ctx = bfv_ctxs[n]
    t = ctx.params.t
    m1, m2 = _bfv_msgs(ctx, seed=level)
    a = ctx.encrypt(ctx.encode(m1, level))
    b = ctx.encrypt(ctx.encode(m2, level))

    np.testing.assert_array_equal(ctx.decrypt_decode(ctx.add(a, b)),
                                  oracles.vec_mod_add(m1, m2, t))
    np.testing.assert_array_equal(ctx.decrypt_decode(ctx.sub(a, b)),
                                  oracles.vec_mod_sub(m1, m2, t))
    np.testing.assert_array_equal(ctx.decrypt_decode(ctx.neg(a)),
                                  oracles.vec_mod_neg(m1, t))
    exp_mul = oracles.vec_mod_mul(m1, m2, t)
    np.testing.assert_array_equal(
        ctx.decrypt_decode(ctx.mult(a, ctx.encode(m2, level))), exp_mul)
    np.testing.assert_array_equal(
        ctx.decrypt_decode(ctx.mult(a, ctx.encode_ringt(m2))), exp_mul)
    np.testing.assert_array_equal(
        ctx.decrypt_decode(ctx.mult(a, ctx.encode_mul(m2, level))), exp_mul)
    np.testing.assert_array_equal(ctx.decrypt_decode(ctx.mult_relin(a, b)),
                                  exp_mul)
    np.testing.assert_array_equal(ctx.decrypt_decode(ctx.rotate_cols(a, 1)),
                                  oracles.vec_rotate_col(m1, 1))
    if level >= 1:
        np.testing.assert_array_equal(
            ctx.decrypt_decode(ctx.rescale(ctx.mult_relin(a, b))), exp_mul)


def test_ckks_full_chain_matrix(ckks_ctxs, ckks_nl):
    """add/sub/neg/mult_relin_rescale/drop at every level of the default
    chain — precision-bounded (reference test_cpu_ckks cases)."""
    n, level = ckks_nl
    ctx = ckks_ctxs[n]
    rng = np.random.default_rng(level)
    v1 = rng.uniform(-1, 1, ctx.params.slots)
    v2 = rng.uniform(-1, 1, ctx.params.slots)
    a = ctx.encrypt(ctx.encode(v1, level))
    b = ctx.encrypt(ctx.encode(v2, level))

    # precision floor of a fresh ct on this chain scales like n/scale
    # (measured floors: ~1.8e-4 at n=8192/2^30, ~2e-5 at n=16384/2^34)
    tol = 64.0 * n / ctx.params.scale
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.add(a, b)).real, v1 + v2,
                               atol=tol)
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.sub(a, b)).real, v1 - v2,
                               atol=tol)
    got = ctx.decrypt_decode(ctx.rescale(ctx.mult_relin(a, b))).real
    np.testing.assert_allclose(got, v1 * v2, atol=tol)
    if level >= 2:
        from lattisense_tpu.schemes.ckks import CkksEngine
        assert isinstance(ctx.engine, CkksEngine)
        dropped = ctx.engine.drop_level(np, a, 1)
        np.testing.assert_allclose(ctx.decrypt_decode(dropped).real, v1,
                                   atol=tol)


def test_bfv_jit_bit_exact_n16384(bfv_ctxs, tmp_path):
    """Device(jit)-vs-eager bit-exactness at the REAL n=16384 tile shapes
    (XLA codegen bugs can be visible only at large shapes)."""
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import FheTaskTpu
    n, level = 16384, 3
    ctx = bfv_ctxs[n]
    fe = fct.BfvParam.create_default_param(n)
    fct.set_fhe_param(fe)
    x = fct.BfvCiphertextNode('x', level)
    y = fct.BfvCiphertextNode('y', level)
    z = fct.mult_relin(x, y, 'z')
    fct.process_custom_task([fct.Argument('x', x), fct.Argument('y', y)],
                            [fct.Argument('z', z)],
                            output_instruction_path=str(tmp_path))
    m1, m2 = _bfv_msgs(ctx, seed=9)
    ea = ctx.encrypt(ctx.encode(m1, level))
    eb = ctx.encrypt(ctx.encode(m2, level))
    eager, _ = FheTaskTpu(str(tmp_path), mode='eager').run(
        ctx, {'x': ea, 'y': eb})
    jit, _ = FheTaskTpu(str(tmp_path), mode='jit').run(
        ctx, {'x': ea, 'y': eb})
    np.testing.assert_array_equal(np.asarray(jit['z'].data),
                                  np.asarray(eager['z'].data))
    np.testing.assert_array_equal(ctx.decrypt_decode(jit['z']),
                                  oracles.vec_mod_mul(m1, m2, ctx.params.t))


@pytest.mark.skipif(os.environ.get('LATTISENSE_HEAVY_TESTS', '') in ('', '0'),
                    reason='25-limb n=65536 ladder (LATTISENSE_HEAVY_TESTS=1)')
def test_ckks_65536_full_chain_ladder():
    """The deepest default chain (n=65536, 25 limbs): mult_relin_rescale
    down the whole ladder — validates every level's rescale constants."""
    params = CkksParams.create(65536)
    ctx = CkksContext.create_random_context(params, seed=73)
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, params.slots)
    ct = ctx.encrypt(ctx.encode(v, params.max_level))
    acc = v.copy()
    ones = ctx.encrypt(ctx.encode(np.ones(params.slots), params.max_level))
    while ct.level >= 1:
        ct = ctx.rescale(ctx.mult_relin(ct, ctx.engine.drop_level(
            np, ones, ones.level - ct.level) if ones.level != ct.level else ones))
        got = ctx.decrypt_decode(ct).real
        np.testing.assert_allclose(got, acc, atol=5e-3)
