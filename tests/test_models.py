"""Model zoo: build → compile → run → decode round trips (toy params)."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.frontend import custom_task as ct
from lattisense_tpu.models import (LogisticRegressionScore,
                                   PackedEuclideanDistance,
                                   PolynomialEvaluator, PackedConv2d)
from lattisense_tpu.params import BfvParams, CkksParams
from lattisense_tpu.runtime import BfvContext, CkksContext

N = 1024


def _ckks_toy(n):
    from lattisense_tpu.core.modring import gen_ntt_primes
    q = gen_ntt_primes(n, 50, 5)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    scale = float(1 << 40)
    fe = ct.CkksParam.create_custom_param(n=n, q=q, p=p, scale=scale,
                                          slots=n // 2)
    return fe, CkksParams.create_custom(n, q, p, scale=scale)


def _bfv_toy(n):
    from lattisense_tpu.core.modring import gen_ntt_primes
    q = gen_ntt_primes(n, 50, 5)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    fe = ct.BfvParam.create_custom_param(n=n, q=q, p=p, t=65537)
    return fe, BfvParams.create_custom(n, 65537, q, p)


@pytest.fixture(scope='module')
def ckks_ctx():
    fe, params = _ckks_toy(N)
    return fe, CkksContext.create_random_context(params, seed=21)


def test_logistic_regression_model(ckks_ctx, tmp_path):
    fe, ctx = ckks_ctx
    m = LogisticRegressionScore(fe, n_features=13)
    task = m.load(ctx)
    rng = np.random.default_rng(0)
    xv, wv, b = rng.uniform(-1, 1, 13), rng.uniform(-1, 1, 13), 0.5
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv, wv, b))
    got = m.decode_output(ctx, outputs)
    assert abs(got - (xv @ wv + b)) < 1e-2


def test_euclidean_distance_model(ckks_ctx):
    fe, ctx = ckks_ctx
    skip = ctx.params.slots // 8
    m = PackedEuclideanDistance(fe, pack=4, skip=skip)
    task = m.load(ctx)
    rng = np.random.default_rng(1)
    xv = rng.uniform(-1, 1, 4 * skip)
    wv = rng.uniform(-1, 1, 4 * skip)
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv, wv))
    got = m.decode_output(ctx, outputs)
    exp = ((xv - wv).reshape(4, skip) ** 2).sum(axis=0)
    np.testing.assert_allclose(got, exp, atol=1e-2)


def test_conv2d_model(ckks_ctx):
    fe, ctx = ckks_ctx
    m = PackedConv2d(fe, pack=2, input_shape=(4, 4), kernel_shape=(3, 3))
    task = m.load(ctx)
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, 2 * 16)
    w = rng.uniform(-1, 1, (2, 9))
    bias = 0.3
    inputs, xv = m.pack_inputs(ctx, img, w, bias)
    outputs, _ = task.run(ctx, inputs)
    got = m.decode_output(ctx, outputs)
    exp = m.reference_conv(xv, w, bias)
    assert np.max(np.abs(got - exp)) < 1e-2


@pytest.mark.parametrize('degree', [3, 7])
def test_polynomial_model(degree):
    fe, params = _bfv_toy(N)
    ctx = BfvContext.create_random_context(params, seed=23)
    m = PolynomialEvaluator(fe, degree=degree, top_level=4)
    task = m.load(ctx)
    rng = np.random.default_rng(3)
    xv = rng.integers(0, 50, params.n, dtype=np.uint64)
    coeffs = [int(c) for c in rng.integers(1, 50, degree + 1)]
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv, coeffs))
    got = m.decode_output(ctx, outputs).astype(object)
    x = xv.astype(object)
    exp = sum(c * x ** i for i, c in enumerate(coeffs)) % params.t
    np.testing.assert_array_equal(got, exp)


def test_encrypted_matvec_model(ckks_ctx, tmp_path):
    """BSGS diagonal y = A·x over all slots (hoisted baby rotations +
    fused cmp_sum MACs per giant step)."""
    from lattisense_tpu.models import EncryptedMatVec
    fe, ctx = ckks_ctx
    s = fe.slots
    rng = np.random.default_rng(3)
    A = rng.uniform(-1, 1, (s, s))
    m = EncryptedMatVec(fe, A, level=2)
    task = m.load(ctx)
    xv = rng.uniform(-1, 1, s)
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv))
    got = m.decode_output(ctx, outputs)
    np.testing.assert_allclose(got, A @ xv, atol=5e-3)


def test_encrypted_matvec_sparse_diagonals(ckks_ctx):
    """Zero diagonals are dropped from the graph (banded matrices cost
    proportionally fewer MACs and keys)."""
    from lattisense_tpu.models import EncryptedMatVec
    fe, ctx = ckks_ctx
    s = fe.slots
    rng = np.random.default_rng(4)
    A = np.zeros((s, s))
    k = np.arange(s)
    for d in (0, 1, 5):                     # three diagonals only
        A[k, (k + d) % s] = rng.uniform(-1, 1, s)
    m = EncryptedMatVec(fe, A, level=2)
    task = m.load(ctx)
    xv = rng.uniform(-1, 1, s)
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv))
    np.testing.assert_allclose(m.decode_output(ctx, outputs), A @ xv,
                               atol=5e-3)


def test_encrypted_matvec_w32(tmp_path):
    """Model zoo on the 31-bit-word profile (w32): the compiled
    task adopts the caller context's RNS word, u32 end-to-end."""
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.models import EncryptedMatVec
    chain = gen_ntt_primes(N, 31, 10)
    q, p = chain[:7], chain[7:10]
    scale = float(1 << 30)
    fe = ct.CkksParam.create_custom_param(n=N, q=q, p=p, scale=scale,
                                          slots=N // 2)
    params = CkksParams.create_custom(N, q, p, scale=scale, word_bits=32)
    ctx = CkksContext.create_random_context(params, seed=29)
    s = fe.slots
    rng = np.random.default_rng(6)
    A = rng.uniform(-1, 1, (s, s))
    m = EncryptedMatVec(fe, A, level=2)
    task = m.load(ctx)
    xv = rng.uniform(-1, 1, s)
    outputs, _ = task.run(ctx, m.pack_inputs(ctx, xv))
    got = m.decode_output(ctx, outputs)
    np.testing.assert_allclose(got, A @ xv, atol=5e-2)
