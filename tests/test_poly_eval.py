"""Homomorphic Chebyshev evaluation vs plain Clenshaw oracle."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import CkksParams
from lattisense_tpu.runtime import CkksContext
from lattisense_tpu.schemes.poly_eval import (ChebyshevEvaluator, cheb_divmod,
                                              chebyshev_interpolate,
                                              eval_chebyshev_plain)

N = 64


def test_cheb_divmod_identity():
    rng = np.random.default_rng(0)
    for d, g in ((7, 4), (12, 8), (30, 16), (5, 4)):
        c = rng.uniform(-1, 1, d + 1)
        q, r = cheb_divmod(c, g)
        y = rng.uniform(-1, 1, 50)
        lhs = eval_chebyshev_plain(c, y)
        rhs = (eval_chebyshev_plain(q, y) * np.cos(g * np.arccos(y))
               + eval_chebyshev_plain(r, y))
        np.testing.assert_allclose(lhs, rhs, atol=1e-12)


def test_chebyshev_interpolate_sin():
    c = chebyshev_interpolate(np.sin, -3, 3, 23)
    y = np.linspace(-3, 3, 100)
    t = (2 * y) / 6
    np.testing.assert_allclose(eval_chebyshev_plain(c, t), np.sin(y), atol=1e-10)


@pytest.fixture(scope='module')
def ctx():
    big = gen_ntt_primes(N, 60, 2)
    mids = gen_ntt_primes(N, 45, 8)
    params = CkksParams.create_custom(N, [big[0]] + mids, [big[1]],
                                      scale=float(1 << 45))
    return CkksContext.create_random_context(params, seed=43)


def test_homomorphic_sine(ctx):
    """Degree-23 sine on [-3, 3]: the EvalMod workhorse shape."""
    rng = np.random.default_rng(2)
    level = ctx.params.max_level
    coeffs = chebyshev_interpolate(np.sin, -3, 3, 23)
    ev = ChebyshevEvaluator(ctx.engine, coeffs, -3, 3)

    v = rng.uniform(-3, 3, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(v, level))
    out = ev(np, ct, ctx.rlk)
    got = ctx.decrypt_decode(out).real
    np.testing.assert_allclose(got, np.sin(v), atol=1e-3)


def test_relu_and_step(ctx):
    from lattisense_tpu.schemes.poly_eval import poly_eval_relu, poly_eval_step
    rng = np.random.default_rng(3)
    level = ctx.params.max_level
    v = rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(v, level))
    got = ctx.decrypt_decode(poly_eval_relu(ctx.engine, np, ct, ctx.rlk)).real
    assert np.max(np.abs(got - np.maximum(v, 0))) < 0.15   # smooth approx
    ct = ctx.encrypt(ctx.encode(v, level))
    got = ctx.decrypt_decode(poly_eval_step(ctx.engine, np, ct, ctx.rlk)).real
    far = np.abs(v) > 0.25
    assert np.max(np.abs(got[far] - (v[far] > 0))) < 0.1


def test_encode_const_matches_full_encode(ctx):
    """encode_const (exact (L,1)-compressed scalar plaintext) must act on a
    ciphertext like the embedding-FFT full encode of the same constant —
    equal slots up to the FFT path's own rounding noise — in both the host
    (np) and traced (jnp, broadcast in-graph) forms. The compressed form is
    what keeps EvalMod's ~45 scalar constants out of the serialized HLO
    (schemes/ckks.py encode_const)."""
    import jax
    import jax.numpy as jnp
    eng = ctx.engine
    rng = np.random.default_rng(9)
    level = ctx.params.max_level
    v = rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(v, level))
    for c in (0.5, -3.25, 1.0):
        pt_full = eng.encode(np.full(ctx.params.slots, c), level)
        pt_col = eng.encode_const(c, level)
        assert pt_col.data.shape == pt_full.data.shape
        # constant NTT: every limb row is one repeated residue
        assert np.all(pt_col.data == pt_col.data[:, :1])
        got_full = ctx.decrypt_decode(eng.add(np, ct, pt_full)).real
        got_col = ctx.decrypt_decode(eng.add(np, ct, pt_col)).real
        np.testing.assert_allclose(got_col, got_full, atol=1e-9)
        np.testing.assert_allclose(got_col, v + c, atol=1e-9)

        def body(data):
            cc = type(ct)(data=data, level=level, is_ntt=True,
                          scale=ct.scale)
            return eng.mult(jnp, cc,
                            eng.encode_const(c, level, None, jnp)).data

        got_jit = np.asarray(jax.jit(body)(np.asarray(ct.data)))
        want = eng.mult(np, ct, eng.encode_const(c, level))
        assert np.array_equal(got_jit, np.asarray(want.data))


def test_staged_evaluation_matches_fused(ctx):
    """stages() folding is bit-identical to __call__ — the jit-boundary
    split that lets the full-size bootstrap EvalMod compile (the fused
    deg-39 program ran a compiler out of memory at n=2^16). Also pins
    the giant-basis trim: no basis
    entry beyond the top divmod block 2^(bit_length(d)-1) is built."""
    rng = np.random.default_rng(4)
    level = ctx.params.max_level
    coeffs = chebyshev_interpolate(np.sin, -1, 1, 39)
    ev = ChebyshevEvaluator(ctx.engine, coeffs, -1, 1)
    assert max(ev._all_keys()) == 32        # deg-39 top block; T64 trimmed

    v = rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(v, level))
    fused = ev(np, ct, ctx.rlk, anchor=ct.scale)

    # identical input ciphertext for both paths
    cts = [type(ct)(data=np.array(ct.data), level=ct.level,
                    is_ntt=ct.is_ntt, scale=ct.scale)]
    names = []
    for name, fn in ev.stages(ct.scale):
        cts = fn(np, cts, ctx.rlk)
        names.append(name)
    assert names == ['b', 'g', 'l', 'e']
    staged = cts[0]
    assert np.array_equal(fused.data, staged.data)
    assert (fused.level, fused.scale) == (staged.level, staged.scale)
    got = ctx.decrypt_decode(staged).real
    np.testing.assert_allclose(got, np.sin(v), atol=1e-3)
