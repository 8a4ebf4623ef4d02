"""32-bit word (u32 / R=2^32) engine path: the 31-bit prime profile.

The reference's FPGA backend pins hardware-word-sized (31-bit) prime chains
(reference frontend/custom_task.py:215 create_fpga_parameter); the analog
here is word_bits=32 params (params.BfvParams.create_tpu_param) where all
RNS modmuls run on 32-bit words (core/u64.py).

Strategy: the same chain run at word_bits=32 and word_bits=64 must agree —
bitwise for word-local ops (sampling is dtype-stable by construction), and
on decryption for BEHZ multiplication (whose auxiliary basis is
word-sized, so ciphertext bits legitimately differ).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lattisense_tpu.core import u64 as _u
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.core import ntt as ntt_mod
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext

N = 64


@pytest.fixture(scope='module')
def chain31():
    return tuple(gen_ntt_primes(N, 31, 5))


@pytest.fixture(scope='module')
def ctx_pair(chain31):
    q, p = list(chain31[:4]), [chain31[4]]
    p32 = BfvParams.create_custom(N, 257, q, p, word_bits=32)
    p64 = BfvParams.create_custom(N, 257, q, p, word_bits=64)
    c32 = BfvContext.create_random_context(p32, seed=11)
    c64 = BfvContext.create_random_context(p64, seed=11)
    return c32, c64


def as64(a):
    return np.asarray(a).astype(np.uint64)


def test_mulhi32_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = _u.mulhi(np, a, b)
    want = ((a.astype(object) * b.astype(object)) >> 32).astype(np.uint64)
    assert np.array_equal(got.astype(np.uint64), want)


def test_u32_ring_tables(chain31):
    r32 = get_rns_ring(chain31, N, 32)
    r64 = get_rns_ring(chain31, N, 64)
    assert r32.q.dtype == np.uint32
    # twiddle VALUES are word-independent; only Shoup companions differ
    assert np.array_equal(as64(r32.psi_rev), np.asarray(r64.psi_rev))


def test_u32_ntt_matches_u64(chain31):
    r32 = get_rns_ring(chain31, N, 32)
    r64 = get_rns_ring(chain31, N, 64)
    rng = np.random.default_rng(1)
    x64 = np.stack([rng.integers(0, qi, N, dtype=np.uint64) for qi in chain31])
    f64 = ntt_mod.ntt(np, x64, r64)
    f32 = ntt_mod.ntt(np, x64.astype(np.uint32), r32)
    assert f32.dtype == np.uint32
    assert np.array_equal(as64(f32), f64)
    back = ntt_mod.intt(np, f32, r32)
    assert np.array_equal(as64(back), x64)


def test_u32_ntt_device_bit_exact(chain31):
    r32 = get_rns_ring(chain31, N, 32)
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, qi, N, dtype=np.uint64).astype(np.uint32)
                  for qi in chain31])
    host = ntt_mod.ntt(np, x, r32)
    dev = np.asarray(ntt_mod.ntt(jnp, jnp.asarray(x), r32))
    assert np.array_equal(host, dev)
    dev_inv = np.asarray(ntt_mod.intt(jnp, jnp.asarray(host), r32))
    assert np.array_equal(dev_inv, x)


def test_word_local_ops_bitwise_equal(ctx_pair):
    c32, c64 = ctx_pair
    msg_a = np.arange(N, dtype=np.int64) % 257
    msg_b = (np.arange(N, dtype=np.int64) * 3 + 1) % 257
    ea32, ea64 = c32.encrypt(c32.encode(msg_a, 3)), c64.encrypt(c64.encode(msg_a, 3))
    eb32, eb64 = c32.encrypt(c32.encode(msg_b, 3)), c64.encrypt(c64.encode(msg_b, 3))
    assert ea32.data.dtype == np.uint32
    assert np.array_equal(as64(ea32.data), np.asarray(ea64.data))
    s32 = c32.add(ea32, eb32)
    s64 = c64.add(ea64, eb64)
    assert np.array_equal(as64(s32.data), np.asarray(s64.data))
    d32, d64 = c32.sub(ea32, eb32), c64.sub(ea64, eb64)
    assert np.array_equal(as64(d32.data), np.asarray(d64.data))
    n32, n64 = c32.neg(ea32), c64.neg(ea64)
    assert np.array_equal(as64(n32.data), np.asarray(n64.data))
    r32, r64 = c32.rescale(s32), c64.rescale(s64)
    assert np.array_equal(as64(r32.data), np.asarray(r64.data))
    assert np.array_equal(c32.decrypt(r32), c64.decrypt(r64))


def test_rotation_bitwise_equal(ctx_pair):
    c32, c64 = ctx_pair
    c32.gen_rotation_keys_for_rotations([1], swap_rows=True)
    c64.gen_rotation_keys_for_rotations([1], swap_rows=True)
    msg = np.arange(N, dtype=np.int64) % 257
    e32, e64 = c32.encrypt(c32.encode(msg, 3)), c64.encrypt(c64.encode(msg, 3))
    ro32, ro64 = c32.rotate_cols(e32, 1), c64.rotate_cols(e64, 1)
    assert np.array_equal(as64(ro32.data), np.asarray(ro64.data))
    rr32, rr64 = c32.rotate_rows(e32), c64.rotate_rows(e64)
    assert np.array_equal(as64(rr32.data), np.asarray(rr64.data))


def test_mult_relin_decrypts_equal(ctx_pair):
    c32, c64 = ctx_pair
    msg_a = np.arange(N, dtype=np.int64) % 257
    msg_b = (np.arange(N, dtype=np.int64) * 5 + 2) % 257
    p32 = c32.mult_relin(c32.encrypt(c32.encode(msg_a, 3)),
                         c32.encrypt(c32.encode(msg_b, 3)))
    p64 = c64.mult_relin(c64.encrypt(c64.encode(msg_a, 3)),
                         c64.encrypt(c64.encode(msg_b, 3)))
    want = (msg_a * msg_b) % 257
    got32 = c32.decrypt_decode(p32)
    assert np.array_equal(got32, want)
    assert np.array_equal(got32, c64.decrypt_decode(p64))


def test_mult_relin_device_bit_exact(ctx_pair):
    c32, _ = ctx_pair
    msg_a = np.arange(N, dtype=np.int64) % 257
    msg_b = (np.arange(N, dtype=np.int64) * 7 + 3) % 257
    ea = c32.encrypt(c32.encode(msg_a, 3))
    eb = c32.encrypt(c32.encode(msg_b, 3))
    eng = c32.engine
    host = eng.relinearize(np, eng.mult(np, ea, eb), c32.rlk)
    import jax
    from lattisense_tpu.schemes.types import Ciphertext

    def dev_fn(a_data, b_data):
        a = Ciphertext(data=a_data, level=3)
        b = Ciphertext(data=b_data, level=3)
        return eng.relinearize(jnp, eng.mult(jnp, a, b), c32.rlk).data

    dev = np.asarray(jax.jit(dev_fn)(ea.data, eb.data))
    assert dev.dtype == np.uint32
    assert np.array_equal(dev, np.asarray(host.data))


def test_tpu_param_factory():
    from lattisense_tpu.utils.security import log_qp, security_bits
    p = BfvParams.create_tpu_param(16384)
    assert p.word_bits == 32
    assert all(q < (1 << 31) for q in p.q + p.p)
    assert all((q - 1) % (2 * 16384) == 0 for q in p.q + p.p)
    ref = BfvParams.create(16384)
    # security-classed: logQP floored INTO the default budget (never over
    # the standard table), at >= the default chain's level capability
    assert log_qp(p) <= log_qp(ref)
    assert security_bits(p) >= security_bits(ref) >= 128
    assert len(p.q) >= len(ref.q)
    assert p.t == ref.t


def test_pt_formats_word32(ctx_pair):
    c32, _ = ctx_pair
    msg = (np.arange(N, dtype=np.int64) * 11 + 4) % 257
    w = (np.arange(N, dtype=np.int64) * 2 + 1) % 257
    e = c32.encrypt(c32.encode(msg, 3))
    for pt in (c32.encode(w, 3), c32.encode_ringt(w), c32.encode_mul(w, 3)):
        got = c32.decrypt_decode(c32.mult(e, pt))
        assert np.array_equal(got, (msg * w) % 257), type(pt)
    got = c32.decrypt_decode(c32.add(e, c32.encode_ringt(w)))
    assert np.array_equal(got, (msg + w) % 257)


# ---------------------------------------------------------------------------
# CKKS 32-bit-word profile (reference CKKS FPGA profile analog:
# CkksParam.create_fpga_param pins 31-bit chains + 2^31 scale)
# ---------------------------------------------------------------------------

def test_ckks_tpu_param_factory():
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.utils.security import log_qp, security_bits
    p = CkksParams.create_tpu_param(4096)
    assert p.word_bits == 32
    assert all(q < (1 << 31) for q in p.q + p.p)
    ref = CkksParams.create(4096)
    assert log_qp(p) <= log_qp(ref) and security_bits(p) >= 128
    assert p.max_level >= 1                  # still multiplication-capable
    p16 = CkksParams.create_tpu_param(16384)
    assert security_bits(p16) >= 128
    assert len(p16.q) >= len(CkksParams.create(16384).q)


@pytest.fixture(scope='module')
def ckks_w32_ctx():
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksContext
    chain = tuple(gen_ntt_primes(N, 31, 7))
    params = CkksParams.create_custom(N, list(chain[:5]), list(chain[5:]),
                                      scale=float(1 << 30), word_bits=32)
    return CkksContext.create_random_context(params, seed=21)


def test_ckks_w32_mult_relin_rescale(ckks_w32_ctx):
    ctx = ckks_w32_ctx
    lvl = ctx.params.max_level
    rng = np.random.default_rng(3)
    msg = rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(msg, lvl))
    assert ct.data.dtype == np.uint32
    out = ctx.rescale(ctx.mult_relin(ct, ctx.encrypt(ctx.encode(msg, lvl))))
    err = np.max(np.abs(ctx.decrypt_decode(out).real - msg ** 2))
    assert err < 1e-3, err


def test_ckks_w32_rotate_and_formats(ckks_w32_ctx):
    ctx = ckks_w32_ctx
    lvl = ctx.params.max_level
    ctx.gen_rotation_keys_for_rotations([1, 2])
    rng = np.random.default_rng(4)
    msg = rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(msg, lvl))
    r = ctx.rotate_cols(ct, 2)
    err = np.max(np.abs(ctx.decrypt_decode(r).real - np.roll(msg, -2)))
    assert err < 1e-3, err
    for pt in (ctx.encode(msg, lvl), ctx.encode_mul(msg, lvl)):
        prod = ctx.rescale(ctx.mult(ct, pt))
        err = np.max(np.abs(ctx.decrypt_decode(prod).real - msg ** 2))
        assert err < 1e-3, (type(pt), err)


def test_ckks_w32_device_bit_exact(ckks_w32_ctx):
    import jax
    from lattisense_tpu.schemes.types import Ciphertext
    ctx = ckks_w32_ctx
    eng = ctx.engine
    lvl = ctx.params.max_level
    rng = np.random.default_rng(5)
    msg = rng.uniform(-1, 1, ctx.params.slots)
    a = ctx.encrypt(ctx.encode(msg, lvl))
    b = ctx.encrypt(ctx.encode(msg, lvl))
    sc = a.scale

    def step(x, y):
        ca = Ciphertext(data=x, level=lvl, is_ntt=True, scale=sc)
        cb = Ciphertext(data=y, level=lvl, is_ntt=True, scale=sc)
        return eng.rescale(jnp, eng.relinearize(
            jnp, eng.mult(jnp, ca, cb), ctx.rlk)).data

    host = np.asarray(step.__call__(a.data, b.data)) if False else None
    dev = np.asarray(jax.jit(step)(a.data, b.data))
    eager = np.asarray(step(jnp.asarray(a.data), jnp.asarray(b.data)))
    assert dev.dtype == np.uint32
    assert np.array_equal(dev, eager)
