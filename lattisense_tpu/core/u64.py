"""Exact unsigned word-modular arithmetic, namespace-parametric (NumPy / JAX).

Every function below uses only wrapping add/sub/mul, shifts, masks and
compares on unsigned words, so results are exact on every backend. Wide
(double-word) products are assembled from four half-word partial products —
the classic mulhi-via-digits scheme (see SURVEY.md §7 "Hard parts").

All functions take an array namespace ``xp`` (``numpy`` or ``jax.numpy``) so
the golden host model and the device path share one implementation; the
golden model's independence comes from scheme-level plain-math oracles (the
reference's ``fhe_ops_lib/utils.h:59-80`` ``vec_mod_*`` semantics), not from
a separate modmul.

Montgomery reduction (REDC, R = 2^64) is the generic modmul; Shoup
multiplication is used where one operand is a precomputed constant (NTT
twiddles, key polynomials) — 6 wide muls instead of ~10.

Word-generic: every function dispatches on the array dtype. With u32 arrays
(prime chains < 2^31, R = 2^32, see ``params.BfvParams.create_tpu_param``)
the same formulas hold verbatim, with ``mulhi`` built from four 32-bit
multiplies of 16-bit digits. The reference's FPGA backend pins 31-bit
prime chains for the same hardware-word reason
(frontend/custom_task.py:215).
"""

MASK32 = (1 << 32) - 1
MASK16 = (1 << 16) - 1


def word_dtype(word_bits: int):
    import numpy as np
    if word_bits == 32:
        return np.uint32
    assert word_bits == 64, word_bits
    return np.uint64


def _mulhi32(xp, a, b):
    """High 32 bits of the 64-bit product a*b (u32 arrays) via 16-bit
    digits — all partials are exact in u32 (no carries possible: each
    sum < 2^32, see inline bounds)."""
    u32 = a.dtype.type
    ah = a >> u32(16)
    al = a & u32(MASK16)
    bh = b >> u32(16)
    bl = b & u32(MASK16)
    t = al * bl                                   # < 2^32
    mid1 = ah * bl + (t >> u32(16))               # < 2^32 - 2^17 + 2^16
    mid2 = al * bh + (mid1 & u32(MASK16))         # same bound
    return ah * bh + (mid1 >> u32(16)) + (mid2 >> u32(16))


def mulhi(xp, a, b):
    """High word of the double-word product a*b (same-width unsigned arrays)."""
    if a.dtype.itemsize == 4:
        return _mulhi32(xp, a, b)
    u64 = a.dtype.type
    ah = a >> u64(32)
    al = a & u64(MASK32)
    bh = b >> u64(32)
    bl = b & u64(MASK32)
    t = al * bl
    mid1 = ah * bl + (t >> u64(32))
    mid2 = al * bh + (mid1 & u64(MASK32))
    return ah * bh + (mid1 >> u64(32)) + (mid2 >> u64(32))


def mulwide(xp, a, b):
    """Full 128-bit product as (hi, lo) u64 pair."""
    return mulhi(xp, a, b), a * b


def addmod(xp, a, b, p):
    """(a + b) mod p for a, b in [0, p), p < 2^63."""
    s = a + b
    return xp.where(s >= p, s - p, s)


def submod(xp, a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b + p
    return xp.where(d >= p, d - p, d)


def negmod(xp, a, p):
    """(-a) mod p for a in [0, p)."""
    zero = xp.zeros_like(a)
    return xp.where(a == 0, zero, p - a)


def redc(xp, hi, lo, p, pinv):
    """Montgomery reduction: (hi*R + lo) * R^-1 mod p, result in [0, p);
    R = 2^word (2^64 for u64 arrays, 2^32 for u32 arrays).

    Requires hi*R + lo < p * R (true for products of values < p).
    ``pinv`` is -p^-1 mod R, in the same dtype.
    """
    m = lo * pinv
    t = hi + mulhi(xp, m, p) + (lo != 0).astype(lo.dtype)
    return xp.where(t >= p, t - p, t)


def mont_mul(xp, a, b, p, pinv):
    """a * b * R^-1 mod p (operands in [0, p)); R = 2^word."""
    assert a.dtype == b.dtype == p.dtype == pinv.dtype, \
        (a.dtype, b.dtype, p.dtype, pinv.dtype)
    hi, lo = mulwide(xp, a, b)
    return redc(xp, hi, lo, p, pinv)


def mulmod(xp, a, b, p, pinv, r2):
    """Generic exact a * b mod p via double Montgomery reduction.

    ``r2`` is 2^128 mod p. Cost ~2 REDC; prefer :func:`shoup_mul` /
    :func:`mont_mul` on hot paths with precomputable operands.
    """
    c = mont_mul(xp, a, b, p, pinv)       # a*b*R^-1
    return mont_mul(xp, c, r2, p, pinv)   # a*b*R^-1 * R^2 * R^-1 = a*b


def to_mont(xp, a, p, pinv, r2):
    """a * 2^64 mod p (enter Montgomery domain)."""
    return mont_mul(xp, a, r2, p, pinv)


def from_mont(xp, a, p, pinv):
    """a * 2^-64 mod p (leave Montgomery domain)."""
    zero = xp.zeros_like(a)
    return redc(xp, zero, a, p, pinv)


def modsum_tree(xp, x, p, axis: int, seq_threshold: int = 64):
    """Modular sum over ``axis``; entries must be in [0, p), ``p``
    broadcastable against the reduced shape. Result is canonical mod p and
    independent of summation order (modular addition is exactly
    associative), so the strategy is purely a performance choice:

    - short axes (≲64, every RNS limb/digit axis): an unrolled sequential
      fold — a pure elementwise chain over slices that XLA fuses into one
      kernel without materializing the full terms tensor (the padded
      halving variant forces a copy of the whole (…, L, n) intermediate);
    - long axes: pairwise halving to keep the traced op count logarithmic.
    """
    if axis < 0:
        axis += x.ndim
    size = x.shape[axis]
    if size <= seq_threshold:
        # slicing removes the reduced axis — drop p's placeholder dim too
        rel = x.ndim - axis
        if p.ndim >= rel:
            pa = p.ndim - rel
            assert p.shape[pa] == 1
            p = p.reshape(p.shape[:pa] + p.shape[pa + 1:])
        ix = [slice(None)] * x.ndim
        ix[axis] = 0
        acc = x[tuple(ix)]
        for k in range(1, size):
            ix[axis] = k
            acc = addmod(xp, acc, x[tuple(ix)], p)
        return acc
    # pad to a power of two with zeros
    pow2 = 1 << (size - 1).bit_length()
    if pow2 != size:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, pow2 - size)
        x = xp.pad(x, pad)
    while x.shape[axis] > 1:
        half = x.shape[axis] // 2
        ix_a = [slice(None)] * x.ndim
        ix_b = [slice(None)] * x.ndim
        ix_a[axis] = slice(0, half)
        ix_b[axis] = slice(half, 2 * half)
        x = addmod(xp, x[tuple(ix_a)], x[tuple(ix_b)], p)
    ix = [slice(None)] * x.ndim
    ix[axis] = 0
    return x[tuple(ix)]


def shoup_mul(xp, a, w, w_shoup, p):
    """a * w mod p where w is a constant with precomputed Shoup companion.

    ``w_shoup`` = floor(w * R / p), R = 2^word. Requires a < p (and w < p,
    p < 2^(word-1)). Constants must share the data dtype — a silent NumPy
    promotion here would pair data with constants built for the wrong R.
    """
    assert a.dtype == w.dtype == w_shoup.dtype == p.dtype, \
        (a.dtype, w.dtype, w_shoup.dtype, p.dtype)
    q = mulhi(xp, a, w_shoup)
    r = a * w - q * p
    return xp.where(r >= p, r - p, r)
