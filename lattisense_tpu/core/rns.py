"""RNS basis conversion and scaling primitives (namespace-parametric).

Implements the integer-only BEHZ toolbox the reference obtains from
Lattigo's ring package (SURVEY.md §2.5): fast (approximate) base
conversion, the m̃-trick small Montgomery reduction (SmMRq) for *exact*
input extension, t/Q flooring, Shenoy–Kumaresan exact back-conversion, and
the divide-and-round-by-last-prime step shared by BFV modulus switching and
CKKS rescaling.

Everything is elementwise/broadcast u64 arithmetic over (..., L, n) limb
stacks — no gathers, no data-dependent control flow — so the same code runs
exactly on NumPy (golden) and as jitted XLA on the device.
"""

import math

import numpy as np

from . import u64 as _u
from ..params import MTILDE

_U64 = np.uint64


def _col(vals, bits: int = 64):
    from .u64 import word_dtype
    return np.array([int(v) % (1 << bits) for v in vals],
                    dtype=word_dtype(bits)).reshape(len(vals), 1)


def _mont(v: int, p: int, bits: int = 64) -> int:
    return (v << bits) % p


def _shoup(v: int, p: int, bits: int = 64) -> int:
    return (v << bits) // p


def _pinv(p: int, bits: int = 64) -> int:
    return (-pow(p, -1, 1 << bits)) % (1 << bits)


class BasisConv:
    """Fast base conversion src-basis → dst-basis (FastBConv).

    conv(x)_t = Σ_i [x_i · (Q/q_i)^-1]_{q_i} · [Q/q_i]_{d_t}  (mod d_t)
             = x + α·Q for some 0 ≤ α ≤ |src|  (approximate extension).
    """

    def __init__(self, src: tuple[int, ...], dst: tuple[int, ...],
                 word_bits: int = 64):
        from .u64 import word_dtype
        b = word_bits
        self.word_bits = b
        self.src = tuple(src)
        self.dst = tuple(dst)
        Q = math.prod(src)
        qhat = [Q // qi for qi in src]
        qhat_inv = [pow(h, -1, qi) for h, qi in zip(qhat, src)]
        self.src_q = _col(src, b)
        self.dst_q = _col(dst, b)
        self.dst_pinv = _col([_pinv(d, b) for d in dst], b)
        self.qhat_inv = _col(qhat_inv, b)
        self.qhat_inv_shoup = _col([_shoup(v, qi, b) for v, qi in zip(qhat_inv, src)], b)
        # [Q/q_i]_{d_t} in Montgomery form w.r.t. d_t: (T, L)
        self.qhat_dst_mont = np.array(
            [[_mont(qhat[i] % d, d, b) for i in range(len(src))] for d in dst],
            dtype=word_dtype(b))
        # m̃ image of the same conversion (for SmMRq)
        self.qhat_mtilde = np.array([qhat[i] % MTILDE for i in range(len(src))],
                                    dtype=word_dtype(b))

    def decompose(self, xp, x):
        """y_i = [x_i * (Q/q_i)^-1]_{q_i};  x: (..., L, n)."""
        return _u.shoup_mul(xp, x, self.qhat_inv, self.qhat_inv_shoup, self.src_q)

    def convert(self, xp, y):
        """Σ_i y_i * [Q/q_i]_{d_t} mod d_t;  y: (..., L, n) → (..., T, n).

        Vectorized over (T, L): one wide mont_mul on (..., T, L, n) plus a
        log-depth modular reduction tree — O(log L) traced ops instead of
        O(L·T), and full (T·L·n)-wide elementwise work per op.
        """
        terms = _u.mont_mul(xp, y[..., None, :, :], self.qhat_dst_mont[:, :, None],
                            self.dst_q[:, :, None], self.dst_pinv[:, :, None])
        return _u.modsum_tree(xp, terms, self.dst_q[:, :, None], axis=-2)

    def convert_mtilde(self, xp, y):
        """Same conversion targeting m̃ = 2^16 (masks only; the u64 sum of
        L < 2^16 32-bit terms cannot wrap)."""
        mask = y.dtype.type(MTILDE - 1)
        # dtype=: NumPy's sum() would promote u32 → u64; wrapping in the
        # word is exact mod m̃ (m̃ | 2^32), so keep the word dtype.
        return ((y & mask) * self.qhat_mtilde[:, None]).sum(
            axis=-2, dtype=y.dtype) & mask

    def __call__(self, xp, x):
        return self.convert(xp, self.decompose(xp, x))


class SmMRq:
    """BEHZ small Montgomery reduction mod m̃: removes the α·Q overflow of a
    FastBConv of [x·m̃]_Q, yielding x' ≡ x (mod Q) with ‖x'‖ ≤ Q(1+|src|)/2."""

    def __init__(self, src_q: tuple[int, ...], dst: tuple[int, ...],
                 word_bits: int = 64):
        b = word_bits
        Q = math.prod(src_q)
        self.neg_qinv_mtilde = (-pow(Q, -1, MTILDE)) % MTILDE
        self.dst_q = _col(dst, b)
        self.dst_pinv = _col([_pinv(d, b) for d in dst], b)
        self.q_mont = _col([_mont(Q % d, d, b) for d in dst], b)
        self.mtilde_inv_mont = _col([_mont(pow(MTILDE, -1, d), d, b) for d in dst], b)

    def __call__(self, xp, ext, ext_mtilde):
        """ext: (..., T, n) residues of x·m̃+αQ in dst; ext_mtilde: (..., n) mod m̃."""
        u64 = ext.dtype.type
        r = (ext_mtilde * u64(self.neg_qinv_mtilde)) & u64(MTILDE - 1)
        # center r to [-m̃/2, m̃/2): negative r maps to dst_q - (m̃ - r)
        r = r[..., None, :]
        big = r >= u64(MTILDE // 2)
        r_mod = xp.where(big, self.dst_q - (u64(MTILDE) - r), r)
        term = _u.mont_mul(xp, r_mod, self.q_mont, self.dst_q, self.dst_pinv)
        s = _u.addmod(xp, ext, term, self.dst_q)
        return _u.mont_mul(xp, s, self.mtilde_inv_mont, self.dst_q, self.dst_pinv)


class ExactExtend:
    """Exact extension R_Q → R_{B ∪ m_sk} (up to a bounded small multiple of Q):
    x ↦ [x·m̃]_Q → FastBConv → SmMRq. The workhorse of BEHZ BFV multiplication."""

    def __init__(self, src: tuple[int, ...], dst: tuple[int, ...],
                 word_bits: int = 64):
        b = word_bits
        self.src_q = _col(src, b)
        self.src_pinv = _col([_pinv(q, b) for q in src], b)
        self.mtilde_mont = _col([_mont(MTILDE % q, q, b) for q in src], b)
        self.conv = BasisConv(src, dst, b)
        self.smmrq = SmMRq(src, dst, b)

    def __call__(self, xp, x):
        xm = _u.mont_mul(xp, x, self.mtilde_mont, self.src_q, self.src_pinv)
        y = self.conv.decompose(xp, xm)
        ext = self.conv.convert(xp, y)
        ext_mt = self.conv.convert_mtilde(xp, y)
        return self.smmrq(xp, ext, ext_mt)


class ShenoyConvert:
    """Exact conversion B → Q using the redundant modulus m_sk
    (Shenoy–Kumaresan): corrects FastBConv's α·B overflow exactly."""

    def __init__(self, b_primes: tuple[int, ...], m_sk: int, dst: tuple[int, ...],
                 word_bits: int = 64):
        from .u64 import word_dtype
        wb = word_bits
        dt = word_dtype(wb)
        B = math.prod(b_primes)
        self.m_sk = m_sk
        self.conv = BasisConv(b_primes, tuple(dst) + (m_sk,), wb)
        self.binv_sk = pow(B % m_sk, -1, m_sk)
        self.sk_q = dt(m_sk)
        self.sk_pinv = dt(_pinv(m_sk, wb))
        self.binv_sk_mont = dt(_mont(self.binv_sk, m_sk, wb))
        self.dst_q = _col(dst, wb)
        self.dst_pinv = _col([_pinv(d, wb) for d in dst], wb)
        self.b_mont = _col([_mont(B % d, d, wb) for d in dst], wb)

    def __call__(self, xp, x_b, x_sk):
        """x_b: (..., T, n) residues in B; x_sk: (..., n) residue mod m_sk."""
        full = self.conv(xp, x_b)                 # (..., |dst|+1, n) = x + αB
        conv_q, conv_sk = full[..., :-1, :], full[..., -1, :]
        diff = _u.submod(xp, conv_sk, x_sk, self.sk_q)
        alpha = _u.mont_mul(xp, diff, self.binv_sk_mont, self.sk_q, self.sk_pinv)
        # α is small (≤ |B|); center to allow slight negatives from rounding.
        alpha = alpha[..., None, :]
        big = alpha >= (self.sk_q >> type(self.sk_q)(1))
        alpha_mod = xp.where(big, self.dst_q - (self.sk_q - alpha), alpha)
        corr = _u.mont_mul(xp, alpha_mod, self.b_mont, self.dst_q, self.dst_pinv)
        return _u.submod(xp, conv_q, corr, self.dst_q)


class DivRoundLast:
    """c' = round(c / q_last) on RNS limbs: the shared kernel of BFV modulus
    switching and CKKS rescale (drops the last limb)."""

    def __init__(self, moduli: tuple[int, ...], word_bits: int = 64):
        from .u64 import word_dtype
        b = word_bits
        assert len(moduli) >= 2
        q_last = moduli[-1]
        rest = moduli[:-1]
        self.q_last_half = word_dtype(b)((q_last + 1) // 2)
        self.dst_q = _col(rest, b)
        self.dst_pinv = _col([_pinv(d, b) for d in rest], b)
        self.qlast_inv_mont = _col([_mont(pow(q_last % d, -1, d), d, b) for d in rest], b)

    def __call__(self, xp, x):
        """x: (..., L, n) → (..., L-1, n)."""
        c_rest, c_last = x[..., :-1, :], x[..., -1:, :]
        a = _u.mont_mul(xp, c_last, self.qlast_inv_mont, self.dst_q, self.dst_pinv)
        b = _u.mont_mul(xp, c_rest, self.qlast_inv_mont, self.dst_q, self.dst_pinv)
        delta = (c_last >= self.q_last_half).astype(x.dtype)
        return _u.addmod(xp, _u.submod(xp, b, a, self.dst_q), delta, self.dst_q)
