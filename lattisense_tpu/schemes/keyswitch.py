"""Hybrid RNS key switching (GHS / Lattigo-style gadget product).

switch(x, ksk) for x ∈ R_{Q_ℓ} (coeff domain) computes (e0, e1) with
e0 + e1·s ≈ x·s' (the key's target secret factor), by:

1. digit-decomposing x into β = ceil((ℓ+1)/α) groups of α = |P| limbs,
2. mod-up of each digit to Q_ℓ ∪ P (FastBConv; the α·Q_d overflow vanishes
   mod Q_ℓ and only adds P-bounded noise),
3. NTT, inner product with the key digits (Montgomery-form keys: one REDC
   per MAC), accumulate,
4. INTT and divide-and-round by P (approximate conversion P→Q_ℓ).

This replaces the reference's Lattigo key-switch kernels used by relin /
rotate executors (mega_ag_runners/cpu/mega_ag_executors_cpu.cpp:236,269).

Every stage is *vectorized over the digit axis*: the whole decomposition is
one (β, α, n)-shaped shoup_mul + one (β, T, α, n) mont_mul with a log-depth
modular reduction tree, and the gadget inner product is a single
(β, 2, T, n) mont_mul reduced over β — O(log β·L) traced ops, full-width
elementwise work, instead of the O(β·L) small-op loops a direct translation of the
reference would produce.
"""

import functools
import math

import numpy as np

from ..core import ntt as ntt_mod
from ..core import u64 as _u

from ..core.modring import get_rns_ring
from ..core.rns import BasisConv, _col, _mont, _shoup, _pinv

_U64 = np.uint64


class RoundDivP:
    """c' = round(c / P): exact mod-down Q_ℓ∪P → Q_ℓ.

    The FastBConv of the P-part overflows by v·P, v ∈ [0, |P|) NON-centered;
    carried into the division it becomes a -v error on every output
    coefficient. Convolved with the secret's partial-sum random walk
    (negacyclic wrap signs), the mean of v produced a COHERENT low-frequency
    error of ~2^20 absolute (measured round 2: 8e-7 relative per rotation at
    Δ=2^40 — the bootstrap precision floor). The HPS-style float estimate
    v = floor(Σ_j y_j/p_j) recovers the overflow exactly (misround
    probability ~2^-50, unbiased) and is added back, leaving only the
    ±1/2-centered division rounding (~2^4 incoherent)."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...],
                 word_bits: int = 64):
        b = word_bits
        P = math.prod(p_moduli)
        half = P // 2
        self.conv = BasisConv(p_moduli, q_moduli, b)
        self.p_q = _col(p_moduli, b)
        self.dst_q = _col(q_moduli, b)
        self.dst_pinv = _col([_pinv(q, b) for q in q_moduli], b)
        self.half_p = _col(
            [half % p for p in p_moduli], b)
        self.half_q = _col([half % q for q in q_moduli], b)
        self.pinv_mont = _col([_mont(pow(P % q, -1, q), q, b) for q in q_moduli], b)
        self.p_inv_f = (1.0 / np.array(p_moduli, dtype=np.float64)).reshape(
            len(p_moduli), 1)
        # w32 fixed-point overflow estimate (no float64 on the 32-bit
        # word path): Σ_j y_j·c_j
        # with c_j = floor(2^62/p_j) < 2^31; v = Σ >> 62 exactly unless the
        # fractional part is < α·2^-31 (unbiased, ~never)
        self.p_inv_fx = np.array([(1 << 62) // p for p in p_moduli],
                                 dtype=np.uint64).reshape(len(p_moduli), 1)

    def overflow(self, xp, y):
        """v = floor(Σ_j y_j/p_j) for decomposed digits y (..., |P|, n)."""
        if y.dtype.itemsize == 4:
            acc = (y.astype(xp.uint64) * self.p_inv_fx).sum(axis=-2)
            return (acc >> xp.uint64(62)).astype(y.dtype)
        frac = (y.astype(xp.float64) * self.p_inv_f).sum(axis=-2)
        return xp.floor(frac).astype(y.dtype)

    def __call__(self, xp, x_q, x_p):
        """x_q: (..., L, n), x_p: (..., |P|, n) → (..., L, n)."""
        xp2 = _u.addmod(xp, x_p, self.half_p, self.p_q)
        y = self.conv.decompose(xp, xp2)
        conv = self.conv.convert(xp, y)
        num = _u.submod(xp, _u.addmod(xp, x_q, self.half_q, self.dst_q), conv, self.dst_q)
        out = _u.mont_mul(xp, num, self.pinv_mont, self.dst_q, self.dst_pinv)
        # overflow correction (see class docstring): Σ_j y_j/p_j = δ + v
        # with δ = (x mod P)/P ∈ [0, 1), so v = floor(Σ frac)
        v = self.overflow(xp, y)[..., None, :]
        return _u.addmod(xp, out, v, self.dst_q)


class KeySwitcher:
    """Per-parameter key-switch engine; per-level precomputes are cached."""

    def __init__(self, q_moduli: tuple[int, ...], p_moduli: tuple[int, ...], n: int,
                 word_bits: int = 64):
        self.q_moduli = tuple(int(q) for q in q_moduli)
        self.p_moduli = tuple(int(p) for p in p_moduli)
        self.n = n
        self.word_bits = word_bits
        self.alpha = len(self.p_moduli)

    def beta(self, level: int) -> int:
        return (level + 1 + self.alpha - 1) // self.alpha

    @functools.lru_cache(maxsize=None)
    def _level_pre(self, level: int):
        """Stacked digit-decomposition constants for one level.

        Shapes: qhat_inv/shoup (β, α, 1) — zero in padded lanes (shoup_mul
        with a zero constant yields zero, so ragged last digits need no
        masking; qhat_conv (β, T, α) with T = L + |P|.
        """
        L = level + 1
        alpha, beta = self.alpha, self.beta(level)
        q = self.q_moduli[:L]
        qp = q + self.p_moduli
        T = len(qp)
        wb = self.word_bits
        from ..core.u64 import word_dtype
        wdt = word_dtype(wb)
        ring_qp = get_rns_ring(qp, self.n, wb)

        qhat_inv = np.zeros((beta, alpha, 1), dtype=wdt)
        qhat_inv_shoup = np.zeros((beta, alpha, 1), dtype=wdt)
        src_q = np.ones((beta, alpha, 1), dtype=wdt)
        qhat_conv = np.zeros((beta, T, alpha), dtype=wdt)
        for d in range(beta):
            grp = q[d * alpha:(d + 1) * alpha]
            Qd = math.prod(grp)
            for j, qi in enumerate(grp):
                h = Qd // qi
                hinv = pow(h, -1, qi)
                qhat_inv[d, j, 0] = hinv
                qhat_inv_shoup[d, j, 0] = _shoup(hinv, qi, wb)
                src_q[d, j, 0] = qi
                for t, dt in enumerate(qp):
                    qhat_conv[d, t, j] = _mont(h % dt, dt, wb)
        return ring_qp, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, \
            RoundDivP(q, self.p_moduli, wb)

    def decompose_modup_ntt(self, xp, x, level: int):
        """Digit-decompose + mod-up + NTT: x (..., L, n) coeff →
        (..., β, T, n) in NTT domain over Q_ℓ∪P. Exposed separately to
        implement hoisted rotations (reference rns_sp_decomp,
        frontend/custom_task.py:1360)."""
        ring_qp, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, _ = self._level_pre(level)
        L = level + 1
        alpha, beta = self.alpha, self.beta(level)
        pad = beta * alpha - L
        if pad:
            widths = [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, 0)]
            x = xp.pad(x, widths)
        xg = x.reshape(*x.shape[:-2], beta, alpha, self.n)
        y = _u.shoup_mul(xp, xg, qhat_inv, qhat_inv_shoup, src_q)
        # grouped FastBConv: (..., β, 1, α, n) × (β, T, α, 1) → Σ_α
        terms = _u.mont_mul(xp, y[..., :, None, :, :],
                            qhat_conv[:, :, :, None],
                            ring_qp.q[:, :, None],
                            ring_qp.pinv[:, :, None])
        xd = _u.modsum_tree(xp, terms, ring_qp.q[:, :, None], axis=-2)
        return ntt_mod.ntt(xp, xd, ring_qp)

    def inner_product(self, xp, digits_ntt, ksk, level: int):
        """Σ_d digit_d ⊙ key_d over Q_ℓ∪P (NTT domain) → pair of (..., T, n).

        digits_ntt: (..., β, T, n); keys in NTT+Montgomery form.
        """
        ring_qp, *_ = self._level_pre(level)
        L = level + 1
        beta = self.beta(level)
        kd = xp.concatenate([ksk.key_q[:beta, :, :L], ksk.key_p[:beta]], axis=2)
        terms = _u.mont_mul(xp, digits_ntt[..., :, None, :, :], kd,
                            ring_qp.q, ring_qp.pinv)
        acc = _u.modsum_tree(xp, terms, ring_qp.q, axis=-4)
        return acc[..., 0, :, :], acc[..., 1, :, :]

    def switch_from_digits(self, xp, digits, ksk, level: int,
                           output_ntt: bool = False):
        """Gadget product + mod-down from precomputed NTT-domain digits
        (..., β, T, n) — the hoisted-rotation entry point."""
        pre = self._level_pre(level)
        ring_qp, round_div = pre[0], pre[5]
        L = level + 1
        acc0, acc1 = self.inner_product(xp, digits, ksk, level)
        ring_q = get_rns_ring(self.q_moduli[:L], self.n, self.word_bits)
        outs = []
        for acc in (acc0, acc1):
            c = ntt_mod.intt(xp, acc, ring_qp)
            e = round_div(xp, c[..., :L, :], c[..., L:, :])
            if output_ntt:
                e = ntt_mod.ntt(xp, e, ring_q)
            outs.append(e)
        return outs[0], outs[1]

    def switch(self, xp, x, ksk, level: int, output_ntt: bool = False):
        """Full key switch of coeff-domain x (..., L, n) → (e0, e1) over Q_ℓ."""
        digits = self.decompose_modup_ntt(xp, x, level)
        return self.switch_from_digits(xp, digits, ksk, level, output_ntt)
