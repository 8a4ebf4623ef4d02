"""Four-step negacyclic NTT/INTT on the matrix units (pure XLA, no kernel).

This module removes the butterflies entirely: an n-point NTT becomes TWO
modular matrix multiplies (R×C decomposition, R = 2^ceil(logn/2), C = n/R)
plus one pointwise twiddle — and the modular matmuls run on the matrix
units (tensor cores on a GPU) via digit-plane decomposition:

    value = Σ_d 2^(w·d) · digit_d,   digit_d ∈ [0, 2^w)   (w = 7, int8)

so X·A mod q = Σ_s (2^(w·s) mod q) · S_s with S_s = Σ_{d+e=s} X_d·A_e,
computed as ONE int8 dot_general (digit axes folded into the contraction
against a diagonally-banded constant tensor) with exact int32 accumulation,
then recombined with three u64 chunk folds + three Montgomery multiplies
per element. Everything stays in one XLA graph: neighboring elementwise
FHE math fuses into the recombination, and the forward/inverse cost is
symmetric by construction (no butterfly stage ordering — the round-1
"inverse 3x anomaly" cannot exist here).

Output convention matches core/ntt.py exactly (bit-reversed evaluation
order: position i holds the evaluation at ψ^(2·brv(i)+1)); asserted
bit-exact by tests/test_ntt_mxu.py.

MAC cost: 2 · D·C · S·R · R per limb-row (D=9 planes, S=17 diagonals)
≈ 0.6 GMAC at n=16384 — matrix-unit work replacing ~14 butterfly stages.

Exact while every accumulator stays below 2^24 (f32 with bf16 planes) or
2^31 (int32 with int8 planes); callers on a GPU run it under
``jax.default_matmul_precision('highest')`` so TF32 never enters. Primes
of 40 bits or fewer are not exact today (open: ROADMAP A3).
"""

import functools
import os

import numpy as np

_U64 = np.uint64
_DIGIT_BITS = 7
_BASE = 1 << _DIGIT_BITS
_HALF = _BASE // 2
_MASK = _U64(_BASE - 1)
# signed chunk offset (see _recombine): |chunk| < 2^58 << 2^59
_OFF = _U64(1 << 59)

# opt-in gate (validated bit-exact; default decided by end-to-end bench)
_ENABLED = os.environ.get('LATTISENSE_MXU_NTT', '0') not in ('', '0')
# bf16 planes + f32 accumulation (the default; exact because balanced
# digits keep |accum| < 2^24); LATTISENSE_MXU_I8DOT=1 uses int8 planes
_I8DOT = os.environ.get('LATTISENSE_MXU_I8DOT', '0') not in ('', '0')


def enabled(xp, n: int, dtype=None) -> bool:
    if dtype is not None and dtype.itemsize != 8:
        return False  # digit-plane decomposition is u64-specific
    return _ENABLED and xp.__name__ != 'numpy' and n >= 4096


def _brv(x: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


def _digits_balanced(mat: np.ndarray, planes: int) -> np.ndarray:
    """u64 (…) → BALANCED signed digit planes (planes, …) int8, digits in
    [-2^(w-1), 2^(w-1)): value = Σ_d b_d·2^(w·d). Balanced digits keep the
    f32 MXU accumulation exactly representable (|Σ| < 2^24)."""
    out = np.empty((planes,) + mat.shape, dtype=np.int8)
    carry = np.zeros(mat.shape, dtype=np.int64)
    for d in range(planes):
        u = ((mat >> _U64(_DIGIT_BITS * d)) & _MASK).astype(np.int64) + carry
        high = u >= _HALF
        out[d] = (u - _BASE * high).astype(np.int8)
        carry = high.astype(np.int64)
    assert not carry.any(), 'top digit overflow — modulus too wide'
    return out


def _banded(mat: np.ndarray, planes: int) -> np.ndarray:
    """Constant matrix (K, M) → diagonally-banded planes
    (D, K, S, M) int8 with band[d, :, s, :] = digit_{s-d}(mat)."""
    S = 2 * planes - 1
    dig = _digits_balanced(mat, planes)           # (D, K, M)
    out = np.zeros((planes, mat.shape[0], S, mat.shape[1]), dtype=np.int8)
    for d in range(planes):
        for e in range(planes):
            out[d, :, d + e, :] = dig[e]
    return out


class _LimbPlan:
    """Per-modulus four-step tables (forward + inverse)."""

    def __init__(self, r, R: int, C: int, planes: int):
        import math
        q, n = int(r.q), R * C
        psi, psi_inv = int(r.psi), int(r.psi_inv)
        omega = (psi * psi) % q
        omega_inv = pow(omega, -1, q)
        logR, logC = R.bit_length() - 1, C.bit_length() - 1
        brvR = [_brv(a, logR) for a in range(R)]
        brvC = [_brv(b, logC) for b in range(C)]

        def shoup(w):
            return (w << 64) // q

        # ---- forward: y[a·C+b] = Σ_j x[j]·ψ^j·ω^{e(a,b)·j},
        # e = brvC(b)·R + brvR(a), j = j1 + R·j2 ----
        A = np.empty((C, R), dtype=_U64)          # contract j2 → a
        for j2 in range(C):
            base = pow(psi, R * j2, q)
            wR = pow(omega, (R * j2) % n, q)
            for a in range(R):
                A[j2, a] = (base * pow(wR, brvR[a] % C, q)) % q
        T = np.empty((R, R), dtype=_U64)          # twiddle (j1, a)
        for j1 in range(R):
            pj = pow(psi, j1, q)
            for a in range(R):
                T[j1, a] = (pj * pow(omega, (brvR[a] * j1) % n, q)) % q
        B = np.empty((R, C), dtype=_U64)          # contract j1 → b
        for j1 in range(R):
            for b in range(C):
                B[j1, b] = pow(omega, (R * brvC[b] * j1) % n, q)

        # ---- inverse: x[C·j1'+j2'] = n^{-1} Σ_pos y[pos]·ψ^{-j·e(pos)}
        # (e over 2n: 2·brv(pos)+1), pos = a·C + b ----
        # j = C·j1' + j2' with j2' ∈ [0, C) low, j1' ∈ [0, R)
        W1 = np.empty((C, C), dtype=_U64)         # contract b → j2'
        for b in range(C):
            for j2p in range(C):
                W1[b, j2p] = pow(omega_inv, (R * brvC[b] * j2p) % n, q)
        Ti = np.empty((R, C), dtype=_U64)         # twiddle (a, j2')
        psi_inv2n = psi_inv
        for a in range(R):
            ea = 2 * brvR[a] + 1
            for j2p in range(C):
                Ti[a, j2p] = pow(psi_inv2n, (j2p * ea) % (2 * n), q)
        ninv = pow(n, -1, q)
        W2 = np.empty((R, R), dtype=_U64)         # contract a → j1'
        psiC_inv = pow(psi_inv2n, C, q)
        for a in range(R):
            ea = 2 * brvR[a] + 1
            for j1p in range(R):
                W2[a, j1p] = (ninv * pow(psiC_inv, (j1p * ea) % (2 * n), q)) % q

        self.q = _U64(q)
        self.pinv = _U64((-pow(q, -1, 1 << 64)) % (1 << 64))
        self.A = _banded(A, planes)               # (D, C, S, R)
        self.T = T
        self.T_sh = np.vectorize(shoup, otypes=[_U64])(T)
        self.B = _banded(B, planes)               # (D, R, S, C)
        self.W1 = _banded(W1, planes)             # (D, C, S, R)
        self.Ti = Ti
        self.Ti_sh = np.vectorize(shoup, otypes=[_U64])(Ti)
        self.W2 = _banded(W2, planes)             # (D, R, S, C)
        # chunk Montgomery constants: M_k = 2^{42k}·2^64 mod q → reduces
        # each exact u64 chunk straight to its mod-q contribution
        self.M = np.array([(1 << (64 + 6 * _DIGIT_BITS * k)) % q
                           for k in range(3)], dtype=_U64)
        # signed-chunk offset correction: Σ_k OFF·2^{42k} mod q
        self.offadj = _U64(sum((int(_OFF) << (6 * _DIGIT_BITS * k)) % q
                               for k in range(3)) % q)


@functools.lru_cache(maxsize=None)
def _plan(ring_key):
    ring = _RINGS[ring_key]
    n = ring.n
    logn = n.bit_length() - 1
    R = 1 << ((logn + 1) // 2)
    C = n // R
    qmax_bits = max(int(m).bit_length() for m in ring.moduli)
    # +2: balanced digits need top-digit headroom for the carry
    planes = -(-(qmax_bits + 2) // _DIGIT_BITS)
    limbs = [_LimbPlan(r, R, C, planes) for r in ring.rings]
    pack = {
        'R': R, 'C': C, 'D': planes, 'S': 2 * planes - 1,
        'q': np.array([p.q for p in limbs], dtype=_U64),
        'pinv': np.array([p.pinv for p in limbs], dtype=_U64),
        'M': np.stack([p.M for p in limbs]),               # (L, 3)
        'offadj': np.array([p.offadj for p in limbs], dtype=_U64),
        'A': np.stack([p.A for p in limbs]),               # (L, D, C, S, R)
        'T': np.stack([p.T for p in limbs]),
        'T_sh': np.stack([p.T_sh for p in limbs]),
        'B': np.stack([p.B for p in limbs]),               # (L, D, R, S, C)
        'W1': np.stack([p.W1 for p in limbs]),
        'Ti': np.stack([p.Ti for p in limbs]),
        'Ti_sh': np.stack([p.Ti_sh for p in limbs]),
        'W2': np.stack([p.W2 for p in limbs]),
    }
    return pack


_RINGS: dict = {}


def _ring_key(ring):
    key = (ring.moduli, ring.n)
    _RINGS[key] = ring
    return key


def _split_planes(xp, x, D):
    """u64 (..., L, P, Q) → balanced signed digit planes (..., L, D, P, Q)
    in the dot dtype (bf16 by default, int8 for the LATTISENSE_MXU_I8DOT
    path). Sequential carry chain, fused by XLA."""
    dt = xp.int8 if _I8DOT else xp.bfloat16
    planes = []
    carry = None
    for d in range(D):
        u = ((x >> _U64(_DIGIT_BITS * d)) & _MASK).astype(xp.int32)
        if carry is not None:
            u = u + carry
        high = u >= _HALF
        planes.append(xp.where(high, u - _BASE, u).astype(dt))
        carry = high.astype(xp.int32)
    return xp.stack(planes, axis=-3)


def _recombine(xp, s_blocks, q, pinv, M, offadj):
    """Signed diagonal sums (..., L, P, S, Q) → u64 (..., L, P, Q) mod q.

    Exact: chunk k sums diagonals [6k, 6k+6) as Σ S_s·2^{7(s-6k)}
    (|chunk| < 2^58); the +2^59 offset makes it unsigned for the
    Montgomery multiply, corrected once by offadj.
    q, pinv: (L, 1, 1); M: (L, 3, 1, 1); offadj: (L, 1, 1)."""
    from ..core import u64 as _u
    S = s_blocks.shape[-2]
    s64 = s_blocks.astype(xp.int64)
    out = None
    for k in range(3):
        lo, hi = 6 * k, min(6 * k + 6, S)
        if lo >= S:
            break
        chunk = s64[..., lo, :]
        for s in range(lo + 1, hi):
            chunk = chunk + (s64[..., s, :] << (_DIGIT_BITS * (s - lo)))
        u = (chunk + (1 << 59)).astype(xp.uint64)
        term = _u.mont_mul(xp, u, M[:, k], q, pinv)
        out = term if out is None else _u.addmod(xp, out, term, q)
    return _u.submod(xp, out, offadj, q)


def _mod_dot(xp, x_planes, banded, q, pinv, M, offadj, spec):
    """einsum over (digit, K) with exact accumulation + recombination."""
    if _I8DOT:
        s = xp.einsum(spec, x_planes, xp.asarray(banded),
                      preferred_element_type=xp.int32)
    else:
        s = xp.einsum(spec, x_planes,
                      xp.asarray(banded).astype(xp.bfloat16),
                      preferred_element_type=xp.float32)
    return _recombine(xp, s, q, pinv, M, offadj)


def ntt(xp, x, ring):
    """Forward negacyclic NTT, bit-exact twin of core.ntt.ntt."""
    from ..core import u64 as _u
    pk = _plan(_ring_key(ring))
    R, C, D = pk['R'], pk['C'], pk['D']
    L = x.shape[-2]
    n = x.shape[-1]
    batch = x.shape[:-2]
    q = pk['q'][:L].reshape(L, 1, 1)
    pinv = pk['pinv'][:L].reshape(L, 1, 1)
    M = pk['M'][:L].reshape(L, 3, 1, 1)
    oa = pk['offadj'][:L].reshape(L, 1, 1)
    # X[j1, j2] = x[j1 + R·j2] → x.reshape(C, R) has axes (j2, j1)
    x4 = x.reshape(*batch, L, C, R)
    xp_pl = _split_planes(xp, x4, D)                      # (..., L, D, C, R)
    # step 1: contract (d, j2) → Z (..., L, j1, a)
    z = _mod_dot(xp, xp_pl, pk['A'][:L], q, pinv, M, oa,
                 '...ldcj,ldcsa->...ljsa')
    # twiddle (j1, a)
    z = _u.shoup_mul(xp, z, pk['T'][:L], pk['T_sh'][:L], q)
    # step 2: contract (d, j1) → Y (..., L, a, b)
    zp = _split_planes(xp, z, D)                          # (..., L, D, j1, a)
    y = _mod_dot(xp, zp, pk['B'][:L], q, pinv, M, oa,
                 '...ldja,ldjsb->...lasb')
    return y.reshape(*batch, L, n)


def intt(xp, x, ring):
    """Inverse negacyclic NTT, bit-exact twin of core.ntt.intt."""
    from ..core import u64 as _u
    pk = _plan(_ring_key(ring))
    R, C, D = pk['R'], pk['C'], pk['D']
    L = x.shape[-2]
    n = x.shape[-1]
    batch = x.shape[:-2]
    q = pk['q'][:L].reshape(L, 1, 1)
    pinv = pk['pinv'][:L].reshape(L, 1, 1)
    M = pk['M'][:L].reshape(L, 3, 1, 1)
    oa = pk['offadj'][:L].reshape(L, 1, 1)
    # Y[a, b] = y[a·C + b] → reshape (R, C), axes (a, b)
    y4 = x.reshape(*batch, L, R, C)
    yp = _split_planes(xp, y4, D)                         # (..., L, D, a, b)
    # step 1: contract (d, b) → Z (..., L, a, j2')
    z = _mod_dot(xp, yp, pk['W1'][:L], q, pinv, M, oa,
                 '...ldab,ldbsj->...lasj')
    # twiddle (a, j2')
    z = _u.shoup_mul(xp, z, pk['Ti'][:L], pk['Ti_sh'][:L], q)
    # step 2: contract (d, a) → X (..., L, j2', j1')
    zp = _split_planes(xp, z, D)                          # (..., L, D, a, j2')
    out = _mod_dot(xp, zp, pk['W2'][:L], q, pinv, M, oa,
                   '...ldac,ldasj->...lcsj')
    # x[C·j1' + j2'] = out[j2', j1'] → swap to (j1', j2') then flatten
    return out.swapaxes(-1, -2).reshape(*batch, L, n)
