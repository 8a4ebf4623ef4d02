"""BFV scheme engine: encode/encrypt/decrypt (host) + eval ops (device-able).

Evaluation ops are namespace-parametric (xp ∈ {numpy, jax.numpy}) pure-array
functions so the graph runtime can jit them for the device; encode/encrypt/decrypt
use exact host big-int/NumPy math (they sit outside the compiled task graph
in the reference too — SDK side, cxx_sdk_v2).

Multiplication is the integer-only BEHZ RNS algorithm:
  exact-extend both ciphertexts Q_ℓ → B_ℓ ∪ m_sk (m̃-trick, core/rns.py),
  NTT tensor product over Q_ℓ and the auxiliary basis,
  scale by t/Q_ℓ (fastfloor), exact Shenoy–Kumaresan conversion back to Q_ℓ.
Correctness does not require centered representatives: the [0,Q) wrap
multiples have {0,1} coefficients and contribute ≤ ~n·t² noise (checked by
the conformance tests at every level).

Reference API parity: BfvContext ops in fhe_ops_lib/fhe_lib_v2.h:358-706.
"""

import functools
import math

import numpy as np

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import ExactExtend, ShenoyConvert, DivRoundLast, BasisConv, _col, _mont
from ..core.u64 import word_dtype
from ..params import BfvParams, bfv_aux_basis
from .types import Ciphertext, Plaintext, PlaintextRingt, PlaintextMul
from .keyswitch import KeySwitcher
from .galois import (apply_automorphism_coeff, galois_elt_col, galois_elt_row)
from .encoding import bfv_encode_slots, bfv_decode_slots

_U64 = np.uint64


class BehzMult:
    """Per-level precomputes for BEHZ multiplication."""

    def __init__(self, q: tuple[int, ...], aux: tuple[int, ...], m_sk: int,
                 t: int, n: int, word_bits: int = 64):
        wb = word_bits
        Q = math.prod(q)
        # take the shortest aux prefix whose product clears the tensor
        # bound t*n*4*Q (Shenoy needs ω < B); narrow words need ~2x limbs
        b = []
        prod_b = 1
        for prime in aux:
            b.append(prime)
            prod_b *= prime
            if len(b) > len(q) and prod_b > 8 * t * n * Q:
                break
        b = tuple(b)
        self.b_primes = b
        self.m_sk = m_sk
        self.t = t
        dst = b + (m_sk,)
        B = math.prod(b)
        assert B > 8 * t * n * Q, 'BEHZ auxiliary basis too small'
        self.extend = ExactExtend(q, dst, wb)
        self.ring_q = get_rns_ring(q, n, wb)
        self.ring_aux = get_rns_ring(dst, n, wb)
        self.shenoy = ShenoyConvert(b, m_sk, q, wb)
        self.conv_q_to_aux = BasisConv(q, dst, wb)
        self.t_mont_q = _col([_mont(t % qi, qi, wb) for qi in q], wb)
        self.t_mont_aux = _col([_mont(t % d, d, wb) for d in dst], wb)
        self.qinv_mont_aux = _col([_mont(pow(Q % d, -1, d), d, wb) for d in dst], wb)

    def scale_and_back(self, xp, d_q, d_aux):
        """round-ish(t/Q · X) mod Q for X given over Q (d_q) and B∪m_sk (d_aux)."""
        rq, ra = self.ring_q, self.ring_aux
        u = _u.mont_mul(xp, d_q, self.t_mont_q, rq.q, rq.pinv)            # [tX]_Q
        v = self.conv_q_to_aux(xp, u)                                     # + α'Q
        td = _u.mont_mul(xp, d_aux, self.t_mont_aux, ra.q, ra.pinv)
        w = _u.mont_mul(xp, _u.submod(xp, td, v, ra.q),
                        self.qinv_mont_aux, ra.q, ra.pinv)                # floor(tX/Q) - α'
        return self.shenoy(xp, w[..., :-1, :], w[..., -1, :])


class BfvEngine:
    def __init__(self, params: BfvParams):
        self.params = params
        self.n = params.n
        self.t = params.t
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.word_bits = getattr(params, 'word_bits', 64)
        self.wdt = word_dtype(self.word_bits)
        self.aux, self.m_sk = bfv_aux_basis(params.n, self.q, self.p,
                                            self.word_bits)
        self.switcher = KeySwitcher(self.q, self.p, self.n, self.word_bits)

    # ---- cached per-level helpers ----
    @functools.lru_cache(maxsize=None)
    def ring(self, level: int):
        return get_rns_ring(self.q[:level + 1], self.n, self.word_bits)

    @functools.lru_cache(maxsize=None)
    def behz(self, level: int) -> BehzMult:
        return BehzMult(self.q[:level + 1], self.aux, self.m_sk, self.t,
                        self.n, self.word_bits)

    @functools.lru_cache(maxsize=None)
    def rescaler(self, level: int) -> DivRoundLast:
        return DivRoundLast(self.q[:level + 1], self.word_bits)

    @functools.lru_cache(maxsize=None)
    def delta_mont(self, level: int) -> np.ndarray:
        """[Δ_ℓ]_{q_i} in Montgomery form, Δ_ℓ = floor(Q_ℓ/t)."""
        delta = self.params.delta(level)
        return _col([_mont(delta % qi, qi, self.word_bits)
                     for qi in self.q[:level + 1]], self.word_bits)

    # ---- encode / decode (host) ----
    def encode(self, values, level: int) -> Plaintext:
        """Slot-batched encode, scaled by round(m·Q/t) (exact big-int)."""
        m = bfv_encode_slots(values, self.t, self.n)
        Q = self.params.q_prod(level)
        scaled = [(int(c) * Q + self.t // 2) // self.t for c in m]
        data = np.stack([np.array([s % qi for s in scaled], dtype=self.wdt)
                         for qi in self.q[:level + 1]])
        return Plaintext(data=data, level=level)

    def encode_ringt(self, values) -> PlaintextRingt:
        return PlaintextRingt(data=bfv_encode_slots(values, self.t, self.n))

    def encode_mul(self, values, level: int) -> PlaintextMul:
        """NTT + Montgomery form of the unscaled message lifted to Q_ℓ."""
        m = bfv_encode_slots(values, self.t, self.n)
        ring = self.ring(level)
        lifted = np.broadcast_to(m, (level + 1, self.n)).astype(self.wdt)
        f = ntt_mod.ntt(np, lifted, ring)
        return PlaintextMul(data=_u.to_mont(np, f, ring.q, ring.pinv, ring.r2),
                            level=level)

    def decode(self, pt_mod_t: np.ndarray) -> np.ndarray:
        return bfv_decode_slots(pt_mod_t, self.t, self.n)

    # ---- coefficient-wise encodes (reference encode_coeffs{,_ringt,_mul},
    # fhe_lib_v2.h:358-706: the message is the polynomial itself) ----------
    def encode_coeffs(self, coeffs, level: int) -> Plaintext:
        m = np.zeros(self.n, dtype=_U64)
        vals = np.asarray(coeffs, dtype=_U64) % _U64(self.t)
        m[:len(vals)] = vals
        Q = self.params.q_prod(level)
        scaled = [(int(c) * Q + self.t // 2) // self.t for c in m]
        data = np.stack([np.array([s % qi for s in scaled], dtype=self.wdt)
                         for qi in self.q[:level + 1]])
        return Plaintext(data=data, level=level)

    def encode_coeffs_ringt(self, coeffs) -> PlaintextRingt:
        m = np.zeros(self.n, dtype=_U64)
        vals = np.asarray(coeffs, dtype=_U64) % _U64(self.t)
        m[:len(vals)] = vals
        return PlaintextRingt(data=m)

    def encode_coeffs_mul(self, coeffs, level: int) -> PlaintextMul:
        m = np.zeros(self.n, dtype=_U64)
        vals = np.asarray(coeffs, dtype=_U64) % _U64(self.t)
        m[:len(vals)] = vals
        ring = self.ring(level)
        lifted = np.broadcast_to(m, (level + 1, self.n)).astype(self.wdt)
        f = ntt_mod.ntt(np, lifted, ring)
        return PlaintextMul(data=_u.to_mont(np, f, ring.q, ring.pinv, ring.r2),
                            level=level)

    def decrypt_coeffs(self, sk, ct: Ciphertext) -> np.ndarray:
        """Decrypt to the raw plaintext polynomial mod t (no slot decode)."""
        return self.decrypt(sk, ct)

    # ---- encrypt / decrypt (host) ----
    def encrypt_asymmetric(self, rng, pk, pt: Plaintext) -> Ciphertext:
        from .keys import sample_ternary, sample_gaussian, lift_signed
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        u_ntt = ntt_mod.ntt(np, lift_signed(sample_ternary(rng, self.n), q_mods,
                                            self.word_bits), ring)
        c = []
        for j in range(2):
            prod = _u.mulmod(np, pk.data[j][:level + 1], u_ntt, ring.q, ring.pinv, ring.r2)
            poly = ntt_mod.intt(np, prod, ring)
            e = lift_signed(sample_gaussian(rng, self.n), q_mods, self.word_bits)
            c.append(_u.addmod(np, poly, e, ring.q))
        c0 = _u.addmod(np, c[0], pt.data, ring.q)
        return Ciphertext(data=np.stack([c0, c[1]]), level=level)

    def encrypt_symmetric(self, rng, sk, pt: Plaintext) -> Ciphertext:
        from .keys import sample_gaussian, lift_signed, sample_uniform_rns
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        a_ntt = sample_uniform_rns(rng, q_mods, self.n, self.word_bits)
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        as_ = ntt_mod.intt(np, _u.mulmod(np, a_ntt, s_ntt, ring.q, ring.pinv, ring.r2), ring)
        e = lift_signed(sample_gaussian(rng, self.n), q_mods, self.word_bits)
        c0 = _u.addmod(np, _u.negmod(np, _u.addmod(np, as_, e, ring.q), ring.q),
                       pt.data, ring.q)
        return Ciphertext(data=np.stack([c0, ntt_mod.intt(np, a_ntt, ring)]), level=level)

    def encrypt_symmetric_compressed(self, rng, sk, pt: Plaintext, seed: int | None = None):
        """Seed-expanded symmetric encryption: c1 = PRG(seed) is not stored
        (reference: encrypt_symmetric_compressed, fhe_lib_v2.h:561)."""
        from .keys import sample_gaussian, lift_signed
        from ..utils.serialize import CompressedCiphertext, expand_uniform
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        if seed is None:
            # 128-bit seed for the seed-expanded c1 (CSPRNG path when the
            # context rng is a CryptoRng; tests may pass plain np rngs).
            seed = (rng.seed_128() if hasattr(rng, 'seed_128')
                    else int(rng.integers(0, 1 << 62)))
        a_ntt = expand_uniform(seed, q_mods, self.n).astype(self.wdt)
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        as_ = ntt_mod.intt(np, _u.mulmod(np, a_ntt, s_ntt, ring.q, ring.pinv, ring.r2), ring)
        e = lift_signed(sample_gaussian(rng, self.n), q_mods, self.word_bits)
        c0 = _u.addmod(np, _u.negmod(np, _u.addmod(np, as_, e, ring.q), ring.q),
                       pt.data, ring.q)
        return CompressedCiphertext(c0=c0, seed=seed, level=level, is_ntt=False)

    def decompress_ciphertext(self, cct) -> Ciphertext:
        """(c0, seed) → full ciphertext (compressed_ciphertext_to_ciphertext)."""
        from ..utils.serialize import expand_uniform
        ring = self.ring(cct.level)
        a_ntt = expand_uniform(cct.seed, self.q[:cct.level + 1],
                               self.n).astype(self.wdt)
        return Ciphertext(data=np.stack([cct.c0, ntt_mod.intt(np, a_ntt, ring)]),
                          level=cct.level)

    def _decrypt_phase(self, sk, ct: Ciphertext):
        """Σ_k c_k·s^k CRT-reconstructed to big ints: (X mod Q, Q)."""
        level = ct.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        acc = np.asarray(ct.data[0])
        s_pow = s_ntt
        for k in range(1, ct.data.shape[0]):
            ck = ntt_mod.ntt(np, np.asarray(ct.data[k]), ring)
            term = ntt_mod.intt(np, _u.mulmod(np, ck, s_pow, ring.q, ring.pinv, ring.r2), ring)
            acc = _u.addmod(np, acc, term, ring.q)
            if k + 1 < ct.data.shape[0]:
                s_pow = _u.mulmod(np, s_pow, s_ntt, ring.q, ring.pinv, ring.r2)
        Q = self.params.q_prod(level)
        X = np.zeros(self.n, dtype=object)
        for i, qi in enumerate(q_mods):
            Qi = Q // qi
            w = Qi * pow(Qi, -1, qi)
            X = X + acc[i].astype(object) * w
        return X % Q, Q

    def decrypt(self, sk, ct: Ciphertext) -> np.ndarray:
        """→ plaintext poly mod t (n,) u64 (exact CRT + rounding)."""
        X, Q = self._decrypt_phase(sk, ct)
        m = np.array([((2 * self.t * int(x) + Q) // (2 * Q)) % self.t for x in X],
                     dtype=_U64)
        return m

    def noise_budget(self, sk, ct: Ciphertext) -> float:
        """Invariant-noise budget in bits (SEAL semantics): with
        v = (t/Q)·[Σ c_k s^k]_Q − m the rational invariant noise, the
        budget is −log2(2·‖v‖∞) = log2(Q / (2·‖t·X − Q·m‖∞)). Decryption
        is reliable while the budget is positive; each BFV multiply
        consumes a roughly constant number of bits. Debug/measurement
        aid — requires the secret key (no reference analog; the
        reference surfaces noise only as decryption failure)."""
        import math
        X, Q = self._decrypt_phase(sk, ct)
        t = self.t
        w_max = 0
        for x in X:
            m = ((2 * t * int(x) + Q) // (2 * Q)) % t
            w = t * int(x) - Q * m                 # exact integer noise·Q
            w = ((w + Q * t // 2) % (Q * t)) - Q * t // 2   # center mod Q·t
            w_max = max(w_max, abs(w))
        if w_max == 0:
            return float(math.log2(Q) - 1.0)
        return float(math.log2(Q) - 1.0 - math.log2(w_max))

    def decrypt_decode(self, sk, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt(sk, ct))

    # ---- eval ops (xp-parametric; arrays only) ----
    @staticmethod
    def _check_levels(a, b, op: str):
        if isinstance(b, Ciphertext) and a.level != b.level:
            raise ValueError(f'ciphertext level mismatch in {op}: '
                             f'{a.level} vs {b.level}')

    def add(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'add')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            data = _u.addmod(xp, a.data, b.data, ring.q)
        elif isinstance(b, Plaintext):
            c0 = _u.addmod(xp, a.data[0], b.data, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        elif isinstance(b, PlaintextRingt):
            dm = _u.mont_mul(xp, b.data[None, :].astype(self.wdt),
                             self.delta_mont(a.level), ring.q, ring.pinv)
            c0 = _u.addmod(xp, a.data[0], dm, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        else:
            raise TypeError(type(b))
        return Ciphertext(data=data, level=a.level, is_ntt=a.is_ntt)

    def sub(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'sub')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            data = _u.submod(xp, a.data, b.data, ring.q)
        elif isinstance(b, Plaintext):
            c0 = _u.submod(xp, a.data[0], b.data, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        elif isinstance(b, PlaintextRingt):
            dm = _u.mont_mul(xp, b.data[None, :].astype(self.wdt),
                             self.delta_mont(a.level), ring.q, ring.pinv)
            c0 = _u.submod(xp, a.data[0], dm, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        else:
            raise TypeError(type(b))
        return Ciphertext(data=data, level=a.level, is_ntt=a.is_ntt)

    def neg(self, xp, a: Ciphertext) -> Ciphertext:
        ring = self.ring(a.level)
        return Ciphertext(data=_u.negmod(xp, a.data, ring.q), level=a.level, is_ntt=a.is_ntt)

    def mult(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'mult')
        """ct⊗ct → ct3; ct×pt per plaintext format."""
        level = a.level
        ring = self.ring(level)
        if isinstance(b, Ciphertext):
            bz = self.behz(level)
            ra = bz.ring_aux
            # batch all four polys through extend/NTT: one (4, L, n) pass
            polys = xp.concatenate([a.data[:2], b.data[:2]], axis=0)
            ext = bz.extend(xp, polys)
            fq = _u.to_mont(xp, ntt_mod.ntt(xp, polys, ring), ring.q, ring.pinv, ring.r2)
            fa = _u.to_mont(xp, ntt_mod.ntt(xp, ext, ra), ra.q, ra.pinv, ra.r2)
            # tensor product: d0 = a0·b0, d1 = a0·b1 + a1·b0, d2 = a1·b1,
            # batched as a (3, L, n) stack
            def tensor(f, q, pinv):
                d0 = _u.mont_mul(xp, f[0], f[2], q, pinv)
                d1 = _u.addmod(xp, _u.mont_mul(xp, f[0], f[3], q, pinv),
                               _u.mont_mul(xp, f[1], f[2], q, pinv), q)
                d2 = _u.mont_mul(xp, f[1], f[3], q, pinv)
                return xp.stack([d0, d1, d2])

            dq = tensor(fq, ring.q, ring.pinv)
            da = tensor(fa, ra.q, ra.pinv)
            # leave Montgomery domain: two to_mont added two R, the product's
            # mont_mul removed one → strip the remaining R.
            dq = ntt_mod.intt(xp, _u.from_mont(xp, dq, ring.q, ring.pinv), ring)
            da = ntt_mod.intt(xp, _u.from_mont(xp, da, ra.q, ra.pinv), ra)
            return Ciphertext(data=bz.scale_and_back(xp, dq, da), level=level)
        if isinstance(b, Plaintext):
            bz = self.behz(level)
            ra = bz.ring_aux
            pe = bz.extend(xp, b.data)
            pq = _u.to_mont(xp, ntt_mod.ntt(xp, b.data, ring), ring.q, ring.pinv, ring.r2)
            pa = _u.to_mont(xp, ntt_mod.ntt(xp, pe, ra), ra.q, ra.pinv, ra.r2)
            ext = bz.extend(xp, a.data)
            dq = _u.mont_mul(xp, ntt_mod.ntt(xp, a.data, ring), pq, ring.q, ring.pinv)
            da = _u.mont_mul(xp, ntt_mod.ntt(xp, ext, ra), pa, ra.q, ra.pinv)
            dq = ntt_mod.intt(xp, dq, ring)
            da = ntt_mod.intt(xp, da, ra)
            return Ciphertext(data=bz.scale_and_back(xp, dq, da), level=level)
        if isinstance(b, PlaintextRingt):
            lifted = xp.broadcast_to(b.data.astype(self.wdt), (level + 1, self.n))
            f = _u.to_mont(xp, ntt_mod.ntt(xp, lifted, ring), ring.q, ring.pinv, ring.r2)
            ca = ntt_mod.ntt(xp, a.data, ring)
            prod = _u.mont_mul(xp, ca, f, ring.q, ring.pinv)
            return Ciphertext(data=ntt_mod.intt(xp, prod, ring), level=level)
        if isinstance(b, PlaintextMul):
            ca = ntt_mod.ntt(xp, a.data, ring)
            prod = _u.mont_mul(xp, ca, b.data[:level + 1], ring.q, ring.pinv)
            return Ciphertext(data=ntt_mod.intt(xp, prod, ring), level=level)
        raise TypeError(type(b))

    def relinearize(self, xp, ct3: Ciphertext, rlk) -> Ciphertext:
        level = ct3.level
        ring = self.ring(level)
        e0, e1 = self.switcher.switch(xp, ct3.data[2], rlk, level)
        c0 = _u.addmod(xp, ct3.data[0], e0, ring.q)
        c1 = _u.addmod(xp, ct3.data[1], e1, ring.q)
        return Ciphertext(data=xp.stack([c0, c1]), level=level)

    def rescale(self, xp, ct: Ciphertext) -> Ciphertext:
        """BFV modulus switching: drop the last prime, round exactly."""
        rs = self.rescaler(ct.level)
        return Ciphertext(data=rs(xp, ct.data), level=ct.level - 1, is_ntt=ct.is_ntt)

    def apply_galois(self, xp, ct: Ciphertext, galois_elt: int, glk,
                     out_ntt: bool | None = None,
                     out_mform: bool | None = None) -> Ciphertext:
        """Rotation on any ciphertext form: NTT/Montgomery inputs (the
        reference's FPGA-path chained rotations, advanced_rotate_cols with
        out_ct_type='ct-ntt'/'ct-ntt-mf') are normalized to coeff domain
        first; the output form defaults to the input form and can be forced
        (the out_ct_type contract)."""
        level = ct.level
        ring = self.ring(level)
        out_ntt = ct.is_ntt if out_ntt is None else out_ntt
        out_mform = ct.is_mform if out_mform is None else out_mform
        data = ct.data
        if ct.is_mform:
            data = _u.from_mont(xp, data, ring.q, ring.pinv)
        if ct.is_ntt:
            data = ntt_mod.intt(xp, data, ring)
        c0 = apply_automorphism_coeff(xp, data[0], ring.q, self.n, galois_elt)
        c1 = apply_automorphism_coeff(xp, data[1], ring.q, self.n, galois_elt)
        e0, e1 = self.switcher.switch(xp, c1, glk, level)
        out = xp.stack([_u.addmod(xp, c0, e0, ring.q), e1])
        if out_ntt:
            out = ntt_mod.ntt(xp, out, ring)
        if out_mform:
            out = _u.to_mont(xp, out, ring.q, ring.pinv, ring.r2)
        return Ciphertext(data=out, level=level, is_ntt=out_ntt,
                          is_mform=out_mform)

    # ---- hoisted rotations (reference rns_sp_decomp + advanced rotate on
    # decomposed input, frontend/custom_task.py:1360, SURVEY.md §5) ---------
    def rns_sp_decomp(self, xp, ct: Ciphertext):
        """Pay the digit-decomposition + mod-up + NTT of c1 once; the result
        is shared by every subsequent rotation of this ciphertext."""
        from .types import DecomposedCiphertext
        assert not ct.is_ntt
        digits = self.switcher.decompose_modup_ntt(xp, ct.data[1], ct.level)
        return DecomposedCiphertext(c0=ct.data[0], digits=digits, level=ct.level,
                                    is_ntt=False, scale=ct.scale)

    def apply_galois_decomposed(self, xp, dct, galois_elt: int, glk,
                                out_ntt: bool = False, out_mform: bool = False):
        """Hoisted rotation: σ_g commutes with the RNS digit decomposition,
        so it permutes the precomputed NTT-domain digits directly."""
        from .galois import apply_automorphism_ntt
        level = dct.level
        ring = self.ring(level)
        c0 = apply_automorphism_coeff(xp, dct.c0, ring.q, self.n, galois_elt)
        digits = apply_automorphism_ntt(xp, dct.digits, self.n, galois_elt)
        e0, e1 = self.switcher.switch_from_digits(xp, digits, glk, level,
                                                  output_ntt=out_ntt)
        if out_ntt:
            c0 = ntt_mod.ntt(xp, c0, ring)
        data = xp.stack([_u.addmod(xp, c0, e0, ring.q), e1])
        if out_mform:
            data = _u.to_mont(xp, data, ring.q, ring.pinv, ring.r2)
        return Ciphertext(data=data, level=level, is_ntt=out_ntt,
                          is_mform=out_mform, scale=dct.scale)

    def rotate_cols(self, xp, ct: Ciphertext, step: int, glk) -> Ciphertext:
        return self.apply_galois(xp, ct, galois_elt_col(step, self.n), glk)

    def rotate_rows(self, xp, ct: Ciphertext, glk) -> Ciphertext:
        return self.apply_galois(xp, ct, galois_elt_row(self.n), glk)

    def mult_scalar(self, xp, ct: Ciphertext, scalar: int) -> Ciphertext:
        ring = self.ring(ct.level)
        sm = _col([_mont(scalar % qi, qi, self.word_bits)
                   for qi in self.q[:ct.level + 1]], self.word_bits)
        return Ciphertext(data=_u.mont_mul(xp, ct.data, sm, ring.q, ring.pinv),
                          level=ct.level, is_ntt=ct.is_ntt)

    def drop_level(self, xp, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        # Limb truncation is NOT a valid BFV level drop: Δ = round(Q/t)
        # changes with Q, so the truncated ct decrypts incorrectly. The
        # graph runtime rejects drop_level on BFV for the same reason; a
        # proper BFV modulus switch would need Δ rescaling.
        raise NotImplementedError(
            'drop_level is not supported for BFV (Delta = round(Q/t) changes '
            'with Q); use CKKS drop_level or a full BFV modulus switch')

    # ---- ciphertext form conversions (reference ops to_ntt/to_mf/to_mul,
    # frontend/custom_task.py:1105-1136; used by the FPGA-format test matrix) --
    def to_ntt(self, xp, ct: Ciphertext) -> Ciphertext:
        assert not ct.is_ntt
        ring = self.ring(ct.level)
        return Ciphertext(data=ntt_mod.ntt(xp, ct.data, ring), level=ct.level,
                          is_ntt=True, is_mform=ct.is_mform)

    def to_inv_ntt(self, xp, ct: Ciphertext) -> Ciphertext:
        assert ct.is_ntt
        ring = self.ring(ct.level)
        return Ciphertext(data=ntt_mod.intt(xp, ct.data, ring), level=ct.level,
                          is_ntt=False, is_mform=ct.is_mform)

    def to_mf(self, xp, ct: Ciphertext) -> Ciphertext:
        assert not ct.is_mform
        ring = self.ring(ct.level)
        return Ciphertext(data=_u.to_mont(xp, ct.data, ring.q, ring.pinv, ring.r2),
                          level=ct.level, is_ntt=ct.is_ntt, is_mform=True)

    def to_mul(self, xp, ct: Ciphertext) -> Ciphertext:
        """coeff → NTT + Montgomery ("mul" form) in one pass."""
        assert not ct.is_ntt and not ct.is_mform
        ring = self.ring(ct.level)
        f = ntt_mod.ntt(xp, ct.data, ring)
        return Ciphertext(data=_u.to_mont(xp, f, ring.q, ring.pinv, ring.r2),
                          level=ct.level, is_ntt=True, is_mform=True)
