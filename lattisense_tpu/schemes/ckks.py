"""CKKS scheme engine (reference API parity: CkksContext,
fhe_ops_lib/fhe_lib_v2.h:831-1163).

Ciphertexts and plaintexts live in the NTT domain (matching the reference's
CkksCiphertextNode is_ntt=True convention, frontend/custom_task.py:755).
Multiplication is native RNS pointwise (no base extension); rescale divides
by the last prime with exact RNS rounding and tracks the scale. Sparse
packing (slots < n/2) is message replication (Lattigo convention),
set_log_slots parity with fhe_lib_v2.h:291.
"""

import functools

import numpy as np

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import get_rns_ring
from ..core.rns import DivRoundLast, _col, _mont
from ..params import CkksParams
from .types import Ciphertext, Plaintext, PlaintextRingt, PlaintextMul
from .keyswitch import KeySwitcher
from .galois import (apply_automorphism_ntt, galois_elt_col, galois_elt_row)
from .encoding import ckks_encode_values, ckks_decode_values


class CkksEngine:
    def __init__(self, params: CkksParams):
        self.params = params
        self.n = params.n
        self.q = tuple(params.q)
        self.p = tuple(params.p)
        self.word_bits = getattr(params, 'word_bits', 64)
        from ..core.u64 import word_dtype
        self.wdt = word_dtype(self.word_bits)
        self.switcher = KeySwitcher(self.q, self.p, self.n, self.word_bits)

    @functools.lru_cache(maxsize=None)
    def ring(self, level: int):
        return get_rns_ring(self.q[:level + 1], self.n, self.word_bits)

    @functools.lru_cache(maxsize=None)
    def rescaler(self, level: int) -> DivRoundLast:
        return DivRoundLast(self.q[:level + 1], self.word_bits)

    # ---- encode / decode (host) ----
    def encode(self, values, level: int, scale: float | None = None) -> Plaintext:
        scale = scale or self.params.scale
        coeffs = ckks_encode_values(values, self.n, self.params.slots, scale)
        ring = self.ring(level)
        data = np.stack([np.array([c % qi for c in coeffs], dtype=self.wdt)
                         for qi in self.q[:level + 1]])
        return Plaintext(data=ntt_mod.ntt(np, data, ring), level=level,
                         is_ntt=True, scale=scale)

    def encode_const(self, value: float, level: int,
                     scale: float | None = None, xp=np) -> Plaintext:
        """Exact scalar-constant plaintext, (L, 1)-compressed.

        A constant slot vector encodes to the constant polynomial
        round(v·Δ)·X⁰, whose NTT is the constant itself — one residue per
        limb. Shipping that as an (L, 1) column broadcast in-graph (pass
        ``xp=jnp`` inside a trace) keeps scalar constants out of the
        serialized HLO: a deg-39 EvalMod program carries ~45 of them, and
        at full (L, n) size they alone would dominate the program's size
        at the n=8192 toy bootstrap.
        Also exact: no embedding-FFT rounding noise (which reaches
        O(ε·Δ) ≈ ±100 absolute at Δ=2⁶⁰), so it strictly dominates
        ``encode(np.full(slots, v))`` for scalars. Valid for any slot
        packing (a constant is constant in every packing)."""
        scale = scale or self.params.scale
        c0 = int(round(float(value) * scale))
        col = np.array([c0 % qi for qi in self.q[:level + 1]], dtype=self.wdt)
        data = xp.broadcast_to(xp.asarray(col)[:, None],
                               (level + 1, self.n))
        return Plaintext(data=data, level=level, is_ntt=True, scale=scale)

    def encode_ringt(self, values, scale: float | None = None) -> PlaintextRingt:
        """Single-component plaintext: small signed integer coeffs, lifted to
        the chain at multiplication time."""
        scale = scale or self.params.scale
        coeffs = ckks_encode_values(values, self.n, self.params.slots, scale)
        assert all(abs(c) < (1 << 62) for c in coeffs), 'ringt coeffs overflow'
        return PlaintextRingt(data=np.array(coeffs, dtype=np.int64), scale=scale)

    def encode_mul(self, values, level: int, scale: float | None = None) -> PlaintextMul:
        pt = self.encode(values, level, scale)
        ring = self.ring(level)
        return PlaintextMul(data=_u.to_mont(np, pt.data, ring.q, ring.pinv, ring.r2),
                            level=level, scale=pt.scale)

    def decode(self, coeffs_signed, scale: float) -> np.ndarray:
        return ckks_decode_values(coeffs_signed, self.n, self.params.slots, scale)

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
            e_ntt = ntt_mod.ntt(np, lift_signed(sample_gaussian(rng, self.n),
                                                q_mods, self.word_bits), ring)
            c.append(_u.addmod(np, prod, e_ntt, ring.q))
        c0 = _u.addmod(np, c[0], pt.data, ring.q)
        return Ciphertext(data=np.stack([c0, c[1]]), level=level, is_ntt=True,
                          scale=pt.scale)

    def encrypt_symmetric(self, rng, sk, pt: Plaintext) -> Ciphertext:
        from .keys import sample_gaussian, lift_signed, sample_uniform_rns
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        a_ntt = sample_uniform_rns(rng, q_mods, self.n, self.word_bits)
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        as_ = _u.mulmod(np, a_ntt, s_ntt, ring.q, ring.pinv, ring.r2)
        e_ntt = ntt_mod.ntt(np, lift_signed(sample_gaussian(rng, self.n),
                                            q_mods, self.word_bits), ring)
        c0 = _u.addmod(np, _u.negmod(np, _u.addmod(np, as_, e_ntt, ring.q), ring.q),
                       pt.data, ring.q)
        return Ciphertext(data=np.stack([c0, a_ntt]), level=level, is_ntt=True,
                          scale=pt.scale)

    def encrypt_symmetric_compressed(self, rng, sk, pt: Plaintext, seed: int | None = None):
        """Seed-expanded symmetric encryption (reference fhe_lib_v2.h:1026);
        c1 lives in the NTT domain like every CKKS ciphertext component."""
        from .keys import sample_gaussian, lift_signed
        from ..utils.serialize import CompressedCiphertext, expand_uniform
        level = pt.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        if seed is None:
            # 128-bit seed for the seed-expanded c1 (see bfv.py counterpart).
            seed = (rng.seed_128() if hasattr(rng, 'seed_128')
                    else int(rng.integers(0, 1 << 62)))
        a_ntt = expand_uniform(seed, q_mods, self.n).astype(self.wdt)
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        as_ = _u.mulmod(np, a_ntt, s_ntt, ring.q, ring.pinv, ring.r2)
        e_ntt = ntt_mod.ntt(np, lift_signed(sample_gaussian(rng, self.n),
                                            q_mods, self.word_bits), ring)
        c0 = _u.addmod(np, _u.negmod(np, _u.addmod(np, as_, e_ntt, ring.q), ring.q),
                       pt.data, ring.q)
        return CompressedCiphertext(c0=c0, seed=seed, level=level, is_ntt=True,
                                    scale=pt.scale)

    def decompress_ciphertext(self, cct) -> Ciphertext:
        from ..utils.serialize import expand_uniform
        a_ntt = expand_uniform(cct.seed, self.q[:cct.level + 1],
                               self.n).astype(self.wdt)
        return Ciphertext(data=np.stack([cct.c0, a_ntt]), level=cct.level,
                          is_ntt=True, scale=cct.scale)

    def decrypt(self, sk, ct: Ciphertext) -> np.ndarray:
        """→ centered big-int coefficient array (n,) dtype=object."""
        level = ct.level
        ring = self.ring(level)
        q_mods = self.q[:level + 1]
        s_ntt = sk.ntt_form(tuple(q_mods), self.n, self.word_bits)
        acc = np.asarray(ct.data[0])
        s_pow = s_ntt
        for k in range(1, ct.data.shape[0]):
            term = _u.mulmod(np, np.asarray(ct.data[k]), s_pow, ring.q, ring.pinv, ring.r2)
            acc = _u.addmod(np, acc, term, ring.q)
            if k + 1 < ct.data.shape[0]:
                s_pow = _u.mulmod(np, s_pow, s_ntt, ring.q, ring.pinv, ring.r2)
        coeffs = ntt_mod.intt(np, acc, ring)
        Q = self.params.q_prod(level)
        X = np.zeros(self.n, dtype=object)
        for i, qi in enumerate(q_mods):
            Qi = Q // qi
            w = Qi * pow(Qi, -1, qi)
            X = X + coeffs[i].astype(object) * w
        X = X % Q
        return np.where(X > Q // 2, X - Q, X)

    def decrypt_decode(self, sk, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt(sk, ct), ct.scale)

    # ---- eval ops (xp-parametric) ----
    def _check_scales(self, a, b):
        if abs(a.scale - b.scale) > 1e-6 * max(a.scale, b.scale):
            raise ValueError(f'scale mismatch: {a.scale} vs {b.scale}')

    @staticmethod
    def _check_levels(a, b, op: str):
        if isinstance(b, Ciphertext) and a.level != b.level:
            raise ValueError(f'ciphertext level mismatch in {op}: '
                             f'{a.level} vs {b.level}')

    def add(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'add')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            self._check_scales(a, b)
            data = _u.addmod(xp, a.data, b.data, ring.q)
        elif isinstance(b, Plaintext):
            self._check_scales(a, b)
            c0 = _u.addmod(xp, a.data[0], b.data, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        elif isinstance(b, PlaintextRingt):
            self._check_scales(a, b)
            lifted = self._lift_ringt_ntt(xp, b, a.level)
            c0 = _u.addmod(xp, a.data[0], lifted, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        else:
            raise TypeError(type(b))
        return Ciphertext(data=data, level=a.level, is_ntt=True, scale=a.scale)

    def sub(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'sub')
        ring = self.ring(a.level)
        if isinstance(b, Ciphertext):
            self._check_scales(a, b)
            data = _u.submod(xp, a.data, b.data, ring.q)
        elif isinstance(b, Plaintext):
            self._check_scales(a, b)
            c0 = _u.submod(xp, a.data[0], b.data, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        elif isinstance(b, PlaintextRingt):
            self._check_scales(a, b)
            lifted = self._lift_ringt_ntt(xp, b, a.level)
            c0 = _u.submod(xp, a.data[0], lifted, ring.q)
            data = xp.concatenate([c0[None], a.data[1:]], axis=0)
        else:
            raise TypeError(type(b))
        return Ciphertext(data=data, level=a.level, is_ntt=True, scale=a.scale)

    def neg(self, xp, a: Ciphertext) -> Ciphertext:
        ring = self.ring(a.level)
        return Ciphertext(data=_u.negmod(xp, a.data, ring.q), level=a.level,
                          is_ntt=True, scale=a.scale)

    def _lift_ringt_ntt(self, xp, pt: PlaintextRingt, level: int):
        """Signed single-component coeffs → NTT form over Q_level."""
        ring = self.ring(level)
        c = pt.data
        pos = (c.astype(self.wdt) if xp is np
               else xp.asarray(c).astype(self.wdt))
        neg_mask = (c < 0)
        lifted = xp.where(neg_mask[None, :], pos[None, :] + ring.q, pos[None, :])
        lifted = xp.broadcast_to(lifted, (level + 1, self.n))
        return ntt_mod.ntt(xp, lifted, ring)

    def mult(self, xp, a: Ciphertext, b) -> Ciphertext:
        self._check_levels(a, b, 'mult')
        level = a.level
        ring = self.ring(level)
        if isinstance(b, Ciphertext):
            a0m = _u.to_mont(xp, a.data[0], ring.q, ring.pinv, ring.r2)
            a1m = _u.to_mont(xp, a.data[1], ring.q, ring.pinv, ring.r2)
            d0 = _u.mont_mul(xp, a0m, b.data[0], ring.q, ring.pinv)
            d1 = _u.addmod(xp, _u.mont_mul(xp, a0m, b.data[1], ring.q, ring.pinv),
                           _u.mont_mul(xp, a1m, b.data[0], ring.q, ring.pinv), ring.q)
            d2 = _u.mont_mul(xp, a1m, b.data[1], ring.q, ring.pinv)
            return Ciphertext(data=xp.stack([d0, d1, d2]), level=level, is_ntt=True,
                              scale=a.scale * b.scale)
        if isinstance(b, Plaintext):
            pm = _u.to_mont(xp, b.data, ring.q, ring.pinv, ring.r2)
            data = _u.mont_mul(xp, a.data, pm, ring.q, ring.pinv)
            return Ciphertext(data=data, level=level, is_ntt=True,
                              scale=a.scale * b.scale)
        if isinstance(b, PlaintextRingt):
            lifted = self._lift_ringt_ntt(xp, b, level)
            pm = _u.to_mont(xp, lifted, ring.q, ring.pinv, ring.r2)
            data = _u.mont_mul(xp, a.data, pm, ring.q, ring.pinv)
            return Ciphertext(data=data, level=level, is_ntt=True,
                              scale=a.scale * b.scale)
        if isinstance(b, PlaintextMul):
            data = _u.mont_mul(xp, a.data, b.data[:level + 1], ring.q, ring.pinv)
            return Ciphertext(data=data, level=level, is_ntt=True,
                              scale=a.scale * b.scale)
        raise TypeError(type(b))

    def relinearize(self, xp, ct3: Ciphertext, rlk) -> Ciphertext:
        level = ct3.level
        ring = self.ring(level)
        c2 = ntt_mod.intt(xp, ct3.data[2], ring)
        e0, e1 = self.switcher.switch(xp, c2, rlk, level, output_ntt=True)
        c0 = _u.addmod(xp, ct3.data[0], e0, ring.q)
        c1 = _u.addmod(xp, ct3.data[1], e1, ring.q)
        return Ciphertext(data=xp.stack([c0, c1]), level=level, is_ntt=True,
                          scale=ct3.scale)

    def rescale(self, xp, ct: Ciphertext, min_scale: float | None = None) -> Ciphertext:
        level = ct.level
        ring = self.ring(level)
        coeff = ntt_mod.intt(xp, ct.data, ring)
        dropped = self.rescaler(level)(xp, coeff)
        ring2 = self.ring(level - 1)
        data = ntt_mod.ntt(xp, dropped, ring2)
        return Ciphertext(data=data, level=level - 1, is_ntt=True,
                          scale=ct.scale / self.q[level])

    def drop_level(self, xp, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        return Ciphertext(data=ct.data[..., :ct.level + 1 - levels, :],
                          level=ct.level - levels, is_ntt=True, scale=ct.scale)

    def apply_galois(self, xp, ct: Ciphertext, galois_elt: int, glk) -> Ciphertext:
        level = ct.level
        ring = self.ring(level)
        c0 = apply_automorphism_ntt(xp, ct.data[0], self.n, galois_elt)
        c1 = apply_automorphism_ntt(xp, ct.data[1], self.n, galois_elt)
        e0, e1 = self.switcher.switch(xp, ntt_mod.intt(xp, c1, ring), glk, level,
                                      output_ntt=True)
        return Ciphertext(data=xp.stack([_u.addmod(xp, c0, e0, ring.q), e1]),
                          level=level, is_ntt=True, scale=ct.scale)

    def key_switch(self, xp, ct: Ciphertext, ksk) -> Ciphertext:
        """Re-key a ciphertext: decrypts under s_new given ksk encrypting
        s_old under s_new (bootstrap's dense↔sparse hops, swk_dts/swk_std)."""
        level = ct.level
        ring = self.ring(level)
        c1 = ntt_mod.intt(xp, ct.data[1], ring)
        e0, e1 = self.switcher.switch(xp, c1, ksk, level, output_ntt=True)
        return Ciphertext(data=xp.stack([_u.addmod(xp, ct.data[0], e0, ring.q), e1]),
                          level=level, is_ntt=True, scale=ct.scale)

    def bootstrap(self, xp, ct: Ciphertext, keys) -> Ciphertext:
        """Graph-runtime entry (OperationType.Bootstrap executor)."""
        btp = getattr(self, 'bootstrapper', None)
        if btp is None:
            raise RuntimeError('engine has no bootstrapper; use CkksBtpContext')
        swk = keys.get('swk', {})
        return btp(xp, ct, keys['rlk'], keys['glk'],
                   swk_dts=swk.get('swk_dts'), swk_std=swk.get('swk_std'))

    def rns_sp_decomp(self, xp, ct: Ciphertext):
        """Hoisted-rotation precompute (c1 decomposition; see bfv.py)."""
        from .types import DecomposedCiphertext
        c1 = ntt_mod.intt(xp, ct.data[1], self.ring(ct.level))
        digits = self.switcher.decompose_modup_ntt(xp, c1, ct.level)
        return DecomposedCiphertext(c0=ct.data[0], digits=digits, level=ct.level,
                                    is_ntt=True, scale=ct.scale)

    def apply_galois_decomposed(self, xp, dct, galois_elt: int, glk,
                                **_ignored) -> Ciphertext:
        from .galois import apply_automorphism_ntt
        level = dct.level
        ring = self.ring(level)
        c0 = apply_automorphism_ntt(xp, dct.c0, self.n, galois_elt)
        digits = apply_automorphism_ntt(xp, dct.digits, self.n, galois_elt)
        e0, e1 = self.switcher.switch_from_digits(xp, digits, glk, level,
                                                  output_ntt=True)
        return Ciphertext(data=xp.stack([_u.addmod(xp, c0, e0, ring.q), e1]),
                          level=level, is_ntt=True, scale=dct.scale)

    def rotate(self, xp, ct: Ciphertext, step: int, glk) -> Ciphertext:
        return self.apply_galois(xp, ct, galois_elt_col(step, self.n), glk)

    def conjugate(self, xp, ct: Ciphertext, glk) -> Ciphertext:
        return self.apply_galois(xp, ct, galois_elt_row(self.n), glk)

    def mult_scalar(self, xp, ct: Ciphertext, scalar: float) -> Ciphertext:
        """Multiply by a real scalar, encoded at the default scale."""
        enc = int(round(scalar * self.params.scale))
        ring = self.ring(ct.level)
        sm = _col([_mont(enc % qi, qi, self.word_bits)
                   for qi in self.q[:ct.level + 1]], self.word_bits)
        return Ciphertext(data=_u.mont_mul(xp, ct.data, sm, ring.q, ring.pinv),
                          level=ct.level, is_ntt=True,
                          scale=ct.scale * self.params.scale)
