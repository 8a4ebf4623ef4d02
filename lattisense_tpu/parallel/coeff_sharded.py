"""Coefficient-axis (ring-dimension) sharding: the distributed NTT.

The second kernel-level sharding axis SURVEY §2.8 promises ("partition RNS
limbs (q_i) AND polynomial coefficients over a mesh; NTT butterfly stages
exchanged all-to-all"): one polynomial's n coefficients are split
contiguously over the mesh's ``coeff`` axis, so a single ciphertext — and a
whole bootstrap working set — can span devices on the n axis, lifting the
limb axis's TP-width cap (≤ L+1).

Distributed four-step negacyclic NTT (n = R·C, R = mesh width D, C = n/D;
device d owns x[d·C:(d+1)·C]):

1. pre-scale ψ^j (pointwise, local),
2. all_to_all #1: transpose the (R, C) view so each device holds all R rows
   of its C/D-column chunk,
3. R-point DFT across the former device axis (a tiny dense modular matmul
   with ω^{C·jr·kr}; R = D ≤ 16, so R² MACs per point ≪ the log C
   butterflies), then the four-step twiddle ω^{jc·kr} merged with the local
   ring's ψ_C^{-jc} (turning step 4's transform into a plain cyclic DFT
   computed by the NEGACYCLIC core kernel),
4. bit-reverse the kr axis and all_to_all #2 so device d receives the row
   kr = brv(d) over all columns,
5. local C-point core NTT (core/ntt.py — natural→bit-reversed).

The output lands contiguously sharded in exactly the single-device order:
out[d·C + t] = X[brv_C(t)·R + brv_R(d)] = brv_n-ordered evaluations, so
every downstream pointwise op (BEHZ conversions, gadget inner products,
rescale, mod-down) is LOCAL per coefficient shard. Bit-exactness vs
core.ntt is structural: all arithmetic is exact mod q and the composed
permutation equals brv_n (asserted by tests/test_coeff_sharded.py).

The inverse runs the same steps mirrored (local core INTT already divides
by C; R^{-1} is folded into the inverse R-point matmul constants).

Collective traffic per transform: 2 all_to_alls of n/D words per device — the
textbook lower bound for a transposed four-step FFT.

Reference anchors: the reference never splits one ciphertext across
devices (SURVEY §5); hoisting/BSGS structure that amortizes this
communication: the reference's frontend/bootstrap_params.py:96-236.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.modring import bit_reverse, get_rns_ring
from ..core.rns import _shoup
from ..core.u64 import word_dtype


class _RingView:
    """Duck-typed per-shard ring constants for core.ntt (``moduli`` absent
    on purpose so the fused-kernel dispatch gates fall through to the XLA
    path inside shard_map)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class DistNtt:
    """Distributed four-step negacyclic NTT/INTT over one mesh axis.

    Built per (moduli, n, mesh, axis); exposes trace-time *bodies*
    (``fwd_body``/``inv_body`` — callable inside an open shard_map over
    ``axis`` on local shards (..., L, C)) plus standalone jitted
    ``ntt``/``intt`` entries on global (..., L, n) arrays.
    """

    def __init__(self, moduli, n: int, mesh, axis: str = 'coeff',
                 word_bits: int = 64):
        self.moduli = tuple(int(m) for m in moduli)
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.word_bits = word_bits
        D = mesh.shape[axis]
        if D < 2 or D & (D - 1):
            raise ValueError(f'coeff mesh axis must be a power of two >= 2, '
                             f'got {D}')
        if n % (D * D):
            raise ValueError(f'n={n} must be divisible by D^2={D * D}')
        self.D = D
        self.C = C = n // D
        R = D
        L = len(self.moduli)
        dt = word_dtype(word_bits)
        ring_n = get_rns_ring(self.moduli, n, word_bits)
        ring_C = get_rns_ring(self.moduli, C, word_bits)
        self.ring_n = ring_n
        # local C-point ring as a view (bypasses fused-kernel dispatch)
        self._ring_C_view = _RingView(
            q=ring_C.q, pinv=ring_C.pinv, r1=ring_C.r1, r2=ring_C.r2,
            n_inv=ring_C.n_inv, n_inv_shoup=ring_C.n_inv_shoup,
            psi_rev=ring_C.psi_rev, psi_rev_shoup=ring_C.psi_rev_shoup,
            psi_inv_rev=ring_C.psi_inv_rev,
            psi_inv_rev_shoup=ring_C.psi_inv_rev_shoup)

        logR = R.bit_length() - 1
        self._brvR = np.array([bit_reverse(i, logR) for i in range(R)],
                              dtype=np.int32)

        pre = np.empty((L, n), dtype=dt)
        pre_sh = np.empty((L, n), dtype=dt)
        post = np.empty((L, n), dtype=dt)
        post_sh = np.empty((L, n), dtype=dt)
        WR = np.empty((L, R, R), dtype=dt)
        WR_sh = np.empty((L, R, R), dtype=dt)
        WRi = np.empty((L, R, R), dtype=dt)
        WRi_sh = np.empty((L, R, R), dtype=dt)
        twf = np.empty((L, R, C), dtype=dt)
        twf_sh = np.empty((L, R, C), dtype=dt)
        twi = np.empty((L, R, C), dtype=dt)
        twi_sh = np.empty((L, R, C), dtype=dt)
        for l, q in enumerate(self.moduli):
            psi = ring_n.rings[l].psi
            om = pow(psi, 2, q)
            om_inv = pow(om, -1, q)
            psiC = ring_C.rings[l].psi
            psiC_inv = pow(psiC, -1, q)
            R_inv = pow(R, -1, q)

            def put(dst, dst_s, idx, v):
                dst[idx] = v
                dst_s[idx] = _shoup(v, q, word_bits)

            pj, pij = 1, 1
            psi_inv = pow(psi, -1, q)
            for j in range(n):
                put(pre, pre_sh, (l, j), pj)
                put(post, post_sh, (l, j), pij)
                pj = (pj * psi) % q
                pij = (pij * psi_inv) % q
            omC = pow(om, C, q)
            omC_inv = pow(om_inv, C, q)
            for kr in range(R):
                for jr in range(R):
                    put(WR, WR_sh, (l, kr, jr), pow(omC, kr * jr, q))
                    # R^{-1} folded into the inverse matmul (jr, kr layout)
                    put(WRi, WRi_sh, (l, jr, kr),
                        (pow(omC_inv, kr * jr, q) * R_inv) % q)
            for kr in range(R):
                wk = pow(om, kr, q)
                wki = pow(om_inv, kr, q)
                a, ai = 1, 1          # ω^{jc·kr}, ω^{-jc·kr}
                b, bi = 1, 1          # ψ_C^{-jc}, ψ_C^{jc}
                e = bit_reverse(kr, logR)   # device that consumes row kr
                for jc in range(C):
                    put(twf, twf_sh, (l, kr, jc), (a * b) % q)
                    # inverse table pre-permuted: row index = DEVICE id
                    put(twi, twi_sh, (l, e, jc), (ai * bi) % q)
                    a, ai = (a * wk) % q, (ai * wki) % q
                    b, bi = (b * psiC_inv) % q, (bi * psiC) % q
        self._pre, self._pre_sh = pre, pre_sh
        self._post, self._post_sh = post, post_sh
        self._WR, self._WR_sh = WR, WR_sh
        self._WRi, self._WRi_sh = WRi, WRi_sh
        self._twf, self._twf_sh = twf, twf_sh
        self._twi, self._twi_sh = twi, twi_sh
        self._q_col = np.asarray(ring_n.q)           # (L, 1)

    # ------------------------------------------------------------------
    # trace-time bodies (inside shard_map over self.axis)
    # ------------------------------------------------------------------
    def _row_tables(self, rows):
        """Limb-axis slice of every per-limb table: rows = (start, size),
        start may be traced (limb×coeff composition: each limb shard
        transforms only its scattered output-limb rows)."""
        if rows is None:
            return (self._q_col, self._pre, self._pre_sh, self._post,
                    self._post_sh, self._WR, self._WR_sh, self._WRi,
                    self._WRi_sh, self._twf, self._twf_sh, self._twi,
                    self._twi_sh, self._ring_C_view)
        start, size = rows

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(jnp.asarray(a), start, size,
                                                axis=0)

        rc = self._ring_C_view
        view = _RingView(
            q=sl(rc.q), pinv=sl(rc.pinv), r1=sl(rc.r1), r2=sl(rc.r2),
            n_inv=sl(rc.n_inv), n_inv_shoup=sl(rc.n_inv_shoup),
            psi_rev=sl(rc.psi_rev), psi_rev_shoup=sl(rc.psi_rev_shoup),
            psi_inv_rev=sl(rc.psi_inv_rev),
            psi_inv_rev_shoup=sl(rc.psi_inv_rev_shoup))
        return (sl(self._q_col), sl(self._pre), sl(self._pre_sh),
                sl(self._post), sl(self._post_sh), sl(self._WR),
                sl(self._WR_sh), sl(self._WRi), sl(self._WRi_sh),
                sl(self._twf), sl(self._twf_sh), sl(self._twi),
                sl(self._twi_sh), view)

    def fwd_body(self, x, rows=None):
        """x: local shard (..., L, C) coeff domain → (..., L, C) shard of
        the global bit-reversed NTT output. ``rows=(start, size)`` uses
        only that limb-row slice of the tables (x's L axis must match)."""
        D, C, axis = self.D, self.C, self.axis
        d = jax.lax.axis_index(axis)
        (q_col, pre_t, pre_sh_t, _, _, WR, WR_sh, _, _, twf_t, twf_sh_t,
         _, _, ring_C) = self._row_tables(rows)
        q2 = q_col                                    # (L, 1)
        q3 = q2[:, None, :]                           # (L, 1, 1)
        q4 = q2[:, None, None, :]                     # (L, 1, 1, 1)
        pre = jax.lax.dynamic_slice_in_dim(jnp.asarray(pre_t),
                                           d * C, C, axis=1)
        pre_sh = jax.lax.dynamic_slice_in_dim(jnp.asarray(pre_sh_t),
                                              d * C, C, axis=1)
        x = _u.shoup_mul(jnp, x, pre, pre_sh, q2)
        lead = x.shape[:-1]
        xs = x.reshape(*lead, D, C // D)
        ax = xs.ndim - 2
        xs = jax.lax.all_to_all(xs, axis, split_axis=ax, concat_axis=ax,
                                tiled=True)           # (..., L, R=jr, C/D)
        # R-point DFT over jr: (..., L, 1, R, C/D) × (L, R, R, 1)
        terms = _u.shoup_mul(jnp, xs[..., None, :, :],
                             WR[:, :, :, None], WR_sh[:, :, :, None], q4)
        B = _u.modsum_tree(jnp, terms, q4, axis=-2)   # (..., L, kr, C/D)
        twf = jax.lax.dynamic_slice_in_dim(jnp.asarray(twf_t),
                                           d * (C // D), C // D, axis=2)
        twf_sh = jax.lax.dynamic_slice_in_dim(jnp.asarray(twf_sh_t),
                                              d * (C // D), C // D, axis=2)
        B = _u.shoup_mul(jnp, B, twf, twf_sh, q3)
        B = jnp.take(B, jnp.asarray(self._brvR), axis=-2)
        ax = B.ndim - 2
        B = jax.lax.all_to_all(B, axis, split_axis=ax, concat_axis=ax + 1,
                               tiled=True)            # (..., L, 1, C)
        y = B.reshape(*lead, C)
        return ntt_mod.ntt(jnp, y, ring_C)

    def inv_body(self, y, rows=None):
        """Inverse of fwd_body: local shard of the bit-reversed NTT →
        local shard of the natural-order coefficients (×n^{-1})."""
        D, C, axis = self.D, self.C, self.axis
        d = jax.lax.axis_index(axis)
        (q_col, _, _, post_t, post_sh_t, _, _, WRi, WRi_sh, _, _,
         twi_t, twi_sh_t, ring_C) = self._row_tables(rows)
        q2 = q_col
        q4 = q2[:, None, None, :]
        z = ntt_mod.intt(jnp, y, ring_C)              # (..., L, C)
        twi = jax.lax.dynamic_slice_in_dim(jnp.asarray(twi_t),
                                           d, 1, axis=1)[:, 0]
        twi_sh = jax.lax.dynamic_slice_in_dim(jnp.asarray(twi_sh_t),
                                              d, 1, axis=1)[:, 0]
        z = _u.shoup_mul(jnp, z, twi, twi_sh, q2)     # B[kr=brv(d), jc]
        lead = z.shape[:-1]
        zs = z.reshape(*lead, D, C // D)
        ax = zs.ndim - 2
        zs = jax.lax.all_to_all(zs, axis, split_axis=ax, concat_axis=ax,
                                tiled=True)           # axis -2: src s → kr=brv(s)
        zs = jnp.take(zs, jnp.asarray(self._brvR), axis=-2)  # natural kr
        terms = _u.shoup_mul(jnp, zs[..., None, :, :],
                             WRi[:, :, :, None], WRi_sh[:, :, :, None], q4)
        M = _u.modsum_tree(jnp, terms, q4, axis=-2)   # (..., L, jr, C/D)
        ax = M.ndim - 2
        M = jax.lax.all_to_all(M, axis, split_axis=ax, concat_axis=ax + 1,
                               tiled=True)
        M = M.reshape(*lead, C)
        post = jax.lax.dynamic_slice_in_dim(jnp.asarray(post_t),
                                            d * C, C, axis=1)
        post_sh = jax.lax.dynamic_slice_in_dim(jnp.asarray(post_sh_t),
                                               d * C, C, axis=1)
        return _u.shoup_mul(jnp, M, post, post_sh, q2)

    # ------------------------------------------------------------------
    # standalone jitted entries on global arrays
    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def _jitted(self, ndim: int, forward: bool):
        spec = P(*([None] * (ndim - 1)), self.axis)
        body = self.fwd_body if forward else self.inv_body
        return jax.jit(jax.shard_map(body, mesh=self.mesh, in_specs=(spec,),
                                     out_specs=spec, check_vma=False))

    def ntt(self, x):
        """Global (..., L, n) coeff-domain → bit-reversed NTT, coefficient-
        sharded end to end. Bit-identical to core.ntt."""
        return self._jitted(np.ndim(x), True)(x)

    def intt(self, x):
        return self._jitted(np.ndim(x), False)(x)


class CoeffShardedKeySwitcher:
    """Hybrid key switch with the COEFFICIENT axis sharded over the mesh.

    Twin of parallel.keyswitch_sharded.ShardedKeySwitcher (limb axis):
    here every non-NTT stage of the switch — digit decomposition, FastBConv
    mod-up, gadget inner product, mod-down — is pointwise per coefficient
    and runs LOCALLY on each shard; only the two distributed NTT transposes
    use collectives (4 all_to_alls per switch). Keys live coefficient-sharded on
    device, so key material also scales with 1/D per chip.

    Optionally composes with the ``limb`` mesh axis (digit-axis sharding +
    psum_scatter, the ShardedKeySwitcher pattern) into a 2-D limb×coeff
    kernel sharding: pass a mesh with both axes and ``limb_axis='limb'``.
    """

    def __init__(self, switcher, level: int, mesh, axis: str = 'coeff'):
        self.sw = switcher
        self.level = level
        self.mesh = mesh
        self.axis = axis
        L = level + 1
        self.L = L
        self.n = switcher.n
        self.alpha = switcher.alpha
        self.beta = switcher.beta(level)
        qp = switcher.q_moduli[:L] + switcher.p_moduli
        self.T = len(qp)
        wb = switcher.word_bits
        self.dntt = DistNtt(qp, self.n, mesh, axis, wb)
        (_, qhat_inv, qhat_inv_shoup, src_q, qhat_conv,
         self.round_div) = switcher._level_pre(level)
        self._qhat_inv = qhat_inv
        self._qhat_inv_shoup = qhat_inv_shoup
        self._src_q = src_q
        self._qhat_conv = qhat_conv
        self._qp_q = np.asarray(self.dntt.ring_n.q)        # (T, 1)
        self._qp_pinv = np.asarray(self.dntt.ring_n.pinv)
        self._spec_ct = P(None, self.axis)
        self._spec_kd = P(None, None, None, self.axis)
        self._switch_jit = jax.jit(jax.shard_map(
            self.switch_body, mesh=self.mesh,
            in_specs=(self._spec_ct, self._spec_kd),
            out_specs=P(None, None, self.axis), check_vma=False))

    def prep_keys(self, ksk):
        """KeySwitchKey → (β, 2, T, n) concatenated digit keys (shard the
        last axis over ``coeff`` when placing on the mesh)."""
        kq = np.asarray(ksk.key_q)[:self.beta, :, :self.L]
        kp = np.asarray(ksk.key_p)[:self.beta]
        return np.concatenate([kq, kp], axis=2)

    # ---- trace-time bodies (inside shard_map over self.axis) ----------
    def decompose_modup_ntt_body(self, x):
        """x local (L, C) coeff → NTT-domain digits (β, T, C) — the
        hoisted entry (rns_sp_decomp under coeff sharding)."""
        L, alpha, beta = self.L, self.alpha, self.beta
        pad = beta * alpha - L
        if pad:
            x = jnp.pad(x, ((0, pad), (0, 0)))
        xg = x.reshape(beta, alpha, x.shape[-1])
        y = _u.shoup_mul(jnp, xg, self._qhat_inv, self._qhat_inv_shoup,
                         self._src_q)
        terms = _u.mont_mul(jnp, y[:, None, :, :], self._qhat_conv[:, :, :, None],
                            self._qp_q[:, :, None], self._qp_pinv[:, :, None])
        xd = _u.modsum_tree(jnp, terms, self._qp_q[:, :, None], axis=-2)
        return self.dntt.fwd_body(xd)                 # (β, T, C)

    def from_digits_body(self, xd, kd):
        """Gadget inner product + distributed INTT + local mod-down.
        xd: (β, T, C) NTT-domain digit shards; kd: (β, 2, T, C) key shards.
        Returns (2, L, C) coeff-domain shards over Q_ℓ."""
        terms = _u.mont_mul(jnp, xd[:, None, :, :], kd, self._qp_q,
                            self._qp_pinv)
        acc = _u.modsum_tree(jnp, terms, self._qp_q, axis=0)   # (2, T, C)
        c = self.dntt.inv_body(acc)
        rd = self.round_div
        return rd(jnp, c[:, :self.L, :], c[:, self.L:, :])

    def switch_body(self, x, kd):
        return self.from_digits_body(self.decompose_modup_ntt_body(x), kd)

    # ---- host entry ----------------------------------------------------
    def __call__(self, x, key_q, key_p):
        """x: (L, n) coeff-domain; bit-identical to KeySwitcher.switch."""
        from ..schemes.types import KeySwitchKey
        ksk = KeySwitchKey(key_q=key_q, key_p=key_p, level=self.level,
                           sp_level=self.alpha - 1)
        kd = self.prep_keys(ksk)
        e = np.asarray(self._switch_jit(np.asarray(x), kd))
        return e[0], e[1]


class LimbCoeffKeySwitcher:
    """2-D kernel sharding: hybrid key switch over a ('limb', 'coeff')
    mesh.

    The digit (β) axis is sharded over ``limb`` exactly as
    ShardedKeySwitcher (each device computes its digit group's mod-up +
    distributed NTT + key product locally, one psum_scatter reduces over
    devices and scatters the T output-limb axis), while every polynomial's
    coefficient axis is simultaneously sharded over ``coeff`` (DistNtt's
    all_to_alls run only over the coeff axis; all other stages stay
    pointwise-local). TP width becomes D_limb × D_coeff, lifting the limb
    axis's β ≤ ⌈(L+1)/α⌉ cap.
    """

    def __init__(self, switcher, level: int, mesh,
                 limb_axis: str = 'limb', coeff_axis: str = 'coeff'):
        self.sw = switcher
        self.level = level
        self.mesh = mesh
        self.limb_axis = limb_axis
        self.coeff_axis = coeff_axis
        self.Dl = mesh.shape[limb_axis]
        self.Dc = mesh.shape[coeff_axis]
        L = level + 1
        self.L = L
        self.n = switcher.n
        self.alpha = switcher.alpha
        self.beta = switcher.beta(level)
        self.beta_pad = -(-self.beta // self.Dl) * self.Dl
        qp = switcher.q_moduli[:L] + switcher.p_moduli
        self.T = T = len(qp)
        self.T_pad = T_pad = -(-T // self.Dl) * self.Dl
        wb = switcher.word_bits
        dt = word_dtype(wb)
        self.wb = wb
        # one DistNtt over the T_pad-padded modulus list: fwd uses the
        # static (0, T) row slice, inv the traced scattered-row slice
        # (padding rows replicate the last real modulus — valid tables,
        # garbage data, discarded on the host)
        qp_pad = qp + (qp[-1],) * (T_pad - T)
        self.dntt = DistNtt(qp_pad, self.n, mesh, coeff_axis, wb)

        pre = switcher._level_pre(level)
        (_, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, self.round_div) = pre

        def padB(a):
            return _pad_axis0(np.asarray(a), self.beta_pad)

        self._qhat_inv = padB(qhat_inv)
        self._qhat_inv_shoup = padB(qhat_inv_shoup)
        src_qb = padB(np.broadcast_to(src_q, qhat_inv.shape).copy())
        src_qb[self.beta:] = 1
        self._src_q = src_qb.astype(dt)
        self._qhat_conv = padB(qhat_conv)
        ring_qp = get_rns_ring(qp, self.n, wb)
        self._qp_q = np.asarray(ring_qp.q)                       # (T, 1)
        self._qp_pinv = np.asarray(ring_qp.pinv)

        def padT(a, fill=0):
            a = np.asarray(a)
            k = a.shape[0]
            out = np.zeros((T_pad,) + a.shape[1:], dtype=a.dtype)
            out[:k] = a
            if fill and T_pad > k:
                out[k:] = fill
            return out

        self._qp_q_pad = padT(self._qp_q, 1).astype(dt)
        self._qp_pinv_pad = padT(self._qp_pinv, 1).astype(dt)
        rd = self.round_div
        self._rd_p_q = np.asarray(rd.p_q)
        self._rd_half_p = np.asarray(rd.half_p)
        self._rd_qhat_inv = np.asarray(rd.conv.qhat_inv)
        self._rd_qhat_inv_shoup = np.asarray(rd.conv.qhat_inv_shoup)
        self._rd_conv_pad = padT(np.asarray(rd.conv.qhat_dst_mont))
        self._half_q_pad = padT(np.asarray(rd.half_q))
        self._pmont_pad = padT(np.asarray(rd.pinv_mont))

        spec_x = P(None, coeff_axis)
        spec_kd = P(limb_axis, None, None, coeff_axis)
        self._jit = jax.jit(jax.shard_map(
            self._body, mesh=mesh, in_specs=(spec_x, spec_kd),
            out_specs=P(None, limb_axis, coeff_axis), check_vma=False))

    def pad_keys(self, key_q, key_p):
        """(β, 2, Lq_full, n) keys → (β_pad, 2, T_pad, n) for the sharded
        (limb on digits, coeff on n) placement."""
        kq = np.asarray(key_q)[:self.beta, :, :self.L]
        kp = np.asarray(key_p)[:self.beta]
        kd = np.concatenate([kq, kp], axis=2)
        kd = _pad_axis0(kd, self.beta_pad)
        out = np.zeros(kd.shape[:2] + (self.T_pad,) + kd.shape[3:],
                       dtype=kd.dtype)
        out[:, :, :self.T] = kd
        return out

    def _body(self, x, kd):
        """x (L, C) replicated over limb; kd digit+coeff shard
        (β_pad/Dl, 2, T_pad, C). Returns (2, T_pad/Dl, C) — this device's
        scattered output-limb rows (padded rows are garbage)."""
        L, T, T_pad = self.L, self.T, self.T_pad
        alpha, beta_pad, Dl = self.alpha, self.beta_pad, self.Dl
        my = jax.lax.axis_index(self.limb_axis)
        bD = beta_pad // Dl
        C = x.shape[-1]
        # local digit group: decompose + mod-up + distributed NTT
        pad = beta_pad * alpha - L
        xg = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
        xg = xg.reshape(beta_pad, alpha, C)
        xg = jax.lax.dynamic_slice_in_dim(xg, my * bD, bD, axis=0)
        qhat_inv = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._qhat_inv), my * bD, bD, axis=0)
        qhat_inv_sh = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._qhat_inv_shoup), my * bD, bD, axis=0)
        src_q = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._src_q), my * bD, bD, axis=0)
        qhat_conv = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._qhat_conv), my * bD, bD, axis=0)
        y = _u.shoup_mul(jnp, xg, qhat_inv, qhat_inv_sh, src_q)
        terms = _u.mont_mul(jnp, y[:, None, :, :], qhat_conv[:, :, :, None],
                            self._qp_q[:, :, None], self._qp_pinv[:, :, None])
        xd = _u.modsum_tree(jnp, terms, self._qp_q[:, :, None], axis=-2)
        xd = self.dntt.fwd_body(xd, rows=(0, T))      # (bD, T, C)
        xd = jnp.pad(xd, ((0, 0), (0, T_pad - T), (0, 0)))
        # gadget inner product (local partial sum over this digit group)
        terms = _u.mont_mul(jnp, xd[:, None, :, :], kd, self._qp_q_pad,
                            self._qp_pinv_pad)
        acc = _u.modsum_tree(jnp, terms, self._qp_q_pad, axis=0)  # (2,T_pad,C)
        # reduce over limb devices + scatter the T axis (widened for u32
        # row sums with Dl > 2 — they wrap the 32-bit word)
        wide = self.wb == 32 and Dl > 2
        if wide:
            acc = acc.astype(jnp.uint64)
        acc = jax.lax.psum_scatter(acc, self.limb_axis, scatter_dimension=1,
                                   tiled=True)        # (2, rpd, C)
        rpd = T_pad // Dl
        q_loc = jax.lax.dynamic_slice_in_dim(
            jnp.asarray(self._qp_q_pad), my * rpd, rpd, axis=0)
        qf = q_loc.astype(acc.dtype)
        d = Dl
        while d > 1:
            d //= 2
            step = qf * jnp.asarray(d, acc.dtype)
            acc = jnp.where(acc >= step, acc - step, acc)
        acc = jnp.where(acc >= qf, acc - qf, acc)
        if wide:
            acc = acc.astype(jnp.uint32)
        # distributed INTT on this device's scattered limb rows
        c = self.dntt.inv_body(acc, rows=(my * rpd, rpd))   # (2, rpd, C)
        # the |P| special-limb rows must reach every limb shard
        p_rows = []
        for a in range(self.alpha):
            r = L + a
            owner, row_in = r // rpd, r % rpd
            contrib = jnp.where(my == owner, c[:, row_in], 0)
            p_rows.append(contrib)
        c_p = jax.lax.psum(jnp.stack(p_rows, axis=1), self.limb_axis)

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(jnp.asarray(a), my * rpd,
                                                rpd, axis=0)

        rd = self.round_div
        y2 = _u.shoup_mul(jnp, _u.addmod(jnp, c_p, self._rd_half_p,
                                         self._rd_p_q),
                          self._rd_qhat_inv, self._rd_qhat_inv_shoup,
                          self._rd_p_q)
        conv_loc = _u.modsum_tree(
            jnp, _u.mont_mul(jnp, y2[:, None, :, :],
                             sl(self._rd_conv_pad)[:, :, None],
                             q_loc[:, None, :],
                             sl(self._qp_pinv_pad)[:, None, :]),
            q_loc[:, None, :], axis=-2)
        num = _u.submod(jnp, _u.addmod(jnp, c, sl(self._half_q_pad), q_loc),
                        conv_loc, q_loc)
        e = _u.mont_mul(jnp, num, sl(self._pmont_pad), q_loc,
                        sl(self._qp_pinv_pad))
        v = rd.overflow(jnp, y2)[..., None, :]
        return _u.addmod(jnp, e, v, q_loc)

    def __call__(self, x, key_q, key_p):
        """x (L, n) coeff-domain numpy → (e0, e1) over Q_ℓ, bit-identical
        to KeySwitcher.switch."""
        kd = self.pad_keys(key_q, key_p)
        e = np.asarray(self._jit(np.asarray(x), kd))
        e = e.reshape(2, self.T_pad, self.n)[:, :self.L]
        return e[0], e[1]


def _pad_axis0(a, size):
    if a.shape[0] == size:
        return a
    widths = [(0, size - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths)


def galois_body(x, src_tbl, sign_tbl, q_col, axis: str, C: int):
    """σ_g on a coeff-domain local shard x (..., L, C): all_gather the
    coefficient axis, static gather + sign flip, keep this device's chunk.

    The automorphism is a global index permutation with sign (x^n = -1
    wrap), so shards exchange coefficients; the all_gather moves (D-1)/D·n
    words per device. A bucketed all_to_all (per-source/destination index
    buckets, ≤ n/D·(1+ε) words) is the optimization path once rotation
    traffic matters; correctness and layout are identical.
    """
    d = jax.lax.axis_index(axis)
    full = jax.lax.all_gather(x, axis, axis=x.ndim - 1, tiled=True)
    src = jax.lax.dynamic_slice_in_dim(jnp.asarray(src_tbl), d * C, C)
    sgn = jax.lax.dynamic_slice_in_dim(jnp.asarray(sign_tbl), d * C, C)
    vals = jnp.take(full, src, axis=-1)
    neg = jnp.where(vals == 0, vals, q_col - vals)
    return jnp.where(sgn.astype(bool), neg, vals)


class CoeffShardedRotator:
    """Coefficient-sharded BFV/CKKS rotation: σ_g on both polys + the
    coeff-sharded key switch of σ_g(c1) (engine.apply_galois pipeline,
    schemes/bfv.py:411-437, for coeff-domain ciphertexts)."""

    def __init__(self, switcher, level: int, mesh, galois_elt: int,
                 axis: str = 'coeff'):
        from ..schemes.galois import coeff_automorphism_maps
        self.ks = CoeffShardedKeySwitcher(switcher, level, mesh, axis)
        self.elt = galois_elt
        n = switcher.n
        src, sign = coeff_automorphism_maps(n, galois_elt)
        dt = word_dtype(switcher.word_bits)
        self._src = src.astype(np.int32)
        self._sign = sign.astype(dt)
        self._q = np.asarray(self.ks.dntt.ring_n.q)[:level + 1]   # (L, 1)
        C, axis_ = self.ks.dntt.C, axis

        def body(ct, kd):
            rot = galois_body(ct, self._src, self._sign, self._q, axis_, C)
            e = self.ks.from_digits_body(
                self.ks.decompose_modup_ntt_body(rot[1]), kd)
            c0 = _u.addmod(jnp, rot[0], e[0], self._q)
            return jnp.stack([c0, e[1]])

        spec = P(None, None, axis_)
        self._jit = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec, self.ks._spec_kd),
            out_specs=spec, check_vma=False))

    def __call__(self, ct_data, glk):
        """ct_data: (2, L, n) coeff-domain; bit-identical to
        engine.apply_galois on a coeff-domain ciphertext."""
        kd = self.ks.prep_keys(glk)
        return np.asarray(self._jit(np.asarray(ct_data), kd))


class CoeffShardedRelin:
    """Coefficient-sharded relinearization: ct3 → ct (engine.relinearize,
    schemes/bfv.py:398-404) with the key switch coeff-sharded."""

    def __init__(self, switcher, level: int, mesh, axis: str = 'coeff'):
        self.ks = CoeffShardedKeySwitcher(switcher, level, mesh, axis)
        self._q = np.asarray(self.ks.dntt.ring_n.q)[:level + 1]

        def body(ct3, kd):
            e = self.ks.switch_body(ct3[2], kd)
            c0 = _u.addmod(jnp, ct3[0], e[0], self._q)
            c1 = _u.addmod(jnp, ct3[1], e[1], self._q)
            return jnp.stack([c0, c1])

        spec = P(None, None, axis)
        self._jit = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec, self.ks._spec_kd),
            out_specs=spec, check_vma=False))

    def __call__(self, ct3_data, rlk):
        kd = self.ks.prep_keys(rlk)
        return np.asarray(self._jit(np.asarray(ct3_data), kd))
