"""Kernel-level (limb/digit) sharded hybrid key switching.

The genuine new capability vs the reference (SURVEY.md §5 "it never splits
one ciphertext across devices"): one key switch distributed over the mesh's
``limb`` axis with explicit collectives:

- the β gadget digits are computed *independently* per device (digit axis
  sharded): each digit's FastBConv mod-up and its (T, n) NTT run locally —
  the dominant FLOPs parallelize with zero communication;
- keys are sharded the same way, so the gadget inner product is a local
  partial sum; one ``psum_scatter`` both reduces over devices and lands
  the accumulator sharded over the T = L+|P| output-limb axis — factor-D
  less traffic than an all-reduce;
- the INTT of the accumulator then runs locally per output-limb shard
  (per-shard twiddle tables sliced inside the mesh body);
- the final mod-down needs the |P| special limbs everywhere: one small
  psum replicates just those α rows, then each device mod-downs its own
  q-limb rows — the whole key switch runs inside one shard_map program.

Per-device compute drops from O(β·T·n·log n) to O((β/D)·T·n·log n +
(T/D)·n·log n); the collectives move 2·T·n/D + |P|·n words.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..core.u64 import word_dtype
from ..core.modring import get_rns_ring


class _RingView:
    """Per-shard slice of an RnsRing's constants (duck-typed for
    core.ntt.intt; ``moduli`` is absent on purpose so the Pallas dispatch
    gate falls back to the XLA path inside shard_map)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _pad_axis(x, axis, size):
    if x.shape[axis] == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - x.shape[axis])
    return np.pad(x, widths) if isinstance(x, np.ndarray) else jnp.pad(x, widths)


class ShardedKeySwitcher:
    """Digit/limb-sharded twin of schemes.keyswitch.KeySwitcher.switch.

    Built for a fixed (mesh, level); produces a jitted callable over
    (x, key_q, key_p) with the digit axis padded to a multiple of the
    ``limb`` mesh axis.
    """

    def __init__(self, switcher, level: int, mesh: Mesh):
        self.sw = switcher
        self.level = level
        self.mesh = mesh
        self.D = mesh.shape['limb']
        L = level + 1
        self.L = L
        self.n = switcher.n
        self.alpha = switcher.alpha
        self.beta = switcher.beta(level)
        self.beta_pad = -(-self.beta // self.D) * self.D
        qp = switcher.q_moduli[:L] + switcher.p_moduli
        self.T = len(qp)
        self.wb = switcher.word_bits
        self.ring_qp = get_rns_ring(qp, self.n, self.wb)
        self.ring_q = get_rns_ring(switcher.q_moduli[:L], self.n, self.wb)
        dt = word_dtype(self.wb)
        # per-digit constants, padded on the digit axis (zeros annihilate)
        pre = switcher._level_pre(level)
        (_, qhat_inv, qhat_inv_shoup, src_q, qhat_conv, self.round_div) = pre
        self.qhat_inv = _pad_axis(qhat_inv, 0, self.beta_pad)
        self.qhat_inv_shoup = _pad_axis(qhat_inv_shoup, 0, self.beta_pad)
        self.src_q = _pad_axis(np.broadcast_to(src_q, qhat_inv.shape).copy(),
                               0, self.beta_pad).astype(dt)
        self.src_q[self.beta:] = 1          # avoid mod-0 in padded digits
        self.qhat_conv = _pad_axis(qhat_conv, 0, self.beta_pad)
        # T padded to a multiple of D for the psum_scatter tiling
        self.T_pad = -(-self.T // self.D) * self.D
        self._call = self._build()

    # ------------------------------------------------------------------
    def pad_keys(self, key_q, key_p):
        """(β, 2, Lq_full, n) keys → concatenated (β_pad, 2, T_pad, n)."""
        kq = np.asarray(key_q)[:self.beta, :, :self.L]
        kp = np.asarray(key_p)[:self.beta]
        kd = np.concatenate([kq, kp], axis=2)
        kd = _pad_axis(kd, 0, self.beta_pad)
        return _pad_axis(kd, 2, self.T_pad)

    def _build(self):
        sw, D = self.sw, self.D
        L, n, T, T_pad = self.L, self.n, self.T, self.T_pad
        alpha, beta_pad = self.alpha, self.beta_pad
        ring_qp, ring_q = self.ring_qp, self.ring_q
        dt = word_dtype(sw.word_bits)
        qp_q = np.asarray(ring_qp.q)                      # (T, 1)
        qp_q_pad = _pad_axis(qp_q, 0, T_pad).astype(dt)
        qp_q_pad[T:] = 1
        qp_pinv_pad = _pad_axis(np.asarray(ring_qp.pinv), 0, T_pad).astype(dt)
        qp_pinv_pad[T:] = 1                               # padded rows discarded

        consts = dict(
            qhat_inv=self.qhat_inv, qhat_inv_shoup=self.qhat_inv_shoup,
            src_q=self.src_q, qhat_conv=self.qhat_conv)

        # epilogue constants, T-padded so per-device tiles slice uniformly
        def padT(a, fill=0):
            a = np.asarray(a)
            out = _pad_axis(a, 0, T_pad).copy()
            if fill and T_pad > a.shape[0]:
                out[a.shape[0]:] = fill
            return out

        pinv_pad = padT(ring_qp.pinv, 1)
        ninv_pad = padT(ring_qp.n_inv, 1)
        ninvs_pad = padT(ring_qp.n_inv_shoup)
        psi_inv_pad = padT(ring_qp.psi_inv_rev)
        psi_invs_pad = padT(ring_qp.psi_inv_rev_shoup)
        rd = self.round_div
        rd_p_q = np.asarray(rd.p_q)                       # (α, 1)
        rd_half_p = np.asarray(rd.half_p)
        rd_qhat_inv = np.asarray(rd.conv.qhat_inv)
        rd_qhat_inv_shoup = np.asarray(rd.conv.qhat_inv_shoup)
        rd_conv_pad = padT(rd.conv.qhat_dst_mont)         # (T_pad, α)
        half_q_pad = padT(rd.half_q)
        pmont_pad = padT(rd.pinv_mont)

        def local(x, kd, qhat_inv, qhat_inv_shoup, src_q, qhat_conv):
            """Per-device body. x: (L_pad_src…, n) replicated; kd digit
            shard (β/D, 2, T_pad, n); constants digit-sharded."""
            # digit decomposition of the local digit group(s)
            pad = beta_pad * alpha - L
            xg = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
            xg = xg.reshape(beta_pad, alpha, n)
            my = jax.lax.axis_index('limb')
            bD = beta_pad // D
            xg = jax.lax.dynamic_slice_in_dim(xg, my * bD, bD, axis=0)
            y = _u.shoup_mul(jnp, xg, qhat_inv, qhat_inv_shoup, src_q)
            terms = _u.mont_mul(jnp, y[:, None, :, :], qhat_conv[:, :, :, None],
                                qp_q[:, :, None], np.asarray(ring_qp.pinv)[:, :, None])
            xd = _u.modsum_tree(jnp, terms, qp_q[:, :, None], axis=-2)
            xd = ntt_mod.ntt(jnp, xd, ring_qp)            # (β/D, T, n)
            xd = jnp.pad(xd, ((0, 0), (0, T_pad - T), (0, 0)))
            return tail(xd, kd)

        def tail(xd, kd):
            """Gadget inner product + collectives + in-mesh epilogue over
            this device's NTT-domain digit shard xd (β/D, T_pad, n) — the
            shared back half of the direct and hoisted (from-digits)
            entries."""
            my = jax.lax.axis_index('limb')
            terms = _u.mont_mul(jnp, xd[:, None, :, :], kd, qp_q_pad, qp_pinv_pad)
            acc = _u.modsum_tree(jnp, terms, qp_q_pad, axis=0)   # (2, T_pad, n)
            # reduce over devices + scatter the T axis: each device gets
            # (2, T_pad/D, n) fully-summed rows. Row sums < D·q must not
            # wrap: always true in u64 (q < 2^62), but u32 rows overflow
            # for D > 2 (q < 2^31) — widen just the collective there.
            wide = sw.word_bits == 32 and D > 2
            if wide:
                acc = acc.astype(jnp.uint64)
            acc = jax.lax.psum_scatter(acc, 'limb', scatter_dimension=1,
                                       tiled=True)
            # fold the ≤ D·q overflow back below q (log2 D conditional subs)
            rpd = T_pad // D
            q_loc = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(qp_q_pad), my * rpd, rpd, axis=0)
            qf = q_loc.astype(acc.dtype)
            d = D
            while d > 1:
                d //= 2
                step = qf * jnp.asarray(d, acc.dtype)
                acc = jnp.where(acc >= step, acc - step, acc)
            acc = jnp.where(acc >= qf, acc - qf, acc)
            if wide:
                acc = acc.astype(jnp.uint32)

            # ---- in-mesh epilogue: local INTT on this device's limb rows
            def sl(a):
                return jax.lax.dynamic_slice_in_dim(jnp.asarray(a), my * rpd,
                                                    rpd, axis=0)

            rv = _RingView(q=q_loc.reshape(rpd, 1), pinv=sl(pinv_pad),
                           n_inv=sl(ninv_pad), n_inv_shoup=sl(ninvs_pad),
                           psi_inv_rev=sl(psi_inv_pad),
                           psi_inv_rev_shoup=sl(psi_invs_pad))
            c = ntt_mod.intt(jnp, acc, rv)                # (2, rpd, n)

            # the |P| special-limb rows must reach every device: each owner
            # contributes its row, one small psum replicates them (α·2·n
            # words — the full-T all_gather this replaces is D× larger)
            p_rows = []
            for a in range(alpha):
                r = L + a
                owner, row_in = r // rpd, r % rpd
                contrib = jnp.where(my == owner, c[:, row_in], 0)
                p_rows.append(contrib)
            c_p = jax.lax.psum(jnp.stack(p_rows, axis=1), 'limb')  # (2, α, n)

            # local mod-down: e = (c_q + half - conv(c_p + half_p)) · P^-1,
            # constants sliced to this device's limb rows (padded rows are
            # garbage and discarded on the host)
            y = _u.shoup_mul(jnp, _u.addmod(jnp, c_p, rd_half_p, rd_p_q),
                             rd_qhat_inv, rd_qhat_inv_shoup, rd_p_q)
            conv_loc = _u.modsum_tree(
                jnp, _u.mont_mul(jnp, y[:, None, :, :], sl(rd_conv_pad)[:, :, None],
                                 q_loc[:, None, :], sl(pinv_pad)[:, None, :]),
                q_loc[:, None, :], axis=-2)               # (2, rpd, n)
            num = _u.submod(jnp, _u.addmod(jnp, c, sl(half_q_pad), q_loc),
                            conv_loc, q_loc)
            e = _u.mont_mul(jnp, num, sl(pmont_pad), q_loc, sl(pinv_pad))
            # HPS overflow correction — must mirror RoundDivP.__call__
            # exactly (bit-parity with the single-device path): the
            # conversion overflow v = floor(Σ_j y_j/p_j) is added back.
            # rd.overflow dispatches per word (float64 on u64 chains, the
            # exact u32 fixed-point estimate on w32 chains).
            v = rd.overflow(jnp, y)[..., None, :]
            return _u.addmod(jnp, e, v, q_loc)

        in_specs = (P(), P('limb'), P('limb'), P('limb'), P('limb'), P('limb'))
        shard_fn = jax.jit(jax.shard_map(
            functools.partial(local),
            mesh=self.mesh, in_specs=in_specs, out_specs=P(None, 'limb', None),
            check_vma=False))

        # batched, trace-time variant: x (B, L, n) with the batch sharded
        # over the op axis; the limb-TP body vmaps over the local batch.
        # Usable inside an enclosing jit — the integrated pipeline entry.
        def local_batched(x, kd, *cs):
            return jax.vmap(lambda xx: local(xx, kd, *cs))(x)

        batched_in = (P('op'), P('limb'), P('limb'), P('limb'), P('limb'),
                      P('limb'))
        self._shard_fn_batched = jax.shard_map(
            local_batched, mesh=self.mesh, in_specs=batched_in,
            out_specs=P('op', None, 'limb', None), check_vma=False)
        self._consts = consts

        # hoisted entry: precomputed NTT-domain digits in (the rns_sp_decomp
        # pattern — pay decompose/mod-up/NTT once, switch per rotation);
        # each device slices its digit group and runs the shared tail.
        def local_digits(xd_full, kd):
            my = jax.lax.axis_index('limb')
            bD = beta_pad // D
            xd = jax.lax.dynamic_slice_in_dim(xd_full, my * bD, bD, axis=0)
            return tail(xd, kd)

        self._shard_fn_digits = jax.shard_map(
            local_digits, mesh=self.mesh, in_specs=(P(), P('limb')),
            out_specs=P(None, 'limb', None), check_vma=False)
        _digits_jit = jax.jit(self._shard_fn_digits)

        def call_digits(xd, kd):
            e = np.asarray(_digits_jit(xd, kd))[:, :L, :]
            return e[0], e[1]

        self._call_digits = call_digits

        def call(x, kd):
            e = shard_fn(x, kd, consts['qhat_inv'], consts['qhat_inv_shoup'],
                         consts['src_q'], consts['qhat_conv'])
            e = np.asarray(e)[:, :L, :]     # drop special + padded limb rows
            return e[0], e[1]

        return call

    def traced(self, x, kd):
        """Trace-time batched key switch: x (B, L, n) coeff-domain (batch
        sharded over ``op``), kd = pad_keys(...) result. Returns
        (e0, e1) each (B, L, n) — callable inside jit (the epilogue runs
        fully in-mesh; only the padded rows are sliced off here)."""
        c = self._consts
        e = self._shard_fn_batched(x, kd, c['qhat_inv'], c['qhat_inv_shoup'],
                                   c['src_q'], c['qhat_conv'])
        e = e[..., :self.L, :]
        return e[:, 0], e[:, 1]

    def __call__(self, x, key_q, key_p):
        """x: (L, n) coeff-domain numpy; returns (e0, e1) over Q_ℓ —
        bit-identical to KeySwitcher.switch."""
        kd = self.pad_keys(key_q, key_p)
        return self._call(np.asarray(x), kd)

    # ---- hoisted (from-digits) entry ---------------------------------
    def pad_digits(self, digits):
        """(β, T, n) NTT-domain digits → the (β_pad, T_pad, n) sharded
        layout (zero padding annihilates against the zero-padded keys)."""
        d = _pad_axis(digits, 0, self.beta_pad)
        return _pad_axis(d, 1, self.T_pad)

    def switch_from_digits(self, digits, key_q, key_p):
        """Hoisted key switch of precomputed digits
        (``KeySwitcher.decompose_modup_ntt`` output, (β, T, n)) — the
        rns_sp_decomp/BSGS pattern where one decomposition is shared by
        many rotations. Bit-identical to
        ``KeySwitcher.switch_from_digits`` (coeff-domain output)."""
        kd = self.pad_keys(key_q, key_p)
        return self._call_digits(self.pad_digits(np.asarray(digits)), kd)

    def traced_from_digits(self, digits, kd):
        """Trace-time hoisted switch: ``digits`` already in the padded
        (β_pad, T_pad, n) layout (see :meth:`pad_digits`), ``kd`` =
        pad_keys(...). Callable inside jit."""
        e = self._shard_fn_digits(digits, kd)
        return e[0, :self.L], e[1, :self.L]
