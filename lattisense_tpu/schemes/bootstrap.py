"""CKKS bootstrapping: ModRaise → CoeffsToSlots → EvalMod → SlotsToCoeffs.

Reference capability parity: CkksBtpContext::bootstrap
(fhe_ops_lib/fhe_lib_v2.h:1173-1217); configuration semantics follow the
frontend's bootstrap parameter math (frontend/bootstrap_params.py — DFT
factorization depths, BSGS ratios, EvalMod sine config).

Value algebra (dense packing, slots s = n/2, folded u_c = m_c + i·m_{c+s}):

1. ModRaise: centered-lift the level-0 ciphertext to the full chain — it
   now encrypts u = m + q0·I with |I| ≲ K (sparse secret, weight h).
2. CoeffsToSlots: inverse special-FFT stages post-scaled by
   Δ/(2K·q0·2^r) put y_j = u_j/(2K·q0·2^r) into slots (bit-reversed
   order); a conjugation splits the real/imag coefficient halves.
3. EvalMod: Chebyshev series of cos(2π(2K·2^r·y − 0.25)/2^r) on the
   actual operand range |y| ≤ 2^-(r+1), then r double-angle squarings:
   slots become sin(2π·u/q0) ≈ 2π·m/q0.
4. SlotsToCoeffs: forward stages post-scaled by q0/(2π·Δ) return values
   to coefficients; the result decodes to the original message.

The bit-reversed slot order introduced by step 2 is consumed exactly by
step 4 — no homomorphic permutation is ever applied (special_fft.py).
"""

import logging
from dataclasses import dataclass

import numpy as np

_log = logging.getLogger(__name__)

from .linear_transform import EncodedLinearTransform
from .poly_eval import ChebyshevEvaluator, chebyshev_interpolate
from .special_fft import cts_matrices, stc_matrices
from .types import Ciphertext
from .galois import galois_elt_row
from ..core import ntt as ntt_mod


@dataclass
class BootstrapConfig:
    """EvalMod + DFT-depth configuration (reference CkksBtpParameter
    fields: btp_cts_depth, btp_stc_depth, btp_eval_mod_* —
    frontend/custom_task.py:1133)."""

    cts_depth: int = 3
    stc_depth: int = 3
    k: int = 16                    # covers |I + m/q0| < K
    sine_deg: int = 30
    double_angle: int = 3
    bsgs_ratio: float = 2.0
    em_scale: float | None = None  # EvalMod working scale; defaults to q[1]
                                   # (mixed chains: pass the EvalMod prime,
                                   # reference btp_eval_mod_scaling_factor)
    message_ratio: float = 256.0   # message is scaled up to q0/message_ratio
                                   # before ModRaise so the sine signal sits
                                   # far above the EvalMod noise floor
                                   # (reference btp_eval_mod_message_ratio);
                                   # also caps precision at ~(ratio/2π)²·6
    limbs_per_level: int | None = None
                                   # limbs one multiplicative level consumes.
                                   # None = auto: 1 on 64-bit-word chains,
                                   # 2 on the 32-bit-word
                                   # engine, where the working scale ≈ 2^62
                                   # spans a PAIR of 31-bit primes, every
                                   # rescale drops two limbs, and ModRaise
                                   # lifts from the composite base q0·q1
                                   # (composite scaling)
    arcsine: bool = False          # cancel the sine's cubic term with a
                                   # deg-3 arcsine correction after EvalMod
                                   # (2 extra levels; the cubic acts per
                                   # ring coefficient, so it shows up as an
                                   # intermodulation floor cubic in message
                                   # amplitude and ∝ ratio⁻²; removing it
                                   # lets low ratios
                                   # trade headroom for precision)


class CkksBootstrapper:
    """Per-context precompute + the bootstrap op itself."""

    def __init__(self, engine, config: BootstrapConfig | None = None):
        self.engine = engine
        self.cfg = config or BootstrapConfig()
        p = engine.params
        cfg = self.cfg
        s = p.slots
        # sparse packing: messages replicate R times over the ring slots;
        # the special transform shrinks to size s (roots ω^R share the same
        # twiddle formula), at the cost of a SubSum projection whose
        # rotations are the frontend's predicted 2^i·s steps
        self.repl = (p.n // 2) // s
        # limbs per multiplicative level: the 32-bit-word engine runs the
        # whole pipeline at composite scales spanning prime PAIRS (every
        # prime is ≤31 bits but the working scale must stay ≈2^62 — any
        # systematic error is amplified up to n/2 by SlotsToCoeffs)
        self.step = int(cfg.limbs_per_level or
                        (2 if getattr(engine, 'word_bits', 64) == 32 else 1))
        st = self.step
        # the ModRaise base: one prime, or the composite q0·q1 for pairs
        self.q0_int = 1
        for j in range(st):
            self.q0_int *= int(p.q[j])
        self.q0 = float(self.q0_int)
        self.scale = p.scale
        L = p.max_level

        # EvalMod working scale ≈ one level's prime product: all
        # scale-preserving constant multiplies encode at the level primes
        # (Lattigo runs EvalMod at 2^60 the same way).
        em_default = 1.0
        for j in range(st, 2 * st):
            em_default *= float(p.q[j])
        self.em_scale = float(cfg.em_scale or em_default)

        # Encoded at the full level: PlaintextMul limbs slice down to any
        # working level, so no rigid level schedule is needed. Matrix
        # plaintexts are encoded at ≈ the level primes so the running
        # scale is preserved through each rescale.
        # BSGS split must agree with the frontend's key prediction
        # (frontend/bootstrap_params.py find_best_bsgs_split) so compiled
        # task signatures register exactly the Galois keys used here.
        from ..frontend.bootstrap_params import find_best_bsgs_split

        def split(g):
            return find_best_bsgs_split({o: True for o in g}, s, cfg.bsgs_ratio)

        # the working message scale inside the pipeline: q0/message_ratio
        # (matches the reference's message_ratio contract — the message is
        # scaled so its scale sits message_ratio below q0 before ModRaise)
        self.c_int = max(1, int(round(
            self.q0 / (cfg.message_ratio * self.scale))))
        self.scale_eff = self.scale * self.c_int

        # Folded into CoeffsToSlots (zero extra levels): the SubSum gain
        # 1/R, the EvalMod domain normalization 2^{r+1} (so the Chebyshev
        # operand is pre-normalized to [-1, 1]), and the 0.5 / -0.5i of
        # the real/imag split — realized as TWO variants of the LAST C2S
        # group whose outputs are closed with a conjugation + add.
        post_cts = (self.scale_eff * 2 ** (cfg.double_angle + 1)
                    / (2.0 * cfg.k * self.q0 * 2 ** cfg.double_angle
                       * self.repl))
        groups = cts_matrices(s, cfg.cts_depth, post_scale=post_cts)
        self.cts = [EncodedLinearTransform(engine, g, L, split(g),
                                           limb_step=st)
                    for g in groups[:-1]]
        last = groups[-1]
        self.cts_last_re = EncodedLinearTransform(
            engine, {o: v * 0.5 for o, v in last.items()}, L, split(last),
            out_scale_target=self.em_scale, limb_step=st)
        self.cts_last_im = EncodedLinearTransform(
            engine, {o: v * -0.5j for o, v in last.items()}, L, split(last),
            out_scale_target=self.em_scale, limb_step=st)
        # Diagonals encode lazily at each level's rescale prime (scale=None)
        # so the running scale is preserved exactly through both transforms
        # on ANY chain layout (mixed 40/60-bit regions included) and the
        # final steering factor stays ≥ 1.
        post_stc = self.q0 / (2.0 * np.pi * self.scale_eff)
        self.stc = [EncodedLinearTransform(engine, g, L, split(g),
                                           limb_step=st)
                    for g in stc_matrices(s, cfg.stc_depth, post_scale=post_stc)]

        # EvalMod series; the operand arrives pre-normalized to [-1, 1]
        # (the 2^{r+1} domain map is folded into post_cts above)
        K2r = 2.0 * cfg.k * 2 ** cfg.double_angle
        r = cfg.double_angle

        def f(y):
            return np.cos(2 * np.pi * (K2r * y - 0.25) / 2 ** r)

        a = 1.0 / 2 ** (r + 1)
        coeffs = chebyshev_interpolate(f, -a, a, cfg.sine_deg)
        # underfit guardrail: deg-39 fits k=20 to ~1e-13, but a larger K
        # widens the oscillation count and the SAME degree silently
        # degrades (measured: k=28 @ deg 39 → 2.4e-4 output, a 5x
        # regression that looks like noise). Check the fit on a grid.
        grid = np.linspace(-a, a, 512)
        fit = np.polynomial.chebyshev.chebval(grid / a, coeffs)
        resid = float(np.max(np.abs(fit - f(grid))))
        if resid > 1e-9:
            _log.warning(
                'EvalMod sine fit residual %.1e at sine_deg=%d, k=%d — '
                'raise sine_deg (the truncation error is SYSTEMATIC and '
                'SlotsToCoeffs amplifies it up to n/2)', resid,
                cfg.sine_deg, cfg.k)
        self.evalmod = ChebyshevEvaluator(
            engine, coeffs, -1.0, 1.0, pre_normalized=True, limb_step=st)
        # steer CoeffsToSlots' output exactly onto the evaluator's planned
        # entry scale (anchored at em_scale) — the evaluator then enters
        # on-plan with zero extra levels and its doublings stay inside the
        # EvalMod prime region
        entry_level = L - cfg.cts_depth * st
        self.em_entry_scale = self.evalmod.planned_scale(entry_level,
                                                         self.em_scale)
        self.cts_last_re.out_scale_target = self.em_entry_scale
        self.cts_last_im.out_scale_target = self.em_entry_scale

    # ------------------------------------------------------------------
    def galois_elements(self) -> list[int]:
        from .galois import galois_elt_col
        p = self.engine.params
        elts = {galois_elt_row(p.n)}
        for lt in self.cts + [self.cts_last_re, self.cts_last_im] + self.stc:
            elts.update(lt.galois_elements())
        step = p.slots
        while step < p.n // 2:                   # SubSum rotations (sparse)
            elts.add(galois_elt_col(step, p.n))
            step <<= 1
        return sorted(elts)

    def min_levels(self) -> int:
        """Rough LIMB consumption (cts + split + evalmod + doublings +
        recombine + stc, each level = ``step`` limbs)."""
        cfg = self.cfg
        em = (len(self.evalmod.coeffs) - 1).bit_length() + 2
        arc = 2 if cfg.arcsine else 0
        return self.step * (cfg.cts_depth + 1 + em + cfg.double_angle + arc
                            + 1 + cfg.stc_depth)

    # ------------------------------------------------------------------
    def _qstep(self, level: int) -> float:
        out = 1.0
        for j in range(level - self.step + 1, level + 1):
            out *= float(self.engine.q[j])
        return out

    def _rescale_n(self, xp, ct):
        for _ in range(self.step):
            ct = self.engine.rescale(xp, ct)
        return ct

    # ------------------------------------------------------------------
    def mod_raise(self, xp, ct: Ciphertext) -> Ciphertext:
        """Base level (``step``−1) → full chain by centered lift of the
        coefficients mod the (possibly composite) base Q0 = Π q_{<step}."""
        eng = self.engine
        p = eng.params
        ring_b = eng.ring(self.step - 1)
        ringL = eng.ring(p.max_level)
        coeffs = ntt_mod.intt(xp, ct.data, ring_b)     # (2, step, n) mod q_j
        if self.step == 1:
            v = coeffs[..., 0, :].astype(np.uint64)
        else:
            # CRT-reconstruct v mod Q0 exactly in u64 (Q0 < 2^63): the
            # composite base is odd, so Montgomery reduction applies
            from ..core import u64 as _u
            Q0 = self.q0_int
            pinv = np.uint64((-pow(Q0, -1, 1 << 64)) % (1 << 64))
            r2 = np.uint64(pow(1 << 64, 2, Q0))
            Q0a = np.uint64(Q0)
            v = None
            for j in range(self.step):
                qj = int(eng.q[j])
                cj = np.uint64((Q0 // qj) * pow(Q0 // qj, -1, qj) % Q0)
                vj = coeffs[..., j, :].astype(np.uint64)
                term = _u.mulmod(xp, vj, xp.full_like(vj, cj), Q0a, pinv, r2)
                v = term if v is None else _u.addmod(xp, v, term, Q0a)
        half = np.uint64(self.q0_int // 2)
        qs = ringL.q.astype(np.uint64)                 # (L+1, 1)
        vm = v[..., None, :] % qs
        q0m = (np.asarray([self.q0_int], dtype=np.uint64)[None, :] % qs)
        neg = (vm + qs - q0m) % qs
        lifted = xp.where((v > half)[..., None, :], neg, vm)
        data = ntt_mod.ntt(xp, lifted.astype(ringL.q.dtype), ringL)
        return Ciphertext(data=data, level=p.max_level, is_ntt=True,
                          scale=ct.scale)

    def _mul_const_complex(self, xp, ct, value, target_scale=None):
        """Constant multiply that lands the output at ``target_scale``
        (defaults to preserving ct.scale) by steering the plaintext scale."""
        eng = self.engine
        target = target_scale or ct.scale
        pt_scale = target * self._qstep(ct.level) / ct.scale
        if complex(value).imag == 0.0:
            pt = eng.encode_const(complex(value).real, ct.level, pt_scale, xp)
        else:
            pt = eng.encode(np.full(eng.params.slots, value), ct.level,
                            pt_scale)
        out = self._rescale_n(xp, eng.mult(xp, ct, pt))
        out.scale = target
        return out

    def _conj(self, xp, ct, glk_map):
        elt = galois_elt_row(self.engine.params.n)
        return self.engine.apply_galois(xp, ct, elt, glk_map[elt])

    def _double_angle(self, xp, ct, rlk):
        eng = self.engine
        sq = self._rescale_n(xp, eng.relinearize(xp, eng.mult(xp, ct, ct),
                                                 rlk))
        two = eng.add(xp, sq, sq)
        pt = eng.encode_const(-1.0, two.level, two.scale, xp)
        return eng.add(xp, two, pt)

    def _arcsine(self, xp, ct, rlk):
        """Slots hold v = sin(2πε) after the doublings; return
        v + v³/6 ≈ arcsin(v) = 2πε (next term 3v⁵/40, ~(2πε)² smaller).
        Because the sine acts per ring coefficient, its cubic appears as a
        cross-slot intermodulation floor — cubic in message amplitude and
        ∝ message_ratio⁻² (measured; the per-slot error shape is NOT m³).
        Cancelling it costs 2 levels (v², v³) — the v³/6 division is free
        via the declared-scale dial."""
        eng = self.engine
        st = self.step
        v2 = self._rescale_n(xp, eng.relinearize(xp, eng.mult(xp, ct, ct),
                                                 rlk))
        vd = eng.drop_level(xp, ct, st)
        v3 = self._rescale_n(xp, eng.relinearize(xp, eng.mult(xp, v2, vd),
                                                 rlk))
        v3.scale *= 6.0                      # decodes as v³/6
        base = self._mul_const_complex(xp, eng.drop_level(xp, ct, st), 1.0,
                                       target_scale=v3.scale)
        return eng.add(xp, v3, base)

    def _check_input_snr(self, ct):
        """Bootstrap output precision is bounded by the INPUT ciphertext's
        own SNR: err ≈ c·n·σ/scale, message_ratio-independent (the
        pipeline refreshes the noise along with the message and StC
        amplifies it √n — measured). Warn once when
        that floor exceeds ~1e-5 so users encode bootstrap-bound data at
        a higher scale (2^40 recommended; doc/performance_guide.md)."""
        if getattr(self, '_snr_warned', False):
            return
        n = self.engine.params.n
        floor = 2.0 * n * 3.2 / float(ct.scale)
        if floor > 1e-5:
            self._snr_warned = True
            _log.warning(
                'bootstrap input scale %.1e caps output precision at '
                '~%.0e (input-SNR bound ~ n*sigma/scale); encode '
                'bootstrap-bound ciphertexts at a higher scale (e.g. '
                '2^40) for pipeline-limited precision', ct.scale, floor)

    # ------------------------------------------------------------------
    def segments(self, caller_scale: float, swk_dts=None, swk_std=None):
        """The bootstrap as a list of (name, fn) with
        fn(xp, cts: tuple[Ciphertext, ...], rlk, glk_map) → tuple; folding
        them in order is bit-identical to ``__call__``. Exists so callers
        can put jit boundaries between phases — the whole-graph jit of a
        full-size bootstrap is one very large program, while each segment
        compiles on its own."""
        eng = self.engine

        def s_raise(xp, cts, rlk, glk_map):
            ct, = cts
            # level-free integer scale-up to the pipeline's working scale;
            # c_int adapts to the ACTUAL input scale, the final steer
            # returns to the caller scale
            c_int = max(1, int(round(self.scale_eff / ct.scale)))
            if c_int > 1:
                from ..core.rns import _col, _mont
                from ..core import u64 as _u
                wb = getattr(eng, 'word_bits', 64)
                ring_b = eng.ring(self.step - 1)
                cm = _col([_mont(c_int % qi, qi, wb)
                           for qi in eng.q[:self.step]], wb)
                ct = Ciphertext(data=_u.mont_mul(xp, ct.data, cm, ring_b.q,
                                                 ring_b.pinv),
                                level=self.step - 1, is_ntt=ct.is_ntt,
                                scale=ct.scale * c_int)
            ct.scale = self.scale_eff
            if swk_dts is not None:
                ct = eng.key_switch(xp, ct, swk_dts)
            t = self.mod_raise(xp, ct)
            if swk_std is not None:
                t = eng.key_switch(xp, t, swk_std)
            # sparse packing: SubSum projects onto the replicated subspace
            from .galois import galois_elt_col
            p = eng.params
            step = p.slots
            while step < p.n // 2:
                elt = galois_elt_col(step, p.n)
                t = eng.add(xp, t, eng.apply_galois(xp, t, elt, glk_map[elt]))
                step <<= 1
            return (t,)

        segs = [('raise', s_raise)]

        # CoeffsToSlots → y in bit-reversed order; the real/imag split is
        # realized level-free by the two last-group variants + conjugation
        for i, lt in enumerate(self.cts):
            def s_cts(xp, cts, rlk, glk_map, lt=lt):
                t, = cts
                return (self._rescale_n(xp, lt(xp, t, glk_map)),)
            segs.append((f'cts{i}', s_cts))

        # The real/imag split carries TWO full BSGS transforms whose
        # encoded diagonals are program constants — as one segment its
        # serialized HLO is ~2x a cts segment. Two segments, each
        # cts-sized; ``t`` passes through
        # the first unchanged. Values are bit-identical to the fused
        # form (the halves are independent computations).
        def s_split_re(xp, cts, rlk, glk_map):
            t, = cts
            ta = self._rescale_n(xp, self.cts_last_re(xp, t, glk_map))
            ta.scale = self.em_entry_scale
            t0 = eng.add(xp, ta, self._conj(xp, ta, glk_map))
            return (t0, t)
        segs.append(('split_re', s_split_re))

        def s_split_im(xp, cts, rlk, glk_map):
            t0, t = cts
            tb = self._rescale_n(xp, self.cts_last_im(xp, t, glk_map))
            tb.scale = self.em_entry_scale
            t1 = eng.add(xp, tb, self._conj(xp, tb, glk_map))
            return (t0, t1)
        segs.append(('split_im', s_split_im))

        # Both halves run as ONE vmapped program: they share level/scale
        # metadata (split emits symmetric ta/tb), so stacking them halves
        # the dominant segment-compile cost (vmap adds a batch dim, not
        # ops) and batches the chip work. The host (np) path loops — the
        # math is identical either way, so eager vs jit stays bit-exact.
        # EvalMod is further cut into cheb / double-angle / arcsine
        # sub-segments: each segment's program carries per-level NTT
        # twiddle constants for every level it touches, so the fused
        # EvalMod's span is the largest program of the bootstrap even
        # with scalar plaintext constants (L, 1)-compressed
        # (encode_const).
        def _em_pair(stage_fn):
            def seg(xp, cts, rlk, glk_map):
                def one(data):
                    c = Ciphertext(data=data, level=cts[0].level,
                                   is_ntt=cts[0].is_ntt, scale=cts[0].scale)
                    c = stage_fn(xp, c, rlk)
                    one.meta = (c.level, c.is_ntt, c.scale)
                    return c.data
                if xp is np:
                    d0, d1 = one(cts[0].data), one(cts[1].data)
                else:
                    import jax
                    out = jax.vmap(one)(xp.stack([cts[0].data, cts[1].data]))
                    d0, d1 = out[0], out[1]
                lv, ntt, sc = one.meta
                return (Ciphertext(data=d0, level=lv, is_ntt=ntt, scale=sc),
                        Ciphertext(data=d1, level=lv, is_ntt=ntt, scale=sc))
            return seg

        # List-valued twin of _em_pair for the staged Chebyshev eval:
        # boundaries carry (re_0..re_{k-1}, im_0..im_{k-1}); the re/im
        # halves share metadata positionally (symmetric plans), so both
        # run as ONE vmapped program exactly like _em_pair.
        def _em_pair_list(stage_fn):
            def seg(xp, cts, rlk, glk_map):
                half = len(cts) // 2
                res, ims = cts[:half], cts[half:]

                def one(datas):
                    cc = [Ciphertext(data=d, level=r.level, is_ntt=r.is_ntt,
                                     scale=r.scale)
                          for d, r in zip(datas, res)]
                    out = stage_fn(xp, cc, rlk)
                    one.meta = [(c.level, c.is_ntt, c.scale) for c in out]
                    return tuple(c.data for c in out)

                if xp is np:
                    d_re = one(tuple(c.data for c in res))
                    d_im = one(tuple(c.data for c in ims))
                else:
                    import jax
                    stacked = tuple(xp.stack([r.data, i.data])
                                    for r, i in zip(res, ims))
                    outs = jax.vmap(lambda *ds: one(ds))(*stacked)
                    d_re = tuple(o[0] for o in outs)
                    d_im = tuple(o[1] for o in outs)

                def mk(ds):
                    return tuple(Ciphertext(data=d, level=m[0], is_ntt=m[1],
                                            scale=m[2])
                                 for d, m in zip(ds, one.meta))
                return mk(d_re) + mk(d_im)
            return seg

        def st_da(xp, c, rlk):
            for _ in range(self.cfg.double_angle):
                c = self._double_angle(xp, c, rlk)
            return c

        # The fused deg-39 Chebyshev program at n=2^16 ran a compiler out
        # of memory even const-lifted — each sub-stage (baby basis /
        # giant basis / PS recursion) compiles on its own.
        for suffix, st in self.evalmod.stages(self.em_scale):
            segs.append((f'evalmod_{suffix}', _em_pair_list(st)))
        if self.cfg.double_angle:
            segs.append(('evalmod_da', _em_pair(st_da)))
        if self.cfg.arcsine:
            segs.append(('evalmod_asin', _em_pair(self._arcsine)))

        def s_merge(xp, cts, rlk, glk_map):
            g0, g1 = cts
            g1i = self._mul_const_complex(xp, g1, 1j)
            if g0.level > g1i.level:
                g0 = eng.drop_level(xp, g0, g0.level - g1i.level)
            g0.scale = g1i.scale
            return (eng.add(xp, g0, g1i),)
        segs.append(('merge', s_merge))

        for i, lt in enumerate(self.stc):
            def s_stc(xp, cts, rlk, glk_map, lt=lt):
                t, = cts
                return (self._rescale_n(xp, lt(xp, t, glk_map)),)
            segs.append((f'stc{i}', s_stc))

        def s_steer(xp, cts, rlk, glk_map):
            t, = cts
            # land exactly on the caller's scale (reference restores the
            # input scale, mega_ag_executors_cpu.cpp:460-463)
            if abs(t.scale - caller_scale) / caller_scale > 1e-9:
                t = self._mul_const_complex(xp, t, 1.0,
                                            target_scale=caller_scale)
            return (t,)
        segs.append(('steer', s_steer))
        return segs

    def __call__(self, xp, ct: Ciphertext, rlk, glk_map,
                 swk_dts=None, swk_std=None) -> Ciphertext:
        """With swk_dts/swk_std (reference two-secret design): hop onto the
        sparse bootstrap secret for the mod-raise (small |I|), then back to
        the dense evaluation secret before the linear transforms."""
        self._check_input_snr(ct)
        eng = self.engine
        base = self.step - 1
        if ct.level != base:
            ct = eng.drop_level(xp, ct, ct.level - base)
        cts = (ct,)
        for _name, fn in self.segments(ct.scale, swk_dts, swk_std):
            cts = fn(xp, cts, rlk, glk_map)
        out, = cts
        return out
