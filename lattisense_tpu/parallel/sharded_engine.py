"""Coefficient-sharded ENGINE view: unmodified scheme code inside shard_map.

`parallel/coeff_sharded.py` provides the kernel-sharding primitives
(DistNtt four-step NTT, coeff-sharded hybrid key switch); this module
composes them into the production paths: an engine
VIEW whose every transform dispatches to the distributed bodies, so the
existing, tested scheme layer — `CkksEngine` ops, `EncodedLinearTransform`
BSGS, `ChebyshevEvaluator`, the whole `CkksBootstrapper` — runs inside a
`jax.shard_map` over the mesh's ``coeff`` axis WITHOUT any changes to that
code.

How the seams work:

- ``ring(level)`` returns a `_DistRingView`: per-limb constants delegate to
  the full-n ring (pointwise ops broadcast identically over local
  coefficient shards), while ``core.ntt.ntt/intt`` dispatch to
  `DistNtt.fwd_body/inv_body` (two all_to_alls each). Host (numpy) code
  paths — trace-time encode, keygen oracles — fall back to the full ring,
  so ``engine.encode(...)`` inside a traced segment still works verbatim.
- ``switcher`` is a view implementing ``switch / switch_from_digits /
  decompose_modup_ntt`` with `CoeffShardedKeySwitcher`'s trace-time bodies
  (digit decomposition, mod-up, gadget product and mod-down are all
  pointwise per coefficient → shard-local; only the NTTs move data).
- ``apply_galois``: the NTT-domain automorphism is a global coefficient
  permutation — one all_gather over the coeff axis + a static local take
  (`galois_body`'s pattern, NTT-domain tables).
- plaintext operands (host-encoded, full n) are sliced to the local chunk
  at op entry (`dynamic_slice` by ``axis_index``). They remain replicated
  HLO constants on every device — the sharded working set is the
  ciphertext/digit/key data; pass big constant sets as sharded arguments
  if per-device plaintext memory ever binds.

The reference never splits one ciphertext across devices (SURVEY §5); this
is the capability that lifts the limb axis's TP-width cap.
"""

import copy
import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import ntt as ntt_mod
from ..core import u64 as _u
from ..schemes.galois import ntt_automorphism_perm
from ..schemes.types import (Ciphertext, Plaintext, PlaintextMul,
                             PlaintextRingt)
from .coeff_sharded import CoeffShardedKeySwitcher


class _DistRingView:
    """Ring whose NTT/INTT are distributed; everything else = full ring."""

    def __init__(self, host, dist):
        self.host = host
        self.dist = dist

    def __getattr__(self, name):            # q, pinv, r1, r2, moduli, ...
        return getattr(self.host, name)


class _ShardedSwitcher:
    """KeySwitcher view: same call surface, coeff-sharded bodies."""

    def __init__(self, base, mesh, axis):
        self.base = base
        self.mesh = mesh
        self.axis = axis
        self.q_moduli = base.q_moduli
        self.p_moduli = base.p_moduli
        self.n = base.n
        self.word_bits = base.word_bits
        self.alpha = base.alpha
        # per-instance cache (NOT lru_cache on the method: that would key
        # the process-global cache on self and pin every switcher/mesh
        # graph ever created — advisor r4)
        self._cs_cache: dict = {}

    def beta(self, level: int) -> int:
        return self.base.beta(level)

    def _level_pre(self, level: int):
        return self.base._level_pre(level)

    def _cs(self, level: int) -> CoeffShardedKeySwitcher:
        cs = self._cs_cache.get(level)
        if cs is None:
            cs = self._cs_cache[level] = CoeffShardedKeySwitcher(
                self.base, level, self.mesh, self.axis)
        return cs

    def _kd(self, xp, ksk, level: int):
        b, L = self.base.beta(level), level + 1
        return xp.concatenate([ksk.key_q[:b, :, :L], ksk.key_p[:b]], axis=2)

    def decompose_modup_ntt(self, xp, x, level: int):
        return self._cs(level).decompose_modup_ntt_body(x)

    def switch_from_digits(self, xp, digits, ksk, level: int,
                           output_ntt: bool = False):
        cs = self._cs(level)
        e = cs.from_digits_body(digits, self._kd(xp, ksk, level))  # (2, L, C)
        if output_ntt:
            e = cs.dntt.fwd_body(e, rows=(0, level + 1))
        return e[0], e[1]

    def switch(self, xp, x, ksk, level: int, output_ntt: bool = False):
        digits = self._cs(level).decompose_modup_ntt_body(x)
        return self.switch_from_digits(xp, digits, ksk, level, output_ntt)


def _make_subclass(cls):
    """Engine subclass with the coeff-sharded overrides (cached per cls)."""

    class Sharded(cls):
        _cs_sharded = True

        # -- ring / plaintext localization --------------------------------
        def ring(self, level: int):
            r = self._cs_rings.get(level)
            if r is None:
                from .coeff_sharded import DistNtt
                host = self._cs_base.ring(level)
                dist = DistNtt(self.q[:level + 1], self.n, self._cs_mesh,
                               self._cs_axis, self.word_bits)
                r = _DistRingView(host, dist)
                self._cs_rings[level] = r
            return r

        def _cs_loc(self, xp, b):
            """Slice a host-encoded full-n plaintext operand to this
            device's coefficient chunk (trace-time constant, sliced by
            axis_index inside the shard_map body)."""
            if xp is np or getattr(b, 'data', None) is None:
                return b
            data = b.data
            if data.shape[-1] != self.n:
                return b                      # already local
            d = jax.lax.axis_index(self._cs_axis)
            loc = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(data), d * self._cs_C, self._cs_C, axis=-1)
            b2 = copy.copy(b)
            b2.data = loc
            return b2

        def _cs_pt(self, xp, b):
            if isinstance(b, PlaintextRingt):
                raise NotImplementedError(
                    'PlaintextRingt operands are not supported under '
                    'coefficient sharding (encode to Plaintext/PlaintextMul)')
            if isinstance(b, (Plaintext, PlaintextMul)):
                return self._cs_loc(xp, b)
            return b

        def add(self, xp, a, b):
            return super().add(xp, a, self._cs_pt(xp, b))

        def sub(self, xp, a, b):
            return super().sub(xp, a, self._cs_pt(xp, b))

        def behz(self, level: int):
            """BehzMult view with coeff-sharded dual-basis rings: every
            BEHZ stage except the NTTs is pointwise per coefficient
            (FastBConv/SmMRq/tensor/Shenoy), so swapping ring_q/ring_aux
            for dist views makes the WHOLE BFV ct x ct multiply run
            coeff-sharded (bfv.py's Pallas megakernel dispatch is gated
            off when the ring carries ``dist``)."""
            v = self._cs_behz.get(level)
            if v is None:
                from .coeff_sharded import DistNtt
                base = self._cs_base.behz(level)
                v = copy.copy(base)
                v.ring_q = _DistRingView(
                    base.ring_q,
                    DistNtt(base.ring_q.moduli, self.n, self._cs_mesh,
                            self._cs_axis, self.word_bits))
                v.ring_aux = _DistRingView(
                    base.ring_aux,
                    DistNtt(base.ring_aux.moduli, self.n, self._cs_mesh,
                            self._cs_axis, self.word_bits))
                self._cs_behz[level] = v
            return v

        def mult(self, xp, a, b):
            return super().mult(xp, a, self._cs_pt(xp, b))

        # -- Galois: all_gather + static local take ------------------------
        def _cs_auto_ntt(self, x, g: int):
            """σ_g on NTT-domain shards: a pure index permutation."""
            perm = ntt_automorphism_perm(self.n, g).astype(np.int32)
            d = jax.lax.axis_index(self._cs_axis)
            full = jax.lax.all_gather(x, self._cs_axis, axis=x.ndim - 1,
                                      tiled=True)
            src = jax.lax.dynamic_slice_in_dim(jnp.asarray(perm),
                                               d * self._cs_C, self._cs_C)
            return jnp.take(full, src, axis=-1)

        def _cs_auto_coeff(self, x, g: int, q_col):
            """σ_g on coeff-domain shards: permutation + sign (x^n = -1)."""
            from ..schemes.galois import coeff_automorphism_maps
            from .coeff_sharded import galois_body
            src, sign = coeff_automorphism_maps(self.n, g)
            return galois_body(x, src.astype(np.int32),
                               sign.astype(x.dtype), q_col, self._cs_axis,
                               self._cs_C)

        def apply_galois(self, xp, ct, galois_elt: int, glk, **kw):
            if xp is np:
                return self._cs_base.apply_galois(xp, ct, galois_elt, glk,
                                                  **kw)
            level = ct.level
            ring = self.ring(level)
            if not hasattr(self._cs_base, 'behz'):    # CKKS: NTT domain
                c0 = self._cs_auto_ntt(ct.data[0], galois_elt)
                c1 = self._cs_auto_ntt(ct.data[1], galois_elt)
                e0, e1 = self.switcher.switch(
                    xp, ntt_mod.intt(xp, c1, ring), glk, level,
                    output_ntt=True)
                return Ciphertext(
                    data=xp.stack([_u.addmod(xp, c0, e0, ring.q), e1]),
                    level=level, is_ntt=True, scale=ct.scale)
            # BFV: mirror BfvEngine.apply_galois (any input form,
            # schemes/bfv.py:411) with sharded automorphisms
            out_ntt = kw.get('out_ntt')
            out_mform = kw.get('out_mform')
            out_ntt = ct.is_ntt if out_ntt is None else out_ntt
            out_mform = ct.is_mform if out_mform is None else out_mform
            data = ct.data
            if ct.is_mform:
                data = _u.from_mont(xp, data, ring.q, ring.pinv)
            if ct.is_ntt:
                data = ntt_mod.intt(xp, data, ring)
            c0 = self._cs_auto_coeff(data[0], galois_elt, ring.q)
            c1 = self._cs_auto_coeff(data[1], galois_elt, ring.q)
            e0, e1 = self.switcher.switch(xp, c1, glk, level)
            out = xp.stack([_u.addmod(xp, c0, e0, ring.q), e1])
            if out_ntt:
                out = ntt_mod.ntt(xp, out, ring)
            if out_mform:
                out = _u.to_mont(xp, out, ring.q, ring.pinv, ring.r2)
            return Ciphertext(data=out, level=level, is_ntt=out_ntt,
                              is_mform=out_mform, scale=ct.scale)

        def apply_galois_decomposed(self, xp, dct, galois_elt: int, glk,
                                    **kw):
            if xp is np:
                return self._cs_base.apply_galois_decomposed(
                    xp, dct, galois_elt, glk, **kw)
            level = dct.level
            ring = self.ring(level)
            if not hasattr(self._cs_base, 'behz'):    # CKKS
                c0 = self._cs_auto_ntt(dct.c0, galois_elt)
                digits = self._cs_auto_ntt(dct.digits, galois_elt)
                e0, e1 = self.switcher.switch_from_digits(
                    xp, digits, glk, level, output_ntt=True)
                return Ciphertext(
                    data=xp.stack([_u.addmod(xp, c0, e0, ring.q), e1]),
                    level=level, is_ntt=True, scale=dct.scale)
            out_ntt = bool(kw.get('out_ntt', False))
            out_mform = bool(kw.get('out_mform', False))
            c0 = self._cs_auto_coeff(dct.c0, galois_elt, ring.q)
            digits = self._cs_auto_ntt(dct.digits, galois_elt)
            e0, e1 = self.switcher.switch_from_digits(xp, digits, glk,
                                                      level,
                                                      output_ntt=out_ntt)
            if out_ntt:
                c0 = ntt_mod.ntt(xp, c0, ring)
            data = xp.stack([_u.addmod(xp, c0, e0, ring.q), e1])
            if out_mform:
                data = _u.to_mont(xp, data, ring.q, ring.pinv, ring.r2)
            return Ciphertext(data=data, level=level, is_ntt=out_ntt,
                              is_mform=out_mform, scale=dct.scale)

    Sharded.__name__ = 'CoeffSharded' + cls.__name__
    Sharded.__qualname__ = Sharded.__name__
    return Sharded


@functools.lru_cache(maxsize=None)
def _subclass(cls):
    return _make_subclass(cls)


def make_coeff_sharded_engine(engine, mesh, axis: str = 'coeff'):
    """An engine VIEW of ``engine`` for use INSIDE a shard_map over
    ``mesh``'s ``axis``: all ciphertext/plaintext data arrays passed to its
    ops must be the LOCAL coefficient shards (..., L, n/D). Host entry
    points (encode/encrypt/decrypt, numpy xp) keep full-n semantics."""
    if type(engine).__name__.startswith('CoeffSharded'):
        return engine
    D = mesh.shape[axis]
    if engine.n % (D * D):
        raise ValueError(f'n={engine.n} not divisible by D^2={D * D}')
    sub = _subclass(type(engine))
    obj = object.__new__(sub)
    obj.__dict__.update(engine.__dict__)
    obj._cs_base = engine
    obj._cs_mesh = mesh
    obj._cs_axis = axis
    obj._cs_D = D
    obj._cs_C = engine.n // D
    obj._cs_rings = {}
    obj._cs_behz = {}
    obj.switcher = _ShardedSwitcher(engine.switcher, mesh, axis)
    return obj


def _swap_engine(obj, eng):
    """Shallow-copy a precompute holder (EncodedLinearTransform,
    ChebyshevEvaluator, CkksBootstrapper) onto the sharded engine; the
    encoded-plaintext caches stay SHARED with the original (host-side
    full-n numpy — localized lazily at op entry)."""
    o2 = copy.copy(obj)
    o2.engine = eng
    return o2


def make_coeff_sharded_bootstrapper(btp, mesh, axis: str = 'coeff'):
    """A CkksBootstrapper view whose segments run coeff-sharded: every op
    of every segment dispatches to the distributed bodies. Use inside
    shard_map (see CoeffShardedBootstrap for the packaged runner)."""
    eng = make_coeff_sharded_engine(btp.engine, mesh, axis)
    b2 = _swap_engine(btp, eng)
    b2.cts = [_swap_engine(lt, eng) for lt in btp.cts]
    b2.cts_last_re = _swap_engine(btp.cts_last_re, eng)
    b2.cts_last_im = _swap_engine(btp.cts_last_im, eng)
    b2.stc = [_swap_engine(lt, eng) for lt in btp.stc]
    b2.evalmod = _swap_engine(btp.evalmod, eng)
    return b2


class CoeffShardedBootstrap:
    """Run a whole CKKS bootstrap with the working set coefficient-sharded
    over the mesh — one exhausted ciphertext refreshed ACROSS devices with
    explicit distributed four-step NTTs and coeff-sharded key switches
    (DistNtt / CoeffShardedKeySwitcher composed into Bootstrapper.segments).

    Each segment compiles as its own shard_map program (the segment
    boundary is the production jit-chunking path); ciphertext
    data, rlk, glk and swk keys are all sharded on their coefficient axis,
    so per-device memory for the working set scales 1/D.
    """

    def __init__(self, ctx, mesh, axis: str = 'coeff'):
        self.ctx = ctx
        self.mesh = mesh
        self.axis = axis
        self.btp = make_coeff_sharded_bootstrapper(ctx.engine.bootstrapper,
                                                   mesh, axis)
        self._cache: dict = {}

    def _spec(self, ndim: int):
        from jax.sharding import PartitionSpec as P
        return P(*([None] * (ndim - 1)), self.axis)

    def _seg_jit(self, idx: int, caller_scale: float, meta, nds: int,
                 has_dts: bool, has_std: bool):
        key = (idx, caller_scale, tuple(meta), nds, has_dts, has_std)
        fn = self._cache.get(key)
        if fn is not None:
            return fn
        from jax.sharding import PartitionSpec as P
        meta_out = {}

        def body(ds, rlk, glk, swk_dts, swk_std):
            segs = self.btp.segments(caller_scale, swk_dts, swk_std)
            cts = tuple(Ciphertext(data=d, level=m[0], is_ntt=m[1],
                                   scale=m[2]) for d, m in zip(ds, meta))
            out = segs[idx][1](jnp, cts, rlk, glk)
            meta_out['m'] = tuple((c.level, c.is_ntt, c.scale) for c in out)
            return tuple(c.data for c in out)

        spec3 = self._spec(3)
        spec4 = self._spec(4)
        smap = jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(spec3, spec4, spec4, spec4, spec4),
            out_specs=spec3, check_vma=False)
        jitted = jax.jit(smap)
        fn = (jitted, meta_out)
        self._cache[key] = fn
        return fn

    def __call__(self, ct, progress=None):
        """ct: a level-(step-1) NTT-domain Ciphertext (global arrays).
        Returns the refreshed Ciphertext; bit-identical to the
        single-device Bootstrapper segment walk."""
        ctx = self.ctx
        btp = self.btp
        eng = ctx.engine
        base = btp.step - 1
        if ct.level != base:
            ct = eng.drop_level(np, ct, ct.level - base)
        swk_dts = ctx.swk.get('swk_dts')
        swk_std = ctx.swk.get('swk_std')
        n_segs = len(btp.segments(ct.scale, swk_dts, swk_std))
        datas = (jnp.asarray(ct.data),)
        meta = ((ct.level, ct.is_ntt, ct.scale),)
        for i in range(n_segs):
            jitted, meta_out = self._seg_jit(i, ct.scale, meta, len(datas),
                                             swk_dts is not None,
                                             swk_std is not None)
            datas = jitted(datas, ctx.rlk, ctx.glk.keys, swk_dts, swk_std)
            meta = meta_out['m']
            if progress:
                progress(i + 1, n_segs)
        lv, is_ntt, scale = meta[0]
        return Ciphertext(data=datas[0], level=lv, is_ntt=is_ntt,
                          scale=scale)
