"""Vectorized negacyclic NTT/INTT over RNS limb stacks (NumPy / JAX).

Iterative Cooley–Tukey (forward, natural → bit-reversed) and
Gentleman–Sande (inverse, bit-reversed → natural) with merged ψ twiddles,
expressed entirely as reshapes + broadcast elementwise ops — no gathers, so
XLA fuses every butterfly stage with its Shoup arithmetic. log2(n) stages
are unrolled at trace time (static shapes). On a GPU the jax path runs the
row-fused kernel of ops/ntt_gpu.py instead (bit-identical).

Arrays are u64 with shape (..., L, n): leading batch dims, L RNS limbs
(one prime per limb, all limbs transformed in parallel), n coefficients.

This replaces the reference's Lattigo/HEonGPU NTT kernels
(SURVEY.md §2.5); the convention "NTT domain" throughout
the framework means *bit-reversed evaluation order*, matching these kernels.
"""

import os

from . import u64 as _u

_USE_NATIVE = os.environ.get('LATTISENSE_NO_NATIVE', '') in ('', '0')

_USE_CONJ_INTT = (os.environ.get('LATTISENSE_CONJ_INTT', '0')
                  not in ('', '0'))
# butterfly radix for the XLA device path: merging levels into one pass
# cuts HBM materializations (the device is bandwidth-bound); 4 = two
# levels per pass. LATTISENSE_NTT_RADIX=2 restores the round-1 code.
_RADIX = int(os.environ.get('LATTISENSE_NTT_RADIX', '4'))

# Word sizes (bytes) whose device transforms run as the row-fused GPU kernel
# (ops/ntt_gpu.py) when the program is compiled for a GPU; other words, and
# every other platform, take the plain XLA path below.
GPU_KERNEL_WORDS = frozenset({4, 8})


def _native():
    if not _USE_NATIVE:
        return None
    from .. import native
    return native if native.available() else None


def _gpu_kernel_ok(xp, x, ring):
    """Whether the GPU kernel can run this device transform (not for host
    arrays, ring views without moduli, other words or shapes)."""
    if xp.__name__ == 'numpy' or getattr(ring, 'moduli', None) is None:
        return False
    from ..ops import ntt_gpu
    return (x.dtype.itemsize in GPU_KERNEL_WORDS
            and ntt_gpu.supported(x.shape[-1], x.dtype))


def _by_platform(xp, x, ring, name, xla_fn):
    """Kernel ``ntt_gpu.<name>`` where the program is lowered for a GPU,
    ``xla_fn`` elsewhere.

    The choice is made per lowering platform (``lax.platform_dependent``),
    not by the process's default backend, so a program placed on CPU
    devices in a GPU process still gets the XLA path. A kernel that fails
    to build or lower on the GPU raises; it never falls back to XLA."""
    if not _gpu_kernel_ok(xp, x, ring):
        return xla_fn(x)
    from jax import lax
    from ..ops import ntt_gpu
    kernel = getattr(ntt_gpu, name)
    return lax.platform_dependent(
        x, cuda=lambda v: kernel(v, ring), default=xla_fn)


def ntt(xp, x, ring):
    """Forward negacyclic NTT. x: u64 (..., L, n) in [0, q). Output bit-reversed."""
    # coefficient-sharded ring view (parallel/sharded_engine.py): inside a
    # shard_map the transform is the distributed four-step NTT; host (np)
    # paths — encode/keygen at trace time — fall back to the full-n ring
    if getattr(ring, 'dist', None) is not None:
        if xp.__name__ != 'numpy':
            return ring.dist.fwd_body(x)
        ring = ring.host
    if xp.__name__ == 'numpy':
        nat = _native()
        if nat is not None:
            if x.dtype.itemsize == 4:
                # native kernels are u64/R=2^64; residues mod q are
                # word-independent, so cast through the u64 ring.
                import numpy as _np
                from .modring import get_rns_ring as _grr
                r64 = _grr(ring.moduli, ring.n, 64)
                return nat.ntt_forward(x.astype(_np.uint64), r64).astype(x.dtype)
            return nat.ntt_forward(x, ring)
    if getattr(ring, 'moduli', None) is not None:
        from ..ops import ntt_mxu
        if ntt_mxu.enabled(xp, x.shape[-1], x.dtype):
            return ntt_mxu.ntt(xp, x, ring)
    return _by_platform(xp, x, ring, 'ntt', lambda v: _ntt_xla(xp, v, ring))


def _ntt_xla(xp, x, ring):
    n = x.shape[-1]
    L = x.shape[-2]
    batch = x.shape[:-2]
    q = ring.q.reshape(L, 1, 1)
    q4 = ring.q.reshape(L, 1, 1, 1)
    tbl = ring.psi_rev
    tbl_sh = ring.psi_rev_shoup

    t = n
    m = 1
    while m < n:
        if _RADIX >= 4 and 4 * m <= n and xp.__name__ != 'numpy':
            # radix-4: two butterfly levels in ONE pass — the XLA device
            # path is HBM-bound at ~1 materialization per level, so
            # merging levels halves NTT traffic (same multiply count).
            t //= 4
            xv = x.reshape(*batch, L, m, 2, 2, t)
            s1 = tbl[:, m:2 * m].reshape(L, m, 1, 1)
            s1_sh = tbl_sh[:, m:2 * m].reshape(L, m, 1, 1)
            s2 = tbl[:, 2 * m:4 * m].reshape(L, m, 2, 1)
            s2_sh = tbl_sh[:, 2 * m:4 * m].reshape(L, m, 2, 1)
            u_ = xv[..., 0, :, :]                     # (…, L, m, 2, t)
            v = _u.shoup_mul(xp, xv[..., 1, :, :], s1, s1_sh, q4)
            p = _u.addmod(xp, u_, v, q4)              # level A outputs
            r = _u.submod(xp, u_, v, q4)
            # level B: pairs within p (twiddle 2m+2k) and r (2m+2k+1)
            pv = _u.shoup_mul(xp, p[..., 1:2, :], s2[:, :, 0:1], s2_sh[:, :, 0:1], q4)
            rv = _u.shoup_mul(xp, r[..., 1:2, :], s2[:, :, 1:2], s2_sh[:, :, 1:2], q4)
            p0 = p[..., 0:1, :]
            r0 = r[..., 0:1, :]
            out = xp.concatenate([_u.addmod(xp, p0, pv, q4),
                                  _u.submod(xp, p0, pv, q4),
                                  _u.addmod(xp, r0, rv, q4),
                                  _u.submod(xp, r0, rv, q4)], axis=-2)
            x = out.reshape(*batch, L, n)
            m *= 4
            continue
        t //= 2
        xv = x.reshape(*batch, L, m, 2, t)
        s = tbl[:, m:2 * m].reshape(L, m, 1)
        s_sh = tbl_sh[:, m:2 * m].reshape(L, m, 1)
        u_ = xv[..., 0, :]
        v = _u.shoup_mul(xp, xv[..., 1, :], s, s_sh, q)
        hi = _u.addmod(xp, u_, v, q)
        lo = _u.submod(xp, u_, v, q)
        x = xp.stack([hi, lo], axis=-2).reshape(*batch, L, n)
        m *= 2
    return x


def _brv_transpose(xp, x, n):
    """Bit-reversal of the last axis as one (2,)*logn axis-reversal
    transpose (a tiled relayout — far cheaper than a gather)."""
    logn = n.bit_length() - 1
    lead = x.shape[:-1]
    k = len(lead)
    x = x.reshape(*lead, *((2,) * logn))
    perm = tuple(range(k)) + tuple(range(k + logn - 1, k - 1, -1))
    return x.transpose(perm).reshape(*lead, n)


def _conj_inv_tables(ring):
    """Per-stage twiddles for the bit-reversal-conjugated (descending
    distance) inverse: W_T[l, g, i] = psi_inv_rev[l, m_core +
    (brv(g·2T+i) >> (k+1))], k = logn-1-log2(T). Conjugation turns the
    GS inverse's ASCENDING butterfly distances into descending ones —
    XLA (like Mosaic) runs ascending stage sequences ~3x slower."""
    cache = getattr(ring, '_conj_inv_tables', None)
    if cache is not None:
        return cache
    import numpy as np
    n = ring.n
    logn = n.bit_length() - 1
    brv = np.zeros(n, dtype=np.int64)
    for bit in range(logn):
        brv |= ((np.arange(n) >> bit) & 1) << (logn - 1 - bit)
    tinv = np.asarray(ring.psi_inv_rev)
    tinv_s = np.asarray(ring.psi_inv_rev_shoup)
    tables = {}
    T = n // 2
    while T >= 1:
        k = logn - 1 - (T.bit_length() - 1)
        m_core = n >> (k + 1)
        m = n // (2 * T)
        p = (np.arange(m)[:, None] * 2 * T + np.arange(T)[None, :]).reshape(-1)
        idx = m_core + (brv[p] >> (k + 1))
        L = tinv.shape[0]
        tables[T] = (tinv[:, idx].reshape(L, m, T),
                     tinv_s[:, idx].reshape(L, m, T))
        T //= 2
    ring._conj_inv_tables = tables
    return tables


def intt(xp, x, ring):
    """Inverse negacyclic NTT. Input bit-reversed, output natural, scaled by n^-1."""
    if getattr(ring, 'dist', None) is not None:   # coeff-sharded ring view
        if xp.__name__ != 'numpy':
            return ring.dist.inv_body(x)
        ring = ring.host
    if xp.__name__ == 'numpy':
        nat = _native()
        if nat is not None:
            if x.dtype.itemsize == 4:
                import numpy as _np
                from .modring import get_rns_ring as _grr
                r64 = _grr(ring.moduli, ring.n, 64)
                return nat.ntt_inverse(x.astype(_np.uint64), r64).astype(x.dtype)
            return nat.ntt_inverse(x, ring)
    if getattr(ring, 'moduli', None) is not None:
        from ..ops import ntt_mxu
        if ntt_mxu.enabled(xp, x.shape[-1], x.dtype):
            return ntt_mxu.intt(xp, x, ring)
    return _by_platform(xp, x, ring, 'intt', lambda v: _intt_xla(xp, v, ring))


def _intt_xla(xp, x, ring):
    if (_USE_CONJ_INTT and xp.__name__ != 'numpy' and x.shape[-1] >= 4
            and getattr(ring, 'moduli', None) is not None):
        # descending-distance formulation: two bit-reversal transposes
        # instead of ascending butterfly distances (opt-in)
        return _intt_conj(xp, x, ring)
    n = x.shape[-1]
    L = x.shape[-2]
    batch = x.shape[:-2]
    q = ring.q.reshape(L, 1, 1)
    q4 = ring.q.reshape(L, 1, 1, 1)
    tbl = ring.psi_inv_rev
    tbl_sh = ring.psi_inv_rev_shoup

    t = 1
    m = n // 2
    while m >= 1:
        if _RADIX >= 4 and m >= 2 and xp.__name__ != 'numpy':
            # radix-4 GS: two levels per pass (see forward comment)
            m2 = m // 2
            xv = x.reshape(*batch, L, m2, 2, 2, t)    # (k, j, i, t)
            s1 = tbl[:, m:2 * m].reshape(L, m2, 2, 1)
            s1_sh = tbl_sh[:, m:2 * m].reshape(L, m2, 2, 1)
            s2 = tbl[:, m2:2 * m2].reshape(L, m2, 1, 1)
            s2_sh = tbl_sh[:, m2:2 * m2].reshape(L, m2, 1, 1)
            u_ = xv[..., 0, :]                        # (…, L, m2, 2, t)
            v = xv[..., 1, :]
            h = _u.addmod(xp, u_, v, q4)
            lo1 = _u.shoup_mul(xp, _u.submod(xp, u_, v, q4), s1, s1_sh, q4)
            # level B pairs j=0 with j=1 (for both h and lo1 lanes)
            a0 = xp.stack([h[..., 0, :], lo1[..., 0, :]], axis=-2)
            a1 = xp.stack([h[..., 1, :], lo1[..., 1, :]], axis=-2)
            hi2 = _u.addmod(xp, a0, a1, q4)
            lo2 = _u.shoup_mul(xp, _u.submod(xp, a0, a1, q4), s2, s2_sh, q4)
            x = xp.concatenate([hi2, lo2], axis=-2).reshape(*batch, L, n)
            t *= 4
            m //= 4
            continue
        xv = x.reshape(*batch, L, m, 2, t)
        s = tbl[:, m:2 * m].reshape(L, m, 1)
        s_sh = tbl_sh[:, m:2 * m].reshape(L, m, 1)
        u_ = xv[..., 0, :]
        v = xv[..., 1, :]
        hi = _u.addmod(xp, u_, v, q)
        lo = _u.shoup_mul(xp, _u.submod(xp, u_, v, q), s, s_sh, q)
        x = xp.stack([hi, lo], axis=-2).reshape(*batch, L, n)
        t *= 2
        m //= 2
    q2 = ring.q.reshape(L, 1)
    return _u.shoup_mul(xp, x, ring.n_inv, ring.n_inv_shoup, q2)


def _intt_conj(xp, x, ring):
    """Conjugated inverse for the device path: x = n^-1·P(conj(P(X))),
    stages at DESCENDING distances (see _conj_inv_tables). Bit-identical
    to the ascending GS formulation (all ops exact mod q)."""
    n = x.shape[-1]
    L = x.shape[-2]
    batch = x.shape[:-2]
    q = ring.q.reshape(L, 1, 1)
    tables = _conj_inv_tables(ring)
    x = _brv_transpose(xp, x, n)
    T = n // 2
    while T >= 1:
        m = n // (2 * T)
        xv = x.reshape(*batch, L, m, 2, T)
        w, w_sh = tables[T]
        u_ = xv[..., 0, :]
        v = xv[..., 1, :]
        hi = _u.addmod(xp, u_, v, q)
        lo = _u.shoup_mul(xp, _u.submod(xp, u_, v, q), w, w_sh, q)
        x = xp.stack([hi, lo], axis=-2).reshape(*batch, L, n)
        T //= 2
    x = _brv_transpose(xp, x, n)
    q2 = ring.q.reshape(L, 1)
    return _u.shoup_mul(xp, x, ring.n_inv, ring.n_inv_shoup, q2)
