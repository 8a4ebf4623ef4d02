"""Row-fused negacyclic NTT/INTT for NVIDIA GPUs (Pallas, Triton route).

One program per (batch·limb) row: the row is loaded once, all log2(n)
butterfly stages run on chip (Triton keeps the row in registers and
exchanges lanes through shared memory at each stage's re-layout), and the
row is stored once. The plain XLA path (core/ntt.py) instead makes one
pass over the whole (…, L, n) array per two stages.

Word-generic: u32 rows (31-bit chains, R = 2^32) and u64 rows (R = 2^64)
share the kernel body. On the card the high word of a Shoup product is one
``mul.hi.u32`` / ``mul.hi.u64`` instruction; under ``interpret=True`` (CPU
tests) it is the portable formula of core/u64.py ``mulhi``.

Bit-exact with core/ntt.py: forward is Cooley–Tukey natural → bit-reversed
with ``psi_rev`` twiddles, inverse is Gentleman–Sande bit-reversed →
natural with ``psi_inv_rev`` twiddles and the n^-1 scale. Twiddles and
their Shoup companions are read from global memory (L2-resident), one
contiguous ``[m, 2m)`` slice per stage.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import u64 as _u

# A row is held on chip whole: cap its bytes at what one block can keep
# (data plus one re-layout buffer within the 227 KB of shared memory).
MAX_ROW_BYTES = 1 << 17

# inline PTX for the high word of a u32/u64 product, on signless ints
_MULHI_ASM = {np.dtype(np.uint32): ('mul.hi.u32 $0, $1, $2;', '=r,r,r', jnp.int32),
              np.dtype(np.uint64): ('mul.hi.u64 $0, $1, $2;', '=l,l,l', jnp.int64)}


def supported(n: int, dtype) -> bool:
    """Whether the kernel handles rows of ``n`` words of ``dtype``."""
    dtype = np.dtype(dtype)
    return (dtype in (np.uint32, np.uint64) and n >= 2 and n & (n - 1) == 0
            and n * dtype.itemsize <= MAX_ROW_BYTES)


def _num_warps(n: int, itemsize: int) -> int:
    # ~2 KB of row data per warp, between 4 and 32 warps
    return int(min(32, max(4, n * itemsize // 2048)))


def _mulhi(a, b, asm: bool):
    if not asm:
        return _u.mulhi(jnp, a, b)
    code, constraints, signless = _MULHI_ASM[np.dtype(a.dtype)]
    shape = jnp.broadcast_shapes(a.shape, b.shape)   # the asm op is elementwise
    [r] = plgpu.elementwise_inline_asm(
        code, args=[lax.bitcast_convert_type(jnp.broadcast_to(v, shape), signless)
                    for v in (a, b)],
        constraints=constraints, pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(shape, signless)])
    return lax.bitcast_convert_type(r, a.dtype)


def _shoup(a, w, ws, q, asm):
    r = a * w - _mulhi(a, ws, asm) * q
    return jnp.where(r >= q, r - q, r)


def _split_pairs(x, m, t):
    """(n,) → the two butterfly halves, each (m, t, 1): element [g, j] of
    the first is x[g·2t + j], of the second x[g·2t + t + j]."""
    y = x.reshape(m, 2, t).transpose(0, 2, 1)           # (m, t, 2)
    u, v = jnp.split(y, 2, axis=-1)
    return u, v


def _join_pairs(hi, lo, n):
    y = jnp.concatenate([hi, lo], axis=-1)               # (m, t, 2)
    return y.transpose(0, 2, 1).reshape(n)


def _kernel(x_ref, w_ref, ws_ref, c_ref, o_ref, *, n, inverse, asm):
    """One row. c_ref holds (q, n^-1, Shoup(n^-1), 0) for the row's limb."""
    x = x_ref[...]
    q = c_ref[0]
    if not inverse:
        m, t = 1, n
        while m < n:
            t //= 2
            u, v = _split_pairs(x, m, t)
            w = w_ref[m:2 * m].reshape(m, 1, 1)
            ws = ws_ref[m:2 * m].reshape(m, 1, 1)
            v = _shoup(v, w, ws, q, asm)
            x = _join_pairs(_u.addmod(jnp, u, v, q), _u.submod(jnp, u, v, q), n)
            m *= 2
    else:
        m, t = n // 2, 1
        while m >= 1:
            u, v = _split_pairs(x, m, t)
            w = w_ref[m:2 * m].reshape(m, 1, 1)
            ws = ws_ref[m:2 * m].reshape(m, 1, 1)
            lo = _shoup(_u.submod(jnp, u, v, q), w, ws, q, asm)
            x = _join_pairs(_u.addmod(jnp, u, v, q), lo, n)
            t *= 2
            m //= 2
        x = _shoup(x, c_ref[1], c_ref[2], q, asm)
    o_ref[...] = x


@functools.lru_cache(maxsize=None)
def _row_consts(ring, inverse: bool):
    """(L, n) twiddles + Shoup companions and the (L, 4) scalar table."""
    dt = ring.q.dtype
    if inverse:
        w, ws = ring.psi_inv_rev, ring.psi_inv_rev_shoup
    else:
        w, ws = ring.psi_rev, ring.psi_rev_shoup
    L = ring.q.shape[0]
    c = np.zeros((L, 4), dtype=dt)
    c[:, 0] = ring.q[:, 0]
    c[:, 1] = ring.n_inv[:, 0]
    c[:, 2] = ring.n_inv_shoup[:, 0]
    return np.asarray(w), np.asarray(ws), c


def _pallas(x, w, ws, c, *, inverse: bool, interpret: bool):
    """The kernel over (B, L, n) rows with (L, n) tables: grid (B, L)."""
    B, L, n = x.shape
    row_spec = pl.BlockSpec((None, None, n), lambda b, l: (b, l, 0))
    limb_spec = pl.BlockSpec((None, n), lambda b, l: (l, 0))
    kernel = functools.partial(_kernel, n=n, inverse=inverse,
                               asm=not interpret)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(B, L),
        in_specs=[row_spec, limb_spec, limb_spec,
                  pl.BlockSpec((None, 4), lambda b, l: (l, 0))],
        out_specs=row_spec,
        backend='triton',
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(n, x.dtype.itemsize), num_stages=1),
        interpret=interpret,
        name='lattisense_intt' if inverse else 'lattisense_ntt',
    )(x, w, ws, c)


def _local_shardings(mesh, x_sharding):
    """Shardings the kernel runs under: x keeps its batch and limb axes and
    is whole along n; the tables follow x's limb axis."""
    spec = tuple(getattr(x_sharding, 'spec', ())) + (None, None, None)
    b, l = spec[0], spec[1]
    return NamedSharding(mesh, P(b, l, None)), NamedSharding(mesh, P(l, None))


@functools.lru_cache(maxsize=None)
def _entry(inverse: bool, interpret: bool):
    """The kernel as one op that a sharded program partitions along batch
    and limb axes (never along n), and that vmap folds into its batch."""
    call = functools.partial(_pallas, inverse=inverse, interpret=interpret)

    @custom_partitioning
    def part(x, w, ws, c):
        return call(x, w, ws, c)

    def partition(mesh, arg_shapes, result_shape):
        x_sh, t_sh = _local_shardings(mesh, arg_shapes[0].sharding)
        return mesh, call, x_sh, (x_sh, t_sh, t_sh, t_sh)

    def infer(mesh, arg_shapes, result_shape):
        return _local_shardings(mesh, arg_shapes[0].sharding)[0]

    part.def_partition(partition=partition,
                       infer_sharding_from_operands=infer,
                       sharding_rule='b l n, l n, l n, l c -> b l n',
                       need_replication_factors=('n', 'c'))

    @jax.custom_batching.custom_vmap
    def entry(x, w, ws, c):
        return part(x, w, ws, c)

    @entry.def_vmap
    def _fold_vmap(axis_size, in_batched, x, w, ws, c):
        if any(in_batched[1:]):
            raise NotImplementedError('NTT tables must not be batched')
        if not in_batched[0]:
            return entry(x, w, ws, c), False
        rows = x.reshape(axis_size * x.shape[1], *x.shape[2:])
        return entry(rows, w, ws, c).reshape(x.shape), True

    return entry


def _call(x, ring, inverse: bool, interpret: bool):
    n = x.shape[-1]
    L = x.shape[-2]
    if x.dtype != ring.q.dtype:
        raise TypeError(f'row dtype {x.dtype} does not match the ring word '
                        f'{ring.q.dtype}')
    if n != ring.n or L > ring.q.shape[0]:
        raise ValueError(f'rows (..., {L}, {n}) do not fit ring '
                         f'(L={ring.q.shape[0]}, n={ring.n})')
    if not supported(n, x.dtype):
        raise ValueError(f'no GPU NTT kernel for n={n} {x.dtype} rows')
    w, ws, c = _row_consts(ring, inverse)
    out = _entry(inverse, interpret)(
        x.reshape(-1, L, n), jnp.asarray(w[:L]), jnp.asarray(ws[:L]),
        jnp.asarray(c[:L]))
    return out.reshape(x.shape)


def ntt(x, ring, *, interpret: bool = False):
    """Forward negacyclic NTT of (..., L, n) rows; same output as core.ntt.ntt."""
    return _call(x, ring, False, interpret)


def intt(x, ring, *, interpret: bool = False):
    """Inverse negacyclic NTT of (..., L, n) rows; same output as core.ntt.intt."""
    return _call(x, ring, True, interpret)
