"""Microbenchmarks of the core kernels on the current backend.

Reports per-op time (median of block_until_ready runs) and the bandwidth
that the minimal traffic would need, so kernel work targets the real
bottleneck (integer arithmetic vs device-memory traffic).
Run: python benchmarks/micro.py [--n 16384] [--limbs 4] [--batch 32]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import numpy as np


def timeit(fn, *args, iters=10):
    """Median seconds of ``fn(*args)`` over ``iters`` block_until_ready runs."""
    from lattisense_tpu.utils import device
    med, _ = device.median_ms(fn, *args, reps=iters)
    return med / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=16384)
    ap.add_argument('--limbs', type=int, default=4)
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    import lattisense_tpu  # noqa: F401
    from lattisense_tpu.utils import compile_cache
    compile_cache.configure()
    import jax.numpy as jnp
    from lattisense_tpu.core import ntt as ntt_mod
    from lattisense_tpu.core import u64 as _u
    from lattisense_tpu.core.modring import get_rns_ring, gen_ntt_primes

    n, L, B = args.n, args.limbs, args.batch
    q = gen_ntt_primes(n, 55, L)
    ring = get_rns_ring(tuple(q), n)
    rng = np.random.default_rng(0)
    x = rng.integers(0, q[0], (B, L, n), dtype=np.uint64) % np.array(q)[None, :, None].astype(np.uint64)
    xd = jnp.asarray(x)
    y = jnp.asarray(rng.integers(0, q[0], (B, L, n), dtype=np.uint64))

    bytes_rw = 2 * x.nbytes  # one read + one write

    ntt_f = jax.jit(lambda v: ntt_mod.ntt(jnp, v, ring))
    t = timeit(ntt_f, xd)
    print(f'ntt        (B={B},L={L},n={n}): {t*1e6:9.1f} us  '
          f'{x.nbytes/1e6:.1f}MB  minimal-traffic BW {bytes_rw/t/1e9:7.1f} GB/s')

    intt_f = jax.jit(lambda v: ntt_mod.intt(jnp, v, ring))
    t = timeit(intt_f, ntt_f(xd))
    print(f'intt                          : {t*1e6:9.1f} us')

    mm = jax.jit(lambda a, b: _u.mont_mul(jnp, a, b, ring.q, ring.pinv))
    t = timeit(mm, xd, y)
    print(f'mont_mul pointwise            : {t*1e6:9.1f} us  BW {3*x.nbytes/t/1e9:7.1f} GB/s')

    am = jax.jit(lambda a, b: _u.addmod(jnp, a, b, ring.q))
    t = timeit(am, xd, y)
    print(f'addmod pointwise              : {t*1e6:9.1f} us  BW {3*x.nbytes/t/1e9:7.1f} GB/s')

    sm = jax.jit(lambda a: _u.shoup_mul(jnp, a, ring.psi_rev, ring.psi_rev_shoup, ring.q))
    t = timeit(sm, xd)
    print(f'shoup_mul pointwise           : {t*1e6:9.1f} us  BW {2*x.nbytes/t/1e9:7.1f} GB/s')

    # key-switch at this level
    from lattisense_tpu.schemes.keyswitch import KeySwitcher
    p = gen_ntt_primes(n, 56, 1, exclude=tuple(q))
    sw = KeySwitcher(tuple(q), tuple(p), n)
    from lattisense_tpu.schemes import keys as K
    sk = K.SecretKey(K.sample_ternary(rng, n))
    ksk = K.gen_keyswitch_key(rng, sk, lambda mods: sk.ntt_form(tuple(mods), n),
                              tuple(q), tuple(p), n)
    ks = jax.jit(lambda v: sw.switch(jnp, v, ksk, L - 1))
    t = timeit(ks, xd, iters=4)
    print(f'key_switch (hybrid)           : {t*1e6:9.1f} us')

    from lattisense_tpu.core.rns import BasisConv
    dst = gen_ntt_primes(n, 56, L + 1, exclude=tuple(q) + tuple(p))
    conv = BasisConv(tuple(q), tuple(dst))
    yd = jnp.asarray(conv.decompose(np, x))
    cv = jax.jit(lambda v: conv.convert(jnp, v))
    t = timeit(cv, yd)
    print(f'bconv {L}->{L+1} (xla)            : {t*1e6:9.1f} us')


if __name__ == '__main__':
    main()
