"""Row-fused GPU NTT kernel (ops/ntt_gpu.py) against XLA's plain path.

Per word, on the card:
- one forward and one inverse transform at B=32, n=16384 (u64: the default
  BFV chain at level 3, L=4; u32: the create_tpu_param chain, L=8),
  checked bit-exact against the NumPy golden model;
- end to end, the batched BFV mult_relin of ``make_batched_step`` at B=32
  (u64 at level 3; u32 at the level that matches its logQ), checked
  bit-exact between the two paths.

Each time is the median of ``--reps`` runs ending in ``block_until_ready``,
taken in the order XLA, kernel, kernel, XLA. Every line carries the card's
name and power limit. Exits non-zero when there is no GPU.

    python benchmarks/ntt_gpu_ab.py [--reps 10] [--warps 8,16,32] [--no-e2e]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--warps', default='',
                    help='comma list: also time the kernel at these warp counts')
    ap.add_argument('--no-e2e', action='store_true')
    ap.add_argument('--words', default='32,64')
    args = ap.parse_args()

    import lattisense_tpu  # noqa: F401  (x64)
    from lattisense_tpu.utils import compile_cache, device
    compile_cache.configure()
    device.require_gpu()
    card = device.card_line()
    print(f'card: {card}', flush=True)

    import jax
    import jax.numpy as jnp
    from lattisense_tpu.core import ntt as ntt_mod
    from lattisense_tpu.core.modring import get_rns_ring
    from lattisense_tpu.ops import ntt_gpu
    from lattisense_tpu.params import BfvParams

    B, n = args.batch, 16384
    kernel_words = ntt_mod.GPU_KERNEL_WORDS

    def emit(**kw):
        kw['card'] = card
        print(json.dumps(kw), flush=True)

    def variant(use_kernel):
        ntt_mod.GPU_KERNEL_WORDS = kernel_words if use_kernel else frozenset()

    def ab(make, label, reps):
        """make(use_kernel) -> fn of no args, traced on its first call
        (under that variant); timed in the order XLA, K, K, XLA."""
        fns = {}
        for k in (False, True):
            variant(k)
            t0 = time.perf_counter()
            fns[k] = make(k)
            jax.block_until_ready(fns[k]())
            emit(case=label, path='kernel' if k else 'xla',
                 compile_and_first_run_s=time.perf_counter() - t0)
        variant(True)
        med = {False: [], True: []}
        for k in (False, True, True, False):
            m, _ = device.median_ms(fns[k], reps=reps)
            med[k].append(m)
        out = {('kernel' if k else 'xla'): v for k, v in med.items()}
        emit(case=label, median_ms=out,
             kernel_over_xla=min(out['kernel']) / min(out['xla']))
        return fns

    for word in [int(w) for w in args.words.split(',')]:
        if word == 64:
            bp = BfvParams.create(n)
            moduli, level = tuple(bp.q[:4]), 3
        else:
            bp = BfvParams.create_tpu_param(n)
            moduli, level = tuple(bp.q[:8]), 7
        ring = get_rns_ring(moduli, n, word)
        dt = np.uint32 if word == 32 else np.uint64
        rng = np.random.default_rng(word)
        x = np.stack([rng.integers(0, qi, (B, n), dtype=np.uint64).astype(dt)
                      for qi in moduli], axis=1)               # (B, L, n)
        want_f = ntt_mod.ntt(np, x, ring)
        xd = jax.device_put(x)
        fd = jax.device_put(want_f)

        # correctness of the kernel itself, at the real width
        t0 = time.perf_counter()
        got_f = np.asarray(jax.jit(lambda v: ntt_gpu.ntt(v, ring))(xd))
        got_i = np.asarray(jax.jit(lambda v: ntt_gpu.intt(v, ring))(fd))
        ok = bool(np.array_equal(got_f, want_f) and np.array_equal(got_i, x))
        emit(case=f'u{word} kernel check B={B} L={len(moduli)} n={n}',
             bit_exact=ok, compile_and_run_s=time.perf_counter() - t0)
        if not ok:
            raise SystemExit(f'u{word}: kernel is not bit-exact')

        for name, fn, arg in (('ntt', ntt_mod.ntt, xd), ('intt', ntt_mod.intt, fd)):
            def make(k, fn=fn, arg=arg):
                f = jax.jit(lambda v: fn(jnp, v, ring))
                return lambda: f(arg)
            ab(make, f'u{word} {name} B={B} L={len(moduli)} n={n}', args.reps)

        for w in [int(v) for v in args.warps.split(',') if v]:
            saved = ntt_gpu._num_warps
            ntt_gpu._num_warps = lambda n_, i_, w=w: w
            try:
                f = jax.jit(lambda v: ntt_gpu.ntt(v, ring))
                t0 = time.perf_counter()
                jax.block_until_ready(f(xd))
                c = time.perf_counter() - t0
                m, _ = device.median_ms(f, xd, reps=args.reps)
                emit(case=f'u{word} ntt kernel num_warps={w}', median_ms=m,
                     compile_s=c)
            finally:
                ntt_gpu._num_warps = saved

        if args.no_e2e:
            continue
        from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                                   make_batched_step)
        from lattisense_tpu.runtime import BfvContext
        ctx = BfvContext.create_random_context(bp, seed=7)
        msgs = rng.integers(0, bp.t, (2 * B, n), dtype=np.uint64)
        cts = [ctx.encrypt(ctx.encode(m, level)).data for m in msgs]
        a = jax.device_put(np.stack(cts[:B]))
        b = jax.device_put(np.stack(cts[B:]))
        keys = jax.device_put(key_tree(ctx))

        def make_e2e(k):
            f = make_batched_step(ctx.engine, bfv_mult_relin, level)
            return lambda: f(a, b, keys)

        fns = ab(make_e2e, f'u{word} BFV mult_relin B={B} level={level} n={n}',
                 args.reps)
        same = bool(np.array_equal(np.asarray(fns[False]()),
                                   np.asarray(fns[True]())))
        emit(case=f'u{word} BFV mult_relin kernel vs xla', bit_exact=same)
        if not same:
            raise SystemExit(f'u{word}: mult_relin differs between paths')


if __name__ == '__main__':
    main()
