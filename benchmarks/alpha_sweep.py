"""Key-switch digit-size (alpha) sweep on the w32 BFV mult_relin pipeline.

The hybrid key switch decomposes the ct3 quadratic part into
beta = ceil((L+1)/alpha) digits; each digit is lifted to Q_l u P
(T = L+1+alpha limbs) and NTT'd, so the dominant mod-up/NTT row count is
beta*T while the gadget inner product sums beta terms over T rows:

    alpha=2: beta=4, rows 40
    alpha=3: beta=3, rows 33
    alpha=4: beta=2, rows 24   (the create_tpu_param default at L=7)

Larger alpha trades fewer digits (less NTT + inner-product work) against
more special-prime limbs carried through every key-switch tail (mod-down
rows, key size) and a larger noise bound (digit magnitude ~ alpha*2^62 /
Q_d). Correctness at alpha 1-4 is CPU-verified (mult_relin + rotate
bit-exact vs the golden engine); this benchmark measures the on-chip
throughput of each point with the same chained-slope method as bench.py
(the device is whatever JAX selects: JAX_PLATFORMS=cpu for host runs).

Reference anchor: the hybrid decomposition mirrors Lattigo's
(#P = digit size), reference key layout `abi/c_types.h:40-52`
(CKeySwitchKey.n_public_key = beta).

Usage:  python benchmarks/alpha_sweep.py [--alphas 2,3,4]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--alphas', default='2,3,4')
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--n', type=int, default=16384)
    args = ap.parse_args()

    import lattisense_tpu  # noqa: F401  (x64 config)
    import jax
    from lattisense_tpu.utils import compile_cache
    compile_cache.configure()
    from lattisense_tpu.params import BfvParams, _load_table
    from lattisense_tpu.runtime import BfvContext
    from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                               make_batched_step)

    entry = _load_table()['BFV'][str(args.n)]
    log_q = sum(int(x).bit_length() for x in entry['q'])
    # Match bench.py's headline config: level with logQ >= the default
    # chain's L3 budget.
    logq_l3 = sum(int(q).bit_length() for q in entry['q'][:4])

    rng = np.random.default_rng(0)
    results = {}
    for alpha in [int(a) for a in args.alphas.split(',')]:
        t0 = time.time()
        bp = BfvParams.create_tpu_custom(args.n, entry['t'], log_q=log_q,
                                         log_p=alpha * 31)
        assert len(bp.p) == alpha, (len(bp.p), alpha)
        lvl = 0
        while sum(q.bit_length() for q in bp.q[:lvl + 1]) < logq_l3:
            lvl += 1
        ctx = BfvContext.create_random_context(bp, seed=7)
        msgs = rng.integers(0, bp.t, (2 * args.batch, bp.n), dtype=np.uint64)
        cts = [ctx.encrypt(ctx.encode(m, lvl)) for m in msgs]
        a = jax.device_put(np.stack([c.data for c in cts[:args.batch]]))
        b = jax.device_put(np.stack([c.data for c in cts[args.batch:]]))
        keys = jax.device_put(key_tree(ctx))
        fn = make_batched_step(ctx.engine, bfv_mult_relin, lvl, n_inputs=2)

        out = np.asarray(fn(a, b, keys))          # compile + warm
        # correctness: one op decrypts to the slotwise product mod t
        from lattisense_tpu.schemes.types import Ciphertext
        got = ctx.decrypt_decode(Ciphertext(out[0], lvl))
        want = (msgs[0].astype(object) * msgs[args.batch].astype(object)
                ) % bp.t
        ok = bool(np.array_equal(got.astype(object), want))

        def chained(k):
            x = a
            t0 = time.perf_counter_ns()
            for _ in range(k):
                x = fn(x, b, keys)
            np.asarray(x.ravel()[:4])
            return (time.perf_counter_ns() - t0) / 1e9

        chained(2)
        t1, t2 = chained(8), chained(16)
        ops_s = args.batch / ((t2 - t1) / 8)
        beta = -(-(lvl + 1) // alpha)
        results[alpha] = ops_s
        print(json.dumps({
            'metric': f'bfv_mult_relin_w32_alpha{alpha}', 'value':
            round(ops_s, 1), 'unit': 'ops/s', 'beta': beta,
            'rows': beta * (lvl + 1 + alpha), 'level': lvl,
            'bit_exact': ok, 'wall_s': round(time.time() - t0, 1)}),
            flush=True)
    best = max(results, key=results.get)
    print(f'# best: alpha={best} at {results[best]:.0f} ops/s', flush=True)


if __name__ == '__main__':
    main()
