"""Throughput benchmarks (measurement parity with the reference's
examples/benchmark_cpu/benchmark_cpu.cpp: BFV mult_relin, CKKS mult_relin,
BFV rotate — N_OP independent ops, ops/s from wall-clock).

Where the reference extracts parallelism from a 32-thread pool over 1024
graph nodes, this framework batches the independent ops on the device
(parallel/batch.py) — same measurement, hardware-appropriate execution.
Timing uses chained dependencies + an output fetch and reports the
marginal per-call slope (fixed dispatch/fetch overheads stripped).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _common import bfv_params, ckks_params, example_args  # noqa: E402

import numpy as np  # noqa: E402


def slope_time(fn, feedback_arg0, args, iters=8):
    import jax  # noqa: F401

    def chained(k):
        x = feedback_arg0
        t0 = time.perf_counter_ns()
        for _ in range(k):
            x = fn(x, *args)
        np.asarray(jax.tree.leaves(x)[0].ravel()[:4])
        return (time.perf_counter_ns() - t0) / 1e9

    chained(2)
    t1, t2 = chained(iters), chained(2 * iters)
    return (t2 - t1) / iters


def main():
    args = example_args('throughput benchmarks')
    import jax
    import jax.numpy as jnp
    from lattisense_tpu.runtime import BfvContext, CkksContext
    from lattisense_tpu.parallel.batch import (bfv_mult_relin,
                                               ckks_mult_relin_rescale,
                                               key_tree, make_batched_step)
    from lattisense_tpu.schemes.galois import galois_elt_col

    level, batch = 3, 32
    rng = np.random.default_rng(0)

    # --- BFV mult_relin + rotate ---
    _, bp = bfv_params(args.n, args.toy)
    bctx = BfvContext.create_random_context(bp, seed=7)
    elt = galois_elt_col(1, bp.n)
    bctx.gen_galois_keys_for_elements([elt])
    msgs = rng.integers(0, bp.t, (2 * batch, bp.n), dtype=np.uint64)
    cts = [bctx.encrypt(bctx.encode(m, level)) for m in msgs]
    a = jax.device_put(np.stack([c.data for c in cts[:batch]]))
    b = jax.device_put(np.stack([c.data for c in cts[batch:]]))
    keys = jax.device_put(key_tree(bctx, galois_elts=[elt]))

    fn = make_batched_step(bctx.engine, bfv_mult_relin, level, n_inputs=2)
    np.asarray(fn(a, b, keys))
    per = slope_time(fn, a, (b, keys))
    print(f'BFV  mult_relin n={bp.n} level={level}: {batch/per:10.1f} ops/s')

    def rot_step(engine, x, keys):
        return engine.apply_galois(jnp, x, elt, keys['glk'][elt])

    fr = make_batched_step(bctx.engine, rot_step, level, n_inputs=1)
    np.asarray(fr(a, keys))
    per = slope_time(fr, a, (keys,))
    print(f'BFV  rotate_col n={bp.n} level={level}: {batch/per:10.1f} ops/s')

    # --- CKKS mult_relin_rescale ---
    _, cp = ckks_params(args.n, args.toy)
    cctx = CkksContext.create_random_context(cp, seed=9)
    vals = rng.uniform(-1, 1, (2 * batch, cp.slots))
    ccts = [cctx.encrypt(cctx.encode(v, level)) for v in vals]
    ca = jax.device_put(np.stack([c.data for c in ccts[:batch]]))
    cb = jax.device_put(np.stack([c.data for c in ccts[batch:]]))
    ckeys = jax.device_put(key_tree(cctx))

    # rescale drops a limb: chain on the second operand instead
    fc = make_batched_step(cctx.engine, ckks_mult_relin_rescale, level,
                           n_inputs=2, is_ntt=True)
    np.asarray(fc(ca, cb, ckeys))

    def chained(k):
        t0 = time.perf_counter_ns()
        out = None
        for _ in range(k):
            out = fc(ca, cb, ckeys)
        np.asarray(out[0, 0, 0, :4])
        return (time.perf_counter_ns() - t0) / 1e9

    chained(2)
    t1, t2 = chained(8), chained(16)
    per = (t2 - t1) / 8
    print(f'CKKS mult_relin_rescale n={cp.n} level={level}: {batch/per:10.1f} ops/s')


if __name__ == '__main__':
    main()
