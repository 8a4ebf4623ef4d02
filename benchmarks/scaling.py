"""Multi-device scaling efficiency of batched FHE throughput.

Batch sharded over the `op` mesh axis, keys replicated. On several
devices this measures the real thing; on one device or the virtual CPU
mesh (--cpu) it validates the harness and reports the SPMD overhead of
the partitioning.

Run: python benchmarks/scaling.py [--n 4096] [--limbs 3] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=4096)
    ap.add_argument('--limbs', type=int, default=3)
    ap.add_argument('--per-device-batch', type=int, default=4)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()

    import jax
    if args.cpu:
        flags = os.environ.get('XLA_FLAGS', '')
        if '--xla_force_host_platform_device_count' not in flags:
            # one intra-op thread per virtual device: otherwise a single
            # "device" already spans every physical core and the scaling
            # curve only measures oversubscription. Honest reading: points
            # with devices <= physical cores measure SPMD efficiency;
            # beyond that they measure core starvation.
            os.environ['XLA_FLAGS'] = (
                flags + ' --xla_force_host_platform_device_count=8'
                        ' --xla_cpu_multi_thread_eigen=false'
                        ' intra_op_parallelism_threads=1').strip()
        jax.config.update('jax_platforms', 'cpu')
        print(f'physical cores: {os.cpu_count()} — efficiency valid up to '
              f'devices={os.cpu_count()}', flush=True)

    import lattisense_tpu  # noqa: F401
    from lattisense_tpu.utils import compile_cache
    compile_cache.configure()
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                               make_batched_step)
    from lattisense_tpu.parallel.mesh import make_mesh, ct_batch_spec, shard
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = args.n
    q = gen_ntt_primes(n, 50, args.limbs + 1)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    params = BfvParams.create_custom(n, 65537, q, p)
    ctx = BfvContext.create_random_context(params, seed=7)
    level = args.limbs
    rng = np.random.default_rng(0)
    msg = rng.integers(0, params.t, (2, n), dtype=np.uint64)
    c0 = ctx.encrypt(ctx.encode(msg[0], level))
    c1 = ctx.encrypt(ctx.encode(msg[1], level))

    n_dev = len(jax.devices())
    results = {}
    d = 1
    while d <= n_dev:
        B = args.per_device_batch * d
        mesh = make_mesh(op=d, limb=1, devices=jax.devices()[:d])
        fn = make_batched_step(ctx.engine, bfv_mult_relin, level, mesh=mesh,
                               n_inputs=2)
        a = shard(mesh, np.tile(c0.data[None], (B, 1, 1, 1)), ct_batch_spec())
        b = shard(mesh, np.tile(c1.data[None], (B, 1, 1, 1)), ct_batch_spec())
        keys = jax.tree.map(lambda k: jax.device_put(
            k, NamedSharding(mesh, P())), key_tree(ctx))
        out = fn(a, b, keys)
        np.asarray(out).ravel()[:2]

        def run(k):
            t0 = time.perf_counter()
            x = a
            for _ in range(k):
                x = fn(x, b, keys)
            np.asarray(x).ravel()[:2]
            return time.perf_counter() - t0

        run(2)
        t1, t2 = run(4), run(8)
        per = (t2 - t1) / 4
        results[d] = B / per
        eff = results[d] / (results[1] * d) * 100
        print(f'devices={d}: {results[d]:10.1f} ops/s  '
              f'(scaling efficiency {eff:5.1f}%)', flush=True)
        d *= 2

    # limb-TP latency scaling: ONE op's RNS limbs sharded over the limb
    # axis (the single-ciphertext-across-devices axis; meaningful on real
    # devices — on the virtual mesh it validates the harness). Separate
    # context with 4 special primes so key arrays stay divisible under
    # 2/4-way limb sharding — a heavier key switch than the op-loop
    # workload above, so the two sections' numbers are not comparable.
    p4 = gen_ntt_primes(n, 51, 4, exclude=tuple(q))
    ctx_tp = BfvContext.create_random_context(
        BfvParams.create_custom(n, 65537, q, p4), seed=7)
    c0t = ctx_tp.encrypt(ctx_tp.encode(msg[0], level))
    c1t = ctx_tp.encrypt(ctx_tp.encode(msg[1], level))
    B = args.per_device_batch
    for limb in (1, 2, 4):
        if limb > n_dev or (level + 1) % limb:
            continue
        mesh = make_mesh(op=1, limb=limb, devices=jax.devices()[:limb])
        fn = make_batched_step(ctx_tp.engine, bfv_mult_relin, level,
                               mesh=mesh, limb_sharded=(limb > 1),
                               n_inputs=2)
        a = shard(mesh, np.tile(c0t.data[None], (B, 1, 1, 1)),
                  ct_batch_spec(limb > 1))
        b = shard(mesh, np.tile(c1t.data[None], (B, 1, 1, 1)),
                  ct_batch_spec(limb > 1))
        from lattisense_tpu.parallel.mesh import key_spec
        keys = jax.tree.map(lambda k: jax.device_put(
            k, NamedSharding(mesh, key_spec(limb > 1))), key_tree(ctx_tp))
        np.asarray(fn(a, b, keys)).ravel()[:2]

        def run_tp(k):
            t0 = time.perf_counter()
            x = a
            for _ in range(k):
                x = fn(x, b, keys)
            np.asarray(x).ravel()[:2]
            return time.perf_counter() - t0

        run_tp(2)
        t1, t2 = run_tp(4), run_tp(8)
        ms = (t2 - t1) / 4 / B * 1e3
        print(f'limb-TP x{limb}: {ms:8.2f} ms/op latency', flush=True)

    # ---- INTEGRATED op×limb pipeline THROUGHPUT ----
    # ops/s of make_limb_tp_mult_relin and the hoisted-rotation bundle at
    # 2/4/8 virtual devices (limb=2 × op=d/2), normalized per device
    # against the d=2 point. Honest reading on a CPU box: points with
    # devices <= physical cores measure SPMD efficiency, beyond that core
    # starvation (printed with each row). One JSON line per row for the
    # MULTICHIP/BENCH artifacts.
    import json
    from lattisense_tpu.parallel.batch import (make_limb_tp_mult_relin,
                                               make_limb_tp_hoisted_rotations)
    from lattisense_tpu.frontend.custom_task import get_glk_col
    from lattisense_tpu.schemes.galois import galois_elt_col

    cores = os.cpu_count()
    base_mr = base_rot = None
    steps = [1, 2]
    elts = [galois_elt_col(s, n) for s in steps]
    ctx_tp.gen_galois_keys_for_elements(elts)
    for d in (2, 4, 8):
        if d > n_dev or (level + 1) % 2:
            continue
        mesh = make_mesh(op=d // 2, limb=2, devices=jax.devices()[:d])
        B = args.per_device_batch * (d // 2)
        f_mr, prep = make_limb_tp_mult_relin(ctx_tp.engine, level, mesh)
        kd = prep(ctx_tp.rlk.key_q, ctx_tp.rlk.key_p)
        a = shard(mesh, np.tile(c0t.data[None], (B, 1, 1, 1)),
                  ct_batch_spec(False))
        b = shard(mesh, np.tile(c1t.data[None], (B, 1, 1, 1)),
                  ct_batch_spec(False))
        np.asarray(f_mr(a, b, kd)).ravel()[:2]

        def run_mr(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = f_mr(a, b, kd)
            np.asarray(o).ravel()[:2]
            return time.perf_counter() - t0

        run_mr(2)
        t1, t2 = run_mr(4), run_mr(8)
        ops = B / ((t2 - t1) / 4)
        if base_mr is None:
            base_mr = ops / d
        eff = ops / (base_mr * d) * 100
        starve = ' (core-starved)' if d > cores else ''
        print(json.dumps({
            'metric': f'limb_tp_mult_relin_opxlimb_{d}dev_ops_per_s',
            'value': round(ops, 2), 'unit': 'ops/s',
            'vs_baseline': round(eff / 100, 3)}) + starve, flush=True)

        try:
            f_rot, prep_r = make_limb_tp_hoisted_rotations(
                ctx_tp.engine, elts, level, mesh)
            kdr = prep_r({e: ctx_tp.glk.keys[e] for e in elts})
            # the hoisted bundle is a single-ciphertext latency pipeline
            # (one decomposition shared by all rotations)
            ct1 = np.asarray(c0t.data)
            np.asarray(jax.tree.leaves(f_rot(ct1, kdr))[0]).ravel()[:2]

            def run_rot(k):
                t0 = time.perf_counter()
                o = None
                for _ in range(k):
                    o = f_rot(ct1, kdr)
                np.asarray(jax.tree.leaves(o)[0]).ravel()[:2]
                return time.perf_counter() - t0

            run_rot(2)
            t1, t2 = run_rot(4), run_rot(8)
            ops = len(elts) / ((t2 - t1) / 4)
            if base_rot is None:
                base_rot = ops / d
            eff = ops / (base_rot * d) * 100
            print(json.dumps({
                'metric': f'limb_tp_hoisted_rot_opxlimb_{d}dev_ops_per_s',
                'value': round(ops, 2), 'unit': 'rot/s',
                'vs_baseline': round(eff / 100, 3)}) + starve, flush=True)
        except Exception as e:   # hoisted bundle is optional per config
            print(f'hoisted-rotation point skipped at d={d}: {e}',
                  flush=True)

    # ---- COEFFICIENT-axis latency scaling --------------------------------
    # ONE ciphertext's ring dimension sharded over the coeff axis: the
    # sharded-ENGINE mult+relin (distributed four-step NTTs + coeff-sharded
    # key switch, parallel/sharded_engine.py) at D = 1/2/4/8. This is a
    # LATENCY axis (it shrinks one op's critical path and per-device
    # memory), so the row reports ms/op and speedup vs D=1; on the virtual
    # CPU mesh the collectives are memcpys — points <= physical cores
    # indicate SPMD overhead, not interconnect behavior.
    from jax.sharding import Mesh, PartitionSpec
    from lattisense_tpu.schemes.types import Ciphertext
    from lattisense_tpu.parallel.sharded_engine import (
        make_coeff_sharded_engine)
    import jax.numpy as jnp

    eng = ctx_tp.engine
    ct3 = eng.mult(np, c0t, c1t)
    base_ms = None
    for D in (1, 2, 4, 8):
        if D > n_dev or (D > 1 and n % (D * D)):
            continue
        if D == 1:
            f1 = jax.jit(lambda d3: eng.relinearize(
                jnp, Ciphertext(data=d3, level=level, is_ntt=False,
                                scale=1.0), ctx_tp.rlk).data)
            fn_c, args_c = f1, (jnp.asarray(ct3.data),)
        else:
            cmesh = Mesh(np.array(jax.devices()[:D]), ('coeff',))
            eng_sh = make_coeff_sharded_engine(eng, cmesh)

            def body(d3, rlk):
                c = Ciphertext(data=d3, level=level, is_ntt=False,
                               scale=1.0)
                return eng_sh.relinearize(jnp, c, rlk).data

            sp3 = PartitionSpec(None, None, 'coeff')
            sp4 = PartitionSpec(None, None, None, 'coeff')
            fD = jax.jit(jax.shard_map(body, mesh=cmesh,
                                       in_specs=(sp3, sp4), out_specs=sp3,
                                       check_vma=False))
            fn_c, args_c = fD, (jnp.asarray(ct3.data), ctx_tp.rlk)
        np.asarray(fn_c(*args_c)).ravel()[:2]

        def run_c(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = fn_c(*args_c)
            np.asarray(o).ravel()[:2]
            return time.perf_counter() - t0

        run_c(2)
        t1, t2 = run_c(8), run_c(16)
        ms = (t2 - t1) / 8 * 1e3
        if base_ms is None:
            base_ms = ms
        starve = ' (core-starved)' if D > cores else ''
        print(json.dumps({
            'metric': f'coeff_sharded_relin_{D}dev_ms_per_op',
            'value': round(ms, 3), 'unit': 'ms/op',
            'vs_baseline': round(base_ms / ms, 3)}) + starve, flush=True)

    # ---- coeff-sharded FULL BFV mult_relin (BEHZ under shard_map) -------
    # Round-4 capability: the whole BFV pipeline spans the coeff axis
    # (dist dual-basis rings — every BEHZ stage but its NTTs is pointwise
    # per coefficient). Latency row like the relin one above.
    base_mr = None
    for D in (1, 2, 4, 8):
        if D > n_dev or (D > 1 and n % (D * D)):
            continue
        if D == 1:
            fmr1 = jax.jit(lambda da, db: eng.relinearize(
                jnp, eng.mult(jnp,
                              Ciphertext(data=da, level=level, is_ntt=True,
                                         scale=1.0),
                              Ciphertext(data=db, level=level, is_ntt=True,
                                         scale=1.0)), ctx_tp.rlk).data)
            fn_m, args_m = fmr1, (jnp.asarray(c0t.data), jnp.asarray(c1t.data))
        else:
            cmesh = Mesh(np.array(jax.devices()[:D]), ('coeff',))
            eng_shm = make_coeff_sharded_engine(eng, cmesh)

            def body_m(da, db, rlk):
                ca = Ciphertext(data=da, level=level, is_ntt=True, scale=1.0)
                cb = Ciphertext(data=db, level=level, is_ntt=True, scale=1.0)
                return eng_shm.relinearize(jnp, eng_shm.mult(jnp, ca, cb),
                                           rlk).data

            spc = PartitionSpec(None, None, 'coeff')
            spk = PartitionSpec(None, None, None, 'coeff')
            fDm = jax.jit(jax.shard_map(body_m, mesh=cmesh,
                                        in_specs=(spc, spc, spk),
                                        out_specs=spc, check_vma=False))
            fn_m, args_m = fDm, (jnp.asarray(c0t.data), jnp.asarray(c1t.data),
                                 ctx_tp.rlk)
        np.asarray(fn_m(*args_m)).ravel()[:2]

        def run_m(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = fn_m(*args_m)
            np.asarray(o).ravel()[:2]
            return time.perf_counter() - t0

        run_m(2)
        t1, t2 = run_m(8), run_m(16)
        ms = (t2 - t1) / 8 * 1e3
        if base_mr is None:
            base_mr = ms
        starve = ' (core-starved)' if D > cores else ''
        print(json.dumps({
            'metric': f'coeff_sharded_mult_relin_{D}dev_ms_per_op',
            'value': round(ms, 3), 'unit': 'ms/op',
            'vs_baseline': round(base_mr / ms, 3)}) + starve, flush=True)

    # ---- 2-D limb×coeff key-switch latency ------------------------------
    from lattisense_tpu.parallel.coeff_sharded import LimbCoeffKeySwitcher
    x1 = np.asarray(ct3.data[2]) if ct3.data.shape[0] > 2 \
        else np.asarray(ct3.data[1])
    base2 = None
    for (dl, dc) in ((2, 2), (2, 4)):
        if dl * dc > n_dev or n % (dc * dc) or (level + 1) % dl:
            continue
        mesh2 = Mesh(np.array(jax.devices()[:dl * dc]).reshape(dl, dc),
                     ('limb', 'coeff'))
        ks2 = LimbCoeffKeySwitcher(eng.switcher, level, mesh2)
        kd2 = ks2.pad_keys(ctx_tp.rlk.key_q, ctx_tp.rlk.key_p)

        def run_2d(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = ks2._jit(x1, kd2)
            np.asarray(jax.tree.leaves(o)[0]).ravel()[:2]
            return time.perf_counter() - t0

        np.asarray(jax.tree.leaves(ks2._jit(x1, kd2))[0]).ravel()[:2]
        run_2d(2)
        t1, t2 = run_2d(8), run_2d(16)
        ms = (t2 - t1) / 8 * 1e3
        if base2 is None:
            base2 = ms
        starve = ' (core-starved)' if dl * dc > cores else ''
        print(json.dumps({
            'metric': f'limb{dl}_coeff{dc}_keyswitch_ms_per_op',
            'value': round(ms, 3), 'unit': 'ms/op',
            'vs_baseline': round(base2 / ms, 3)}) + starve, flush=True)


if __name__ == '__main__':
    main()
