#!/usr/bin/env python3
"""End-to-end check that LattiSense runs on an NVIDIA GPU, at full width.

Run from the root of a checkout on a machine with one card:

    python chip_smoke.py               # phases (a)-(f), one card
    python chip_smoke.py --four-cards  # the multi-card path only, 4 cards

Phases (each prints one line with its result and wall time, tagged with
the card's name and power limit; any failure is fatal):

(a) device: jax.devices() must be GPUs, else the script fails.
(b) transforms at real widths, bit-exact against the NumPy golden model:
    core NTT/INTT (the row-fused GPU kernel) on the default BFV chain at
    level 3 with its BEHZ auxiliary basis (u64) and on the 31-bit
    create_tpu_param chain (L=8), B=32, n=16384; ops/ntt_mxu.py with bf16
    and int8 digit planes (exact while the f32 accumulator stays below
    2^24), under default_matmul_precision('highest').
(c) BFV compiled task, n=16384 default parameters: mult_relin then one
    rotate_cols, frontend -> mega_ag.json -> FheTaskTpu(dir).run, three
    requests with fresh inputs; bit-identical to FheTaskTpu(dir,
    mode='eager') and decrypting to the plain mod-t result.
(d) CKKS compiled task, n=16384 default parameters: mult_relin, rescale,
    rotate_cols on inputs encoded at scale 2^40; bit-identical to eager,
    decoded within 1e-5 of float64.
(e) batched primitives (parallel/batch.py make_batched_step, B=32): BFV
    mult_relin and rotate_col on the u64 level-3 chain and on the 31-bit
    chain at matched logQ; entries spot-checked bit-exact against the
    NumPy engine; median of 10 block_until_ready runs (information).
(f) CKKS bootstrap, the reference toy profile (n=8192 dense), as a task
    bootstrap node run by FheTaskTpu in partitioned mode; refreshed output
    within 1e-3 of the input message.

--four-cards runs, on a 4-card mesh and against the same computation on
one card (bit-exact): batched BFV mult_relin on an op x limb (2 x 2) mesh,
make_limb_tp_mult_relin, FheTaskTpu placed over the op axis, and
CoeffShardedRelin + CoeffShardedRotator over 4 cards, all at n=16384.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 16384            # ring size of phases (b)-(e): the reference default set
BATCH = 32           # batch of phases (b) and (e)
REQUESTS = 3         # requests served per compiled task
REPS = 10            # timed runs per batched primitive
SPOT = 4             # batch entries checked against the NumPy engine
CKKS_TOL = 1e-5      # phase (d) decode bound (absolute, inputs in [-1, 1])
CKKS_SCALE = 2.0 ** 40   # phase (d) input scale: the table's own n=16384
                         # scale (2^34) has a fresh-encryption error of
                         # ~1.4e-5, above the bound by itself
BTP_TOL = 1e-3       # phase (f) bound (tests/test_bootstrap.py)

CARD = ''


def phase(name, fn):
    """Run one phase; print its result line with wall time and card."""
    note(f'{name} ...')
    t0 = time.perf_counter()
    detail = fn()
    dt = time.perf_counter() - t0
    print(f'phase {name}: ok {dt:.1f} s | {detail} | card: {CARD}', flush=True)


def note(msg):
    """Progress inside a phase, on standard error."""
    print(f'[smoke] {msg}', file=sys.stderr, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _equal(a, b):
    import numpy as np
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


# ---- (b) transforms -------------------------------------------------------

def phase_transforms():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lattisense_tpu.core import ntt as ntt_mod
    from lattisense_tpu.core.modring import get_rns_ring
    from lattisense_tpu.ops import ntt_mxu
    from lattisense_tpu.params import BfvParams, bfv_aux_basis

    bp = BfvParams.create(N)
    aux, m_sk = bfv_aux_basis(N, tuple(bp.q), tuple(bp.p), 64)
    b32 = BfvParams.create_tpu_param(N)
    cases = [('u64 L3 chain', tuple(bp.q[:4]), 64),
             ('u64 BEHZ aux basis', tuple(aux) + (m_sk,), 64),
             ('u32 chain L=8', tuple(b32.q[:8]), 32)]
    rng = np.random.default_rng(1)
    out = []
    for label, moduli, word in cases:
        ring = get_rns_ring(moduli, N, word)
        dt = np.uint32 if word == 32 else np.uint64
        x = np.stack([rng.integers(0, q, (BATCH, N), dtype=np.uint64).astype(dt)
                      for q in moduli], axis=1)
        want = ntt_mod.ntt(np, x, ring)
        got = jax.jit(lambda v, r=ring: ntt_mod.ntt(jnp, v, r))(x)
        check(_equal(got, want), f'NTT {label} differs from the golden model')
        back = jax.jit(lambda v, r=ring: ntt_mod.intt(jnp, v, r))(want)
        check(_equal(back, x), f'INTT {label} differs from the golden model')
        out.append(f'{label} (B={BATCH}, L={len(moduli)}) bit-exact')

    ring = get_rns_ring(tuple(bp.q[:4]), N, 64)
    x = np.stack([rng.integers(0, q, (BATCH, N), dtype=np.uint64)
                  for q in ring.moduli], axis=1)
    want = ntt_mod.ntt(np, x, ring)
    saved = ntt_mxu._I8DOT
    try:
        for planes, i8 in (('bf16', False), ('int8', True)):
            ntt_mxu._I8DOT = i8
            with jax.default_matmul_precision('highest'):
                got = jax.jit(lambda v: ntt_mxu.ntt(jnp, v, ring))(x)
                back = jax.jit(lambda v: ntt_mxu.intt(jnp, v, ring))(want)
            check(_equal(got, want), f'MXU NTT ({planes} planes) differs')
            check(_equal(back, x), f'MXU INTT ({planes} planes) differs')
            out.append(f'ntt_mxu {planes} planes (u64 L=4) bit-exact')
    finally:
        ntt_mxu._I8DOT = saved
    return '; '.join(out)


# ---- (c), (d) compiled tasks ----------------------------------------------

def _serve(task_dir, ctx, make_inputs, check_plain):
    """REQUESTS fresh requests through FheTaskTpu(dir).run, each compared
    with the eager interpreter bit for bit and checked against plain math."""
    from lattisense_tpu.runtime import FheTaskTpu
    task = FheTaskTpu(task_dir)
    eager = FheTaskTpu(task_dir, mode='eager')
    first_s, ns = None, []
    for r in range(REQUESTS):
        inputs, plain = make_inputs(r)
        t0 = time.perf_counter()
        out, dur = task.run(ctx, inputs)
        if first_s is None:
            first_s = time.perf_counter() - t0
        ns.append(dur)
        ref, _ = eager.run(ctx, inputs)
        for k in out:
            check(_equal(out[k].data, ref[k].data),
                  f'request {r}: output {k} differs from eager')
        check_plain(r, out, plain)
    # run() returns the ns of execution alone; the rest of the first
    # request's wall time is the compile
    return (f'compile {first_s - ns[0] / 1e9:.1f} s; run ns per request '
            f'{ns}')


def phase_bfv_task():
    import numpy as np
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext

    level, step = 3, 1
    bp = BfvParams.create(N)
    fct.set_fhe_param(fct.BfvParam.create_default_param(n=N))
    x, y = fct.BfvCiphertextNode('x', level), fct.BfvCiphertextNode('y', level)
    z = fct.rotate_cols(fct.mult_relin(x, y, 'm'), [step], 'z')[0]
    ctx = BfvContext.create_random_context(bp, seed=11)
    ctx.gen_rotation_keys_for_rotations([step])
    rng = np.random.default_rng(2)

    def make_inputs(r):
        a = rng.integers(0, bp.t, N, dtype=np.uint64)
        b = rng.integers(0, bp.t, N, dtype=np.uint64)
        prod = (a.astype(object) * b % bp.t).astype(np.uint64)
        want = np.roll(prod.reshape(2, -1), -step, axis=1).reshape(-1)
        return ({'x': ctx.encrypt(ctx.encode(a, level)),
                 'y': ctx.encrypt(ctx.encode(b, level))}, want)

    def check_plain(r, out, want):
        check(_equal(ctx.decrypt_decode(out['z']), want),
              f'request {r}: BFV result does not decrypt to the plain result')

    with tempfile.TemporaryDirectory() as d:
        fct.process_custom_task([fct.Argument('x', x), fct.Argument('y', y)],
                                [fct.Argument('z', z)],
                                output_instruction_path=d)
        return ('mult_relin + rotate_cols, bit-identical to eager, decrypts '
                'to plain; ' + _serve(d, ctx, make_inputs, check_plain))


def phase_ckks_task():
    import numpy as np
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksContext

    cp = CkksParams.create(N)
    level, step = cp.max_level, 1
    fct.set_fhe_param(fct.CkksParam.create_default_param(n=N))
    x, y = fct.CkksCiphertextNode('x', level), fct.CkksCiphertextNode('y', level)
    prod = fct.rescale(fct.mult_relin(x, y, 'm'), 'r')
    z = fct.rotate_cols(prod, [step], 'z')[0]
    ctx = CkksContext.create_random_context(cp, seed=13)
    ctx.gen_rotation_keys_for_rotations([step])
    rng = np.random.default_rng(3)
    errs = []

    def make_inputs(r):
        a = rng.uniform(-1, 1, cp.slots)
        b = rng.uniform(-1, 1, cp.slots)
        return ({'x': ctx.encrypt(ctx.encode(a, level, scale=CKKS_SCALE)),
                 'y': ctx.encrypt(ctx.encode(b, level, scale=CKKS_SCALE))},
                np.roll(a * b, -step))

    def check_plain(r, out, want):
        err = float(np.max(np.abs(ctx.decrypt_decode(out['z']).real - want)))
        errs.append(err)
        check(err <= CKKS_TOL, f'request {r}: CKKS error {err:.3e} > {CKKS_TOL}')

    with tempfile.TemporaryDirectory() as d:
        fct.process_custom_task([fct.Argument('x', x), fct.Argument('y', y)],
                                [fct.Argument('z', z)],
                                output_instruction_path=d)
        served = _serve(d, ctx, make_inputs, check_plain)
    return (f'mult_relin + rescale + rotate_cols at level {level}, inputs '
            f'at scale 2^{int(np.log2(CKKS_SCALE))}, bit-identical to eager, '
            f'max decode error {max(errs):.3e} '
            f'(bound {CKKS_TOL}); {served}')


# ---- (e) batched primitives -----------------------------------------------

def _batched_case(label, ctx, level, step_fn, keys, n_inputs, host_fn):
    import jax
    import numpy as np
    from lattisense_tpu.parallel.batch import make_batched_step
    from lattisense_tpu.utils import device

    rng = np.random.default_rng(len(label))
    t = ctx.params.t
    cts = [ctx.encrypt(ctx.encode(rng.integers(0, t, N, dtype=np.uint64), level))
           for _ in range(n_inputs * BATCH)]
    args = [np.stack([c.data for c in cts[i * BATCH:(i + 1) * BATCH]])
            for i in range(n_inputs)]
    f = make_batched_step(ctx.engine, step_fn, level, n_inputs=n_inputs)
    dargs = [jax.device_put(a) for a in args] + [jax.device_put(keys)]
    t0 = time.perf_counter()
    out = np.asarray(f(*dargs))
    compile_s = time.perf_counter() - t0
    for i in np.linspace(0, BATCH - 1, SPOT).astype(int):
        want = host_fn(*[cts[j * BATCH + i] for j in range(n_inputs)])
        check(_equal(out[i], want.data), f'{label}: batch entry {i} differs '
              'from the NumPy engine')
    med, _ = device.median_ms(f, *dargs, reps=REPS)
    return (f'{label}: {SPOT} entries bit-exact, compile {compile_s:.1f} s, '
            f'median {med:.3f} ms per batch of {BATCH} over {REPS} runs')


def phase_batched():
    import jax.numpy as jnp
    import numpy as np
    from lattisense_tpu.parallel.batch import bfv_mult_relin, key_tree
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    from lattisense_tpu.schemes.galois import galois_elt_col

    bp = BfvParams.create(N)
    bp32 = BfvParams.create_tpu_param(N)
    logq = sum(q.bit_length() for q in bp.q[:4])
    lvl32 = 0
    while sum(q.bit_length() for q in bp32.q[:lvl32 + 1]) < logq:
        lvl32 += 1
    lines = []
    for word, params, level in ((64, bp, 3), (32, bp32, lvl32)):
        ctx = BfvContext.create_random_context(params, seed=7)
        eng = ctx.engine
        elt = galois_elt_col(1, N)
        ctx.gen_galois_keys_for_elements([elt])
        keys = key_tree(ctx, galois_elts=[elt])

        def rot(engine, a, k, elt=elt):
            return engine.apply_galois(jnp, a, elt, k['glk'][elt])

        lines.append(_batched_case(
            f'u{word} mult_relin level {level}', ctx, level, bfv_mult_relin,
            keys, 2, lambda a, b, e=eng, c=ctx: e.relinearize(
                np, e.mult(np, a, b), c.rlk)))
        lines.append(_batched_case(
            f'u{word} rotate_col level {level}', ctx, level, rot, keys, 1,
            lambda a, e=eng, c=ctx, g=elt: e.apply_galois(
                np, a, g, c.glk.keys[g])))
    return '; '.join(lines)


# ---- (f) bootstrap --------------------------------------------------------

def btp_profile():
    """The reference toy bootstrap profile (n=8192 dense) -> (frontend
    param, runtime params, BootstrapConfig, seed, h)."""
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig
    fe = CkksBtpParam.create_toy_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(
        cts_depth=fe.cts_params.depth(), stc_depth=fe.stc_params.depth(),
        k=20, sine_deg=39, double_angle=fe.eval_mod_params.double_angle,
        em_scale=float(fe.eval_mod_params.scaling_factor),
        message_ratio=8.0, arcsine=True)
    return fe, params, cfg, 77, 192


def phase_bootstrap():
    import numpy as np
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import CkksBtpContext, FheTaskTpu

    fe, params, cfg, seed, h = btp_profile()
    t0 = time.perf_counter()
    ctx = CkksBtpContext.create_random_context(params, seed=seed, h=h,
                                               btp_config=cfg)
    keygen_s = time.perf_counter() - t0
    note(f'(f) keygen {keygen_s:.1f} s')
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as d:
        fct.set_fhe_param(fe)
        x = fct.CkksCiphertextNode('x', 0)
        z = fct.bootstrap(x, 'z')
        fct.process_custom_task([fct.Argument('x', x)], [fct.Argument('z', z)],
                                output_instruction_path=d)
        task = FheTaskTpu(d, mode='partitioned')
        times, errs = [], []
        for r in range(2):
            msg = rng.uniform(-1, 1, params.slots)
            ct = ctx.encrypt(ctx.encode(msg, 0))
            t0 = time.perf_counter()
            out, _ = task.run(ctx, {'x': ct})
            times.append(time.perf_counter() - t0)
            note(f'(f) run {r}: {times[-1]:.1f} s')
            err = float(np.max(np.abs(ctx.decrypt_decode(out['z']).real - msg)))
            errs.append(err)
            check(err <= BTP_TOL, f'bootstrap error {err:.3e} > {BTP_TOL}')
    return (f'n={params.n} slots={params.slots}: keygen {keygen_s:.1f} s, '
            f'compile {task.last_compile_s:.1f} s (segments in parallel), '
            f'first run (compile + run) {times[0]:.1f} s, second run '
            f'{times[1]:.3f} s, output level {out["z"].level}, max error '
            f'{max(errs):.3e} (bound {BTP_TOL})')


# ---- --four-cards -----------------------------------------------------------

def four_card_phases():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                               make_batched_step,
                                               make_limb_tp_mult_relin)
    from lattisense_tpu.parallel.coeff_sharded import (CoeffShardedRelin,
                                                       CoeffShardedRotator)
    from lattisense_tpu.parallel.mesh import (ct_batch_spec, key_spec,
                                              make_mesh, shard)
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext, FheTaskTpu
    from lattisense_tpu.schemes.galois import galois_elt_col
    from lattisense_tpu.schemes.types import Ciphertext

    devs = jax.devices()
    check(len(devs) >= 4, f'--four-cards needs 4 GPUs, found {len(devs)}')
    level = 3
    bp = BfvParams.create(N)
    ctx = BfvContext.create_random_context(bp, seed=21)
    eng = ctx.engine
    rng = np.random.default_rng(9)
    cts = [ctx.encrypt(ctx.encode(rng.integers(0, bp.t, N, dtype=np.uint64), level))
           for _ in range(2 * BATCH)]
    a = np.stack([c.data for c in cts[:BATCH]])
    b = np.stack([c.data for c in cts[BATCH:]])
    keys = key_tree(ctx)
    # the one-card result every mesh path is compared with: entry k is
    # mult_relin(cts[k], cts[BATCH + k]) on device 0
    one = make_batched_step(eng, bfv_mult_relin, level)
    want = np.asarray(one(a, b, keys))
    mesh = make_mesh(2, limb=2, devices=devs[:4])

    def batched_mesh():
        f = make_batched_step(eng, bfv_mult_relin, level, mesh=mesh,
                              limb_sharded=True)
        args = (shard(mesh, a, ct_batch_spec(True)),
                shard(mesh, b, ct_batch_spec(True)),
                jax.tree.map(lambda k: jax.device_put(
                    k, NamedSharding(mesh, key_spec(True))), keys))
        got = np.asarray(f(*args))
        check(_equal(got, want), 'op x limb mesh mult_relin differs from one card')
        from lattisense_tpu.utils import device
        med, _ = device.median_ms(f, *args, reps=REPS)
        return (f'op x limb (2 x 2) batched mult_relin B={BATCH} bit-exact vs '
                f'one card; median {med:.3f} ms per batch')

    def limb_tp():
        f, prep = make_limb_tp_mult_relin(eng, level, mesh)
        kd = prep(ctx.rlk.key_q, ctx.rlk.key_p)
        got = np.asarray(f(a, b, kd))
        check(_equal(got, want), 'limb-TP mult_relin differs from one card')
        from lattisense_tpu.utils import device
        med, _ = device.median_ms(f, a, b, kd, reps=REPS)
        return (f'make_limb_tp_mult_relin B={BATCH} bit-exact vs one card; '
                f'median {med:.3f} ms per batch')

    def placed_task():
        fct.set_fhe_param(fct.BfvParam.create_default_param(n=N))
        ins, outs, vals = [], [], {}
        for k in range(4):
            xk = fct.BfvCiphertextNode(f'x{k}', level)
            yk = fct.BfvCiphertextNode(f'y{k}', level)
            ins += [fct.Argument(f'x{k}', xk), fct.Argument(f'y{k}', yk)]
            outs.append(fct.Argument(f'z{k}', fct.mult_relin(xk, yk, f'z{k}')))
            vals[f'x{k}'], vals[f'y{k}'] = cts[k], cts[BATCH + k]
        with tempfile.TemporaryDirectory() as d:
            fct.process_custom_task(ins, outs, output_instruction_path=d)
            op_mesh = make_mesh(4, devices=devs[:4])
            placed_task = FheTaskTpu(d, mesh=op_mesh)
            placed, _ = placed_task.run(ctx, vals)
            _, ns = placed_task.run(ctx, vals)
        for k in range(4):
            check(_equal(placed[f'z{k}'].data, want[k]),
                  f'placed task output z{k} differs from one card')
        return (f'FheTaskTpu placed over op=4, 4 mult_relin bit-exact vs one '
                f'card; second task run ns {ns}')

    def coeff_sharded():
        cmesh = Mesh(np.array(devs[:4]), ('coeff',))
        ct3 = eng.mult(np, cts[0], cts[BATCH])
        relin = CoeffShardedRelin(eng.switcher, level, cmesh)
        t0 = time.perf_counter()
        got = relin(np.asarray(ct3.data), ctx.rlk)
        relin_s = time.perf_counter() - t0
        check(_equal(got, want[0]), 'coeff-sharded relin differs from one card')
        elt = galois_elt_col(1, N)
        ctx.gen_galois_keys_for_elements([elt])
        glk = ctx.glk.keys[elt]
        rot = CoeffShardedRotator(eng.switcher, level, cmesh, elt)
        t0 = time.perf_counter()
        got_rot = rot(got, glk)
        rot_s = time.perf_counter() - t0
        ref_rot = jax.jit(lambda d, k: eng.apply_galois(
            jnp, Ciphertext(data=d, level=level), elt, k).data)(got, glk)
        check(_equal(got_rot, ref_rot), 'coeff-sharded rotation differs from one card')
        return (f'CoeffShardedRelin + CoeffShardedRotator over 4 cards bit-exact '
                f'vs one card; first call (compile + run) relin {relin_s:.1f} s, '
                f'rotate {rot_s:.1f} s')

    phase('4-card batched mesh', batched_mesh)
    phase('4-card limb-TP', limb_tp)
    phase('4-card placed task', placed_task)
    phase('4-card coeff-sharded', coeff_sharded)


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description='LattiSense GPU smoke check')
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the multi-card path, on 4 cards')
    args = ap.parse_args(argv)

    import lattisense_tpu  # noqa: F401  (enables x64)
    from lattisense_tpu.utils import compile_cache, device
    compile_cache.configure()

    def phase_device():
        devs = device.require_gpu()
        return (f'{len(devs)} x {devs[0].device_kind} '
                f'({devs[0].platform})')

    t0 = time.perf_counter()
    devs_line = phase_device()
    CARD = device.card_line()
    print(CARD, flush=True)
    print(f'phase (a) device: ok {time.perf_counter() - t0:.1f} s | '
          f'{devs_line} | card: {CARD}', flush=True)
    if args.four_cards:
        four_card_phases()
    else:
        phase('(b) transforms', phase_transforms)
        phase('(c) BFV task', phase_bfv_task)
        phase('(d) CKKS task', phase_ckks_task)
        phase('(e) batched primitives', phase_batched)
        phase('(f) bootstrap', phase_bootstrap)
    print(json.dumps({'ok': True, 'device': device.device_tag()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
