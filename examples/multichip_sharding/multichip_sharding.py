"""Example: the three sharding axes on a multi-device mesh.

Demonstrates, end-to-end on a virtual (or real) device mesh:

1. **op axis** — a batch of independent mult_relin ops sharded across
   devices (graph-level data parallelism: the reference thread pool's
   role, SURVEY §2.8);
2. **limb axis** — ONE ciphertext's RNS limbs sharded: the integrated
   op×limb pipeline (explicit psum_scatter key switch);
3. **coefficient axis** — ONE ciphertext's ring coefficients sharded:
   the distributed four-step NTT, with relinearization and a rotation
   executed coefficient-sharded (all_to_all between butterfly phases).

Every result is asserted bit-exact against the single-device path.
Run:  python examples/multichip_sharding/multichip_sharding.py --toy
(forces an 8-device virtual CPU mesh when fewer devices are present).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _common import example_args  # noqa: E402

import numpy as np  # noqa: E402


def main():
    args = example_args('multi-chip sharding (op / limb / coeff axes)')
    flags = os.environ.get('XLA_FLAGS', '')
    if '--xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8').strip()
    import jax

    import lattisense_tpu  # noqa: F401
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                               make_batched_step,
                                               make_limb_tp_mult_relin)
    from lattisense_tpu.parallel.coeff_sharded import (CoeffShardedRelin,
                                                       CoeffShardedRotator)
    from lattisense_tpu.parallel.mesh import make_mesh, ct_batch_spec, shard
    from lattisense_tpu.schemes.galois import galois_elt_col
    from lattisense_tpu.schemes.types import Ciphertext

    n = 256 if args.toy else 4096
    t, level = 65537, 3
    q = gen_ntt_primes(n, 50, 4)
    p = gen_ntt_primes(n, 51, 2, exclude=tuple(q))
    params = BfvParams.create_custom(n, t, q, p)
    ctx = BfvContext.create_random_context(params, seed=42)
    gal = galois_elt_col(1, n)
    ctx.gen_galois_keys_for_elements([gal])

    rng = np.random.default_rng(0)
    m1 = rng.integers(0, t, n, dtype=np.uint64)
    m2 = rng.integers(0, t, n, dtype=np.uint64)
    a = ctx.encrypt(ctx.encode(m1, level))
    b = ctx.encrypt(ctx.encode(m2, level))
    golden = ctx.engine.relinearize(np, ctx.engine.mult(np, a, b), ctx.rlk)

    # ---- 1. op axis: batch of ops sharded over 4 devices ----------------
    mesh = make_mesh(op=4, limb=1, devices=jax.devices()[:4])
    fn = make_batched_step(ctx.engine, bfv_mult_relin, level, mesh=mesh,
                           n_inputs=2)
    B = 8
    ad = shard(mesh, np.tile(a.data[None], (B, 1, 1, 1)), ct_batch_spec())
    bd = shard(mesh, np.tile(b.data[None], (B, 1, 1, 1)), ct_batch_spec())
    keys = jax.tree.map(lambda k: jax.device_put(
        k, NamedSharding(mesh, P())), key_tree(ctx))
    out = np.asarray(fn(ad, bd, keys))
    assert np.array_equal(out[0], np.asarray(golden.data))
    print(f'op axis: {B} ops sharded over 4 devices — bit-exact')

    # ---- 2. op×limb: integrated pipeline (explicit-collective switch) ---
    mesh2 = make_mesh(op=2, limb=2, devices=jax.devices()[:4])
    f2, prep = make_limb_tp_mult_relin(ctx.engine, level, mesh2)
    kd = prep(ctx.rlk.key_q, ctx.rlk.key_p)
    out2 = np.asarray(f2(ad[:4], bd[:4], kd))
    assert np.array_equal(out2[0], np.asarray(golden.data))
    print('op×limb: RNS limbs of each key switch sharded — bit-exact')

    # ---- 3. coeff axis: ONE ciphertext spanning 4 devices ---------------
    cmesh = Mesh(np.array(jax.devices()[:4]), ('coeff',))
    ct3 = ctx.engine.mult(np, a, b)
    relin = CoeffShardedRelin(ctx.engine.switcher, level, cmesh)
    got = relin(np.asarray(ct3.data), ctx.rlk)
    assert np.array_equal(got, np.asarray(golden.data))
    rot = CoeffShardedRotator(ctx.engine.switcher, level, cmesh, gal)
    got_rot = rot(got, ctx.glk.keys[gal])
    ref_rot = ctx.engine.apply_galois(
        np, Ciphertext(data=got, level=level), gal, ctx.glk.keys[gal])
    assert np.array_equal(got_rot, np.asarray(ref_rot.data))
    dec = ctx.decrypt_decode(Ciphertext(data=got_rot, level=level))
    prod = (m1 * m2) % t
    half = n // 2
    expect = np.concatenate([np.roll(prod[:half], -1),
                             np.roll(prod[half:], -1)])
    assert np.array_equal(dec, expect)
    print('coeff axis: one ciphertext over 4 devices (distributed NTT), '
          'relin + rotation — bit-exact, decrypts to the oracle')

    # ---- 4. the sharded ENGINE: unmodified scheme code inside shard_map --
    # (round 4: the production composition — every transform of the
    # ordinary engine op surface dispatches to the distributed bodies)
    import jax.numpy as jnp
    from lattisense_tpu.parallel.sharded_engine import (
        make_coeff_sharded_engine)
    eng_sh = make_coeff_sharded_engine(ctx.engine, cmesh)

    def body(da, db, rlk, glk):
        ca = Ciphertext(data=da, level=level, is_ntt=False)
        cb = Ciphertext(data=db, level=level, is_ntt=False)
        c = eng_sh.relinearize(jnp, eng_sh.mult(jnp, ca, cb), rlk)
        return eng_sh.apply_galois(jnp, c, gal, glk).data

    sp3, sp4 = P(None, None, 'coeff'), P(None, None, None, 'coeff')
    f_sh = jax.jit(jax.shard_map(body, mesh=cmesh,
                                 in_specs=(sp3, sp3, sp4, sp4),
                                 out_specs=sp3, check_vma=False))
    got_eng = np.asarray(f_sh(np.asarray(a.data), np.asarray(b.data),
                              ctx.rlk, ctx.glk.keys[gal]))
    assert np.array_equal(got_eng, got_rot)
    print('sharded engine: BEHZ mult + relinearize + rotation inside '
          'shard_map (coeff axis) — bit-exact')
    print('OK')


if __name__ == '__main__':
    main()
