"""Whole-profile CKKS bootstrap on the virtual multi-device mesh with the
working set COEFFICIENT-SHARDED: one exhausted
ciphertext refreshed across D devices via CoeffShardedBootstrap —
distributed four-step NTTs + coeff-sharded key switches in every segment,
bit-exact vs the single-device host walk.

Why this exists: the full n=2^16 profile's RESIDENT working set (~40-80
rotation keys x 157 MB + GB-scale DFT diagonals) exceeded a 16 GB
device (RESOURCE_EXHAUSTED). A D-device
coeff mesh holds 1/D of every key — this runner measures that per-device
working set directly (addressable-shard bytes) and proves end-to-end
correctness at the reference profiles.

Usage: python benchmarks/sharded_btp_run.py {smoke|toy|full} [--devices D]
CPU virtual mesh only (pins JAX_PLATFORMS=cpu). Artifact:
artifacts/sharded_btp_{mode}_<date>.json (gitignored).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

D = 8
if '--devices' in sys.argv:
    D = int(sys.argv[sys.argv.index('--devices') + 1])

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = \
        f'{flags} --xla_force_host_platform_device_count={D}'.strip()

import numpy as np
import jax

jax.config.update('jax_platforms', 'cpu')
from lattisense_tpu.utils import compile_cache  # noqa: E402
compile_cache.configure()

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from btp_profiles import build as build_profile  # noqa: E402
from lattisense_tpu.schemes.types import Ciphertext  # noqa: E402
from lattisense_tpu.runtime import CkksBtpContext
from lattisense_tpu.schemes.poly_eval import EVAL_VERSION as _EV  # noqa: E402
from lattisense_tpu.parallel.sharded_engine import CoeffShardedBootstrap  # noqa: E402


def tree_bytes(tree):
    return sum(np.asarray(a).nbytes for a in jax.tree.leaves(tree))


def main():
    mode = (sys.argv[1] if len(sys.argv) > 1
            and not sys.argv[1].startswith('--') else 'smoke')
    t0 = time.time()
    params, cfg, seed, h = build_profile(mode)
    ctx = CkksBtpContext.create_random_context(params, seed=seed, h=h,
                                               btp_config=cfg)
    print(f'keygen {time.time() - t0:.0f}s', flush=True)
    eng = ctx.engine
    p_ = eng.params
    bs = eng.bootstrapper

    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, p_.slots)
    ct0 = ctx.encrypt(ctx.encode(msg, 0))
    swk_dts, swk_std = ctx.swk.get('swk_dts'), ctx.swk.get('swk_std')
    segs = bs.segments(ct0.scale, swk_dts, swk_std)
    names = [n for n, _ in segs]

    # ---- golden boundaries: the single-device host walk (cache shared
    # with bootstrap_chip.py) -------------------------------------------
    cache = os.environ.get('LATTISENSE_BTP_WALK_CACHE',
                           os.path.join(ROOT, '.cache',
                                        f'lattisense_btp_walk_{mode}_{p_.n}.npz'))
    boundaries = None
    if os.path.exists(cache):
        z = np.load(cache, allow_pickle=False)
        hdr = json.loads(str(z['header']))
        if hdr['names'] == names and hdr['n'] == p_.n \
                and hdr.get('ver') == _EV:
            boundaries = [tuple(z[f'b{i}_{j}'] for j in range(c))
                          for i, c in enumerate(hdr['b_counts'])]
            host_err = hdr['host_err']
            out_meta = tuple(hdr['out_meta'])
            print(f'host walk loaded from {cache}', flush=True)
    if boundaries is None:
        tw = time.time()
        boundaries = []
        cts = (Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                          scale=ct0.scale),)
        metas, seg_elems = [], []
        for name, fn in segs:
            metas.append([(c.level, c.is_ntt, c.scale) for c in cts])
            boundaries.append(tuple(np.asarray(c.data) for c in cts))

            class _Rec:
                def __init__(self, base):
                    self.base, self.used = base, set()

                def __getitem__(self, k):
                    self.used.add(k)
                    return self.base[k]

                def get(self, k, d=None):
                    self.used.add(k)
                    return self.base.get(k, d)
            rec = _Rec(ctx.glk.keys)
            cts = fn(np, cts, ctx.rlk, rec)
            seg_elems.append(sorted(rec.used))
        boundaries.append(tuple(np.asarray(c.data) for c in cts))
        out_meta = (cts[0].level, cts[0].is_ntt, cts[0].scale)
        host_err = float(np.max(np.abs(
            ctx.decrypt_decode(cts[0]).real - msg)))
        hdr = {'n': p_.n, 'ver': _EV, 'n_seg': len(segs), 'names': names,
               'metas': [[list(m) for m in ms] for ms in metas],
               'seg_elems': [list(map(int, e)) for e in seg_elems],
               'b_counts': [len(b) for b in boundaries],
               'out_meta': list(out_meta), 'host_err': host_err}
        np.savez(cache, header=json.dumps(hdr),
                 **{f'b{i}_{j}': a for i, b in enumerate(boundaries)
                    for j, a in enumerate(b)})
        print(f'host walk {time.time() - tw:.0f}s, cached to {cache}',
              flush=True)
    print(f'host path err {host_err:.2e}', flush=True)

    # ---- the sharded run ----------------------------------------------
    devs = jax.devices()
    assert len(devs) >= D, (len(devs), D)
    mesh = Mesh(np.array(devs[:D]), ('coeff',))
    btp = CoeffShardedBootstrap(ctx, mesh)

    # per-device working set: every key leaf sharded on its coeff axis
    spec = lambda a: NamedSharding(mesh, P(*([None] * (a.ndim - 1)), 'coeff'))  # noqa: E731
    keys_sharded = jax.tree.map(
        lambda a: jax.device_put(jnp.asarray(a), spec(jnp.asarray(a))),
        {'rlk': ctx.rlk, 'glk': dict(ctx.glk.keys),
         'swk': {k: v for k, v in (('dts', swk_dts), ('std', swk_std))
                 if v is not None}})
    total_key_b = tree_bytes(keys_sharded)
    per_dev_key_b = sum(
        a.addressable_shards[0].data.nbytes
        for a in jax.tree.leaves(keys_sharded))
    n_glk = len(ctx.glk.keys)
    print(f'keys: {n_glk} galois + rlk + {len(keys_sharded["swk"])} swk = '
          f'{total_key_b / 1e9:.2f} GB total, '
          f'{per_dev_key_b / 1e9:.3f} GB/device on D={D} '
          f'(1/D = {total_key_b / D / 1e9:.3f})', flush=True)

    seg_t = {}
    t0 = time.time()
    ctin = Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                      scale=ct0.scale)
    base = btp.btp.step - 1
    if ctin.level != base:
        ctin = eng.drop_level(np, ctin, ctin.level - base)
    datas = (jnp.asarray(ctin.data),)
    meta = ((ctin.level, ctin.is_ntt, ctin.scale),)
    for i, name in enumerate(names):
        ts = time.time()
        jitted, meta_out = btp._seg_jit(i, ctin.scale, meta, len(datas),
                                        swk_dts is not None,
                                        swk_std is not None)
        datas = jitted(datas, ctx.rlk, ctx.glk.keys, swk_dts, swk_std)
        jax.block_until_ready(datas)
        meta = meta_out['m']
        seg_t[name] = round(time.time() - ts, 1)
        # bit-exactness vs the host walk at EVERY boundary
        want = boundaries[i + 1]
        for got, w in zip(datas, want):
            assert np.array_equal(np.asarray(got), w), \
                f'{name}: sharded != host walk'
        print(f'  {name:12s} {seg_t[name]:7.1f}s  bit-exact '
              f'({len(datas)} cts)', flush=True)
    out = Ciphertext(data=np.asarray(datas[0]), level=meta[0][0],
                     is_ntt=meta[0][1], scale=meta[0][2])
    err = float(np.max(np.abs(ctx.decrypt_decode(out).real - msg)))
    total_s = time.time() - t0
    print(f'sharded bootstrap ({mode}, D={D}): bit-exact all segments, '
          f'precision {err:.2e} (= host {host_err:.2e}), '
          f'{total_s:.0f}s wall on the CPU mesh', flush=True)

    out_path = os.environ.get(
        'LATTISENSE_SBTP_OUT',
        os.path.join(ROOT, 'artifacts', f'sharded_btp_{mode}_'
                     f'{time.strftime("%Y-%m-%d")}.json'))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump({
            'mode': mode, 'n': p_.n, 'devices': D,
            'bit_exact_vs_host_walk': True,
            'precision': err, 'host_err': host_err,
            'working_set': {
                'n_galois_keys': n_glk,
                'keys_total_bytes': int(total_key_b),
                'keys_per_device_bytes': int(per_dev_key_b),
                'per_device_equals_total_over_D':
                    abs(per_dev_key_b * D - total_key_b) < 1e-6 * total_key_b,
            },
            'segment_wall_s_cpu_mesh': seg_t,
            'date': time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime()),
            'note': 'virtual CPU mesh (functional/memory proof; '
                    'collectives are host memcpys — timing is not a '
                    'device measurement)',
        }, f, indent=1)
    print(f'artifact written: {out_path}', flush=True)


if __name__ == '__main__':
    main()
