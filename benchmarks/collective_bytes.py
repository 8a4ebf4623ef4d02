"""Collective-traffic audit: measured bytes over each XLA collective in
the sharded kernels vs the doc/sharding_guide.md cost model — exact,
hardware-free (compiled-HLO inspection on the virtual mesh), converting the sharding guide's formulas from prose to evidence.

Model predictions audited (per device, words of the data dtype):
- DistNtt forward/inverse: 2 all_to_alls x L*n/D words per transform
  (sharding_guide.md "collective traffic: two all_to_alls of n/D words per
  device per transform", per limb-row, L rows).
- Limb-axis hybrid key switch: psum_scatter 2*T*n/D + psum alpha*n
  ("collective traffic: 2*T*n/D + alpha*n words per switch").
- Coeff-axis hybrid key switch: 4 all_to_alls per switch (2 per NTT
  direction in decompose-modup + switch epilogue).
- Coeff-axis Galois: one all_gather (n words landed per device).

Usage: python benchmarks/collective_bytes.py [--devices D]
Artifact: artifacts/collective_bytes_<date>.json
"""

import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

D = 4
if '--devices' in sys.argv:
    D = int(sys.argv[sys.argv.index('--devices') + 1])

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = \
        f'{flags} --xla_force_host_platform_device_count={max(8, D)}'.strip()

import numpy as np
import jax

jax.config.update('jax_platforms', 'cpu')
from lattisense_tpu.utils import compile_cache  # noqa: E402
compile_cache.configure()

_DT_BYTES = {'u64': 8, 's64': 8, 'f64': 8, 'u32': 4, 's32': 4, 'f32': 4,
             'u16': 2, 's16': 2, 'u8': 1, 's8': 1, 'pred': 1}
_COLLECTIVES = ('all-to-all', 'all-gather', 'all-reduce', 'reduce-scatter',
                'collective-permute')
_SHAPE_RE = re.compile(r'\b([a-z]+\d*)\[([\d,]*)\]')


def collective_bytes(fn, *args):
    """Compile fn(*args) and sum output bytes per collective kind from the
    optimized HLO (shapes are PER-DEVICE after SPMD partitioning).
    ``fn`` may be an already-jitted callable (has .lower) or a plain
    trace-compatible function."""
    jfn = fn if hasattr(fn, 'lower') else jax.jit(fn)
    txt = jfn.lower(*args).compile().as_text()
    out = {}
    for line in txt.splitlines():
        line = line.strip()
        m = re.match(r'%?\S+\s*=\s*(.*?)\s+(' + '|'.join(_COLLECTIVES) + r')\(',
                     line)
        if not m:
            continue
        shapes, kind = m.group(1), m.group(2)
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(shapes):
            if dt not in _DT_BYTES:
                continue
            cnt = 1
            for d in dims.split(','):
                if d:
                    cnt *= int(d)
            nbytes += cnt * _DT_BYTES[dt]
        ent = out.setdefault(kind, {'count': 0, 'bytes': 0})
        ent['count'] += 1
        ent['bytes'] += nbytes
    return out


def main():
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.schemes import keys as K
    from lattisense_tpu.schemes.keyswitch import KeySwitcher
    from lattisense_tpu.schemes.galois import galois_elt_col
    from lattisense_tpu.parallel.coeff_sharded import (
        DistNtt, CoeffShardedKeySwitcher)
    from lattisense_tpu.parallel.keyswitch_sharded import ShardedKeySwitcher
    from lattisense_tpu.parallel.mesh import make_mesh
    from jax.sharding import Mesh

    n, L = 4096, 4
    wb = 64
    word = 8
    rng = np.random.default_rng(1)
    report = {'n': n, 'L': L, 'devices': D, 'word_bytes': word, 'paths': {}}

    def audit(name, meas, model_words, note):
        meas_b = {k: v['bytes'] for k, v in meas.items()}
        total = sum(meas_b.values())
        model_b = int(model_words * word)
        report['paths'][name] = {
            'measured_per_device': meas,
            'measured_total_bytes': total,
            'model_bytes': model_b,
            'ratio_measured_over_model': round(total / model_b, 3)
            if model_b else None,
            'model': note,
        }
        print(f'{name:28s} measured {total / 1e6:8.3f} MB/dev '
              f'model {model_b / 1e6:8.3f} MB '
              f'({", ".join(f"{k}:{v['count']}" for k, v in meas.items())})',
              flush=True)

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:D]), ('coeff',))

    # ---- DistNtt ------------------------------------------------------
    moduli = tuple(gen_ntt_primes(n, 50, L))
    dn = DistNtt(moduli, n, mesh)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    audit('dist_ntt_fwd', collective_bytes(dn._jitted(x.ndim, True), x),
          2 * L * n / D,
          'two all_to_alls of n/D words per limb-row transform')
    y = np.asarray(dn.ntt(x))
    audit('dist_ntt_inv', collective_bytes(dn._jitted(y.ndim, False), y),
          2 * L * n / D,
          'two all_to_alls of n/D words per limb-row transform')

    # ---- coeff-sharded hybrid key switch ------------------------------
    q = gen_ntt_primes(n, 50, L)
    p = gen_ntt_primes(n, 51, 2, exclude=tuple(q))
    sw = KeySwitcher(tuple(q), tuple(p), n)
    sk = K.SecretKey(K.sample_ternary(rng, n))
    ksk = K.gen_keyswitch_key(rng, sk,
                              lambda mods: sk.ntt_form(tuple(mods), n),
                              tuple(q), tuple(p), n)
    level = L - 1
    xs = np.stack([rng.integers(0, qi, n, dtype=np.uint64)
                   for qi in q[:level + 1]])
    from lattisense_tpu.schemes.types import KeySwitchKey
    ksk_t = KeySwitchKey(key_q=ksk.key_q, key_p=ksk.key_p, level=level,
                         sp_level=sw.alpha - 1)
    cks = CoeffShardedKeySwitcher(sw, level, mesh)
    kd = cks.prep_keys(ksk_t)
    T = (level + 1) + len(p)            # QP rows carried through the switch
    beta = sw.beta(level)
    audit('coeff_keyswitch',
          collective_bytes(cks._switch_jit, xs, kd),
          (beta * T + 2 * T) * n / D * 2,
          'all_to_all pairs over the mod-up NTTs (beta digits x T rows) '
          'and the two output polys; bytes dominated by digit transforms')

    # ---- limb-axis hybrid key switch ----------------------------------
    lmesh = make_mesh(op=2, limb=D)
    lks = ShardedKeySwitcher(sw, level, lmesh)
    lkd = lks.pad_keys(ksk.key_q, ksk.key_p)
    xb = np.stack([xs, xs])             # (B=2, L, n), batch over 'op'
    audit('limb_keyswitch',
          collective_bytes(lambda a, k: lks.traced(a, k), xb, lkd),
          2 * (2 * lks.T_pad * n / D + len(p) * n),
          'per op: psum_scatter 2*T_pad*n/D + psum alpha*n — the guide '
          'formula 2*T*n/D with T rounded up to the device-divisible '
          'T_pad (padded rows ride the collective); B=2 ops in the '
          'program. XLA additionally decomposes the reduce-scatter '
          'into a pair of boundary collective-permutes on this backend.')

    # ---- coeff-sharded Galois rotation --------------------------------
    from lattisense_tpu.parallel.coeff_sharded import CoeffShardedRotator
    elt = galois_elt_col(1, n)
    ct = np.stack([xs, np.stack([rng.integers(0, qi, n, dtype=np.uint64)
                                 for qi in q[:level + 1]])])   # (2, L', n)
    rot = CoeffShardedRotator(sw, level, mesh, elt)
    audit('coeff_rotate',
          collective_bytes(rot._jit, ct, kd),
          2 * (level + 1) * n
          + (beta * T + 2 * T) * n / D * 2,
          'all_gather for the two static automorphism permutations '
          '(full n-point rows landed per device; bucketed all_to_all '
          '<= n/D*(1+eps) is the optimization path) + the coeff key '
          'switch of sigma(c1)')

    out_path = os.environ.get(
        'LATTISENSE_CB_OUT',
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'artifacts',
                     f'collective_bytes_{time.strftime("%Y-%m-%d")}.json'))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    report['date'] = time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())
    with open(out_path, 'w') as f:
        json.dump(report, f, indent=1)
    print(f'artifact written: {out_path}', flush=True)


if __name__ == '__main__':
    main()
