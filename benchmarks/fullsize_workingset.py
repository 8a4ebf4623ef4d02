"""Full n=2^16 profile: measured sharded key working set vs the HBM wall.

The full bootstrap's key set was too large for a 16 GB device
(~6-12 GB of Galois keys alone). This measures the
actual numbers at full size on the virtual 8-device mesh: total key
bytes, per-device addressable-shard bytes under coeff sharding, and the
exact 1/D split, with no host walk. Reference profile anchor:
fhe_ops_lib/fhe_lib_v2.h:294-308 (N16QP1546H192H32).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
from lattisense_tpu.utils import compile_cache  # noqa: E402
compile_cache.configure()
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from btp_profiles import build as build_profile
from lattisense_tpu.runtime import CkksBtpContext

D = int(sys.argv[sys.argv.index('--devices') + 1]) \
    if '--devices' in sys.argv else 8
t0 = time.time()
params, cfg, seed, h = build_profile('full', sparse=False)
ctx = CkksBtpContext.create_random_context(params, seed=seed, h=h,
                                           btp_config=cfg)
t_keygen = time.time() - t0
print(f'keygen {t_keygen:.0f}s', flush=True)

mesh = Mesh(np.array(jax.devices()[:D]), ('coeff',))
spec = lambda a: NamedSharding(mesh, P(*([None] * (a.ndim - 1)), 'coeff'))  # noqa: E731
swk = {k: v for k, v in (('dts', ctx.swk.get('swk_dts')),
                         ('std', ctx.swk.get('swk_std'))) if v is not None}
tree = {'rlk': ctx.rlk, 'glk': dict(ctx.glk.keys), 'swk': swk}
sharded = jax.tree.map(
    lambda a: jax.device_put(jnp.asarray(a), spec(jnp.asarray(a))), tree)
leaves = jax.tree.leaves(sharded)
total = sum(a.nbytes for a in leaves)
per_dev = sum(a.addressable_shards[0].data.nbytes for a in leaves)
one_glk = next(iter(ctx.glk.keys.values()))
out = {
    'profile': 'full n=2^16 (reference N16QP1546H192H32-class)',
    'n': params.n, 'limbs_q': len(params.q), 'limbs_p': len(params.p),
    'n_galois_keys': len(ctx.glk.keys),
    'bytes_per_galois_key': int(sum(np.asarray(a).nbytes
                                    for a in jax.tree.leaves(one_glk))),
    'keys_total_bytes': int(total),
    'keys_per_device_bytes': int(per_dev),
    'devices': D,
    'per_device_equals_total_over_D': bool(per_dev == total // D),
    'keygen_s': round(t_keygen, 1),
    'note': ('coeff-axis sharding of every key leaf on the virtual '
             'D-device mesh; per-device bytes are addressable-shard '
             'measurements, not arithmetic.'),
    'date': time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime()),
}
path = os.path.join(ROOT, 'artifacts',
                    f'fullsize_keyset_D{D}_{time.strftime("%Y-%m-%d")}.json')
os.makedirs(os.path.dirname(path), exist_ok=True)
with open(path, 'w') as f:
    json.dump(out, f, indent=1)
print(json.dumps(out, indent=1), flush=True)
print(f'artifact written: {path}', flush=True)
