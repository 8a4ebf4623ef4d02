"""Chunked (per-segment jit) CKKS bootstrap timing on the device.

    python benchmarks/bootstrap_chip.py {smoke|toy|full} [--isolated] [--sparse]
"""
import os, sys, time, numpy as np
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
import jax, jax.numpy as jnp
from lattisense_tpu.utils import compile_cache
compile_cache.configure()
from lattisense_tpu.schemes.types import Ciphertext
from lattisense_tpu.runtime import CkksBtpContext
from lattisense_tpu.schemes.poly_eval import EVAL_VERSION as _EV

mode = (sys.argv[1] if len(sys.argv) > 1
        and not sys.argv[1].startswith('--') else 'smoke')
t0 = time.time()
# profile definitions shared with the sharded-mesh runner so walk caches
# and artifacts are comparable (benchmarks/btp_profiles.py):
#   smoke: n=256 fast check
#   toy:   reference CI profile (n=8192, test_cpu_ckks.cpp:847), ratio 8
#          + deg-3 arcsine (5.4e-6 band); --sparse quarters the slots
#   full:  reference n=2^16 profile, ratio 4 + arcsine (8.25e-5 band);
#          host walk + keygen ~1 h CPU before first device contact
#          (cached after the first run)
from btp_profiles import build as _build_profile
params, cfg, _seed, _h = _build_profile(mode, sparse='--sparse' in sys.argv)
ctx = CkksBtpContext.create_random_context(params, seed=_seed, h=_h,
                                           btp_config=cfg)
print(f'keygen {time.time()-t0:.0f}s', flush=True)
eng = ctx.engine
bs = eng.bootstrapper
p_ = eng.params

rng = np.random.default_rng(0)
msg = rng.uniform(-1, 1, p_.slots)
ct0 = ctx.encrypt(ctx.encode(msg, 0))
segs = bs.segments(ct0.scale, ctx.swk.get('swk_dts'), ctx.swk.get('swk_std'))

# host walk to capture per-segment input metadata (level/scale/is_ntt),
# per-segment boundary VALUES (for the isolated mode's independent
# segment drives) and the Galois elements each segment touches (for
# per-segment key staging).
class _RecGlk:
    """glk dict view recording which elements a segment accesses."""
    def __init__(self, base):
        self.base = base
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self.base[k]

    def get(self, k, d=None):
        self.used.add(k)
        return self.base.get(k, d)


# The full-size walk costs ~40-50 min CPU and is DETERMINISTIC given
# (profile, seed) — cache boundaries/metas/seg_elems on disk so re-runs
# (and the isolated-mode chip session) skip straight to device work.
import json as _json
os.makedirs(os.path.join(ROOT, '.cache'), exist_ok=True)
_walk_cache = os.environ.get(
    'LATTISENSE_BTP_WALK_CACHE',
    os.path.join(ROOT, '.cache', f'lattisense_btp_walk_{mode}_{p_.n}.npz'))
metas = boundaries = seg_elems = host_err = None
if _walk_cache and os.path.exists(_walk_cache):
    try:
        z = np.load(_walk_cache, allow_pickle=False)
        hdr = _json.loads(str(z['header']))
        if hdr['n_seg'] == len(segs) and hdr['n'] == p_.n \
                and hdr.get('ver') == _EV \
                and hdr['names'] == [n_ for n_, _ in segs]:
            metas = [[tuple(m) for m in ms] for ms in hdr['metas']]
            seg_elems = hdr['seg_elems']
            host_err = hdr['host_err']
            _out_meta = tuple(hdr['out_meta'])
            boundaries = [tuple(z[f'b{i}_{j}'] for j in range(cnt))
                          for i, cnt in enumerate(hdr['b_counts'])]
            print(f'host walk loaded from cache {_walk_cache}', flush=True)
    except Exception as e:  # noqa: BLE001 — fall through to a fresh walk
        print(f'walk cache unusable ({e}); re-walking', flush=True)
        metas = None
if metas is None:
    metas = []
    boundaries = []
    seg_elems = []
    cts = (Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True, scale=ct0.scale),)
    for name, fn in segs:
        metas.append([(c.level, c.is_ntt, c.scale) for c in cts])
        boundaries.append(tuple(np.asarray(c.data) for c in cts))
        rec = _RecGlk(ctx.glk.keys)
        cts = fn(np, cts, ctx.rlk, rec)
        seg_elems.append(sorted(rec.used))
    boundaries.append(tuple(np.asarray(c.data) for c in cts))
    host_out = cts[0]
    _out_meta = (host_out.level, host_out.is_ntt, host_out.scale)
    host_err = float(np.max(np.abs(ctx.decrypt_decode(host_out).real - msg)))
    if _walk_cache:
        hdr = {'n': p_.n, 'ver': _EV, 'n_seg': len(segs),
               'names': [n_ for n_, _ in segs],
               'metas': [[list(m) for m in ms] for ms in metas],
               'seg_elems': [list(map(int, e)) for e in seg_elems],
               'b_counts': [len(b) for b in boundaries],
               'out_meta': list(_out_meta),
               'host_err': host_err}
        arrs = {f'b{i}_{j}': a for i, b in enumerate(boundaries)
                for j, a in enumerate(b)}
        np.savez(_walk_cache, header=_json.dumps(hdr), **arrs)
        print(f'host walk cached to {_walk_cache}', flush=True)
print(f'host path err {host_err:.2e}', flush=True)
host_out = Ciphertext(data=boundaries[-1][0], level=_out_meta[0],
                      is_ntt=bool(_out_meta[1]), scale=_out_meta[2])

# ---- isolated per-segment mode (--isolated; the full n=2^16 profile) ----
# The full profile's RESIDENT working set exceeds one chip's HBM: ~60
# rotation keys x 157 MB/KSK (2*beta*(L+k)*n u64) = 6-12 GB of Galois
# keys alone, plus GB-scale encoded DFT diagonals — all segments resident
# together exceeded a 16 GB device (ResourceExhausted at cts1).
# Isolated mode measures each segment ALONE:
# stage exactly that segment's keys + lifted constants, drive it on the
# host walk's boundary values, slope-time it, assert the device output is
# BIT-IDENTICAL to the host walk's next boundary, then free everything.
# The pipeline number is the sum of segment times (inter-segment key
# re-staging excluded — on real deployments the fix is key/working-set
# sharding over a mesh: parallel/sharded_engine.CoeffShardedBootstrap).
if '--isolated' in sys.argv:
    import gc
    from lattisense_tpu.utils.jit_lift import jit_lifted

    # --seg-skip K: resume a partial table — skip the first K segments'
    # compiles entirely (their boundaries come from the walk cache, so
    # isolation semantics are unchanged). The 2026-08-2x partial runs
    # re-paid ~52 min of compiles to reach segment 8; with this flag a
    # resume costs only the walk-cache load.
    skip = int(os.environ.get('LATTISENSE_BTP_ISO_SKIP', '0'))
    if '--seg-skip' in sys.argv:
        skip = int(sys.argv[sys.argv.index('--seg-skip') + 1])
    iso_ms = []
    reps = int(os.environ.get('LATTISENSE_BTP_ISO_REPS', '3'))
    for si, ((name, fn), meta) in enumerate(zip(segs, metas)):
        if si < skip:
            print(f'  {name:12s} skipped (--seg-skip {skip})', flush=True)
            continue
        t0 = time.time()
        rlk_d = jax.device_put(ctx.rlk)
        glk_seg = {e: jax.device_put(ctx.glk.keys[e])
                   for e in seg_elems[si]}

        def g(*datas, fn=fn, meta=meta):
            cc = tuple(Ciphertext(data=d, level=m[0], is_ntt=m[1],
                                  scale=m[2])
                       for d, m in zip(datas, meta))
            return tuple(c.data for c in fn(jnp, cc, rlk_d, glk_seg))

        jitted = jit_lifted(g)
        ins = tuple(jax.device_put(b) for b in boundaries[si])
        outs = jitted(*ins)
        np.asarray(outs[0].ravel()[:2])
        t_compile = time.time() - t0
        for got, want in zip(outs, boundaries[si + 1]):
            assert np.array_equal(np.asarray(got), want), \
                f'{name}: device != host walk'

        def run(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = jitted(*ins)
            np.asarray(o[0].ravel()[:2])
            return time.perf_counter() - t0

        run(1)
        t1, t2 = run(reps), run(2 * reps)
        ms = (t2 - t1) / reps * 1e3
        iso_ms.append((name, ms, len(glk_seg)))
        print(f'  {name:12s} {ms:8.1f} ms   (keys {len(glk_seg)}, '
              f'compile+check {t_compile:.0f}s)', flush=True)
        del jitted, ins, outs, glk_seg, rlk_d
        gc.collect()
    total = sum(m for _, m, _ in iso_ms)
    print(f'bootstrap on chip ({mode}, isolated-sum): {total:.1f} ms/op '
          f'(bit-exact vs host per segment'
          f'{f"; first {skip} segments skipped" if skip else ""})',
          flush=True)
    out_path = os.environ.get(
        'LATTISENSE_BTP_ISO_OUT',
        os.path.join(ROOT, 'artifacts', f'bootstrap_{mode}_iso_'
                     f'{time.strftime("%Y-%m-%d")}.json'))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        _json.dump({
            'mode': mode, 'n': p_.n, 'profile_limbs': len(p_.q),
            'method': 'isolated per-segment (keys+consts staged per '
                      'segment, slope-timed, bit-exact vs host walk; '
                      'inter-segment key re-staging excluded — production '
                      'fix is working-set sharding, '
                      'parallel/sharded_engine.CoeffShardedBootstrap)',
            'segments_ms': {nm: round(m, 2) for nm, m, _ in iso_ms},
            'segment_keys': {nm: k for nm, _, k in iso_ms},
            'seg_skip': skip,
            'pipeline_sum_ms': round(total, 1),
            'host_path_err': host_err,
            'reps': reps,
            'date': time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime()),
        }, f, indent=1)
    print(f'artifact written: {out_path}', flush=True)
    sys.exit(0)

rlk_d = jax.device_put(ctx.rlk)
glk_d = jax.device_put(ctx.glk.keys)

# --batch B: vmap every segment over a leading batch axis — bootstrap
# THROUGHPUT (ops/s) instead of single-op latency; the per-segment
# programs amortize their fixed costs across the batch.
BATCH = 0
if '--batch' in sys.argv:
    BATCH = int(sys.argv[sys.argv.index('--batch') + 1])

# Const lifting (utils/jit_lift.py): the full profile's segment HLO
# embeds hundreds of MB of DFT-diagonal + twiddle constants; lifting
# turns them into runtime argument buffers. Default ON for every
# profile; LATTISENSE_JIT_LIFT=0 turns it off.
LIFT = os.environ.get('LATTISENSE_JIT_LIFT', '1') not in ('', '0')
if LIFT:
    from lattisense_tpu.utils.jit_lift import jit_lifted
    print('jit const-lifting ON', flush=True)

jits = []
for (name, fn), meta in zip(segs, metas):
    def make(fn, meta):
        def g(*datas):
            cts = tuple(Ciphertext(data=d, level=m[0], is_ntt=m[1], scale=m[2])
                        for d, m in zip(datas, meta))
            out = fn(jnp, cts, rlk_d, glk_d)
            return tuple(c.data for c in out)
        body = jax.vmap(g) if BATCH else g
        return jit_lifted(body) if LIFT else jax.jit(body)
    jits.append((name, make(fn, meta)))

# compile + first run, segment by segment
ct0_data = (np.tile(np.asarray(ct0.data)[None], (BATCH, 1, 1, 1))
            if BATCH else np.asarray(ct0.data))
datas = (jax.device_put(ct0_data),)
t_all0 = time.time()
for name, g in jits:
    tseg = time.time()
    datas = g(*datas)
    np.asarray(datas[0].ravel()[:2])
    print(f'  {name}: compile+run {time.time()-tseg:.0f}s', flush=True)
print(f'total compile+first run {time.time()-t_all0:.0f}s', flush=True)

def run_once():
    ds = (jax.device_put(ct0_data),)
    for _, g in jits:
        ds = g(*ds)
    np.asarray(ds[0].ravel()[:2])
    return ds

run_once()
t0 = time.perf_counter(); run_once(); t1 = time.perf_counter()
outs = []
k = 3
t0 = time.perf_counter()
for _ in range(k):
    out = run_once()
t1 = time.perf_counter()
ms = (t1 - t0) / k * 1e3
if BATCH:
    print(f'bootstrap on chip ({mode}, chunked, batch={BATCH}): '
          f'{ms / BATCH:.1f} ms/op ({BATCH / (ms / 1e3):.2f} ops/s)',
          flush=True)
else:
    print(f'bootstrap on chip ({mode}, chunked): {ms:.1f} ms/op', flush=True)

got = np.asarray(out[0])[0] if BATCH else np.asarray(out[0])
fresh = Ciphertext(data=got, level=host_out.level, is_ntt=True, scale=host_out.scale)
err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
print(f'device-path precision: {err:.2e}', flush=True)

# per-segment steady-state timing table: marginal
# slope per segment — run the pipeline truncated after segment i for k
# and 2k iterations; the difference isolates segment i's contribution
# without per-segment fetch barriers distorting the pipeline.
if '--segtable' in sys.argv:
    def run_upto(idx, k):
        t0 = time.perf_counter()
        for _ in range(k):
            ds = (jax.device_put(ct0_data),)
            for _, g in jits[:idx + 1]:
                ds = g(*ds)
            np.asarray(ds[0].ravel()[:2])
        return (time.perf_counter() - t0) / k
    prev = 0.0
    print('per-segment steady-state (marginal, ms):', flush=True)
    for i, (name, _) in enumerate(jits):
        cur = min(run_upto(i, 2), run_upto(i, 2))
        print(f'  {name:10s} {max(0.0, (cur - prev)) * 1e3:8.1f} ms',
              flush=True)
        prev = cur
