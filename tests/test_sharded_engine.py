"""Coeff-sharded ENGINE view (parallel/sharded_engine.py): the unmodified
scheme layer running inside shard_map must be BIT-EXACT vs the
single-device engine — op by op (default tier) and across a whole toy
bootstrap (slow tier). This is the production composition of
DistNtt/CoeffShardedKeySwitcher into the engine/bootstrap paths; the
reference never splits one ciphertext across devices (SURVEY §5, fhe_ops_lib/fhe_lib_v2.h:1173)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import lattisense_tpu  # noqa: F401
from lattisense_tpu.params import CkksParams
from lattisense_tpu.runtime import CkksContext
from lattisense_tpu.schemes.galois import galois_elt_col
from lattisense_tpu.schemes.types import Ciphertext
from lattisense_tpu.parallel.sharded_engine import make_coeff_sharded_engine

N = 256


def _mesh(d):
    devs = jax.devices()
    if len(devs) < d:
        pytest.skip(f'need {d} virtual devices')
    return Mesh(np.array(devs[:d]), ('coeff',))


def _ctx(word_bits=64):
    from lattisense_tpu.core.modring import gen_ntt_primes
    if word_bits == 64:
        q = gen_ntt_primes(N, 50, 5)
        p = gen_ntt_primes(N, 51, 2)
        params = CkksParams.create_custom(N, q, p, scale=float(1 << 40))
    else:
        q = gen_ntt_primes(N, 31, 6)
        p = gen_ntt_primes(N, 30, 2)
        params = CkksParams.create_custom(N, q, p, scale=float(1 << 25),
                                          word_bits=32)
    ctx = CkksContext.create_random_context(params, seed=11)
    ctx.gen_galois_keys_for_elements([galois_elt_col(1, N)])
    return ctx


def _sharded_call(eng_sh, mesh, fn, ct_datas, keys):
    """Run fn(engine, cts..., keys) inside shard_map over coeff."""
    def spec(x):
        return P(*([None] * (np.ndim(x) - 1)), 'coeff')

    in_specs = (jax.tree.map(spec, tuple(ct_datas)),
                jax.tree.map(spec, keys))
    out_holder = {}

    def body(ds, ks):
        out = fn(eng_sh, ds, ks)
        out_holder['meta'] = jax.tree.map(
            lambda x: None, out)  # structure probe
        return out

    smap = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                         out_specs=spec(np.zeros((1, 1, 1))),
                         check_vma=False)
    return jax.jit(smap)(tuple(ct_datas), keys)


@pytest.mark.parametrize('wb', [64, 32])
def test_sharded_engine_mult_relin_rescale(wb):
    """ct×ct mult + relinearize + rescale through the sharded engine ==
    the single-device engine, bit for bit."""
    ctx = _ctx(wb)
    eng = ctx.engine
    mesh = _mesh(4)
    eng_sh = make_coeff_sharded_engine(eng, mesh)
    rng = np.random.default_rng(5)
    lvl = 3
    a = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), lvl))
    b = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), lvl))

    # golden single-device
    g3 = eng.mult(np, a, b)
    g = eng.rescale(np, eng.relinearize(np, g3, ctx.rlk))

    def fn(e, ds, ks):
        ca = Ciphertext(data=ds[0], level=lvl, is_ntt=True, scale=a.scale)
        cb = Ciphertext(data=ds[1], level=lvl, is_ntt=True, scale=b.scale)
        out = e.rescale(jnp, e.relinearize(jnp, e.mult(jnp, ca, cb), ks))
        return out.data

    got = _sharded_call(eng_sh, mesh, fn,
                        (np.asarray(a.data), np.asarray(b.data)), ctx.rlk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(g.data))


@pytest.mark.parametrize('wb', [64, 32])
def test_sharded_engine_rotate(wb):
    """apply_galois (all_gather automorphism + coeff-sharded key switch)
    == single-device, bit for bit."""
    ctx = _ctx(wb)
    eng = ctx.engine
    mesh = _mesh(4)
    eng_sh = make_coeff_sharded_engine(eng, mesh)
    rng = np.random.default_rng(6)
    lvl = 3
    elt = galois_elt_col(1, N)
    a = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), lvl))
    g = eng.apply_galois(np, a, elt, ctx.glk.keys[elt])

    def fn(e, ds, ks):
        ca = Ciphertext(data=ds[0], level=lvl, is_ntt=True, scale=a.scale)
        return e.apply_galois(jnp, ca, elt, ks).data

    got = _sharded_call(eng_sh, mesh, fn, (np.asarray(a.data),),
                        ctx.glk.keys[elt])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(g.data))


@pytest.mark.parametrize('wb', [64])
def test_sharded_engine_hoisted_rotations(wb):
    """rns_sp_decomp + apply_galois_decomposed (the hoisted BSGS path the
    linear transforms use) — decryption-exact vs single-device (hoisted
    FastBConv overflow makes raw bits differ by design on SOME paths;
    here both run the same math, so bits must match)."""
    ctx = _ctx(wb)
    eng = ctx.engine
    mesh = _mesh(4)
    eng_sh = make_coeff_sharded_engine(eng, mesh)
    rng = np.random.default_rng(7)
    lvl = 3
    elt = galois_elt_col(1, N)
    a = ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.params.slots), lvl))
    d = eng.rns_sp_decomp(np, a)
    g = eng.apply_galois_decomposed(np, d, elt, ctx.glk.keys[elt])

    def fn(e, ds, ks):
        ca = Ciphertext(data=ds[0], level=lvl, is_ntt=True, scale=a.scale)
        dd = e.rns_sp_decomp(jnp, ca)
        return e.apply_galois_decomposed(jnp, dd, elt, ks).data

    got = _sharded_call(eng_sh, mesh, fn, (np.asarray(a.data),),
                        ctx.glk.keys[elt])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(g.data))


@pytest.mark.skipif(
    os.environ.get('LATTISENSE_SLOW_TESTS', '') in ('', '0'),
    reason='segment compiles (set LATTISENSE_SLOW_TESTS=1)')
def test_coeff_sharded_bootstrap_toy():
    """A WHOLE toy bootstrap coeff-sharded end-to-end via
    CoeffShardedBootstrap (explicit DistNtt + coeff-sharded switches in
    every segment) — bit-exact vs the single-device segment walk."""
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.runtime import CkksBtpContext
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig
    from lattisense_tpu.parallel.sharded_engine import CoeffShardedBootstrap

    n = 256
    q0 = gen_ntt_primes(n, 61, 1)
    qs = gen_ntt_primes(n, 60, 22)
    p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(n, q0 + qs, p[1:],
                                      scale=float(1 << 45))
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                          double_angle=3)
    ctx = CkksBtpContext.create_random_context(params, seed=73, h=32,
                                               btp_config=cfg)
    rng = np.random.default_rng(9)
    msg = rng.uniform(-1, 1, params.slots)
    ct0 = ctx.encrypt(ctx.encode(msg, 0))

    # golden single-device walk
    host = ctx.engine.bootstrapper(
        np, Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                       scale=ct0.scale),
        ctx.rlk, ctx.glk.keys, swk_dts=ctx.swk.get('swk_dts'),
        swk_std=ctx.swk.get('swk_std'))

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip('need 4 virtual devices')
    mesh = Mesh(np.array(devs[:4]), ('coeff',))
    btp = CoeffShardedBootstrap(ctx, mesh)
    out = btp(Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                         scale=ct0.scale))
    np.testing.assert_array_equal(np.asarray(out.data),
                                  np.asarray(host.data))
    err = np.max(np.abs(ctx.decrypt_decode(out).real - msg))
    assert err < 5e-3, f'coeff-sharded bootstrap err {err:.2e}'


def test_sharded_engine_bfv_relin_rotate():
    """BFV coeff-domain engine surface under coeff sharding: the WHOLE
    mult_relin + rotate pipeline — BEHZ ct x ct mult (dist dual-basis
    rings; every non-NTT stage is pointwise per coefficient),
    relinearize, and apply_galois (signed coeff-domain automorphism +
    coeff-sharded switch) — bit-exact vs single-device."""
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext

    n, t = 256, 65537
    q = gen_ntt_primes(n, 50, 4)
    p = gen_ntt_primes(n, 51, 2, exclude=tuple(q))
    params = BfvParams.create_custom(n, t, q, p)
    ctx = BfvContext.create_random_context(params, seed=23)
    elt = galois_elt_col(1, n)
    ctx.gen_galois_keys_for_elements([elt])
    mesh = _mesh(4)
    eng = ctx.engine
    eng_sh = make_coeff_sharded_engine(eng, mesh)
    rng = np.random.default_rng(8)
    lvl = 3
    m1 = rng.integers(0, t, n, dtype=np.uint64)
    m2 = rng.integers(0, t, n, dtype=np.uint64)
    a = ctx.encrypt(ctx.encode(m1, lvl))
    b = ctx.encrypt(ctx.encode(m2, lvl))
    ct3 = eng.mult(np, a, b)
    g = eng.apply_galois(np, eng.relinearize(np, ct3, ctx.rlk), elt,
                         ctx.glk.keys[elt])

    def fn(e, ds, ks):
        c3 = Ciphertext(data=ds[0], level=lvl, is_ntt=False)
        c = e.relinearize(jnp, c3, ks['rlk'])
        return e.apply_galois(jnp, c, elt, ks['glk']).data

    got = _sharded_call(eng_sh, mesh, fn, (np.asarray(ct3.data),),
                        {'rlk': ctx.rlk, 'glk': ctx.glk.keys[elt]})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(g.data))

    # BEHZ ct x ct mult coeff-sharded (dist dual-basis rings)
    def fn_mult(e, ds, ks):
        ca = Ciphertext(data=ds[0], level=lvl, is_ntt=False)
        cb = Ciphertext(data=ds[1], level=lvl, is_ntt=False)
        c = e.relinearize(jnp, e.mult(jnp, ca, cb), ks['rlk'])
        return e.apply_galois(jnp, c, elt, ks['glk']).data

    got2 = _sharded_call(eng_sh, mesh, fn_mult,
                         (np.asarray(a.data), np.asarray(b.data)),
                         {'rlk': ctx.rlk, 'glk': ctx.glk.keys[elt]})
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(g.data))


@pytest.mark.skipif(
    os.environ.get('LATTISENSE_SLOW_TESTS', '') in ('', '0'),
    reason='reference toy profile, ~30 min CPU (set LATTISENSE_SLOW_TESTS=1)')
def test_coeff_sharded_bootstrap_reference_toy_profile():
    """The REFERENCE toy bootstrap profile (n=8192 dense, the config the
    reference CI exercises — unittests/test_cpu_ckks.cpp:847) refreshed
    end-to-end with the working set coeff-sharded over the virtual mesh,
    bit-exact vs the single-device segment walk at every boundary
    (the n=256 smoke proof promoted to the reference profile). Shares the
    profile definition (and walk cache) with benchmarks/bootstrap_chip.py
    via benchmarks/btp_profiles.py."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), 'benchmarks'))
    from btp_profiles import build as build_profile
    from lattisense_tpu.runtime import CkksBtpContext
    from lattisense_tpu.parallel.sharded_engine import CoeffShardedBootstrap

    params, cfg, seed, h = build_profile('toy')
    ctx = CkksBtpContext.create_random_context(params, seed=seed, h=h,
                                               btp_config=cfg)
    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, params.slots)
    ct0 = ctx.encrypt(ctx.encode(msg, 0))

    host = ctx.engine.bootstrapper(
        np, Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                       scale=ct0.scale),
        ctx.rlk, ctx.glk.keys, swk_dts=ctx.swk.get('swk_dts'),
        swk_std=ctx.swk.get('swk_std'))
    host_err = np.max(np.abs(ctx.decrypt_decode(host).real - msg))

    mesh = _mesh(4)
    btp = CoeffShardedBootstrap(ctx, mesh)
    out = btp(Ciphertext(data=np.asarray(ct0.data), level=0, is_ntt=True,
                         scale=ct0.scale))
    np.testing.assert_array_equal(np.asarray(out.data),
                                  np.asarray(host.data))
    err = np.max(np.abs(ctx.decrypt_decode(out).real - msg))
    assert err == host_err
    assert err < 2e-5, f'toy-profile sharded bootstrap err {err:.2e}'
