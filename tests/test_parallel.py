"""Multi-chip sharding conformance on the virtual 8-device CPU mesh:
batched (op-axis) + limb-sharded pipelines must stay bit-identical to the
single-device NumPy golden path."""

import os

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext
from lattisense_tpu.parallel.mesh import make_mesh, ct_batch_spec, key_spec, shard
from lattisense_tpu.parallel.batch import (bfv_mult_relin, key_tree,
                                           make_batched_step)

N, T = 64, 65537


@pytest.fixture(scope='module')
def ctx():
    q = gen_ntt_primes(N, 50, 4)
    p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, T, q, p)
    return BfvContext.create_random_context(params, seed=21)


@pytest.mark.parametrize('limb', [1, 2])
def test_batched_mult_relin_sharded_bitexact(ctx, limb):
    level = 3
    mesh = make_mesh(op=8 // limb, limb=limb)
    fn = make_batched_step(ctx.engine, bfv_mult_relin, level, mesh=mesh,
                           limb_sharded=(limb > 1), n_inputs=2)
    batch = 8
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, T, (2 * batch, N), dtype=np.uint64)
    cts = [ctx.encrypt(ctx.encode(m, level)) for m in msgs]
    a = np.stack([c.data for c in cts[:batch]])
    b = np.stack([c.data for c in cts[batch:]])
    keys = key_tree(ctx)

    from jax.sharding import NamedSharding
    a_d = shard(mesh, a, ct_batch_spec(limb > 1))
    b_d = shard(mesh, b, ct_batch_spec(limb > 1))
    keys_d = jax.tree.map(
        lambda k: jax.device_put(k, NamedSharding(mesh, key_spec(limb > 1))), keys)
    out = np.asarray(fn(a_d, b_d, keys_d))

    for i in range(batch):
        ref = ctx.engine.relinearize(np, ctx.engine.mult(np, cts[i], cts[batch + i]),
                                     ctx.rlk)
        np.testing.assert_array_equal(out[i], ref.data)
        np.testing.assert_array_equal(
            ctx.decrypt_decode(ref),
            (msgs[i].astype(object) * msgs[batch + i] % T).astype(np.uint64))


def test_integrated_limb_tp_mult_relin(ctx):
    """Integrated 2-D pipeline: op-sharded BEHZ mult feeding the
    explicit-collective limb-TP key switch in one jit program — bit-exact
    vs the single-device golden pipeline."""
    from lattisense_tpu.parallel.batch import make_limb_tp_mult_relin
    level = 3
    mesh = make_mesh(op=4, limb=2)
    f, prep = make_limb_tp_mult_relin(ctx.engine, level, mesh)
    kd = prep(ctx.rlk.key_q, ctx.rlk.key_p)
    batch = 8
    rng = np.random.default_rng(8)
    msgs = rng.integers(0, T, (2 * batch, N), dtype=np.uint64)
    cts = [ctx.encrypt(ctx.encode(m, level)) for m in msgs]
    a = np.stack([c.data for c in cts[:batch]])
    b = np.stack([c.data for c in cts[batch:]])
    out = np.asarray(f(a, b, kd))
    for i in range(batch):
        ref = ctx.engine.relinearize(
            np, ctx.engine.mult(np, cts[i], cts[batch + i]), ctx.rlk)
        np.testing.assert_array_equal(out[i], np.asarray(ref.data))


@pytest.mark.parametrize('mesh_shape', [(8, 1), (2, 4)],
                         ids=['op8', 'op2xlimb4'])
def test_task_graph_op_placement(ctx, tmp_path, mesh_shape):
    """FheTaskTpu(mesh=...): iso-op groups of a compiled task sharded over
    the op axis — and, when the mesh carries a limb axis, each member's RNS
    limbs sharded across it (graph-level DP x kernel-level TP in one
    compiled program) — results identical to the eager interpreter."""
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import FheTaskTpu
    level = 3
    mesh = make_mesh(op=mesh_shape[0], limb=mesh_shape[1])
    params = ctx.params
    fe = fct.BfvParam.create_custom_param(n=N, q=list(params.q),
                                          p=list(params.p), t=T)
    fct.set_fhe_param(fe)
    n_par = 8
    ins, outs = [], []
    for k in range(n_par):
        xk = fct.BfvCiphertextNode(f'x{k}', level)
        yk = fct.BfvCiphertextNode(f'y{k}', level)
        ins += [fct.Argument(f'x{k}', xk), fct.Argument(f'y{k}', yk)]
        outs.append(fct.Argument(f'z{k}', fct.mult_relin(xk, yk, f'z{k}')))
    fct.process_custom_task(ins, outs, output_instruction_path=str(tmp_path))

    rng = np.random.default_rng(9)
    vals = {}
    expected = {}
    for k in range(n_par):
        m1 = rng.integers(0, T, N, dtype=np.uint64)
        m2 = rng.integers(0, T, N, dtype=np.uint64)
        vals[f'x{k}'] = ctx.encrypt(ctx.encode(m1, level))
        vals[f'y{k}'] = ctx.encrypt(ctx.encode(m2, level))
        expected[f'z{k}'] = (m1.astype(object) * m2 % T).astype(np.uint64)
    placed = FheTaskTpu(str(tmp_path), mode='jit', mesh=mesh)
    out_p, _ = placed.run(ctx, vals)
    eager = FheTaskTpu(str(tmp_path), mode='eager')
    out_e, _ = eager.run(ctx, vals)
    for k in range(n_par):
        np.testing.assert_array_equal(np.asarray(out_p[f'z{k}'].data),
                                      np.asarray(out_e[f'z{k}'].data))
        np.testing.assert_array_equal(ctx.decrypt_decode(out_p[f'z{k}']),
                                      expected[f'z{k}'])


@pytest.mark.skipif(
    os.environ.get('LATTISENSE_SLOW_TESTS', '') in ('', '0'),
    reason='~5 min of segment compiles (set LATTISENSE_SLOW_TESTS=1)')
def test_bootstrap_segments_limb_sharded(tmp_path):
    """Limb-sharded CKKS bootstrap: every Bootstrapper segment jitted with
    the ciphertext's RNS limb axis sharded over the mesh's 8-way ``limb``
    axis — one exhausted ciphertext refreshed ACROSS devices (the single-
    ciphertext-across-chips capability SURVEY §5 marks as the genuinely
    new one; the reference never splits a ciphertext, fhe_lib_v2.h:1173).
    GSPMD inserts the collectives where limbs interact (ModRaise basis
    spread, key-switch digits); rotations stay shard-local (coefficient
    axis unsharded). Output must match the host golden path bit-for-bit
    at every segment boundary's end."""
    from jax.sharding import NamedSharding, PartitionSpec
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksBtpContext
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig
    from lattisense_tpu.schemes.types import Ciphertext

    n = 256
    q0 = gen_ntt_primes(n, 61, 1)
    qs = gen_ntt_primes(n, 60, 22)
    p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(n, q0 + qs, p[1:],
                                      scale=float(1 << 45))
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                          double_angle=3)
    ctx = CkksBtpContext.create_random_context(params, seed=71, h=32,
                                               btp_config=cfg)
    rng = np.random.default_rng(3)
    msg = rng.uniform(-1, 1, params.slots)
    ct0 = ctx.encrypt(ctx.encode(msg, 0))
    bs = ctx.engine.bootstrapper
    segs = bs.segments(ct0.scale, ctx.swk.get('swk_dts'),
                       ctx.swk.get('swk_std'))

    # host golden walk, capturing per-segment input metadata
    metas, host = [], (Ciphertext(data=np.asarray(ct0.data), level=0,
                                  is_ntt=True, scale=ct0.scale),)
    for _name, fn in segs:
        metas.append([(c.level, c.is_ntt, c.scale) for c in host])
        host = fn(np, host, ctx.rlk, ctx.glk.keys)

    mesh = make_mesh(op=1, limb=8)
    sh = NamedSharding(mesh, PartitionSpec(None, 'limb', None))

    datas = (jnp.asarray(ct0.data),)
    for (_name, fn), meta in zip(segs, metas):
        def seg(ds, rlk, glk, _fn=fn, _meta=meta):
            cts = tuple(Ciphertext(
                data=jax.lax.with_sharding_constraint(d, sh), level=m[0],
                is_ntt=m[1], scale=m[2]) for d, m in zip(ds, _meta))
            return tuple(c.data for c in _fn(jnp, cts, rlk, glk))
        datas = jax.jit(seg)(datas, ctx.rlk, ctx.glk.keys)

    got = np.asarray(datas[0])
    np.testing.assert_array_equal(got, np.asarray(host[0].data))
    out = Ciphertext(data=got, level=host[0].level, is_ntt=host[0].is_ntt,
                     scale=host[0].scale)
    err = np.max(np.abs(ctx.decrypt_decode(out).real - msg))
    assert err < 5e-3, f'sharded bootstrap err {err:.2e}'


@pytest.mark.skipif(
    os.environ.get('LATTISENSE_SLOW_TESTS', '') in ('', '0'),
    reason='~5 min of segment compiles (set LATTISENSE_SLOW_TESTS=1)')
def test_bootstrap_segments_limb_coeff_sharded(tmp_path):
    """2-D limb×coeff sharded CKKS bootstrap segments: every segment jitted with the
    ciphertext sharded over BOTH the RNS-limb axis and the coefficient
    (ring-dimension) axis of a (limb=2, coeff=4) mesh. GSPMD inserts the
    collectives (all_to_all/all_gather where the NTT butterflies and the
    Galois gathers cross coefficient shards; psums where limbs interact).
    Bit-exact vs the host golden path at every segment boundary."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksBtpContext
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig
    from lattisense_tpu.schemes.types import Ciphertext

    n = 256
    q0 = gen_ntt_primes(n, 61, 1)
    qs = gen_ntt_primes(n, 60, 22)
    p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(n, q0 + qs, p[1:],
                                      scale=float(1 << 45))
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                          double_angle=3)
    ctx = CkksBtpContext.create_random_context(params, seed=72, h=32,
                                               btp_config=cfg)
    rng = np.random.default_rng(4)
    msg = rng.uniform(-1, 1, params.slots)
    ct0 = ctx.encrypt(ctx.encode(msg, 0))
    bs = ctx.engine.bootstrapper
    segs = bs.segments(ct0.scale, ctx.swk.get('swk_dts'),
                       ctx.swk.get('swk_std'))

    metas, host = [], (Ciphertext(data=np.asarray(ct0.data), level=0,
                                  is_ntt=True, scale=ct0.scale),)
    for _name, fn in segs:
        metas.append([(c.level, c.is_ntt, c.scale) for c in host])
        host = fn(np, host, ctx.rlk, ctx.glk.keys)

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip('need 8 virtual devices')
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ('limb', 'coeff'))
    sh = NamedSharding(mesh, PartitionSpec(None, 'limb', 'coeff'))

    datas = (jnp.asarray(ct0.data),)
    for (_name, fn), meta in zip(segs, metas):
        def seg(ds, rlk, glk, _fn=fn, _meta=meta):
            cts = tuple(Ciphertext(
                data=jax.lax.with_sharding_constraint(d, sh), level=m[0],
                is_ntt=m[1], scale=m[2]) for d, m in zip(ds, _meta))
            return tuple(c.data for c in _fn(jnp, cts, rlk, glk))
        datas = jax.jit(seg)(datas, ctx.rlk, ctx.glk.keys)

    got = np.asarray(datas[0])
    np.testing.assert_array_equal(got, np.asarray(host[0].data))
    out = Ciphertext(data=got, level=host[0].level, is_ntt=host[0].is_ntt,
                     scale=host[0].scale)
    err = np.max(np.abs(ctx.decrypt_decode(out).real - msg))
    assert err < 5e-3, f'limb×coeff sharded bootstrap err {err:.2e}'


def test_integrated_limb_tp_ckks_mult_relin_rescale():
    """CKKS twin of the integrated 2-D pipeline: op-sharded NTT-domain
    tensor product -> limb-TP key switch -> in-graph rescale, one jit
    program — bit-exact vs the single-device golden pipeline."""
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksContext
    from lattisense_tpu.parallel.batch import make_limb_tp_mult_relin_rescale
    q = gen_ntt_primes(N, 45, 5)
    p = gen_ntt_primes(N, 46, 2, exclude=tuple(q))
    params = CkksParams.create_custom(N, q, p, scale=float(1 << 40))
    cctx = CkksContext.create_random_context(params, seed=31)
    level = params.max_level
    mesh = make_mesh(op=4, limb=2)
    f, prep = make_limb_tp_mult_relin_rescale(cctx.engine, level, mesh)
    kd = prep(cctx.rlk.key_q, cctx.rlk.key_p)
    batch = 8
    rng = np.random.default_rng(12)
    vals = rng.uniform(-1, 1, (2 * batch, params.slots))
    cts = [cctx.encrypt(cctx.encode(v, level)) for v in vals]
    a = np.stack([c.data for c in cts[:batch]])
    b = np.stack([c.data for c in cts[batch:]])
    out = np.asarray(f(a, b, kd))
    eng = cctx.engine
    for i in range(batch):
        ref = eng.rescale(np, eng.relinearize(
            np, eng.mult(np, cts[i], cts[batch + i]), cctx.rlk))
        np.testing.assert_array_equal(out[i], np.asarray(ref.data))
        got = cctx.decrypt_decode(
            type(ref)(data=out[i], level=ref.level, is_ntt=True,
                      scale=ref.scale))
        np.testing.assert_allclose(got.real, vals[i] * vals[batch + i],
                                   atol=1e-4)


def test_integrated_limb_tp_mult_relin_w32():
    """The headline w32 (31-bit-word) BFV pipeline through the integrated
    op x limb program — bit-exact vs the single-device w32 golden path."""
    from lattisense_tpu.parallel.batch import make_limb_tp_mult_relin
    chain = tuple(gen_ntt_primes(N, 31, 10))
    q, p = list(chain[:8]), list(chain[8:10])
    params = BfvParams.create_custom(N, 65537, q, p, word_bits=32)
    wctx = BfvContext.create_random_context(params, seed=23)
    level = 7
    mesh = make_mesh(op=2, limb=4)
    f, prep = make_limb_tp_mult_relin(wctx.engine, level, mesh)
    kd = prep(wctx.rlk.key_q, wctx.rlk.key_p)
    batch = 4
    rng = np.random.default_rng(17)
    msgs = rng.integers(0, 65537, (2 * batch, N), dtype=np.uint64)
    cts = [wctx.encrypt(wctx.encode(m, level)) for m in msgs]
    a = np.stack([c.data for c in cts[:batch]])
    b = np.stack([c.data for c in cts[batch:]])
    out = np.asarray(f(a, b, kd))
    assert out.dtype == np.uint32
    for i in range(batch):
        ref = wctx.engine.relinearize(
            np, wctx.engine.mult(np, cts[i], cts[batch + i]), wctx.rlk)
        np.testing.assert_array_equal(out[i], np.asarray(ref.data))


@pytest.mark.parametrize('word', [64, 32])
def test_integrated_limb_tp_rotate(ctx, word):
    """rotate_col through the limb-TP switch (automorphism local under
    both axes, key switch explicit-collective) — bit-exact vs
    engine.apply_galois, on both RNS words."""
    from lattisense_tpu.parallel.batch import make_limb_tp_rotate
    from lattisense_tpu.schemes.galois import galois_elt_col
    if word == 64:
        wctx, level = ctx, 3
    else:
        chain = tuple(gen_ntt_primes(N, 31, 10))
        q, p = list(chain[:8]), list(chain[8:10])
        params = BfvParams.create_custom(N, 65537, q, p, word_bits=32)
        wctx, level = BfvContext.create_random_context(params, seed=27), 7
    elt = galois_elt_col(1, N)
    wctx.gen_galois_keys_for_elements([elt])
    mesh = make_mesh(op=4, limb=2)
    f, prep = make_limb_tp_rotate(wctx.engine, elt, level, mesh)
    glk = wctx.glk.keys[elt]
    kd = prep(glk.key_q, glk.key_p)
    batch = 4
    rng = np.random.default_rng(13)
    msgs = rng.integers(0, 65537, (batch, N), dtype=np.uint64)
    cts = [wctx.encrypt(wctx.encode(m, level)) for m in msgs]
    a = np.stack([c.data for c in cts])
    out = np.asarray(f(a, kd))
    for i in range(batch):
        ref = wctx.engine.apply_galois(np, cts[i], elt, glk)
        np.testing.assert_array_equal(out[i], np.asarray(ref.data))


def test_limb_tp_hoisted_rotations(ctx):
    """Hoisted rotation bundle: one decomposition, per-element digit
    permutation + sharded from-digits switch — bit-exact vs the engine's
    rns_sp_decomp + apply_galois_decomposed path."""
    from lattisense_tpu.parallel.batch import make_limb_tp_hoisted_rotations
    from lattisense_tpu.schemes.galois import galois_elt_col
    level = 3
    elts = [galois_elt_col(s, N) for s in (1, 2, 5)]
    ctx.gen_galois_keys_for_elements(elts)
    mesh = make_mesh(op=4, limb=2)
    f, prep = make_limb_tp_hoisted_rotations(ctx.engine, elts, level, mesh)
    kds = prep(ctx.glk.keys)
    rng = np.random.default_rng(19)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ct = ctx.encrypt(ctx.encode(m, level))
    got = f(np.asarray(ct.data), kds)
    dct = ctx.engine.rns_sp_decomp(np, ct)
    for e in elts:
        ref = ctx.engine.apply_galois_decomposed(np, dct, e,
                                                 ctx.glk.keys[e])
        np.testing.assert_array_equal(np.asarray(got[e]),
                                      np.asarray(ref.data))


def test_limb_tp_hoisted_rotations_ckks():
    """CKKS hoisted bundle (NTT-domain cts): bit-exact vs the engine's
    rns_sp_decomp + apply_galois_decomposed path."""
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksContext
    from lattisense_tpu.parallel.batch import make_limb_tp_hoisted_rotations
    from lattisense_tpu.schemes.galois import galois_elt_col
    q = gen_ntt_primes(N, 45, 5)
    p = gen_ntt_primes(N, 46, 2, exclude=tuple(q))
    params = CkksParams.create_custom(N, q, p, scale=float(1 << 40))
    cctx = CkksContext.create_random_context(params, seed=37)
    level = params.max_level
    elts = [galois_elt_col(s, N) for s in (1, 3)]
    cctx.gen_galois_keys_for_elements(elts)
    mesh = make_mesh(op=4, limb=2)
    f, prep = make_limb_tp_hoisted_rotations(cctx.engine, elts, level, mesh)
    kds = prep(cctx.glk.keys)
    rng = np.random.default_rng(23)
    v = rng.uniform(-1, 1, params.slots)
    ct = cctx.encrypt(cctx.encode(v, level))
    got = f(np.asarray(ct.data), kds)
    dct = cctx.engine.rns_sp_decomp(np, ct)
    for e in elts:
        ref = cctx.engine.apply_galois_decomposed(np, dct, e,
                                                  cctx.glk.keys[e])
        np.testing.assert_array_equal(np.asarray(got[e]),
                                      np.asarray(ref.data))


@pytest.mark.parametrize('mesh_shape', [(1, 2, 4), (2, 2, 2)],
                         ids=['limb2xcoeff4', 'op2xlimb2xcoeff2'])
def test_task_graph_coeff_placement(ctx, tmp_path, mesh_shape):
    """FheTaskTpu(mesh=...) with a ``coeff`` mesh axis: each op's ring
    dimension sharded across devices via GSPMD sharding constraints
    — a
    mult_relin + rotate task graph, results identical to the eager
    interpreter."""
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import FheTaskTpu
    level = 3
    op_d, limb_d, coeff_d = mesh_shape
    mesh = make_mesh(op=op_d, limb=limb_d, coeff=coeff_d)
    params = ctx.params
    fe = fct.BfvParam.create_custom_param(n=N, q=list(params.q),
                                          p=list(params.p), t=T)
    fct.set_fhe_param(fe)
    n_par = 4
    ins, outs = [], []
    for k in range(n_par):
        xk = fct.BfvCiphertextNode(f'x{k}', level)
        yk = fct.BfvCiphertextNode(f'y{k}', level)
        ins += [fct.Argument(f'x{k}', xk), fct.Argument(f'y{k}', yk)]
        zk = fct.mult_relin(xk, yk, f'z{k}')
        outs.append(fct.Argument(f'r{k}', fct.rotate_cols(zk, [1], f'r{k}')[0]))
    fct.process_custom_task(ins, outs, output_instruction_path=str(tmp_path))

    ctx.gen_rotation_keys_for_rotations([1], level=level)
    rng = np.random.default_rng(17)
    vals = {}
    expected = {}
    from tests import oracles
    for k in range(n_par):
        m1 = rng.integers(0, T, N, dtype=np.uint64)
        m2 = rng.integers(0, T, N, dtype=np.uint64)
        vals[f'x{k}'] = ctx.encrypt(ctx.encode(m1, level))
        vals[f'y{k}'] = ctx.encrypt(ctx.encode(m2, level))
        expected[f'r{k}'] = oracles.vec_rotate_col(
            (m1.astype(object) * m2 % T).astype(np.uint64), 1)
    placed = FheTaskTpu(str(tmp_path), mode='jit', mesh=mesh)
    out_p, _ = placed.run(ctx, vals)
    eager = FheTaskTpu(str(tmp_path), mode='eager')
    out_e, _ = eager.run(ctx, vals)
    for k in range(n_par):
        np.testing.assert_array_equal(np.asarray(out_p[f'r{k}'].data),
                                      np.asarray(out_e[f'r{k}'].data))
        np.testing.assert_array_equal(ctx.decrypt_decode(out_p[f'r{k}']),
                                      expected[f'r{k}'])
