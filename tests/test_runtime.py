"""End-to-end: frontend Erg → mega_ag.json → FheTaskTpu (eager & jit) →
decrypt, matching the plain-math oracles — this framework's analog of the reference's
two-phase suite (SURVEY.md §4, test_cpu_bfv.{py,cpp})."""

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.frontend import custom_task as ct
from lattisense_tpu.params import BfvParams, CkksParams
from lattisense_tpu.runtime import BfvContext, CkksContext, FheTaskTpu

from . import oracles

N = 64
T = 65537


@pytest.fixture()
def bfv_setup():
    q = gen_ntt_primes(N, 50, 3)
    p = gen_ntt_primes(N, 51, 1, exclude=tuple(q))
    fe_param = ct.BfvParam.create_custom_param(n=N, q=q, p=p, t=T)
    rt_params = BfvParams.create_custom(N, T, q, p)
    context = BfvContext.create_random_context(rt_params, seed=11)
    return fe_param, context


@pytest.fixture()
def ckks_setup():
    big = gen_ntt_primes(N, 60, 2)
    mids = gen_ntt_primes(N, 40, 3)
    q = [big[0]] + mids
    p = [big[1]]
    scale = float(1 << 40)
    fe_param = ct.CkksParam.create_custom_param(n=N, q=q, p=p, slots=N // 2, scale=scale)
    rt_params = CkksParams.create_custom(N, q, p, slots=N // 2, scale=scale)
    context = CkksContext.create_random_context(rt_params, seed=13)
    return fe_param, context


def gen_task(fe_param, build, tmp_path):
    ct.set_fhe_param(fe_param)
    ins, outs = build()
    ct.process_custom_task(input_args=ins, output_args=outs,
                           output_instruction_path=str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_bfv_mult_relin_task(bfv_setup, tmp_path, mode):
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 2)
        y = ct.BfvCiphertextNode('y', 2)
        z = ct.mult_relin(x, y, 'z')
        return [ct.Argument('x', x), ct.Argument('y', y)], [ct.Argument('z', z)]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode)
    rng = np.random.default_rng(0)
    ma = rng.integers(0, T, N, dtype=np.uint64)
    mb = rng.integers(0, T, N, dtype=np.uint64)
    ea = context.encrypt(context.encode(ma, 2))
    eb = context.encrypt(context.encode(mb, 2))
    outputs, dur_ns = task.run(context, {'x': ea, 'y': eb})
    got = context.decrypt_decode(outputs['z'])
    assert dur_ns > 0
    np.testing.assert_array_equal(got, oracles.vec_mod_mul(ma, mb, T))


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_bfv_rotation_and_mix_task(bfv_setup, tmp_path, mode):
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        y = ct.BfvPlaintextNode('y', 1)
        s = ct.add(x, y, 's')
        r = ct.rotate_cols(s, [3], 'r')[0]
        w = ct.rotate_rows(s, 'w')
        return [ct.Argument('x', x), ct.Argument('y', y)], \
            [ct.Argument('r', r), ct.Argument('w', w)]

    task_dir = gen_task(fe_param, build, tmp_path)
    # keys required by the task signature
    context.gen_rotation_keys_for_rotations([3], swap_rows=True, level=1)
    task = FheTaskTpu(task_dir, mode=mode)
    rng = np.random.default_rng(1)
    ma = rng.integers(0, T, N, dtype=np.uint64)
    mb = rng.integers(0, T, N, dtype=np.uint64)
    ea = context.encrypt(context.encode(ma, 1))
    pb = context.encode(mb, 1)
    outputs, _ = task.run(context, {'x': ea, 'y': pb})
    expected_sum = oracles.vec_mod_add(ma, mb, T)
    np.testing.assert_array_equal(context.decrypt_decode(outputs['r']),
                                  oracles.vec_rotate_col(expected_sum, 3))
    np.testing.assert_array_equal(context.decrypt_decode(outputs['w']),
                                  oracles.vec_rotate_row(expected_sum))


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_bfv_cmp_sum_task(bfv_setup, tmp_path, mode):
    fe_param, context = bfv_setup
    k = 4

    def build():
        xs = [ct.BfvCiphertextNode(f'x{i}', 1) for i in range(k)]
        ys = [ct.BfvPlaintextRingtNode(f'y{i}') for i in range(k)]
        acc = ct.BfvCiphertextNode('acc', 1)
        z = ct.ct_pt_mult_accumulate_add_ct_slice(xs + [acc], ys, 'z')
        return [ct.Argument('x', xs), ct.Argument('y', ys), ct.Argument('acc', acc)], \
            [ct.Argument('z', z)]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode)
    rng = np.random.default_rng(2)
    ms = [rng.integers(0, T, N, dtype=np.uint64) for _ in range(k)]
    ps = [rng.integers(0, T, N, dtype=np.uint64) for _ in range(k)]
    macc = rng.integers(0, T, N, dtype=np.uint64)
    xs = [context.encrypt(context.encode(m, 1)) for m in ms]
    ys = [context.encode_ringt(p) for p in ps]
    acc = context.encrypt(context.encode(macc, 1))
    outputs, _ = task.run(context, {'x': xs, 'y': ys, 'acc': acc})
    expected = macc.astype(np.int64) % T
    for m, p in zip(ms, ps):
        expected = oracles.vec_mod_add(expected, oracles.vec_mod_mul(m, p, T), T)
    np.testing.assert_array_equal(context.decrypt_decode(outputs['z']), expected)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_ckks_pipeline_task(ckks_setup, tmp_path, mode):
    fe_param, context = ckks_setup

    def build():
        x = ct.CkksCiphertextNode('x', 2)
        y = ct.CkksCiphertextNode('y', 2)
        z = ct.rescale(ct.mult_relin(x, y, 'z'), 'zr')
        return [ct.Argument('x', x), ct.Argument('y', y)], [ct.Argument('zr', z)]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode)
    rng = np.random.default_rng(3)
    va = rng.uniform(-1, 1, N // 2)
    vb = rng.uniform(-1, 1, N // 2)
    ea = context.encrypt(context.encode(va, 2))
    eb = context.encrypt(context.encode(vb, 2))
    outputs, _ = task.run(context, {'x': ea, 'y': eb})
    got = context.decrypt_decode(outputs['zr'])
    np.testing.assert_allclose(got.real, va * vb, atol=1e-4)


def test_signature_error_messages(bfv_setup, tmp_path):
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 2)
        y = ct.BfvCiphertextNode('y', 2)
        z = ct.mult_relin(x, y, 'z')
        return [ct.Argument('x', x), ct.Argument('y', y)], [ct.Argument('z', z)]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode='eager')
    rng = np.random.default_rng(4)
    m = rng.integers(0, T, N, dtype=np.uint64)
    good = context.encrypt(context.encode(m, 2))
    wrong_level = context.encrypt(context.encode(m, 1))
    with pytest.raises(RuntimeError,
                       match='For argument x, expected level is 2, but input level is 1.'):
        task.run(context, {'x': wrong_level, 'y': good})
    pt = context.encode(m, 2)
    with pytest.raises(RuntimeError,
                       match='For argument x, expected type is ct, but input type is pt.'):
        task.run(context, {'x': pt, 'y': good})


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_hoisted_rotations_task(bfv_setup, tmp_path, mode):
    """rns_sp_decomp + advanced rotations must match direct rotations
    (hoisting shares one decomposition across all steps)."""
    fe_param, context = bfv_setup
    steps = [1, 2, 5]

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        outs = ct.advanced_rotate_cols(x, steps, 'r', rot_type='hoisted')
        return [ct.Argument('x', x)], [ct.Argument(f'r{s}', o)
                                       for s, o in zip(steps, outs)]

    task_dir = gen_task(fe_param, build, tmp_path)
    from lattisense_tpu.schemes.galois import galois_elt_col
    context.gen_galois_keys_for_elements(
        [galois_elt_col(s, N) for s in steps])
    task = FheTaskTpu(task_dir, mode=mode)
    rng = np.random.default_rng(7)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ea = context.encrypt(context.encode(m, 1))
    outputs, _ = task.run(context, {'x': ea})
    for s in steps:
        # hoisted ≠ bit-identical to the direct path (the FastBConv overflow
        # multiple differs under negation) but BFV decryption is exact
        np.testing.assert_array_equal(context.decrypt_decode(outputs[f'r{s}']),
                                      oracles.vec_rotate_col(m, s))


@pytest.mark.parametrize('mode', ['eager', 'jit', 'partitioned'])
def test_custom_compute_escape_hatch(bfv_setup, tmp_path, mode):
    """User-defined compute nodes bound to user executors at load time
    (reference: custom_compute + bind_*_task_custom_executors)."""
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        y = ct.BfvCiphertextNode('y', 1)
        ct.custom_compute([x], y, type='double_it', attributes={'factor': 2})
        return [ct.Argument('x', x)], [ct.Argument('y', y)]

    def double_it(xp, engine, inputs, attrs):
        assert attrs['factor'] == 2
        out = inputs[0]
        return engine.add(xp, out, out)

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode,
                      custom_executors={'double_it': double_it})
    rng = np.random.default_rng(8)
    m = rng.integers(0, T, N, dtype=np.uint64)
    outputs, _ = task.run(context, {'x': context.encrypt(context.encode(m, 1))})
    np.testing.assert_array_equal(context.decrypt_decode(outputs['y']),
                                  (2 * m.astype(np.int64)) % T)


def test_facade_completeness(bfv_setup):
    """Coefficient encodes, coefficient peek, batch hoisted rotations
    (reference facade surface: encode_coeffs*, get_coeff, batch
    advanced_rotate_cols)."""
    fe_param, context = bfv_setup
    rng = np.random.default_rng(9)
    m = rng.integers(0, T, N, dtype=np.uint64)

    # coefficient-wise encode: the polynomial IS the message
    ctx_ct = context.encrypt(context.encode_coeffs(m, 2))
    np.testing.assert_array_equal(context.decrypt_coeffs(ctx_ct), m)

    # pt_ringt / pt_mul coefficient variants multiply correctly
    a = context.encrypt(context.encode_coeffs(m, 1))
    one = np.zeros(N, dtype=np.uint64)
    one[0] = 1                                  # x^0: identity polynomial
    prod = context.mult(a, context.encode_coeffs_mul(one, 1))
    np.testing.assert_array_equal(context.decrypt_coeffs(prod), m)

    # raw coefficient peek matches the array
    assert context.get_coeff(a, 0, 0, 5) == int(np.asarray(a.data)[0, 0, 5])

    # batch hoisted rotation returns {step: ct}
    steps = [1, 2]
    from lattisense_tpu.schemes.galois import galois_elt_col
    context.gen_galois_keys_for_elements([galois_elt_col(s, N) for s in steps])
    msg = rng.integers(0, T, N, dtype=np.uint64)
    ct2 = context.encrypt(context.encode(msg, 1))
    rots = context.advanced_rotate_cols(ct2, steps)
    for s in steps:
        np.testing.assert_array_equal(context.decrypt_decode(rots[s]),
                                      oracles.vec_rotate_col(msg, s))


@pytest.mark.parametrize('mode', ['eager'])
def test_seal_convention_rotations(bfv_setup, tmp_path, mode):
    """SEAL-convention rotations (galois_gen=3) through the compiled path:
    the runtime reads galois elements off the key nodes, so both
    conventions execute with the same machinery."""
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        r = ct.seal_advanced_rotate_cols(x, [2], 'r')[0]
        w = ct.seal_rotate_rows(x, 'w')
        return [ct.Argument('x', x)], [ct.Argument('r', r), ct.Argument('w', w)]

    task_dir = gen_task(fe_param, build, tmp_path)
    from lattisense_tpu.frontend.custom_task import (
        get_galois_element_for_column_rotation_by, get_galois_element_for_row_rotation)
    elt = get_galois_element_for_column_rotation_by(2, N, 3)
    context.gen_galois_keys_for_elements([elt, get_galois_element_for_row_rotation(N)])
    task = FheTaskTpu(task_dir, mode=mode)
    rng = np.random.default_rng(10)
    m = rng.integers(0, T, N, dtype=np.uint64)
    outputs, _ = task.run(context, {'x': context.encrypt(context.encode(m, 1))})
    # gen-3 automorphism x -> x^(3^2): a valid permutation of slots; row
    # swap is convention-independent
    np.testing.assert_array_equal(context.decrypt_decode(outputs['w']),
                                  oracles.vec_rotate_row(m))
    got = np.sort(context.decrypt_decode(outputs['r']))
    np.testing.assert_array_equal(got, np.sort(m))   # permutation of the slots


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_compressed_plaintext_mac(bfv_setup, tmp_path, mode):
    """Compressed pt_ringt storage: one (blocks, n) plaintext argument
    feeds a MAC chain block-by-block via compressed_block_info."""
    fe_param, context = bfv_setup
    k = 4

    def build():
        xs = [ct.BfvCiphertextNode(f'x{i}', 1) for i in range(k)]
        y = ct.BfvCompressedPlaintextRingtNode('y', compressed_block_info=list(range(k)))
        z = ct.ct_pt_mult_accumulate(xs, y)
        return [ct.Argument('x', xs), ct.Argument('y', y)], [ct.Argument('z', z, )]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode)
    rng = np.random.default_rng(12)
    ms = [rng.integers(0, T, N, dtype=np.uint64) for _ in range(k)]
    blocks = rng.integers(0, T, (k, N), dtype=np.uint64)
    from lattisense_tpu.schemes.types import PlaintextRingt
    xs = [context.encrypt(context.encode(m, 1)) for m in ms]
    y = PlaintextRingt(data=np.stack([
        context.engine.encode_ringt(b).data for b in blocks]))
    outputs, _ = task.run(context, {'x': xs, 'y': y})
    expected = np.zeros(N, dtype=np.int64)
    for m, b in zip(ms, blocks):
        expected = oracles.vec_mod_add(expected, oracles.vec_mod_mul(m, b, T), T)
    np.testing.assert_array_equal(context.decrypt_decode(outputs['z']), expected)


def test_iso_op_batching(bfv_setup, tmp_path):
    """benchmark_cpu-style graph: many identical parallel ops fuse into one
    vmapped executor (plan shrinks), results identical to eager."""
    fe_param, context = bfv_setup
    n_op = 8

    def build():
        ins, outs = [], []
        for k in range(n_op):
            x = ct.BfvCiphertextNode(f'x{k}', 2)
            y = ct.BfvCiphertextNode(f'y{k}', 2)
            outs.append(ct.mult_relin(x, y, f'z{k}'))
            ins += [x, y]
        return ([ct.Argument(n.id, n) for n in ins],
                [ct.Argument(f'z{k}', o) for k, o in enumerate(outs)])

    task_dir = gen_task(fe_param, build, tmp_path)
    fused = FheTaskTpu(task_dir, mode='jit', batch_fuse=True)
    assert len(fused.plan) == 2, 'mult wave + relin wave should fuse to 2 steps'
    plain = FheTaskTpu(task_dir, mode='eager')

    rng = np.random.default_rng(13)
    ms = rng.integers(0, T, (2 * n_op, N), dtype=np.uint64)
    values = {}
    for k in range(n_op):
        values[f'x{k}'] = context.encrypt(context.encode(ms[2 * k], 2))
        values[f'y{k}'] = context.encrypt(context.encode(ms[2 * k + 1], 2))
    out_f, _ = fused.run(context, values)
    out_p, _ = plain.run(context, values)
    for k in range(n_op):
        np.testing.assert_array_equal(out_f[f'z{k}'].data, out_p[f'z{k}'].data)
        expected = (ms[2 * k].astype(object) * ms[2 * k + 1] % T).astype(np.uint64)
        np.testing.assert_array_equal(context.decrypt_decode(out_f[f'z{k}']),
                                      expected)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_domain_conversion_ops(bfv_setup, tmp_path, mode):
    """to_ntt / to_inv_ntt / to_mform / to_mul execution (the reference's
    FPGA-format op set; NTT-form round trip must be the identity)."""
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        a = ct.to_inv_ntt(ct.to_ntt(x), 'a')            # identity
        d = ct.to_mul(x, 'd')                           # NTT + Montgomery
        return [ct.Argument('x', x)], [ct.Argument('a', a), ct.Argument('d', d)]

    task = FheTaskTpu(gen_task(fe_param, build, tmp_path), mode=mode)
    rng = np.random.default_rng(14)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ea = context.encrypt(context.encode(m, 1))
    outputs, _ = task.run(context, {'x': ea})
    np.testing.assert_array_equal(outputs['a'].data, ea.data)
    ref = context.engine.to_mul(np, ea)
    np.testing.assert_array_equal(outputs['d'].data, ref.data)
    assert outputs['d'].is_ntt and outputs['d'].is_mform


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_offline_input_phase(bfv_setup, tmp_path, mode):
    """Offline inputs preloaded once serve many online runs (reference
    offline_inputs phase, frontend/custom_task.py:2190)."""
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        w = ct.BfvPlaintextMulNode('w', 1)
        z = ct.mult(x, w, 'z')
        return ([ct.Argument('x', x)], [ct.Argument('z', z)],
                [ct.Argument('w', w)])

    fct_ns = ct
    fct_ns.set_fhe_param(fe_param)
    ins, outs, off = build()
    fct_ns.process_custom_task(input_args=ins, output_args=outs,
                               offline_input_args=off,
                               output_instruction_path=str(tmp_path))
    task = FheTaskTpu(str(tmp_path), mode=mode)
    rng = np.random.default_rng(15)
    wv = rng.integers(0, T, N, dtype=np.uint64)
    task.preload(context, {'w': context.encode_mul(wv, 1)})
    for _ in range(2):
        m = rng.integers(0, T, N, dtype=np.uint64)
        outputs, _ = task.run(context, {'x': context.encrypt(context.encode(m, 1))})
        np.testing.assert_array_equal(context.decrypt_decode(outputs['z']),
                                      oracles.vec_mod_mul(m, wv, T))
    # missing offline arg without preload is a hard error
    t2 = FheTaskTpu(str(tmp_path), mode='eager')
    with pytest.raises(RuntimeError, match='Missing input argument "w"'):
        t2.run(context, {'x': context.encrypt(context.encode(wv, 1))})


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_ntt_form_rotation_chain(bfv_setup, tmp_path, mode):
    """NTT-form in/out rotation chains (the reference FPGA test matrix:
    advanced_rotate_cols with out_ct_type='ct-ntt' consumed by further
    rotations)."""
    fe_param, context = bfv_setup

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        r1 = ct.advanced_rotate_cols(x, [1], out_ct_type='ct-ntt')[0]
        r2 = ct.advanced_rotate_cols(r1, [2], out_ct_type='ct-ntt-mf')[0]
        return [ct.Argument('x', x)], [ct.Argument('r', r2)]

    task_dir = gen_task(fe_param, build, tmp_path)
    from lattisense_tpu.schemes.galois import galois_elt_col
    context.gen_galois_keys_for_elements([galois_elt_col(1, N), galois_elt_col(2, N)])
    task = FheTaskTpu(task_dir, mode=mode)
    rng = np.random.default_rng(16)
    m = rng.integers(0, T, N, dtype=np.uint64)
    outputs, _ = task.run(context, {'x': context.encrypt(context.encode(m, 1))})
    out = outputs['r']
    assert out.is_ntt and out.is_mform
    # normalize back (mform -> plain, NTT -> coeff) and check rotation by 3
    from lattisense_tpu.core import u64 as u64mod
    from lattisense_tpu.schemes.types import Ciphertext as Ct
    ring = context.engine.ring(out.level)
    plain = u64mod.from_mont(np, np.asarray(out.data), ring.q, ring.pinv)
    norm = context.engine.to_inv_ntt(
        np, Ct(data=plain, level=out.level, is_ntt=True))
    np.testing.assert_array_equal(context.decrypt_decode(norm),
                                  oracles.vec_rotate_col(m, 3))


def test_partitioned_mode_host_only_custom(bfv_setup, tmp_path):
    """Partitioned mode (reference FPGA analog: graph split at custom-op
    barriers into composite jitted kernels) runs host-ONLY custom executors
    between device segments — code that cannot trace under jit at all."""
    fe_param, context = bfv_setup

    def host_neg(xp, engine, inputs, attrs):
        # deliberately NOT jax-traceable: tolist() forces host values
        assert xp is np
        arr = np.asarray(inputs[0].data)
        assert isinstance(arr.tolist(), list)
        return engine.add(np, inputs[0], inputs[0])

    def build2():
        x = ct.BfvCiphertextNode('x', 1)
        w = ct.rescale(ct.mult_relin(x, x, 'w'), 'wr')
        y = ct.BfvCiphertextNode('y', 0)
        ct.custom_compute([w], y, type='host_neg', attributes={})
        z = ct.add(y, y, 'z')
        return [ct.Argument('x', x)], [ct.Argument('z', z)]

    task_dir = gen_task(fe_param, build2, tmp_path)
    kw = dict(custom_executors={'host_neg': host_neg})
    rng = np.random.default_rng(13)
    m = rng.integers(0, T, N, dtype=np.uint64)
    ea = context.encrypt(context.encode(m, 1))
    ref, _ = FheTaskTpu(task_dir, mode='eager', **kw).run(context, {'x': ea})
    task = FheTaskTpu(task_dir, mode='partitioned', **kw)
    assert len(task._segments()) == 3              # device | host | device
    got, _ = task.run(context, {'x': ea})
    np.testing.assert_array_equal(context.decrypt_decode(got['z']),
                                  context.decrypt_decode(ref['z']))


def test_partitioned_host_steps_overlap(bfv_setup, tmp_path):
    """Heterogeneous overlap (reference: scheduler routes on_cpu nodes to
    the CPU pool concurrently with backend work, cpu_task_utils.h:540-546):
    two INDEPENDENT host custom steps must execute concurrently, not in
    ping-pong order. Each executor waits on a shared 2-party barrier —
    sequential execution would time the barrier out; concurrent execution
    passes it immediately."""
    import threading
    fe_param, context = bfv_setup
    barrier = threading.Barrier(2, timeout=30.0)

    def host_rendezvous(xp, engine, inputs, attrs):
        barrier.wait()          # raises BrokenBarrierError if sequential
        return engine.add(np, inputs[0], inputs[0])

    def build():
        x = ct.BfvCiphertextNode('x', 1)
        y = ct.BfvCiphertextNode('y', 1)
        a = ct.add(x, x, 'a')
        b = ct.add(y, y, 'b')
        ca = ct.BfvCiphertextNode('ca', 1)
        cb = ct.BfvCiphertextNode('cb', 1)
        ct.custom_compute([a], ca, type='host_rendezvous', attributes={})
        ct.custom_compute([b], cb, type='host_rendezvous', attributes={})
        z = ct.add(ca, cb, 'z')
        return ([ct.Argument('x', x), ct.Argument('y', y)],
                [ct.Argument('z', z)])

    task_dir = gen_task(fe_param, build, tmp_path)
    task = FheTaskTpu(task_dir, mode='partitioned',
                      custom_executors={'host_rendezvous': host_rendezvous})
    rng = np.random.default_rng(14)
    mx = rng.integers(0, T, N, dtype=np.uint64)
    my = rng.integers(0, T, N, dtype=np.uint64)
    got, _ = task.run(context, {'x': context.encrypt(context.encode(mx, 1)),
                                'y': context.encrypt(context.encode(my, 1))})
    assert not barrier.broken
    np.testing.assert_array_equal(
        context.decrypt_decode(got['z']),
        (4 * (mx.astype(object) + my.astype(object))) % T)


@pytest.mark.parametrize('mode', ['eager', 'jit'])
def test_w32_task_adopts_context_word(tmp_path, mode):
    """A compiled task executed with a 32-bit-word context: the runtime
    rebuilds its engine on the context's RNS word (the serialized blob is
    word-agnostic), so 31-bit-chain tasks run the u32 path."""
    n, t = 64, 65537
    primes = gen_ntt_primes(n, 31, 6)
    q, p = primes[:4], primes[4:]
    fe = ct.BfvParam.create_custom_param(n=n, q=list(q), p=list(p), t=t)

    def build():
        x = ct.BfvCiphertextNode('x', 3)
        y = ct.BfvCiphertextNode('y', 3)
        z = ct.mult_relin(x, y, 'z')
        return [ct.Argument('x', x), ct.Argument('y', y)], [ct.Argument('z', z)]

    task_dir = gen_task(fe, build, tmp_path)
    params = BfvParams.create_custom(n, t, list(q), list(p), word_bits=32)
    ctx = BfvContext.create_random_context(params, seed=5)
    rng = np.random.default_rng(1)
    a = rng.integers(0, t, n, dtype=np.uint64)
    b = rng.integers(0, t, n, dtype=np.uint64)
    task = FheTaskTpu(task_dir, mode=mode)
    out, _ = task.run(ctx, {'x': ctx.encrypt(ctx.encode(a, 3)),
                            'y': ctx.encrypt(ctx.encode(b, 3))})
    assert task.engine.word_bits == 32
    assert np.asarray(out['z'].data).dtype == np.uint32
    np.testing.assert_array_equal(
        ctx.decrypt_decode(out['z']), oracles.vec_mod_mul(a, b, t))


def test_gen_rotation_keys_standard_set():
    """ctx.gen_rotation_keys() (reference standard key set: every ±2^i
    column key + the row key) serves arbitrary NAF-composite rotate_cols
    steps and rotate_rows without per-step keygen."""
    import numpy as np
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext
    n = 64
    q = gen_ntt_primes(n, 50, 3)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    ctx = BfvContext.create_random_context(
        BfvParams.create_custom(n, 65537, q, p), seed=3)
    ctx.gen_rotation_keys()
    m = np.arange(n, dtype=np.uint64) % 65537
    ct = ctx.encrypt(ctx.encode(m, 2))
    half = n // 2
    for s in (1, 5, 13, -7):
        got = ctx.decrypt_decode(ctx.rotate_cols(ct, s))
        want = np.concatenate([np.roll(m[:half], -s), np.roll(m[half:], -s)])
        assert np.array_equal(got, want), s
    got = ctx.decrypt_decode(ctx.rotate_rows(ct))
    assert np.array_equal(got, np.concatenate([m[half:], m[:half]]))
