"""Precision stats + observability units."""

import numpy as np

import lattisense_tpu  # noqa: F401
from lattisense_tpu.utils.observability import MemoryMonitor, TaskProgressBar
from lattisense_tpu.utils.precision import get_precision_stats


def test_precision_stats_basic():
    rng = np.random.default_rng(0)
    want = rng.uniform(-1, 1, 256) + 1j * rng.uniform(-1, 1, 256)
    test = want + (rng.uniform(-1, 1, 256) + 1j * rng.uniform(-1, 1, 256)) * 2**-30
    p = get_precision_stats(want, test)
    assert 28 < p.mean_precision.l2 < 34
    assert p.min_precision.l2 <= p.mean_precision.l2 <= p.max_precision.l2
    assert p.max_delta.l2 >= p.median_delta.l2 >= p.min_delta.l2
    assert 2**-34 < p.std_freq < 2**-28
    assert len(p.l2_dist) == p.cdf_resol
    s = str(p)
    assert 'AVG Prec' in s and 'Err STD Slots' in s


def test_precision_stats_exact_match():
    v = np.ones(16)
    p = get_precision_stats(v, v)
    assert p.mean_precision.real >= 53   # clamped at 1e-16 floor


def test_progress_bar_and_memory_monitor(tmp_path, capsys):
    bar = TaskProgressBar(total=10, interval_ms=0)
    for i in range(11):
        bar(i, 10)
    err = capsys.readouterr().err
    assert '10/10' in err and '100.0%' in err

    mon = MemoryMonitor(interval_ms=10)
    csv = str(tmp_path / 'mem.csv')
    mon.start(csv)
    import time
    time.sleep(0.08)
    mon.stop()
    lines = open(csv).read().strip().splitlines()
    assert lines[0].startswith('time_s,vmrss_kb')
    assert len(lines) >= 2
    assert int(lines[1].split(',')[1]) > 0   # nonzero RSS


def test_trace_and_cost_analysis(tmp_path):
    """jax-profiler trace context + XLA cost analysis (SURVEY §5 profiling
    hooks): the trace directory materializes, and the cost model reports
    nonzero flops for a modular-arithmetic program."""
    import jax.numpy as jnp

    from lattisense_tpu.utils import observability as obs

    def f(a, b):
        return (a * b) % jnp.uint32(65537)

    a = np.arange(64, dtype=np.uint32)
    cost = obs.xla_cost_analysis(f, a, a)
    assert cost.get('flops', 0) > 0 or cost.get('bytes accessed', 0) > 0
    with obs.trace(str(tmp_path / 'trace')):
        np.asarray(f(a, a))
    assert any((tmp_path / 'trace').rglob('*'))


def test_task_progress_callback(tmp_path):
    """Eager-mode per-op progress (reference ProgressCallback shape)."""
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.frontend import custom_task as ct
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext, FheTaskTpu

    n, t = 64, 65537
    q = gen_ntt_primes(n, 50, 3)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    ct.set_fhe_param(ct.BfvParam.create_custom_param(n=n, q=q, p=p, t=t))
    x = ct.BfvCiphertextNode('x', 1)
    y = ct.add(ct.add(x, x), ct.add(x, x), 'y')
    ct.process_custom_task([ct.Argument('x', x)], [ct.Argument('y', y)],
                           output_instruction_path=str(tmp_path))
    context = BfvContext.create_random_context(
        BfvParams.create_custom(n, t, q, p), seed=1)
    task = FheTaskTpu(str(tmp_path), mode='eager')
    calls = []
    m = np.arange(n, dtype=np.uint64)
    task.run(context, {'x': context.encrypt(context.encode(m, 1))},
             progress_cb=lambda done, total: calls.append((done, total)))
    assert calls[-1] == (len(task.plan), len(task.plan))


def test_noise_budget_meter():
    """BFV invariant-noise budget (SEAL semantics): positive on a fresh
    ciphertext, strictly consumed by multiplication, and still positive
    while decryption is exact."""
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams
    from lattisense_tpu.runtime import BfvContext

    n, t = 64, 65537
    q = gen_ntt_primes(n, 50, 3)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    ctx = BfvContext.create_random_context(
        BfvParams.create_custom(n, t, q, p), seed=5)
    m = np.arange(n, dtype=np.uint64) % t
    ct = ctx.encrypt(ctx.encode(m, 2))
    b0 = ctx.noise_budget(ct)
    assert b0 > 40, f'fresh budget too low: {b0:.1f}'
    sq = ctx.mult_relin(ct, ct)
    b1 = ctx.noise_budget(sq)
    assert 0 < b1 < b0, (b0, b1)
    np.testing.assert_array_equal(
        ctx.decrypt_decode(sq), (m.astype(object) ** 2 % t).astype(np.uint64))


def test_security_estimation():
    import warnings

    from lattisense_tpu.params import BfvParams, CkksParams
    from lattisense_tpu.utils.security import (check_security, log_qp,
                                               security_bits)

    # the reference default production chains satisfy 128-bit security
    for n in (8192, 16384):
        assert security_bits(BfvParams.create(n)) >= 128, n
    # an oversized toy chain misses every tier and warns
    from lattisense_tpu.core.modring import gen_ntt_primes
    q = gen_ntt_primes(1024, 50, 2)
    p = gen_ntt_primes(1024, 51, 1, exclude=tuple(q))
    bad = BfvParams.create_custom(1024, 65537, q, p)
    assert log_qp(bad) > 100 and security_bits(bad) == 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        assert check_security(bad) == 0
    assert any('128-bit' in str(w.message) for w in rec)
    # the 31-bit bootstrap profile (48+4 x 31-bit, logQP ~ 1612) sits inside
    # the n=2^16 128-bit convention bound (~1792) — factory stays silent
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tier = security_bits(CkksParams.create_tpu_btp_param(65536))
    assert tier >= 128 and not any('security' in str(w.message) for w in rec)


def test_eval_op_error_paths():
    """Descriptive errors on invalid eager ops (reference REQUIRE_THROWS
    coverage, test_lattigo.cpp:2049-2119)."""
    import pytest
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import BfvParams, CkksParams
    from lattisense_tpu.runtime import BfvContext, CkksContext

    n = 64
    q = gen_ntt_primes(n, 50, 3)
    p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
    ctx = BfvContext.create_random_context(BfvParams.create_custom(n, 65537, q, p),
                                           seed=5)
    m = np.arange(n, dtype=np.uint64)
    a = ctx.encrypt(ctx.encode(m, 2))
    b = ctx.encrypt(ctx.encode(m, 1))
    with pytest.raises(RuntimeError, match='x0 and x1 have different levels.'):
        ctx.add(a, b)
    with pytest.raises(RuntimeError, match='x0 and x1 have different levels.'):
        ctx.mult(a, b)
    with pytest.raises(RuntimeError, match='missing Galois key'):
        ctx.rotate_cols(a, 5)
    pub = ctx.make_public_context()
    with pytest.raises(RuntimeError, match='Context does not have sk and decryptor.'):
        pub.decrypt(a)

    big = gen_ntt_primes(n, 60, 2)
    mids = gen_ntt_primes(n, 40, 2)
    cctx = CkksContext.create_random_context(
        CkksParams.create_custom(n, [big[0]] + mids, [big[1]], scale=float(1 << 40)),
        seed=6)
    x = cctx.encrypt(cctx.encode(np.ones(n // 2), 2))
    y = cctx.encrypt(cctx.encode(np.ones(n // 2), 2, scale=float(1 << 41)))
    with pytest.raises(ValueError, match='scale mismatch'):
        cctx.add(x, y)


def test_jit_lifted_equivalence_and_cache():
    """utils.jit_lift.jit_lifted: bit-identical to jax.jit with closure
    constants turned into runtime arguments; re-calls at the same shapes
    hit the jaxpr cache, new shapes retrace."""
    import jax
    import jax.numpy as jnp

    from lattisense_tpu.utils.jit_lift import jit_lifted

    big = np.arange(1 << 12, dtype=np.uint64).reshape(64, 64)
    calls = {'n': 0}

    def g(x, y):
        calls['n'] += 1
        tab = jnp.asarray(big)[:x.shape[0]]
        return {'a': x * tab + y['b'], 'n': (x - y['b'],)}

    f = jit_lifted(g)
    x = np.full((64, 64), 3, np.uint64)
    y = {'b': np.full((64, 64), 5, np.uint64)}
    got = f(x, y)
    want = jax.jit(g)(x, y)
    np.testing.assert_array_equal(np.asarray(got['a']), np.asarray(want['a']))
    np.testing.assert_array_equal(np.asarray(got['n'][0]),
                                  np.asarray(want['n'][0]))
    traced = calls['n']
    f(x, y)                                 # same shapes: cached jaxpr
    assert calls['n'] == traced
    f(x[:32, :], {'b': y['b'][:32, :]})     # new shapes: retrace
    assert calls['n'] == traced + 1
