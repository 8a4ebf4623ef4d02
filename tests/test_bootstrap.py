"""CKKS bootstrapping end-to-end (toy config; reference analog:
test_cpu_ckks toy bootstrap, SURVEY.md §4)."""

import os
import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu.core.modring import gen_ntt_primes
from lattisense_tpu.params import CkksParams
from lattisense_tpu.runtime import CkksBtpContext
from lattisense_tpu.schemes.bootstrap import BootstrapConfig

N = 256


@pytest.fixture(scope='module')
def btp_ctx():
    # 60-bit working primes (EvalMod runs at scale ≈ 2^60); the input
    # scale 2^45 gives message ratio q0/Δ ≈ 2^16
    q0 = gen_ntt_primes(N, 61, 1)
    qs = gen_ntt_primes(N, 60, 22)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(N, q0 + qs, p[1:], scale=float(1 << 45))
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                          double_angle=3)
    return CkksBtpContext.create_random_context(params, seed=71, h=32,
                                                btp_config=cfg)


def test_bootstrap_refresh(btp_ctx):
    ctx = btp_ctx
    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, ctx.params.slots)
    # exhausted ciphertext at level 0
    ct = ctx.encrypt(ctx.encode(msg, 0))
    assert ct.level == 0

    fresh = ctx.bootstrap(ct)
    assert fresh.level >= 2, 'bootstrap must leave usable levels'
    got = ctx.decrypt_decode(fresh).real
    err = np.max(np.abs(got - msg))
    assert err < 5e-3, f'bootstrap precision too low: max err {err:.2e}'

    # the refreshed ciphertext supports further multiplications
    sq = ctx.rescale(ctx.mult_relin(fresh, fresh))
    got2 = ctx.decrypt_decode(sq).real
    np.testing.assert_allclose(got2, msg ** 2, atol=5e-2)


def test_bootstrap_preserves_complex(btp_ctx):
    ctx = btp_ctx
    rng = np.random.default_rng(1)
    msg = rng.uniform(-1, 1, ctx.params.slots) + 1j * rng.uniform(-1, 1, ctx.params.slots)
    ct = ctx.encrypt(ctx.encode(msg, 0))
    fresh = ctx.bootstrap(ct)
    got = ctx.decrypt_decode(fresh)
    assert np.max(np.abs(got - msg)) < 5e-3


def test_bootstrap_task_graph(btp_ctx, tmp_path):
    """Frontend bootstrap node → mega_ag.json → FheTaskTpu eager run
    (reference two-phase shape for the toy bootstrap)."""
    from lattisense_tpu.frontend import custom_task as fct
    from lattisense_tpu.runtime import FheTaskTpu

    ctx = btp_ctx
    p = ctx.params
    fe = fct.CkksBtpParam.create_custom_param(
        n=N, q=p.q, p=p.p, slots=p.slots, scale=p.scale,
        cts_depth=3, stc_depth=3, eval_mod_k=16, sine_deg=30, double_angle=3,
        btp_output_level=3)
    fct.set_fhe_param(fe)
    x = fct.CkksCiphertextNode('x', 0)
    z = fct.bootstrap(x, 'z')
    fct.process_custom_task([fct.Argument('x', x)], [fct.Argument('z', z)],
                            output_instruction_path=str(tmp_path))

    task = FheTaskTpu(str(tmp_path), mode='eager')
    rng = np.random.default_rng(5)
    msg = rng.uniform(-1, 1, p.slots)
    ct = ctx.encrypt(ctx.encode(msg, 0))
    outputs, _ = task.run(ctx, {'x': ct})
    got = ctx.decrypt_decode(outputs['z']).real
    assert np.max(np.abs(got - msg)) < 5e-3

    # partitioned mode lowers the bootstrap node through per-phase jits
    # (the full-size compile path, Bootstrapper.segments) — must agree
    # with the eager run bit-exactly
    taskp = FheTaskTpu(str(tmp_path), mode='partitioned')
    outp, _ = taskp.run(ctx, {'x': ct})
    np.testing.assert_array_equal(np.asarray(outp['z'].data),
                                  np.asarray(outputs['z'].data))

    # const-lifted segment jit (utils/jit_lift.py — the full-size 413
    # path, auto-on at n>=32768) must be bit-identical to plain jit
    import os
    os.environ['LATTISENSE_JIT_LIFT'] = '1'
    try:
        taskl = FheTaskTpu(str(tmp_path), mode='partitioned')
        outl, _ = taskl.run(ctx, {'x': ct})
    finally:
        del os.environ['LATTISENSE_JIT_LIFT']
    np.testing.assert_array_equal(np.asarray(outl['z'].data),
                                  np.asarray(outputs['z'].data))


def test_bootstrap_sparse_slots():
    """Sparse packing (slots < n/2): SubSum projection + size-s transforms
    (reference toy bootstrap covers dense AND sparse)."""
    q0 = gen_ntt_primes(N, 61, 1)
    qs = gen_ntt_primes(N, 60, 22)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(N, q0 + qs, p[1:], slots=N // 8,
                                      scale=float(1 << 45))
    cfg = BootstrapConfig(cts_depth=2, stc_depth=2, k=16, sine_deg=30,
                          double_angle=3)
    ctx = CkksBtpContext.create_random_context(params, seed=73, h=32,
                                               btp_config=cfg)
    rng = np.random.default_rng(2)
    msg = rng.uniform(-1, 1, params.slots)
    ct = ctx.encrypt(ctx.encode(msg, 0))
    fresh = ctx.bootstrap(ct)
    got = ctx.decrypt_decode(fresh).real
    err = np.max(np.abs(got - msg))
    assert err < 5e-3, f'sparse bootstrap err {err:.2e}'


@pytest.mark.skipif(os.environ.get('LATTISENSE_SLOW_TESTS', '') == '',
                    reason='slow: reference toy profile (n=8192, 30 limbs); '
                           'set LATTISENSE_SLOW_TESTS=1 (reference tags the '
                           'full-size bootstrap [.] the same way)')
def test_bootstrap_reference_toy_profile():
    """The reference's toy bootstrap parameter set, end-to-end."""
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    fe = CkksBtpParam.create_toy_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    # table config, two deviations with measured rationale:
    #  - K=20 (table: 16): with H=192 the observed |I| reaches 18, and
    #    our sine formulation needs the operand strictly inside [-K, K]
    #  - sine_deg=39 (table: 31): SlotsToCoeffs has no 1/n normalization,
    #    so the SYSTEMATIC part of the Chebyshev truncation error (a
    #    deterministic function of each coefficient's I value) adds
    #    coherently across slots — amplified by up to n/2, deg 31's
    #    5.5e-8 truncation becomes ~7e-3 in the output. Deg 39 (3.6e-13,
    #    same Paterson-Stockmeyer depth as 32..63) removes it; the
    #    remaining ~4e-4 is rotation/rescale noise through the ~2^39
    #    scale of the 40-bit StC prime region.
    cfg = BootstrapConfig(cts_depth=fe.cts_params.depth(),
                          stc_depth=fe.stc_params.depth(),
                          k=20, sine_deg=39,
                          double_angle=fe.eval_mod_params.double_angle,
                          em_scale=float(fe.eval_mod_params.scaling_factor),
                          message_ratio=fe.eval_mod_params.message_ratio)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(7)
    msg = rng.uniform(-1, 1, params.slots)
    ct = ctx.encrypt(ctx.encode(msg, 0))
    fresh = ctx.bootstrap(ct)
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 5, f'too few usable levels left (level {fresh.level})'
    assert err < 1e-3, f'toy-profile bootstrap err {err:.2e}'


def test_bootstrap_mixed_chain_regions():
    """Mixed-prime-size chain with region alignment (the reference table
    SHAPE: big q0 | ~40-bit StC region | uniform 60-bit EvalMod region |
    ~57-bit CtS region): the lazy level-prime plaintext encoding and the
    level-free real/imag split keep every stage inside its region."""
    q0 = gen_ntt_primes(N, 61, 1)
    q41 = gen_ntt_primes(N, 41, 4)
    q60 = gen_ntt_primes(N, 60, 10, exclude=tuple(q0))
    q57 = gen_ntt_primes(N, 57, 3)
    p = [x for x in gen_ntt_primes(N, 62, 3)][:2]
    params = CkksParams.create_custom(N, q0 + q41 + q60 + q57, p,
                                      scale=float(1 << 40))
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                          double_angle=3, em_scale=float(1 << 60),
                          message_ratio=256.0)
    ctx = CkksBtpContext.create_random_context(params, seed=71, h=32,
                                               btp_config=cfg)
    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, params.slots)
    ct = ctx.encrypt(ctx.encode(msg, 0))
    fresh = ctx.bootstrap(ct)
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert err < 1e-4, f'mixed-chain bootstrap err {err:.2e}'


@pytest.mark.skipif(os.environ.get('LATTISENSE_SLOW_TESTS', '') == '',
                    reason='slow: reference toy profile, precision-tuned; '
                           'set LATTISENSE_SLOW_TESTS=1')
def test_bootstrap_toy_profile_tuned_ratio():
    """The same reference toy profile with message_ratio tuned 256 → 32.

    message_ratio trades message headroom (|v| ≤ q0/(ratio·Δ)) against the
    noise floor: the pipeline's absolute noise ε·q0 appears in the output
    as ratio·ε relative to the message (measured: err ≈ ratio·6.6e-7 after
    the round-2 HPS mod-down fix — 1.7e-4 at the reference's 256, 2.5e-5
    at 32 — while the sine's cubic term only reaches ~(2π/ratio)²/6 ≈
    3e-6·m³ at 32). The reference field (btp_eval_mod_message_ratio)
    remains the default contract; 32 is the precision-tuned profile."""
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    fe = CkksBtpParam.create_toy_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(cts_depth=fe.cts_params.depth(),
                          stc_depth=fe.stc_params.depth(),
                          k=20, sine_deg=39,
                          double_angle=fe.eval_mod_params.double_angle,
                          em_scale=float(fe.eval_mod_params.scaling_factor),
                          message_ratio=32.0)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(7)
    msg = rng.uniform(-1, 1, params.slots)
    fresh = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 0)))
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 5
    assert err < 1e-4, f'tuned toy-profile bootstrap err {err:.2e}'


@pytest.mark.skipif(os.environ.get('LATTISENSE_HEAVY_TESTS', '') == '',
                    reason='heavy: full-size n=65536 bootstrap, ~50 min CPU; '
                           'set LATTISENSE_HEAVY_TESTS=1')
def test_bootstrap_reference_full_profile():
    """The reference's FULL bootstrap parameter set (n=2^16, 25 limbs).

    Measured (2026-08-17, CPU golden path): level 6 remaining,
    err 7.6e-3 ≈ 2^-7 — the rotation/rescale-noise floor through the
    40-bit StC region scales ~√n over the toy profile's 4e-4.
    """
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    fe = CkksBtpParam.create_default_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(cts_depth=fe.cts_params.depth(),
                          stc_depth=fe.stc_params.depth(),
                          k=20, sine_deg=39,
                          double_angle=fe.eval_mod_params.double_angle,
                          em_scale=float(fe.eval_mod_params.scaling_factor),
                          message_ratio=fe.eval_mod_params.message_ratio)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(7)
    msg = rng.uniform(-1, 1, params.slots)
    fresh = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 0)))
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 5, f'too few levels left ({fresh.level})'
    assert err < 5e-2, f'full-profile bootstrap err {err:.2e}'


def test_bootstrap_w32_composite_scale():
    """32-bit-word bootstrap via composite scaling: the
    working scale ≈2^62 spans a PAIR of 31-bit primes (limbs_per_level
    auto-selects 2 on w32 engines), every rescale drops two limbs, and
    ModRaise lifts from the composite base q0·q1 by an exact u64 CRT.

    Measured (n=256, 2026-08-18): ratio 16 plain 2.16e-4 (the cubic
    intermodulation floor, same as u64); ratio 8 + arcsine 4.24e-6 — the
    noise slope, u64-class quality with every op in native 32-bit words."""
    qs = gen_ntt_primes(N, 31, 46)
    p = gen_ntt_primes(N, 31, 3, exclude=tuple(qs))
    params = CkksParams.create_custom(N, qs, p, scale=float(1 << 30),
                                      word_bits=32)
    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, params.slots)
    errs = {}
    for ratio, arc in ((16.0, False), (8.0, True)):
        cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                              double_angle=3, message_ratio=ratio,
                              arcsine=arc)
        ctx = CkksBtpContext.create_random_context(params, seed=7, h=32,
                                                   btp_config=cfg)
        assert ctx.engine.bootstrapper.step == 2      # auto from word_bits
        fresh = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 1)))
        assert fresh.level >= 7, f'too few limbs left ({fresh.level})'
        errs[arc] = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert errs[False] < 5e-4, f'w32 bootstrap err {errs[False]:.2e}'
    assert errs[True] < 2e-5, f'w32 arcsine bootstrap err {errs[True]:.2e}'
    # input-SNR bound: part of the floor above is the INPUT ciphertext's
    # own noise (≈c·n·σ/Δ_in, measured stage-clean to 1e-13); encoding
    # the bootstrap input at 2^40 removes that component. At n=256 other floors bind near 2e-6 so the gain here
    # is ~2x (measured 1.96e-6 vs 4.24e-6); at n=4096 it is 843x
    # (4.5e-5 → 5.3e-8) and grows with n.
    ct40 = ctx.encrypt(ctx.engine.encode(msg, 1, float(1 << 40)))
    fresh40 = ctx.bootstrap(ct40)
    err40 = np.max(np.abs(ctx.decrypt_decode(fresh40).real - msg))
    assert err40 < errs[True] * 0.75, \
        f'scale-2^40 input should beat the input-SNR floor: {err40:.2e}'


@pytest.mark.skipif(os.environ.get('LATTISENSE_HEAVY_TESTS', '') == '',
                    reason='heavy: full-size n=65536 w32 bootstrap; '
                           'set LATTISENSE_HEAVY_TESTS=1')
def test_bootstrap_w32_full_size():
    """Full-size 32-bit-word bootstrap: n=2^16 on the 31-bit chain
    (create_tpu_btp_param), reference full-profile circuit quality
    (k=20, sine_deg=39, arcsine).

    The input is encoded at scale 2^40: bootstrap output precision is
    bounded by the INPUT ciphertext's own SNR (err ≈ c·n·σ/Δ_in,
    ratio/amplitude/h-independent — measured by the session-5 probes:
    every homomorphic stage is clean to ~1e-13; the floor at the default
    Δ=2^30 is the input noise √n-amplified by SlotsToCoeffs). At Δ=2^40
    the pipeline itself binds. Measured 2026-08-18: n=4096 4.5e-5 @
    2^30 → 5.3e-8 @ 2^40 (843x)."""
    params = CkksParams.create_tpu_btp_param(65536)
    cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=20, sine_deg=39,
                          double_angle=3, message_ratio=8.0, arcsine=True)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(7)
    msg = rng.uniform(-1, 1, params.slots)
    ct = ctx.encrypt(ctx.engine.encode(msg, 1, float(1 << 40)))
    fresh = ctx.bootstrap(ct)
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 8, f'too few limbs left ({fresh.level})'
    # measured 1.119e-6 (2026-08-18, this exact config/seed); 18x margin
    assert err < 2e-5, f'w32 full-size bootstrap err {err:.2e}'


@pytest.mark.skipif(os.environ.get('LATTISENSE_HEAVY_TESTS', '') == '',
                    reason='heavy: full-size n=65536 bootstrap, ~50 min CPU; '
                           'set LATTISENSE_HEAVY_TESTS=1')
def test_bootstrap_reference_full_profile_arcsine():
    """Full profile + arcsine correction at message_ratio 4: the cubic
    intermodulation floor cancelled, the output rides the noise slope.

    Measured (2026-08-17, CPU golden path): err 8.25e-5 — below the 1e-4
    round-2 target (2.9e-4 at the best non-arcsine tuning, 7.6e-3 in
    round 1) — with 4 levels left (arcsine costs 2)."""
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    fe = CkksBtpParam.create_default_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(cts_depth=fe.cts_params.depth(),
                          stc_depth=fe.stc_params.depth(),
                          k=20, sine_deg=39,
                          double_angle=fe.eval_mod_params.double_angle,
                          em_scale=float(fe.eval_mod_params.scaling_factor),
                          message_ratio=4.0, arcsine=True)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(7)
    msg = rng.uniform(-1, 1, params.slots)
    fresh = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 0)))
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 3, f'too few levels left ({fresh.level})'
    assert err < 2e-4, f'arcsine full-profile bootstrap err {err:.2e}'


def test_bootstrap_arcsine_cancels_cubic_floor():
    """BootstrapConfig(arcsine=True): the deg-3 arcsine correction after
    EvalMod cancels the sine's cubic term (which acts per ring coefficient
    — a cross-slot intermodulation floor cubic in message amplitude and
    ∝ ratio⁻²). Measured at n=256, ratio 8: 6.7e-4 → 1.3e-6 (~500×); the
    residual scales as the quintic (1/ratio⁴). Costs 2 levels."""
    q0 = gen_ntt_primes(N, 61, 1)
    qs = gen_ntt_primes(N, 60, 22)
    p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
    params = CkksParams.create_custom(N, q0 + qs, p[1:], scale=float(1 << 45))
    msg = np.linspace(-1, 1, params.n // 2)
    errs = {}
    for arc in (False, True):
        cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                              double_angle=3, message_ratio=8.0, arcsine=arc)
        ctx = CkksBtpContext.create_random_context(params, seed=7, h=32,
                                                   btp_config=cfg)
        out = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 0)))
        errs[arc] = np.max(np.abs(ctx.decrypt_decode(out).real - msg))
    assert errs[True] < 1e-5, f'arcsine floor {errs[True]:.2e}'
    assert errs[True] < errs[False] / 50, (
        f'arcsine should cancel the cubic floor: {errs}')


@pytest.mark.skipif(os.environ.get('LATTISENSE_SLOW_TESTS', '') == '',
                    reason='slow: reference toy profile + arcsine; '
                           'set LATTISENSE_SLOW_TESTS=1')
def test_bootstrap_toy_profile_arcsine():
    """Reference toy profile, arcsine + ratio 8: the cubic intermodulation
    floor cancelled, the output sits exactly on the noise slope
    (measured 5.4e-6 at ratio 8, 2.8e-6 at ratio 4 — vs 2.5e-5 for the
    best non-arcsine tuning). Costs 2 of the remaining levels."""
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    fe = CkksBtpParam.create_toy_param()
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(cts_depth=fe.cts_params.depth(),
                          stc_depth=fe.stc_params.depth(),
                          k=20, sine_deg=39,
                          double_angle=fe.eval_mod_params.double_angle,
                          em_scale=float(fe.eval_mod_params.scaling_factor),
                          message_ratio=8.0, arcsine=True)
    ctx = CkksBtpContext.create_random_context(params, seed=77, h=192,
                                               btp_config=cfg)
    rng = np.random.default_rng(3)
    msg = rng.uniform(-1, 1, params.slots)
    fresh = ctx.bootstrap(ctx.encrypt(ctx.encode(msg, 0)))
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    assert fresh.level >= 2, f'too few levels left ({fresh.level})'
    assert err < 2e-5, f'arcsine toy-profile bootstrap err {err:.2e}'
