"""Example: CKKS bootstrapping — refresh an exhausted (level-0) ciphertext
back to a computable level and keep multiplying.

No reference analog (the reference exposes bootstrap only through its
CkksBtpContext API, fhe_lib_v2.h:1173); this demonstrates the same
two-secret design (dense evaluation key + sparse H-weight bootstrap key
bridged by swk_dts/swk_std) on a toy chain sized to run in seconds.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _common import example_args  # noqa: E402

import numpy as np  # noqa: E402


def main():
    import sys as _sys
    w32 = '--w32' in _sys.argv
    if w32:
        _sys.argv.remove('--w32')
    example_args('CKKS bootstrapping (toy chain); --w32 runs the '
                 '32-bit-word composite-scaling variant')
    from lattisense_tpu.core.modring import gen_ntt_primes
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.runtime import CkksBtpContext
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig

    N = 256
    if w32:
        # 32-bit word: uniform 31-bit chain; the working scale spans prime
        # PAIRS (composite scaling, limbs_per_level auto-2), so the
        # exhausted input sits at level 1 (the composite base q0·q1)
        qs = gen_ntt_primes(N, 31, 46)
        p = gen_ntt_primes(N, 31, 3, exclude=tuple(qs))
        params = CkksParams.create_custom(N, qs, p, scale=float(1 << 30),
                                          word_bits=32)
        cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                              double_angle=3, message_ratio=8.0,
                              arcsine=True)
    else:
        q0 = gen_ntt_primes(N, 61, 1)
        qs = gen_ntt_primes(N, 60, 22)
        p = gen_ntt_primes(N, 61, 3, exclude=tuple(q0))
        params = CkksParams.create_custom(N, q0 + qs, p[1:],
                                          scale=float(1 << 45))
        cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                              double_angle=3)
    ctx = CkksBtpContext.create_random_context(params, seed=7, h=32,
                                               btp_config=cfg)

    rng = np.random.default_rng(0)
    msg = rng.uniform(-1, 1, ctx.params.slots)
    base = ctx.engine.bootstrapper.step - 1
    # Encode bootstrap-bound data at a HIGH scale: output precision is
    # bounded by the input ciphertext's own SNR (~n·σ/scale, see
    # doc/performance_guide.md §6) — on 31-bit chains the stationary
    # 2^30 scale would cap large-ring precision; 2^40 is pipeline-limited.
    in_scale = float(1 << 40) if w32 else params.scale
    ct = ctx.encrypt(ctx.engine.encode(msg, base, in_scale))  # exhausted
    print(f'input level: {ct.level} (no multiplies left)')

    fresh = ctx.bootstrap(ct)
    err = np.max(np.abs(ctx.decrypt_decode(fresh).real - msg))
    print(f'refreshed level: {fresh.level}, precision: {err:.2e}')

    sq = ctx.rescale(ctx.mult_relin(fresh, fresh))
    err2 = np.max(np.abs(ctx.decrypt_decode(sq).real - msg ** 2))
    print(f'msg^2 after refresh: max err {err2:.2e}')
    assert err < 5e-3 and err2 < 5e-2
    print('OK')


if __name__ == '__main__':
    main()
