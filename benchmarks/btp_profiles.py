"""Shared bootstrap profile construction for the chip / sharded-mesh
runners — ONE definition per profile so walk caches and artifacts are
comparable across scripts.

Profiles mirror the reference facade's bootstrap configs
(fhe_ops_lib/fhe_lib_v2.h:294-308: toy n=2^13 CI-exercised set, full
n=2^16 N16QP1546H192H32) at this repo's best-known quality dials
(toy ratio 8 + deg-3 arcsine -> 5.4e-6; full ratio 4 + arcsine ->
8.25e-5, both measured on the host golden path).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(mode: str, sparse: bool = False):
    """-> (params, cfg, seed, h) for mode in {'smoke', 'toy', 'full'}."""
    from lattisense_tpu.params import CkksParams
    from lattisense_tpu.schemes.bootstrap import BootstrapConfig
    from lattisense_tpu.core.modring import gen_ntt_primes

    if mode == 'smoke':
        n = 256
        q0 = gen_ntt_primes(n, 61, 1)
        qs = gen_ntt_primes(n, 60, 22)
        p = gen_ntt_primes(n, 61, 3, exclude=tuple(q0))
        params = CkksParams.create_custom(n, q0 + qs, p[1:],
                                          scale=float(1 << 45))
        cfg = BootstrapConfig(cts_depth=3, stc_depth=3, k=16, sine_deg=30,
                              double_angle=3)
        return params, cfg, 7, 32
    from lattisense_tpu.frontend.custom_task import CkksBtpParam
    if mode == 'full':
        fe = CkksBtpParam.create_default_param()
        params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=fe.slots,
                                          scale=float(fe.scale))
        cfg = BootstrapConfig(
            cts_depth=fe.cts_params.depth(), stc_depth=fe.stc_params.depth(),
            k=20, sine_deg=39, double_angle=fe.eval_mod_params.double_angle,
            em_scale=float(fe.eval_mod_params.scaling_factor),
            message_ratio=4.0, arcsine=True)
        return params, cfg, 77, 192
    assert mode == 'toy', mode
    fe = CkksBtpParam.create_toy_param()
    slots = fe.slots // 4 if sparse else fe.slots
    params = CkksParams.create_custom(fe.n, fe.q, fe.p, slots=slots,
                                      scale=float(fe.scale))
    cfg = BootstrapConfig(
        cts_depth=fe.cts_params.depth(), stc_depth=fe.stc_params.depth(),
        k=20, sine_deg=39, double_angle=fe.eval_mod_params.double_angle,
        em_scale=float(fe.eval_mod_params.scaling_factor),
        message_ratio=8.0, arcsine=True)
    return params, cfg, 77, 192
