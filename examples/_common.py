"""Shared example scaffolding: repo-root import path + parameter helpers.

Every example supports ``--n <ring_dim>`` (default 16384, reference parity)
and ``--toy`` for a fast self-check on small custom parameters.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_args(description: str):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument('--n', type=int, default=16384)
    ap.add_argument('--toy', action='store_true',
                    help='n=64 custom params on CPU for a fast self-check')
    ap.add_argument('--cpu', action='store_true', help='force the CPU backend')
    args = ap.parse_args()
    if args.toy:
        args.n = 64
        args.cpu = True
    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')
    from lattisense_tpu.utils import compile_cache
    compile_cache.configure()
    return args


def bfv_params(n: int, toy: bool):
    """(frontend Param, runtime BfvParams) pair for the chosen size."""
    from lattisense_tpu.frontend import custom_task as ct
    from lattisense_tpu.params import BfvParams

    if toy:
        from lattisense_tpu.core.modring import gen_ntt_primes
        q = gen_ntt_primes(n, 50, 5)
        p = gen_ntt_primes(n, 51, 1, exclude=tuple(q))
        return (ct.BfvParam.create_custom_param(n=n, q=q, p=p, t=65537),
                BfvParams.create_custom(n, 65537, q, p))
    return ct.BfvParam.create_default_param(n=n), BfvParams.create(n)


def ckks_params(n: int, toy: bool):
    from lattisense_tpu.frontend import custom_task as ct
    from lattisense_tpu.params import CkksParams

    if toy:
        from lattisense_tpu.core.modring import gen_ntt_primes
        big = gen_ntt_primes(n, 60, 2)
        mids = gen_ntt_primes(n, 40, 4)
        q, p, scale = [big[0]] + mids, [big[1]], float(1 << 40)
        return (ct.CkksParam.create_custom_param(n=n, q=q, p=p, scale=scale),
                CkksParams.create_custom(n, q, p, scale=scale))
    return ct.CkksParam.create_default_param(n=n), CkksParams.create(n)
