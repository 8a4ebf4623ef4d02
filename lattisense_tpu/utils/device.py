"""Device checks and timing shared by the GPU scripts (chip_smoke.py,
benchmarks/). A measurement path that finds no GPU fails; it never falls
back to the CPU."""

import statistics
import subprocess
import time


def require_gpu():
    """The JAX devices, which must all be GPUs; raises otherwise."""
    import jax
    devs = jax.devices()
    if not devs or any(d.platform != 'gpu' for d in devs):
        raise RuntimeError('no GPU found: jax.devices() = '
                           f'{[d.platform for d in devs]}')
    return devs


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_tag() -> dict:
    import jax
    d = jax.devices()[0]
    return {'platform': d.platform, 'kind': d.device_kind,
            'count': len(jax.devices())}


def median_ms(fn, *args, reps: int = 10) -> tuple[float, list[float]]:
    """Median wall time of ``fn(*args)`` ending in ``block_until_ready``
    over ``reps`` calls (after one warm-up call), and all samples, in ms."""
    import jax
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples), samples
