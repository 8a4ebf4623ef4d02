"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's two-phase strategy (SURVEY.md §4): Python graph
generation + executor conformance against plain-math oracles. Multi-chip
sharding is validated on host-platform virtual devices, as the driver's
``dryrun_multichip`` does.

The platform defaults to the CPU. Tests marked ``gpu`` need a card: run
them there with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

from lattisense_tpu.utils import compile_cache  # noqa: E402

# FHE task graphs are deep elementwise programs; caching compiles across
# test runs cuts suite time drastically.
compile_cache.configure()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == 'gpu']
    if not gpus:
        pytest.skip('needs an NVIDIA GPU (JAX_PLATFORMS=cuda); chip_smoke.py '
                    'runs the same check on the card')
    return gpus[0]
