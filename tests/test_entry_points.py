"""Entry-point plumbing: the compile-cache helper and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from lattisense_tpu.utils import compile_cache
path = compile_cache.configure()
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({'path': path, 'config': jax.config.jax_compilation_cache_dir,
                  'default': compile_cache.default_dir()}))
'''


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env['JAX_PLATFORMS'] = 'cpu'
    if env_dir is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = env_dir
    out = subprocess.run([sys.executable, '-c', _PROBE, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('case', ['env_set', 'env_unset'])
def test_compile_cache_location(tmp_path, case):
    """Set: JAX's own variable decides and the executable lands there.
    Unset: <checkout>/.cache/jax, resolved from the package location."""
    if case == 'env_set':
        d = str(tmp_path / 'cache')
        got = _probe(d)
        assert got['path'] == d and got['config'] == d
        assert os.listdir(d), 'no compiled executable in the cache dir'
    else:
        got = _probe(None)
        want = os.path.join(ROOT, '.cache', 'jax')
        assert got['path'] == got['config'] == got['default'] == want


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """No GPU (or no checkout beside it): non-zero exit, no ok line."""
    if where == 'checkout':
        cwd = ROOT
    else:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), cwd)
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _bench_module(monkeypatch, budget):
    monkeypatch.setenv('LATTISENSE_BENCH_ALARM', '0')
    monkeypatch.syspath_prepend(ROOT)
    import importlib
    import bench
    bench = importlib.reload(bench)
    monkeypatch.setattr(bench, '_BUDGET_S', budget)
    return bench


@pytest.mark.parametrize('outcome', ['ok', 'fail', 'skip'])
def test_bench_scenario_outcomes(monkeypatch, outcome):
    """A failed scenario is recorded for a non-zero exit and does not stop
    the next one; a budget skip is not a failure."""
    bench = _bench_module(monkeypatch, 0.0 if outcome == 'skip' else 1e9)

    @bench._scenario(f'device: {outcome}')
    def run():
        if outcome == 'fail':
            raise RuntimeError('device fault')
        return 'done'

    got = run()
    assert got == ('done' if outcome == 'ok' else None)
    assert bench._FAILED == (['device: fail'] if outcome == 'fail' else [])


def test_bench_watchdog_exits_nonzero():
    env = dict(os.environ, JAX_PLATFORMS='cpu', LATTISENSE_BENCH_ALARM='1')
    code = ('import sys, time; sys.path.insert(0, sys.argv[1]); '
            'import bench; time.sleep(30)')
    out = subprocess.run([sys.executable, '-c', code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert 'WATCHDOG' in out.stderr
