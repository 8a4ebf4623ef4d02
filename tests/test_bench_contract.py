"""Contract test for bench.py: under LATTISENSE_BENCH_BUDGET=0 every
device scenario must skip loudly (a skip is not a failure), the process
must exit rc 0, and the LAST stdout JSON line must be the w32 headline
metric. Slow tier —
the host-native baselines still run real keygen at n=16384."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))


@pytest.mark.skipif(os.environ.get('LATTISENSE_SLOW_TESTS', '') == '',
                    reason='several minutes of host keygen; '
                           'set LATTISENSE_SLOW_TESTS=1')
def test_bench_budget_zero_contract():
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['LATTISENSE_BENCH_BUDGET'] = '0'
    env['LATTISENSE_BENCH_HOST_OPS'] = '4'
    r = subprocess.run([sys.executable, 'bench.py'], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr[-2000:]
    json_lines = [ln for ln in r.stdout.splitlines()
                  if ln.startswith('{')]
    assert json_lines, r.stdout[-2000:]
    last = json.loads(json_lines[-1])
    assert last['metric'] == \
        'bfv_mult_relin_n16384_logQ223_w32_ops_per_s_per_chip'
    assert set(last) >= {'metric', 'value', 'unit', 'vs_baseline'}
    # every line parses
    for ln in json_lines:
        json.loads(ln)
