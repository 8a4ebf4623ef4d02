"""Binary-real plug-in boundary: build the C ABI
.so + a standalone C++ client, drive a compiled bfv mult_relin+rotate
task through it over raw-RNS C structs only, and verify the returned
ciphertext decrypts to the oracle. The client also asserts the verbatim
reference signature-error strings through the C ABI.

The client process embeds CPython for the XLA run but itself links ONLY
csrc/lattisense_plugin.h + liblattisense_plugin.so — the contract a real
SEAL/Go binary would compile against."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
from lattisense_tpu import abi
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.frontend import custom_task as ctk
from lattisense_tpu.frontend.custom_task import BfvParam
from lattisense_tpu.params import BfvParams
from lattisense_tpu.runtime import BfvContext

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
from tools import plugin_fixture as fx  # noqa: E402

from . import oracles

N, T = 64, 65537
CSRC = os.path.join(os.path.dirname(__file__), '..', 'csrc')


@pytest.fixture(scope='module')
def built():
    if shutil.which('g++') is None:
        pytest.skip('no g++ toolchain')
    r = subprocess.run(['make', '-C', CSRC, 'plugin'],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f'plugin build failed: {r.stderr[-500:]}')
    return os.path.join(CSRC, 'plugin_client')


def test_cpp_client_end_to_end(built, tmp_path):
    q = gen_ntt_primes(N, 50, 4)
    p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, T, q, p)
    level = 2

    task_dir = tmp_path / 'task'
    task_dir.mkdir()
    fe = BfvParam.create_custom_param(N, list(q), list(p), T)
    ctk.set_fhe_param(fe)
    x = ctk.BfvCiphertextNode('x', level)
    y = ctk.BfvCiphertextNode('y', level)
    z = ctk.mult_relin(x, y, 'z')
    w = ctk.rotate_cols(z, 1, 'w')
    ctk.process_custom_task([ctk.Argument('x', x), ctk.Argument('y', y)],
                            [ctk.Argument('w', w)],
                            output_instruction_path=str(task_dir))

    ctx = BfvContext.create_random_context(params, seed=91)
    ctx.gen_rotation_keys_for_rotations([1])
    rng = np.random.default_rng(7)
    m1 = rng.integers(0, T, N, dtype=np.uint64)
    m2 = rng.integers(0, T, N, dtype=np.uint64)

    fix = tmp_path / 'fixtures'
    fix.mkdir()
    fx.write_ct(str(fix / 'x.ct'), ctx.encrypt(ctx.encode(m1, level)))
    fx.write_ct(str(fix / 'y.ct'), ctx.encrypt(ctx.encode(m2, level)))
    fx.write_ct(str(fix / 'x_badlevel.ct'),
                ctx.encrypt(ctx.encode(m1, level - 1)))
    qp_ring = get_rns_ring(tuple(q) + tuple(p), N)
    fx.write_ksk(str(fix / 'rlk.key'), ctx.rlk, qp_ring)
    fx.write_glk(str(fix / 'glk.key'), ctx.glk.keys, qp_ring)

    out_ct = tmp_path / 'w.ct'
    env = dict(os.environ)
    env['PYTHONPATH'] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), '..'))
    env['LATTISENSE_PLUGIN_PLATFORM'] = 'cpu'
    env['JAX_PLATFORMS'] = 'cpu'
    r = subprocess.run([built, str(task_dir), str(fix), str(out_ct)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, \
        f'client failed rc={r.returncode}\nstdout:{r.stdout}\nstderr:{r.stderr}'
    assert 'CLIENT OK' in r.stdout
    assert 'negative wrong-level: OK' in r.stdout
    assert 'negative swapped-id: OK' in r.stdout

    back = fx.read_ct(str(out_ct))
    got = ctx.decrypt_decode(back)
    prod = (m1 * m2) % T
    half = N // 2
    expected = np.concatenate([np.roll(prod[:half], -1),
                               np.roll(prod[half:], -1)])
    np.testing.assert_array_equal(got, expected)


def test_capi_registry_roundtrip(tmp_path):
    """The Python half of the boundary in-process (no toolchain needed):
    create/run/release through pointer-level marshaling (abi casts)."""
    import ctypes

    from lattisense_tpu.plugin import capi

    q = gen_ntt_primes(N, 50, 4)
    p = gen_ntt_primes(N, 51, 2, exclude=tuple(q))
    params = BfvParams.create_custom(N, T, q, p)
    level = 2
    task_dir = tmp_path / 'task'
    task_dir.mkdir()
    fe = BfvParam.create_custom_param(N, list(q), list(p), T)
    ctk.set_fhe_param(fe)
    x = ctk.BfvCiphertextNode('x', level)
    y = ctk.BfvCiphertextNode('y', level)
    z = ctk.mult_relin(x, y, 'z')
    ctk.process_custom_task([ctk.Argument('x', x), ctk.Argument('y', y)],
                            [ctk.Argument('z', z)],
                            output_instruction_path=str(task_dir))
    ctx = BfvContext.create_random_context(params, seed=92)
    rng = np.random.default_rng(8)
    m1 = rng.integers(0, T, N, dtype=np.uint64)
    m2 = rng.integers(0, T, N, dtype=np.uint64)
    a = abi.export_ciphertext(ctx.encrypt(ctx.encode(m1, level)))
    b = abi.export_ciphertext(ctx.encrypt(ctx.encode(m2, level)))
    qp_ring = get_rns_ring(tuple(q) + tuple(p), N)
    rlk = abi.export_keyswitch_key(ctx.rlk, 0, qp_ring)

    tid = capi.create_task(str(task_dir))
    rows = capi.run_task(
        tid,
        [('x', capi.TYPE_CIPHERTEXT, [ctypes.addressof(a.struct)], level),
         ('y', capi.TYPE_CIPHERTEXT, [ctypes.addressof(b.struct)], level),
         ('rlk', capi.TYPE_RELIN_KEY, [ctypes.addressof(rlk.struct)], 0)],
        ['z'], 0)
    (ptr_arr_addr, size, out_level) = rows[0]
    assert size == 1 and out_level == level
    elem = ctypes.cast(ptr_arr_addr,
                       ctypes.POINTER(ctypes.c_void_p))[0]
    w = ctypes.cast(elem, ctypes.POINTER(abi.CCiphertext)).contents
    got = ctx.decrypt_decode(abi.import_ciphertext(w))
    np.testing.assert_array_equal(got, (m1 * m2) % T)
    capi.release_task(tid)
