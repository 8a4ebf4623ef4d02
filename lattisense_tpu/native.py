"""ctypes bindings for the native host kernel library (csrc/).

Builds ``liblattisense_host.so`` from the committed sources on first use
in each process (``make -C csrc``, a no-op when the library is up to date,
so a stale library never outlives a source change); every entry point has
a NumPy fallback, so the framework works without the native library (it
is a host-side accelerator, not a dependency). The C++ kernels are
bit-identical to core/u64.py / core/ntt.py by construction — asserted by
tests/test_native.py.
"""

import ctypes
import functools
import os
import subprocess

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'csrc')
_SO = os.path.join(_CSRC, 'liblattisense_host.so')
_U64P = ctypes.POINTER(ctypes.c_uint64)


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        subprocess.run(['make', '-C', _CSRC], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    for name, args in (
            ('ls_vec_addmod', [_U64P] * 4 + [ctypes.c_long] * 2),
            ('ls_vec_submod', [_U64P] * 4 + [ctypes.c_long] * 2),
            ('ls_vec_mont_mul', [_U64P] * 5 + [ctypes.c_long] * 2),
            ('ls_vec_mulmod', [_U64P] * 6 + [ctypes.c_long] * 2),
            ('ls_ntt_forward', [_U64P] * 4 + [ctypes.c_long] * 2),
            ('ls_ntt_inverse', [_U64P] * 6 + [ctypes.c_long] * 2),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _flat_limbs(x: np.ndarray):
    """(..., L, n) → (B·L, n) contiguous view + (B, L, n) dims."""
    n = x.shape[-1]
    L = x.shape[-2]
    flat = np.ascontiguousarray(x).reshape(-1, n)
    return flat, L, n


def ntt_forward(x: np.ndarray, ring) -> np.ndarray:
    """Batched negacyclic NTT on (..., L, n); same output as core.ntt.ntt."""
    lib = _lib()
    flat, L, n = _flat_limbs(x)
    batch = flat.shape[0] // L
    out = flat.copy()
    tbl = np.ascontiguousarray(ring.psi_rev)
    tbl_sh = np.ascontiguousarray(ring.psi_rev_shoup)
    q = np.ascontiguousarray(ring.q.reshape(-1))
    if batch > 1:
        tbl = np.tile(tbl, (batch, 1))
        tbl_sh = np.tile(tbl_sh, (batch, 1))
        q = np.tile(q, batch)
    lib.ls_ntt_forward(_ptr(out), _ptr(tbl), _ptr(tbl_sh), _ptr(q),
                       out.shape[0], n)
    return out.reshape(x.shape)


def ntt_inverse(x: np.ndarray, ring) -> np.ndarray:
    lib = _lib()
    flat, L, n = _flat_limbs(x)
    batch = flat.shape[0] // L
    out = flat.copy()
    tbl = np.ascontiguousarray(ring.psi_inv_rev)
    tbl_sh = np.ascontiguousarray(ring.psi_inv_rev_shoup)
    q = np.ascontiguousarray(ring.q.reshape(-1))
    ninv = np.ascontiguousarray(ring.n_inv.reshape(-1))
    ninv_sh = np.ascontiguousarray(ring.n_inv_shoup.reshape(-1))
    if batch > 1:
        tbl = np.tile(tbl, (batch, 1))
        tbl_sh = np.tile(tbl_sh, (batch, 1))
        q = np.tile(q, batch)
        ninv = np.tile(ninv, batch)
        ninv_sh = np.tile(ninv_sh, batch)
    lib.ls_ntt_inverse(_ptr(out), _ptr(tbl), _ptr(tbl_sh), _ptr(ninv),
                       _ptr(ninv_sh), _ptr(q), out.shape[0], n)
    return out.reshape(x.shape)
