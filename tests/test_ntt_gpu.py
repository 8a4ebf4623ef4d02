"""Row-fused GPU NTT (ops/ntt_gpu.py): the kernel body in Pallas interpret
mode, the wrapper's row flattening and checks, and core/ntt.py's choice of
backend. Under ``interpret=True`` the high word of a Shoup product is the
portable formula of core/u64.py, not the ``mul.hi`` instruction the card
runs; ``test_kernel_on_card`` covers that
(skips without a GPU; chip_smoke.py phase (b) runs the same check)."""

import functools
import types

import numpy as np
import pytest

import lattisense_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from lattisense_tpu.core import ntt as ntt_mod
from lattisense_tpu.core.modring import gen_ntt_primes, get_rns_ring
from lattisense_tpu.ops import ntt_gpu

WORDS = {32: (31, np.uint32), 64: (59, np.uint64)}


def _ring_and_rows(n, word, batch, L=2, seed=0):
    bits, dt = WORDS[word]
    q = tuple(gen_ntt_primes(n, bits, L))
    ring = get_rns_ring(q, n, word)
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, qi, (*batch, n), dtype=np.uint64).astype(dt)
                  for qi in q], axis=-2)
    return ring, x


@pytest.mark.parametrize('word', [32, 64])
@pytest.mark.parametrize('n', [256, 1024, 16384])
def test_kernel_interpret_bit_exact(n, word):
    ring, x = _ring_and_rows(n, word, (2,), seed=n + word)
    want = ntt_mod.ntt(np, x, ring)
    got = np.asarray(ntt_gpu.ntt(jnp.asarray(x), ring, interpret=True))
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)
    back = np.asarray(ntt_gpu.intt(jnp.asarray(want), ring, interpret=True))
    np.testing.assert_array_equal(back, ntt_mod.intt(np, want, ring))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize('word', [32, 64])
def test_kernel_interpret_under_vmap(word):
    """vmap (the batched-step path) adds a grid axis; same result."""
    ring, x = _ring_and_rows(512, word, (3,), seed=7)
    fwd = jax.vmap(lambda v: ntt_gpu.ntt(v, ring, interpret=True))
    got = np.asarray(jax.jit(fwd)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ntt_mod.ntt(np, x, ring))


@pytest.mark.parametrize('batch', [(), (3,), (2, 2)])
def test_kernel_row_flattening(batch):
    """Any leading batch shape flattens to (rows, n) and back; a limb
    prefix of the ring (fewer limbs than the ring has) uses its twiddles."""
    n = 256
    ring, x = _ring_and_rows(n, 32, batch, L=3, seed=len(batch))
    x2 = x[..., :2, :]
    got = np.asarray(ntt_gpu.ntt(jnp.asarray(x2), ring, interpret=True))
    assert got.shape == x2.shape
    np.testing.assert_array_equal(got, ntt_mod.ntt(np, x, ring)[..., :2, :])


@pytest.mark.parametrize('case', ['dtype', 'n', 'limbs'])
def test_kernel_rejects_mismatched_rows(case):
    ring, x = _ring_and_rows(256, 32, (1,), L=2)
    if case == 'dtype':
        x, err = x.astype(np.uint64), TypeError
    elif case == 'n':
        x, err = x[..., :128], ValueError
    else:
        x, err = np.concatenate([x, x], axis=-2), ValueError
    with pytest.raises(err):
        ntt_gpu.ntt(jnp.asarray(x), ring, interpret=True)


@pytest.mark.parametrize('n,dtype,ok', [
    (16384, np.uint32, True),
    (16384, np.uint64, True),
    (32768, np.uint32, True),
    (32768, np.uint64, False),     # 256 KB row: more than a block keeps
    (16384, np.int32, False),
    (3, np.uint32, False),
])
def test_supported_shapes(n, dtype, ok):
    assert ntt_gpu.supported(n, dtype) is ok


@pytest.mark.parametrize('case', ['kernel', 'numpy', 'word', 'n'])
def test_kernel_eligibility(monkeypatch, case):
    """jax arrays + a word in GPU_KERNEL_WORDS + a row the kernel holds →
    the kernel is offered; host arrays, other words or shapes → XLA only."""
    n = 65536 if case == 'n' else 256
    ring = types.SimpleNamespace(moduli=(1,))    # only .moduli is read
    x = jnp.zeros((1, n), jnp.uint64)
    xp = np if case == 'numpy' else jnp
    if case == 'word':
        monkeypatch.setattr(ntt_mod, 'GPU_KERNEL_WORDS', frozenset({4}))
    assert ntt_mod._gpu_kernel_ok(xp, x, ring) is (case == 'kernel')


@pytest.mark.parametrize('platform', ['cpu', 'cuda'])
def test_platform_choice(platform):
    """The choice is made per lowering platform: a program lowered for
    CUDA calls the Triton kernel; one lowered for the CPU has none."""
    ring, x = _ring_and_rows(256, 32, (3,))
    for fn in (ntt_mod.ntt, ntt_mod.intt):
        f = jax.jit(lambda v: fn(jnp, v, ring))
        text = f.trace(x).lower(lowering_platforms=(platform,)).as_text()
        assert ('xla.gpu.triton' in text) is (platform == 'cuda')


def test_dispatch_wires_kernel(monkeypatch):
    """With the CUDA branch taken, core.ntt.ntt/intt call the kernel (run
    here in interpret mode) and stay bit-exact."""
    ring, x = _ring_and_rows(256, 64, (2,), seed=3)
    calls = []

    def spy(fn):
        def run(v, r):
            calls.append(fn.__name__)
            return functools.partial(fn, interpret=True)(v, r)
        return run

    monkeypatch.setattr(jax.lax, 'platform_dependent',
                        lambda *a, cuda, default: cuda(*a))
    monkeypatch.setattr(ntt_gpu, 'ntt', spy(ntt_gpu.ntt))
    monkeypatch.setattr(ntt_gpu, 'intt', spy(ntt_gpu.intt))
    f = np.asarray(ntt_mod.ntt(jnp, jnp.asarray(x), ring))
    b = np.asarray(ntt_mod.intt(jnp, jnp.asarray(f), ring))
    assert calls == ['ntt', 'intt']
    np.testing.assert_array_equal(f, ntt_mod.ntt(np, x, ring))
    np.testing.assert_array_equal(b, x)


@pytest.mark.gpu
@pytest.mark.parametrize('word', [32, 64])
def test_kernel_on_card(gpu_device, word):
    """The compiled kernel (mul.hi instructions) at n=16384, bit-exact."""
    ring, x = _ring_and_rows(16384, word, (32,), L=4, seed=word)
    want = ntt_mod.ntt(np, x, ring)
    got = np.asarray(jax.jit(lambda v: ntt_gpu.ntt(v, ring))(x))
    np.testing.assert_array_equal(got, want)
    back = np.asarray(jax.jit(lambda v: ntt_gpu.intt(v, ring))(want))
    np.testing.assert_array_equal(back, x)
