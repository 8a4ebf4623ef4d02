"""Graph-level (batch) sharding of FHE pipelines over a device mesh.

The reference extracts throughput from many independent FHE ops in flight
on a thread pool (SURVEY.md §2.8 item 1, cpu_task_utils.h:378). Here:
vmap the single-ciphertext engine pipeline over a batch axis,
shard that axis over the mesh's ``op`` dimension, and optionally shard the
RNS limb axis over ``limb`` — XLA GSPMD partitions the program and inserts
collectives where limbs interact (base conversion, key-switch inner
products). The GPU NTT kernel partitions along batch and limb axes with
the program (ops/ntt_gpu.py).
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..schemes.types import Ciphertext, KeySwitchKey
from .mesh import ct_batch_spec, key_spec


def _wrap_ct(data, level, is_ntt, scale):
    return Ciphertext(data=data, level=level, is_ntt=is_ntt, scale=scale)


def make_batched_step(engine, step_fn, level: int, *, mesh=None,
                      limb_sharded: bool = False, is_ntt: bool = False,
                      n_inputs: int = 2, donate: bool = False,
                      jit: bool = True):
    """Compile ``step_fn(engine, *cts, keys) -> ct`` into a batched, sharded,
    jitted callable over raw arrays.

    Returns f(a_data[B,2,L,n], ..., keys) -> out_data[B,...]. When ``mesh``
    is given, inputs are constrained to (op × limb) shardings; otherwise the
    single-chip jit path is produced (the driver's ``entry()`` contract).
    ``jit=False`` returns the raw batched callable (single-chip only) so a
    caller can apply its own wrapper — e.g. ``utils.jit_lift.jit_lifted``
    to keep twiddle-table constants out of the serialized HLO.
    """
    scale = getattr(engine.params, 'scale', 1.0)

    def single(*args):
        ct_args = [ _wrap_ct(a, level, is_ntt, scale) for a in args[:n_inputs] ]
        keys = args[n_inputs]
        return step_fn(engine, *ct_args, keys).data

    batched = jax.vmap(single, in_axes=(*([0] * n_inputs), None))

    if mesh is None:
        if not jit:
            return batched
        return jax.jit(batched, donate_argnums=tuple(range(n_inputs)) if donate else ())
    assert jit, 'jit=False is single-chip only'

    ct_sh = NamedSharding(mesh, ct_batch_spec(limb_sharded))
    key_sh = NamedSharding(mesh, key_spec(limb_sharded))

    def sharded(*args):
        cts = [jax.lax.with_sharding_constraint(a, ct_sh) for a in args[:n_inputs]]
        keys = jax.tree.map(lambda k: jax.lax.with_sharding_constraint(k, key_sh),
                            args[n_inputs])
        out = batched(*cts, keys)
        return jax.lax.with_sharding_constraint(out, ct_sh)

    return jax.jit(sharded, donate_argnums=tuple(range(n_inputs)) if donate else ())


# ---- flagship pipelines (benchmark parity: examples/benchmark_cpu) --------

def bfv_mult_relin(engine, a, b, keys):
    """BFV mult + relinearize (benchmark_cpu.cpp:27-51 measured op)."""
    return engine.relinearize(jnp, engine.mult(jnp, a, b), keys['rlk'])


def ckks_mult_relin_rescale(engine, a, b, keys):
    """CKKS mult + relin + rescale (benchmark_cpu.cpp:53-78)."""
    return engine.rescale(jnp, engine.relinearize(jnp, engine.mult(jnp, a, b),
                                                  keys['rlk']))


def ckks_mult_relin_rescale2(engine, a, b, keys):
    """CKKS mult + relin + DOUBLE rescale: one multiplicative level on a
    composite 31-bit chain (limbs_per_level=2, scale ≈ 2^60) — the honest
    w32 twin of the reference's scale-2^40 u64 measurement
    (benchmark_cpu.cpp:53-78): each level consumes a prime PAIR, so the
    per-op work includes both rescales."""
    out = engine.rescale(jnp, engine.relinearize(jnp, engine.mult(jnp, a, b),
                                                 keys['rlk']))
    return engine.rescale(jnp, out)


def make_rotate_step(galois_elt: int):
    def rot(engine, a, keys):
        return engine.apply_galois(jnp, a, galois_elt, keys['glk'][galois_elt])
    return rot


def make_limb_tp_mult_relin(engine, level: int, mesh):
    """Integrated 2-D pipeline: batched BEHZ mult with the batch sharded
    over ``op`` (GSPMD), relinearization through the explicit-collective
    limb-TP key switch (ShardedKeySwitcher.traced — digits computed per
    device, one psum_scatter, in-mesh INTT + mod-down). Bit-identical to
    the single-device pipeline.

    Returns (f, prep_keys): f(a[B,2,L,n], b, kd) jitted; prep_keys(ksk)
    pads the key into the sharded digit layout.
    """
    from ..core import u64 as _u
    from .keyswitch_sharded import ShardedKeySwitcher
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)
    ct_sh = NamedSharding(mesh, ct_batch_spec(False))

    def single_mult(a_data, b_data):
        a = _wrap_ct(a_data, level, False, 1.0)
        b = _wrap_ct(b_data, level, False, 1.0)
        return engine.mult(jnp, a, b).data          # (3, L, n)

    vmult = jax.vmap(single_mult)

    def f(a, b, kd):
        a = jax.lax.with_sharding_constraint(a, ct_sh)
        b = jax.lax.with_sharding_constraint(b, ct_sh)
        d3 = vmult(a, b)                            # (B, 3, L, n)
        e0, e1 = sharded.traced(d3[:, 2], kd)
        c0 = _u.addmod(jnp, d3[:, 0], e0, ring.q)
        c1 = _u.addmod(jnp, d3[:, 1], e1, ring.q)
        out = jnp.stack([c0, c1], axis=1)
        return jax.lax.with_sharding_constraint(out, ct_sh)

    return jax.jit(f), sharded.pad_keys


def make_limb_tp_mult_relin_rescale(engine, level: int, mesh):
    """CKKS twin of :func:`make_limb_tp_mult_relin`: NTT-domain tensor
    product (batch sharded over ``op``), relinearization through the
    explicit-collective limb-TP key switch, rescale in the same program.
    The per-limb NTT/INTT hops around the switch and the rescale are
    limb-independent, so they stay local under the mesh sharding (no
    collectives beyond the switch's psum_scatter).

    Bit-identical to ``rescale(relinearize(mult(a, b)))``; output is the
    (B, 2, L, n) NTT-domain data at ``level - 1`` with scale
    ``scale² / q_level``. Returns (f, prep_keys) like the BFV variant.
    """
    from ..core import ntt as ntt_mod
    from ..core import u64 as _u
    from .keyswitch_sharded import ShardedKeySwitcher
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)
    ring2 = engine.ring(level - 1)
    rescaler = engine.rescaler(level)
    scale = engine.params.scale
    ct_sh = NamedSharding(mesh, ct_batch_spec(False))

    def single_mult(a_data, b_data):
        a = _wrap_ct(a_data, level, True, scale)
        b = _wrap_ct(b_data, level, True, scale)
        return engine.mult(jnp, a, b).data          # (3, L, n) NTT domain

    vmult = jax.vmap(single_mult)

    def f(a, b, kd):
        a = jax.lax.with_sharding_constraint(a, ct_sh)
        b = jax.lax.with_sharding_constraint(b, ct_sh)
        d3 = vmult(a, b)                            # (B, 3, L, n)
        c2 = ntt_mod.intt(jnp, d3[:, 2], ring)
        e0, e1 = sharded.traced(c2, kd)             # coeff-domain over Q_ℓ
        c0 = _u.addmod(jnp, d3[:, 0], ntt_mod.ntt(jnp, e0, ring), ring.q)
        c1 = _u.addmod(jnp, d3[:, 1], ntt_mod.ntt(jnp, e1, ring), ring.q)
        coeff = ntt_mod.intt(jnp, jnp.stack([c0, c1], axis=1), ring)
        out = ntt_mod.ntt(jnp, rescaler(jnp, coeff), ring2)
        return jax.lax.with_sharding_constraint(out, ct_sh)

    return jax.jit(f), sharded.pad_keys


def make_limb_tp_rotate(engine, galois_elt: int, level: int, mesh):
    """BFV rotate_col (the third headline scenario) through the limb-TP
    switch: the Galois automorphism is a coefficient permutation — local
    under both mesh axes — and the key switch of the permuted c1 runs
    through :class:`ShardedKeySwitcher`. Bit-identical to
    ``engine.apply_galois`` on coeff-domain input.

    Returns (f, prep_keys): f(a[B,2,L,n], kd) jitted; prep_keys pads the
    Galois key (``glk.keys[galois_elt]``) into the sharded digit layout.
    """
    from ..core import u64 as _u
    from ..schemes.galois import apply_automorphism_coeff
    from .keyswitch_sharded import ShardedKeySwitcher
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)
    ct_sh = NamedSharding(mesh, ct_batch_spec(False))

    def f(a, kd):
        a = jax.lax.with_sharding_constraint(a, ct_sh)
        c0 = apply_automorphism_coeff(jnp, a[:, 0], ring.q, engine.n,
                                      galois_elt)
        c1 = apply_automorphism_coeff(jnp, a[:, 1], ring.q, engine.n,
                                      galois_elt)
        e0, e1 = sharded.traced(c1, kd)
        out = jnp.stack([_u.addmod(jnp, c0, e0, ring.q), e1], axis=1)
        return jax.lax.with_sharding_constraint(out, ct_sh)

    return jax.jit(f), sharded.pad_keys


def make_limb_tp_hoisted_rotations(engine, galois_elts, level: int, mesh):
    """Hoisted rotation bundle (the BSGS linear-transform inner loop,
    reference rns_sp_decomp + advanced rotate) through the limb-TP switch:
    one digit decomposition, then each rotation is a local digit
    permutation (σ_g commutes with the decomposition) + the sharded
    from-digits switch — the expensive mod-up/NTT is paid once for the
    whole bundle.

    Returns (f, prep): ``f(ct_data[2,L,n], kds) -> {elt: (2,L,n)}``
    coeff-domain rotated ciphertexts, jitted; ``prep(glk_keys)`` pads each
    element's Galois key into the sharded digit layout.
    """
    from ..core import ntt as ntt_mod
    from ..core import u64 as _u
    from ..schemes.galois import (apply_automorphism_coeff,
                                  apply_automorphism_ntt)
    from .keyswitch_sharded import ShardedKeySwitcher
    sharded = ShardedKeySwitcher(engine.switcher, level, mesh)
    ring = engine.ring(level)
    elts = tuple(galois_elts)
    ntt_dom = engine.params.algo == 'CKKS'   # CKKS cts live in NTT domain

    def prep(glk_keys):
        return {e: sharded.pad_keys(glk_keys[e].key_q, glk_keys[e].key_p)
                for e in elts}

    def f(data, kds):
        c1 = ntt_mod.intt(jnp, data[1], ring) if ntt_dom else data[1]
        digits = sharded.pad_digits(
            engine.switcher.decompose_modup_ntt(jnp, c1, level))
        out = {}
        for e in elts:
            if ntt_dom:
                c0r = apply_automorphism_ntt(jnp, data[0], engine.n, e)
            else:
                c0r = apply_automorphism_coeff(jnp, data[0], ring.q,
                                               engine.n, e)
            dr = apply_automorphism_ntt(jnp, digits, engine.n, e)
            e0, e1 = sharded.traced_from_digits(dr, kds[e])
            if ntt_dom:
                e0 = ntt_mod.ntt(jnp, e0, ring)
                e1 = ntt_mod.ntt(jnp, e1, ring)
            out[e] = jnp.stack([_u.addmod(jnp, c0r, e0, ring.q), e1])
        return out

    return jax.jit(f), prep


def key_tree(context, galois_elts=()):
    """Context keys → plain array pytree for jit arguments."""
    tree = {'rlk': KeySwitchKey(key_q=context.rlk.key_q, key_p=context.rlk.key_p,
                                level=context.rlk.level, sp_level=context.rlk.sp_level)}
    if galois_elts:
        tree['glk'] = {e: context.glk.keys[e] for e in galois_elts}
    return tree
