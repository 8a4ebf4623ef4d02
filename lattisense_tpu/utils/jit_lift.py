"""jit with closure constants lifted to runtime arguments.

`jax.jit` embeds closed-over arrays (NTT twiddle tables, encoded DFT
diagonals, key material captured by a segment closure) as literal
constants in the serialized HLO. A full-profile (n=2^16) bootstrap
segment carries hundreds of MB of such constants, which makes the
program large to serialize and slow to compile.

`jit_lifted(g)` closes that hole generically: trace ``g`` once with
`jax.make_jaxpr` (which hoists every captured array into the jaxpr's
``consts``), `device_put` the consts ONCE, and compile a wrapper whose
XLA signature takes them as ordinary parameters. The serialized program
then contains no big literals; steady-state behavior is identical (the
tables live in HBM either way — as executable-embedded buffers before,
as argument buffers now).

No reference analog (the reference's runtime never serializes programs
— graphs are interpreted against Lattigo/HEonGPU calls). Whether the GPU
build still needs it is an open measurement (ROADMAP C4).
"""


import numpy as np

import jax


def _tree_flatten(args):
    return jax.tree_util.tree_flatten(args)


def _dedup_consts(consts):
    """Collapse content-identical hoisted constants.

    A full-size bootstrap segment trace hoists the SAME ring/twiddle
    tables once per op instance — measured: the n=2^16 evalmod_b
    segment's jaxpr carried 4,730 consts totaling 2.93 GB. Un-deduped,
    every buffer is a separate device_put and the wrapper jit gets a
    4,732-parameter XLA signature.
    Dedup first by object id, then by content hash."""
    uniq = []
    idx = []
    by_id: dict = {}
    by_content: dict = {}
    for c in consts:
        j = by_id.get(id(c))
        if j is None:
            a = np.asarray(c)
            ckey = (a.dtype.str, a.shape,
                    hash(a.tobytes()) if a.nbytes < (1 << 26) else id(c))
            j = by_content.get(ckey)
            if j is None:
                j = len(uniq)
                uniq.append(c)
                by_content[ckey] = j
            by_id[id(c)] = j
        idx.append(j)
    return uniq, idx


def jit_lifted(g, static_argnums=()):
    """Return a callable equivalent to ``jax.jit(g)`` whose compiled
    program takes all closure constants as runtime arguments.

    The jaxpr is cached per (flattened input shapes/dtypes, tree
    structure); consts are content-deduped and device_put ONCE (one
    batched transfer) per cache entry. ``g`` may take / return arbitrary
    pytrees of arrays. ``.lower(*args)`` (arrays or ShapeDtypeStructs)
    gives an ahead-of-time handle whose ``compile()`` returns a callable
    with ``g``'s signature."""
    assert not static_argnums, 'static args not supported'
    cache: dict = {}

    def entry(args):
        flat, in_tree = jax.tree_util.tree_flatten(args)
        key = (in_tree, tuple((tuple(a.shape), np.dtype(a.dtype).str)
                              for a in flat))
        ent = cache.get(key)
        if ent is None:
            def gf(*flat_args):
                return g(*jax.tree_util.tree_unflatten(in_tree, flat_args))

            closed, out_shape = jax.make_jaxpr(gf, return_shape=True)(*flat)
            out_tree = jax.tree_util.tree_structure(out_shape)
            uniq, idx = _dedup_consts(closed.consts)
            jaxpr = closed.jaxpr
            # pack the unique consts into ONE flat buffer per dtype:
            # each buffer is a separate device_put and the wrapper jit
            # would get a parameter per const; packed, the program takes a handful
            # of parameters and reconstructs each const with a STATIC
            # slice + reshape (free inside XLA).
            specs = []
            chunks: dict = {}
            offs: dict = {}
            for c in uniq:
                a = np.ascontiguousarray(np.asarray(c))
                dt = a.dtype.str
                off = offs.get(dt, 0)
                chunks.setdefault(dt, []).append(a.reshape(-1))
                specs.append((dt, off, a.size, a.shape))
                offs[dt] = off + a.size
            packed = {dt: np.concatenate(parts) if len(parts) > 1
                      else parts[0]
                      for dt, parts in chunks.items()}
            packed = jax.device_put(packed)

            @jax.jit
            def run(packed, *flat_args):
                us = [packed[dt][off:off + size].reshape(shape)
                      for dt, off, size, shape in specs]
                consts = [us[i] for i in idx]
                outs = jax.core.eval_jaxpr(jaxpr, consts, *flat_args)
                return jax.tree_util.tree_unflatten(out_tree, outs)

            cache[key] = ent = (run, packed)
        return flat, ent

    def call(*args):
        flat, (run, packed) = entry(args)
        return run(packed, *flat)

    def lower(*args):
        flat, (run, packed) = entry(args)
        return _LiftedLowered(run.lower(packed, *flat), packed)

    call.lower = lower
    return call


class _LiftedLowered:
    """Ahead-of-time handle of a lifted program: ``out_info`` as for
    ``jax.stages.Lowered``; ``compile()`` returns a callable taking the
    original (unlifted) arguments."""

    def __init__(self, lowered, packed):
        self.lowered = lowered
        self.packed = packed
        self.out_info = lowered.out_info

    def compile(self):
        compiled = self.lowered.compile()
        packed = self.packed

        def run(*args):
            return compiled(packed, *jax.tree_util.tree_leaves(args))
        return run
