"""Device-mesh construction for FHE sharding.

Axis vocabulary (SURVEY.md §2.8):

- ``op``   — graph-level sharding: independent ciphertext operations of a
  batch placed on different chips. Replaces the reference's 32-thread
  priority pool (cpu_task_utils.h:378) — FHE's "data parallelism".
- ``limb`` — kernel-level sharding: the RNS limb axis of a single
  ciphertext split across chips; base-conversion/key-switch limb products
  reduced with psum_scatter collectives — FHE's "tensor parallelism".
- ``coeff`` — kernel-level sharding on the ring dimension: one
  polynomial's n coefficients split across chips; NTT stages exchange
  with all_to_all collectives (parallel/coeff_sharded.py,
  sharded_engine.py).

``make_mesh(op=4, limb=2)`` builds the mesh from the available devices
(a plain reshape: the cards of one host are joined all to all);
pass ``coeff=`` for a third axis (e.g. ``make_mesh(op=1, limb=2,
coeff=4)``).
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(op: int | None = None, limb: int = 1, coeff: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if op is None:
        op = n // (limb * coeff)
    if op * limb * coeff != n:
        raise ValueError(f'mesh {op}x{limb}x{coeff} does not match {n} devices')
    arr = np.asarray(devices).reshape(op, limb, coeff)
    return Mesh(arr, axis_names=('op', 'limb', 'coeff'))


def ct_batch_spec(limb_sharded: bool = False) -> P:
    """PartitionSpec for a batched ciphertext (B, degree+1, L, n)."""
    return P('op', None, 'limb' if limb_sharded else None, None)


def key_spec(limb_sharded: bool = False) -> P:
    """PartitionSpec for key-switch key halves (β, 2, L, n): replicated over
    ``op`` (every chip needs the keys), optionally limb-sharded."""
    return P(None, None, 'limb' if limb_sharded else None, None)


def shard(mesh: Mesh, x, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))
