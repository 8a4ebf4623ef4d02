"""LattiSense-TPU: an FHE framework (BFV + CKKS) in JAX.

A from-scratch re-design of the capabilities of cipherflow-fhe/lattisense
(reference layer map: SURVEY.md) for JAX/XLA, running on NVIDIA GPUs:

- RNS polynomial arithmetic (negacyclic NTT, Montgomery/Shoup modular
  multiplication on 64-bit or 32-bit words) runs as jitted XLA programs,
  with a row-fused Pallas (Triton) NTT kernel on the GPU.
- The Python frontend emits the same ``mega_ag.json`` / ``task_signature.json``
  task contract as the reference (reference: frontend/custom_task.py:2187),
  and the runtime lowers the instruction graph to a single jitted XLA
  callable instead of a priority-thread-pool scheduler
  (reference: mega_ag_runners/cpu_task_utils.h:378).
- Multi-device scaling shards RNS limbs / ciphertext batches over a
  ``jax.sharding.Mesh`` with collectives.

64-bit integers are required for exact RNS arithmetic, so x64 mode is
enabled on import (exactness verified by the conformance suite in
``tests/``).
"""

import jax as _jax

_jax.config.update('jax_enable_x64', True)

__version__ = '0.1.0'
