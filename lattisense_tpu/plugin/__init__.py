"""Plug-in offload adapters: run compiled tasks on foreign raw-RNS buffers.

This framework's equivalent of the reference's plug-in band (SURVEY.md §2.6,
plug-in/SEAL/acc/runner.cpp, plug-in/lattigo/acc/gpu_runner.go): a foreign
FHE library (SEAL, Lattigo, ...) exports its ciphertexts/keys as the
canonical C structs (abi.py / abi/c_types.h) and offloads a
LattiSense-compiled task graph to this framework's device runtime, importing
the results back into its own types.
"""

from .foreign_task import ForeignTask, ForeignVectorArgument  # noqa: F401
